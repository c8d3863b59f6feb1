"""manga_ocr_tpu_torch — the batched manga-ocr engine in PyTorch + CUDA.

A second package beside ``manga_ocr_tpu`` (the JAX reference).  Its layout
mirrors the JAX package so each module's counterpart is easy to find:

- ``ops/``     — plain-tensor numerics (``kernel_utils``, ``quant``,
                 ``common``, ``image``, ``preprocess``) and the kernel
                 wrappers: ``flash_attention`` (the int8 encoder attention
                 layer and the packed attention), ``fused_mlp`` (the int8
                 and bf16 MLP blocks), ``decode_loop`` (the whole greedy
                 decode) and ``fused_head`` (the greedy LM head of the
                 step-by-step decode).
- ``csrc/``    — the hand-written CUDA C++ kernels for Hopper (sm_90a),
                 built on first use by ``kernels/build.py``.
- ``models/``  — encoder, decoder, the full model, int8 quantization and the
                 weight bridge from the JAX parameter tree.
- ``engine/``  — ``TorchMangaOcrEngine`` (``ocr_page``, ``ocr_pages``,
                 ``perform_ocr``, ``warmup``).
- ``serve.py`` — the HTTP server around the engine.

Every entry point takes an explicit ``device``; a kernel wrapper runs its
plain PyTorch version only for CPU tensors and launches its CUDA kernel (or
raises) for CUDA tensors.  This package never imports ``jax``; the config,
tokenizer, host batching and microbatcher are imported from
``manga_ocr_tpu`` modules that do not import it either.
"""

__version__ = "0.1.0"
