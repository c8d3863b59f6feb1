"""manga_ocr_tpu_torch — the batched manga-ocr engine in PyTorch + CUDA.

A second package beside ``manga_ocr_tpu`` (the JAX reference).  Its layout
mirrors the JAX package so each module's counterpart is easy to find:

- ``ops/``     — plain-tensor numerics (``kernel_utils``, ``quant``,
                 ``common``, ``image``, ``preprocess``: the model input and the
                 dual pass's binarized variant) and the kernel
                 wrappers: ``flash_attention`` (the int8 encoder attention
                 layer and the packed attention), ``fused_mlp`` (the int8
                 and bf16 MLP blocks), ``decode_loop`` (the whole greedy
                 decode) and ``fused_head`` (the greedy LM head of the
                 step-by-step decode).
- ``csrc/``    — the hand-written CUDA C++ kernels for Hopper (sm_90a),
                 built on first use by ``kernels/build.py``.
- ``models/``  — encoder, decoder, the full model, int8 quantization, the
                 weight bridge from the JAX parameter tree and the npz
                 checkpoint store.
- ``engine/``  — ``TorchMangaOcrEngine`` (``ocr_page``, ``ocr_pages``,
                 ``ocr_page_dual``, ``perform_ocr``, ``warmup``).
- ``parallel/`` — host batching, data-parallel meshes of torch devices
                 (``mesh``) and multi-process meshes on
                 ``torch.distributed`` (``multihost``).
- ``serve.py`` — the HTTP server around the engine.
- ``eval.py``  — the CER harness (``python -m manga_ocr_tpu_torch.eval``).
- ``core/``    — file helpers (image decode, natural sort).

Every entry point takes an explicit ``device``; a kernel wrapper runs its
plain PyTorch version only for CPU tensors and launches its CUDA kernel (or
raises) for CUDA tensors.  This package never imports ``jax`` nor anything
of ``manga_ocr_tpu``: it keeps its own copies of the config, tokenizer,
host batching, microbatcher and file helpers.
"""

__version__ = "0.1.0"
