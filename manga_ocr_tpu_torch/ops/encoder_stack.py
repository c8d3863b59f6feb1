"""Kernel I: ``lpc`` whole encoder blocks per call over stacked weights.

Counterpart of ``manga_ocr_tpu/ops/encoder_stack.py`` ``encoder_stack``
(``_stack_call`` -> ``_stack_kernel`` -> ``_one_layer``), which runs the L
layers as ceil(L / lpc) calls, each over the [lpc, ...] slabs of the
parameter-stacked weights (the last slab shorter when lpc does not divide
L, one slab when lpc >= L).  Its block is kernel H's, int8 W8A8 or bf16,
EXCEPT that the softmax divides by its sum (``p / sum``, where H's
``_attn_core`` multiplies by the reciprocal) and no key is masked (the stack
runs unpadded).  Attention and MLP must share the quantization mode.

On CUDA tensors each slab is one call of the C entry point that also runs
kernel H (``csrc/encoder_layer.cu`` ``mocr_encoder_layers``, here with the
dividing softmax).  It loops over the slab's layers in C++, reading each
layer's pointers into the stacked weights of ``ops.encoder_weights``
(prepared once per params) and reusing one scratch set, allocated once per
call.  ``encoder_stack.launches`` counts the slab calls.  On CPU tensors it
runs ``encoder_stack_reference``.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.models.params import layer_params
from manga_ocr_tpu_torch.ops.encoder_weights import flat_weights, prepare_layers
from manga_ocr_tpu_torch.ops.flash_attention import (
    CUDA_GELU_MODES,
    encoder_block_reference,
    layer_is_int8,
)


def _slabs(num_layers: int, lpc: int) -> list[tuple[int, int]]:
    """(first layer, layer count) of each call, as the JAX loop cuts them."""
    if lpc < 1:
        raise ValueError(f"encoder_stack: lpc must be >= 1, got {lpc}")
    return [(c0, min(lpc, num_layers - c0)) for c0 in range(0, num_layers, lpc)]


def encoder_stack_reference(
    x: torch.Tensor,
    layers: dict,
    num_heads: int,
    eps: float = 1e-12,
    lpc: int = 12,
    gelu_mode: str = "erf",
) -> torch.Tensor:
    """Plain version of kernel I on [B, S, D] (the slab size does not
    change the math)."""
    layer_is_int8(layers, "encoder_stack")
    for c0, n in _slabs(layers["ln1"]["scale"].shape[0], lpc):
        for l in range(c0, c0 + n):
            x = encoder_block_reference(x, layer_params(layers, l), num_heads, eps, gelu_mode,
                                        divide=True)
    return x


def encoder_stack(
    x: torch.Tensor,  # [B, S, D]
    layers: dict,  # the parameter-stacked layer tree (vit params["layers"])
    num_heads: int,
    eps: float = 1e-12,
    lpc: int = 12,
    gelu_mode: str = "erf",
) -> torch.Tensor:
    """Kernel I: every encoder layer as ceil(L / lpc) slab calls.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    int8 = layer_is_int8(layers, "encoder_stack")
    slabs = _slabs(layers["ln1"]["scale"].shape[0], lpc)
    if x.device.type == "cpu":
        return encoder_stack_reference(x, layers, num_heads, eps, lpc, gelu_mode)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"encoder_stack: the CUDA kernel takes bf16, got {x.dtype}")
    if gelu_mode not in CUDA_GELU_MODES:
        raise ValueError(f"encoder_stack: the CUDA kernel has no gelu_mode {gelu_mode!r}")
    w = prepare_layers(layers, x.dtype)
    weights = flat_weights(w)
    b, s, d = x.shape
    scratch = launch.encoder_scratch(b * s, d, w.fc1.bias.shape[-1], int8, x.device)
    scale = 1.0 / ((d // num_heads) ** 0.5)
    x = x.contiguous()
    for c0, n in slabs:
        x = launch.encoder_layers(x, weights, c0, n, True, scratch, num_heads, eps, scale,
                                  gelu_mode == "sigmoid")
        encoder_stack.launches += 1
    return x


encoder_stack.launches = 0  # kernel I's CUDA launches, one per slab (CPU calls do not count)
