"""Encoder MLP block, int8 (kernel B): x + fc2(GELU(fc1(LN(x)))).

Counterpart of ``manga_ocr_tpu/ops/fused_mlp.py`` ``fused_mlp_block`` on its
int8 path (``_kernel_int8``).  On CUDA tensors it runs the hand-written
kernels of ``csrc/encoder.cu``: LN + row quantization -> int8 fc1 with a
dequant + bias + sigmoid-GELU epilogue -> row quantization of the f32 GELU
output -> int8 fc2 with a dequant + bias + residual epilogue.  On CPU
tensors it runs ``fused_mlp_block_reference``, the same math in plain
PyTorch.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_fn, int8_matmul, ln32, quant_rows


def fused_mlp_block_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: tuple[torch.Tensor, torch.Tensor],
    b1: torch.Tensor,
    w2: tuple[torch.Tensor, torch.Tensor],
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
) -> torch.Tensor:
    """Plain version: the JAX ``_kernel_int8`` chain on [..., D] rows."""
    (w1q, s1), (w2q, s2) = w1, w2
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    hq, sx = quant_rows(ln32(xf, ln_scale, ln_bias, eps))
    h = int8_matmul(hq, w1q).float() * sx * s1.float() + b1.float()
    h = gelu_fn(gelu_mode)(h)
    hq2, sx2 = quant_rows(h)
    o = int8_matmul(hq2, w2q).float() * sx2 * s2.float() + b2.float()
    return (xf + o.to(x.dtype)).reshape(shape)


def fused_mlp_block(
    x: torch.Tensor,  # [B, S, D] or [M, D]
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: tuple[torch.Tensor, torch.Tensor],  # (int8 [D, I], f32 scales [I])
    b1: torch.Tensor,
    w2: tuple[torch.Tensor, torch.Tensor],  # (int8 [I, D], f32 scales [D])
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
) -> torch.Tensor:
    """One int8 pre-LN MLP block with its residual.  CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise."""
    if not isinstance(w1, tuple) or not isinstance(w2, tuple):
        raise NotImplementedError(
            "fused_mlp_block: only the int8 form (weights as (w_q, scale)) is "
            "ported; the bf16 form is a later kernel"
        )
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_mode)
    if gelu_mode != "sigmoid":
        raise NotImplementedError(
            "fused_mlp_block: the CUDA kernel implements the serving sigmoid GELU only"
        )
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp_block: the CUDA kernel takes bf16, got {x.dtype}")
    (w1q, s1), (w2q, s2) = w1, w2
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    hq, sx = launch.ln_quant_rows(
        xf, (ln_scale.float().contiguous(), ln_bias.float().contiguous()), eps
    )
    h = launch.int8_gemm(
        hq, w1q.t().contiguous(), sx, s1.float().contiguous(), b1.float().contiguous(),
        launch.GEMM_GELU_F32,
    )
    hq2, sx2 = launch.ln_quant_rows(h)
    out = launch.int8_gemm(
        hq2, w2q.t().contiguous(), sx2, s2.float().contiguous(), b2.float().contiguous(),
        launch.GEMM_RESIDUAL_BF16, residual=xf,
    )
    fused_mlp_block.launches += 1
    return out.reshape(shape)


fused_mlp_block.launches = 0  # launches of the CUDA kernels (CPU calls do not count)
