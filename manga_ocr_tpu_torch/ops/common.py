"""Plain layer norm and dense (counterpart of ``manga_ocr_tpu/ops/common.py``).

Used where the JAX package leaves the work to XLA: the patch embedding, the
encoder's final LayerNorm and the cross-attention K/V precompute.  Matmuls
run in float32 on values already rounded to the compute dtype, which is
exactly a compute-dtype matmul with float32 accumulation (a product of two
bf16 values is exact in f32).  On CUDA this relies on TF32 being off for
matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, cast back to
    ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ kernel + bias`` in ``x.dtype`` with float32 accumulation."""
    y = x.float() @ kernel.to(x.dtype).float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
