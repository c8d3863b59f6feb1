"""Plain layer norm, dense and attention (counterpart of
``manga_ocr_tpu/ops/common.py``).

Used where the JAX package leaves the work to XLA: the patch embedding, the
encoder's final LayerNorm, the projections, the cross-attention K/V
precompute, and the whole reference path (``mha``, exact-erf ``gelu``).
Matmuls run in float32 on values already rounded to the compute dtype,
which is exactly a compute-dtype matmul with float32 accumulation (a
product of two bf16 values is exact in f32).  On CUDA this relies on TF32
being off for matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by
default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from manga_ocr_tpu_torch.ops.quant import dense_int8

NEG_INF = -1e9  # additive mask value of the reference attention, as in JAX


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


def dense_any(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Dense dispatch: a float kernel or the int8-quantized form
    (``{"w_q", "scale", "bias"}``, see ``models.quantize``)."""
    if "w_q" in p:
        return dense_int8(x, p["w_q"], p["scale"], p.get("bias"))
    return dense(x, p["kernel"], p.get("bias"))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., S, D] -> [..., H, S, dh]"""
    *lead, s, d = x.shape
    return x.reshape(*lead, s, num_heads, d // num_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, S, dh] -> [..., S, D]"""
    x = x.transpose(-3, -2)
    *lead, s, h, dh = x.shape
    return x.reshape(*lead, s, h * dh)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` computes it:
    ``exp(x - max) / sum`` (a division, where torch's kernel multiplies by
    the reciprocal)."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention (reference path).  q/k/v [B, H, S, dh];
    ``mask`` boolean, broadcastable to [B, H, S_q, S_k] (True = attend).
    f32 logits and softmax; probabilities cast to the compute dtype before
    PV; output in the compute dtype."""
    # 1/sqrt(dh) in f32, rounded as JAX computes it
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device))
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = softmax(logits)
    return (probs.to(q.dtype).float() @ v.float()).to(q.dtype)


def mha(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    p: dict,
    num_heads: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention block: q/k/v projections, SDPA, output
    projection.  ``p`` holds the q/k/v/o dense params (float or int8)."""
    q = split_heads(dense_any(x_q, p["q"]), num_heads)
    k = split_heads(dense_any(x_kv, p["k"]), num_heads)
    v = split_heads(dense_any(x_kv, p["v"]), num_heads)
    return dense_any(merge_heads(attention_scores(q, k, v, mask)), p["o"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)`` (not the
    kernels' erf polynomial)."""
    return F.gelu(x, approximate="none")
