"""Plain layer norm, dense and attention (counterpart of
``manga_ocr_tpu/ops/common.py``).

Used where the JAX package leaves the work to XLA: the patch embedding, the
encoder's final LayerNorm, the projections, the cross-attention K/V
precompute, and the whole reference path (``mha``, ``mlp``, exact-erf
``gelu``).  ``mha`` and ``mlp`` also run on a data row's model columns
(tensor parallelism, ``parallel.mesh.shard_params``): a list of the
columns' params in place of one set, each column computing its heads or
its slice of fc1 from its copy of the input, and ``row_parallel`` summing
the columns' partial output projections.  One set of params is one
column, and computes exactly what it computes alone.
Matmuls run in float32 on values already rounded to the compute dtype,
which is exactly a compute-dtype matmul with float32 accumulation (a
product of two bf16 values is exact in f32).  On CUDA this relies on TF32
being off for matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by
default).
"""

from __future__ import annotations

import numpy as np
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
    # 1/sqrt(dh) in f32, rounded as JAX computes it; a host scalar, since a
    # device tensor made from a Python number waits for the stream
    scale = float(np.float32(1) / np.sqrt(np.float32(q.shape[-1])))
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = softmax(logits)
    return (probs.to(q.dtype).float() @ v.float()).to(q.dtype)


def columns(p) -> list:
    """``p`` as a list of model columns' params: a list as given, one set
    of params as the list of it alone."""
    return p if isinstance(p, list) else [p]


def tree_device(tree) -> torch.device:
    """The device of a tree's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def spread(x: torch.Tensor, devices: list) -> list:
    """``x`` as each column's input: the tensor itself on its own device, a
    copy on another."""
    return [x.to(d) for d in devices]


def row_parallel(xs: list, ps: list) -> torch.Tensor:
    """The row-parallel dense of model columns: ``sum_c xs[c] @ ps[c] +
    bias`` on column 0's device, the partials in f32 summed in column order
    and the (replicated) bias added once after the sum, in the inputs'
    dtype (``dense``'s rounding).  One column is ``dense_any``."""
    if len(ps) == 1:
        return dense_any(xs[0], ps[0])
    dev, dt = xs[0].device, xs[0].dtype
    acc = None
    for x, p in zip(xs, ps):
        part = (x.float() @ p["kernel"].to(dt).float()).to(dev)
        acc = part if acc is None else acc + part
    return (acc + ps[0]["bias"].float()).to(dt)


def mha(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    p,
    num_heads: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention block: q/k/v projections, SDPA, output
    projection.  ``p`` holds the q/k/v/o dense params (float or int8), or is
    a list of model columns' (each ``num_heads / n`` heads, on its device;
    the output on column 0's)."""
    cols = columns(p)
    heads = num_heads // len(cols)
    devices = [tree_device(c) for c in cols]
    qs = spread(x_q, devices)
    kvs = qs if x_kv is x_q else spread(x_kv, devices)
    ctx = []
    for c, xq, xkv, d in zip(cols, qs, kvs, devices):
        q = split_heads(dense_any(xq, c["q"]), heads)
        k = split_heads(dense_any(xkv, c["k"]), heads)
        v = split_heads(dense_any(xkv, c["v"]), heads)
        ctx.append(merge_heads(attention_scores(q, k, v, None if mask is None else mask.to(d))))
    return row_parallel(ctx, [c["o"] for c in cols])


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    """fc1 -> exact GELU -> fc2 (``p`` holds them, or is a list of model
    columns': fc1 column-parallel, fc2 row-parallel)."""
    cols = columns(p)
    xs = spread(x, [tree_device(c) for c in cols])
    mids = [gelu(dense_any(xc, c["fc1"])) for xc, c in zip(xs, cols)]
    return row_parallel(mids, [c["fc2"] for c in cols])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)`` (not the
    kernels' erf polynomial)."""
    return F.gelu(x, approximate="none")
