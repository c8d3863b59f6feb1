"""Encoder attention: the int8 attention layer (kernel A) and the packed
SDPA of the unquantized encoder (kernel E).

Kernel A, x + O(SDPA(LN(x))), is the counterpart of
``manga_ocr_tpu/ops/flash_attention.py`` ``fused_attn_layer``
(``_attn_layer_kernel`` -> ``_attn_core``) in its default form: W8A8 q/k/v/o
projections (``quant_rows`` activations, per-column weight scales), q/k/v
cast to the compute dtype, f32 softmax as a reciprocal multiply with keys at
or past ``valid_len`` masked, probabilities cast to the compute dtype before
PV, the f32 context row-quantized into the int8 o-projection, and the
residual added in the compute dtype.

On CUDA tensors it runs the kernels of ``csrc/encoder.cu``: LN + row quant
-> one int8 GEMM over the concatenated q|k|v weights (bit-exact: each output
column's contraction is unchanged) -> the attention core -> row quant of the
context -> int8 o-projection with the residual in its epilogue.  On CPU
tensors it runs ``fused_attn_layer_reference``.

Kernel E, ``attention_packed`` (counterpart of ``attention_packed`` ->
``_packed_kernel``, and ``mha_packed`` around it): SDPA alone on q/k/v
[B, S, H*dh] straight from the bf16 projections, f32 logits scaled after
the product, keys at or past ``valid_len`` masked, softmax as a division,
probabilities cast to bf16 before PV, the context cast to bf16 per head.
On CUDA tensors it runs the attention core of ``csrc/encoder.cu`` that A
uses, with separate q/k/v pointers; on CPU tensors
``attention_packed_reference``.  The TPU kernel pads S to a multiple of 128
and masks the padded keys; the port runs S unpadded.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.common import dense
from manga_ocr_tpu_torch.ops.kernel_utils import NEG_INF, int8_matmul, ln32, quant_rows

_VARIANTS = ("fuse_qkv", "batched_sdpa", "sdpa_int8", "sdpa_headpack", "parallel_grid")


def fused_attn_layer_reference(
    x: torch.Tensor,
    p: dict,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    num_heads: int,
    eps: float = 1e-12,
    valid_len: int | None = None,
) -> torch.Tensor:
    """Plain version of the default ``_attn_core`` path on [B, S, D]."""
    b, s, d = x.shape
    dh = d // num_heads
    valid_len = s if valid_len is None else valid_len
    hq, sx = quant_rows(ln32(x, ln_scale, ln_bias, eps).reshape(b * s, d))

    def proj(name):
        w = p[name]
        y = int8_matmul(hq, w["w_q"]).float() * sx * w["scale"].float() + w["bias"].float()
        return y.to(x.dtype).reshape(b, s, num_heads, dh).transpose(1, 2).float()

    q, k, v = proj("q"), proj("k"), proj("v")  # [B, H, S, dh]
    logits = (q @ k.transpose(-1, -2)) * (1.0 / (dh**0.5))
    if valid_len < s:
        keep = torch.arange(s, device=x.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    pr = torch.exp(logits - m)
    pr = pr * (1.0 / pr.sum(-1, keepdim=True))
    ctx = pr.to(x.dtype).float() @ v  # [B, H, S, dh] f32
    ctx = ctx.transpose(1, 2).reshape(b * s, d)
    cq, csx = quant_rows(ctx)
    o = p["o"]
    out = int8_matmul(cq, o["w_q"]).float() * csx * o["scale"].float() + o["bias"].float()
    return x + out.to(x.dtype).reshape(b, s, d)


def fused_attn_layer(
    x: torch.Tensor,  # [B, S, D]
    p: dict,  # attention params: q/k/v/o as {"w_q", "scale", "bias"}
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    num_heads: int,
    eps: float = 1e-12,
    valid_len: int | None = None,  # keys at or past this index are masked
    **variants,
) -> torch.Tensor:
    """x + Attention(LN(x)).  CPU tensors take the plain version; CUDA
    tensors launch the kernels or raise.  The JAX kernel's variant flags
    (``fuse_qkv``, ``batched_sdpa``, ``sdpa_int8``, ``sdpa_headpack``,
    ``parallel_grid``) are not ported and raise when set."""
    for name, value in variants.items():
        if name not in _VARIANTS:
            raise TypeError(f"fused_attn_layer: unexpected argument {name!r}")
        if value:
            raise NotImplementedError(f"fused_attn_layer: variant {name} is not ported")
    if "w_q" not in p["q"]:
        raise NotImplementedError(
            "fused_attn_layer: only int8-quantized projections are ported "
            "(models.quantize.quantize_encoder(quantize_attn_proj=True))"
        )
    if x.device.type == "cpu":
        return fused_attn_layer_reference(x, p, ln_scale, ln_bias, num_heads, eps, valid_len)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_attn_layer: the CUDA kernel takes bf16, got {x.dtype}")
    b, s, d = x.shape
    dh = d // num_heads
    xf = x.reshape(b * s, d).contiguous()
    hq, sx = launch.ln_quant_rows(
        xf, (ln_scale.float().contiguous(), ln_bias.float().contiguous()), eps
    )
    names = ("q", "k", "v")
    wqkv_t = torch.cat([p[n]["w_q"].t() for n in names], 0).contiguous()  # [3D, D]
    sqkv = torch.cat([p[n]["scale"].float() for n in names]).contiguous()
    bqkv = torch.cat([p[n]["bias"].float() for n in names]).contiguous()
    qkv = launch.int8_gemm(hq, wqkv_t, sx, sqkv, bqkv, launch.GEMM_BF16)
    ctx = launch.attention(
        qkv, b, s, num_heads, s if valid_len is None else valid_len, 1.0 / (dh**0.5)
    )
    cq, csx = launch.ln_quant_rows(ctx)
    o = p["o"]
    out = launch.int8_gemm(
        cq, o["w_q"].t().contiguous(), csx, o["scale"].float().contiguous(),
        o["bias"].float().contiguous(), launch.GEMM_RESIDUAL_BF16, residual=xf,
    )
    fused_attn_layer.launches += 1
    return out.reshape(b, s, d)


fused_attn_layer.launches = 0  # launches of the CUDA kernels (CPU calls do not count)


def attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    valid_len: int | None = None,
) -> torch.Tensor:
    """Plain version of ``_packed_kernel`` on q/k/v [B, S, H*dh]."""
    b, s, d = q.shape
    dh = d // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, dh).transpose(1, 2).float()

    logits = (heads(q) @ heads(k).transpose(-1, -2)) * (1.0 / (dh**0.5))
    valid_len = s if valid_len is None else valid_len
    if valid_len < s:
        keep = torch.arange(s, device=q.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    ctx = p.to(v.dtype).float() @ heads(v)  # [B, H, S, dh] f32
    return ctx.transpose(1, 2).reshape(b, s, d).to(q.dtype)


def attention_packed(
    q: torch.Tensor,  # [B, S, H*dh]
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    valid_len: int | None = None,  # keys at or past this index are masked
) -> torch.Tensor:
    """Kernel E: softmax(q k^T / sqrt(dh)) v per head on the packed layout.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, valid_len)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"attention_packed: the CUDA kernel takes bf16, got {q.dtype}")
    b, s, d = q.shape
    dh = d // num_heads
    out = launch.attention_packed(
        q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
        s if valid_len is None else valid_len, 1.0 / (dh**0.5),
    )
    attention_packed.launches += 1
    return out


attention_packed.launches = 0  # launches of the CUDA kernel (CPU calls do not count)


def mha_packed(
    x_q: torch.Tensor, x_kv: torch.Tensor, p: dict, num_heads: int, use_kernels: bool = True
) -> torch.Tensor:
    """Multi-head attention on the packed layout: the q/k/v projections,
    kernel E (or its plain version, ``use_kernels=False``), the output
    projection."""
    q = dense(x_q, p["q"]["kernel"], p["q"]["bias"])
    k = dense(x_kv, p["k"]["kernel"], p["k"]["bias"])
    v = dense(x_kv, p["v"]["kernel"], p["v"]["bias"])
    attn = attention_packed if use_kernels else attention_packed_reference
    return dense(attn(q, k, v, num_heads), p["o"]["kernel"], p["o"]["bias"])
