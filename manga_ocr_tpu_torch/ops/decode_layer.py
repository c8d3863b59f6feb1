"""The attention halves of one decode-step layer (kernels J and K).

Counterpart of ``manga_ocr_tpu/ops/decode_layer.py``:

- J, ``fused_self_attn_step``: LN(x + O(SelfAttn(x))) for one step, the new
  K/V row written into the packed [T, B, D] cache at ``step`` (in place;
  the JAX kernel aliases its cache outputs to its inputs), keys t <= step;
- K, ``fused_cross_attn_step``: LN(x + O(CrossAttn(x))) over packed
  [B, S, D] cross-K/V, int8 with per-(b, s) K scales and per-(b, d) V
  scales applied after the contractions, or in the compute dtype.

The projections take either weight form: int8 W8A8 (``quant_rows`` of the
f32 activations, then ``(acc * sx) * scale + bias``) or float (``h`` rounded
to the compute dtype, f32 accumulation, plus the bias).  ``prepare_self_attn``
and ``prepare_cross_attn`` build a layer's weights once (the q|k|v
concatenation and the int8 GEMM's [N, K] copies), so no step concatenates or
transposes.  On CUDA tensors each half is a chain of the kernels of
``csrc/``: the q|k|v (J) or q (K) projection with an f32-out epilogue, the
attention core of ``csrc/decode_layer.cu``, the out projection with the bf16
residual epilogue and ``ln_rows_bf16``.  On CPU tensors each runs its plain
version.  ``fused_self_attn_step.launches`` and
``fused_cross_attn_step.launches`` count the CUDA launches.

Rounding contract of the JAX kernels: J rounds k and v to the compute dtype
before the insert and keeps q in f32; scores are f32, multiplied by the
Python constant 1/sqrt(dh) (not divided by an f32 sqrt as the XLA step
does), masked with -1e30; the softmax divides; p stays f32; then
``x + out.astype(dt)`` and the LN in f32.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.fused_mlp import Int8Weight, Proj, prepare_proj
from manga_ocr_tpu_torch.ops.kernel_utils import NEG_INF, int8_matmul, ln32, quant_rows


def prepare_self_attn(p: dict, dtype: torch.dtype) -> dict:
    """A layer's self-attention params -> {"qkv", "o"} projections."""
    return {"qkv": prepare_proj([p["q"], p["k"], p["v"]], dtype), "o": prepare_proj([p["o"]], dtype)}


def prepare_cross_attn(p: dict, dtype: torch.dtype) -> dict:
    """A layer's cross-attention params -> {"q", "o"} projections (the
    cross k/v run once per dispatch in ``precompute_cross_kv_packed``)."""
    return {"q": prepare_proj([p["q"]], dtype), "o": prepare_proj([p["o"]], dtype)}


def _proj_reference(h32: torch.Tensor, proj: Proj, dt: torch.dtype) -> torch.Tensor:
    """The JAX ``_proj``: [g, K] f32 -> [g, N] f32."""
    if isinstance(proj.w, Int8Weight):
        hq, sx = quant_rows(h32)
        y = int8_matmul(hq, proj.w.w_q).float() * sx * proj.w.scale
    else:
        y = h32.to(dt).float() @ proj.w.float()
    return y + proj.bias


def _post_ln_reference(x: torch.Tensor, out: torch.Tensor, ln: dict, eps: float) -> torch.Tensor:
    return ln32((x + out.to(x.dtype)).float(), ln["scale"], ln["bias"], eps).to(x.dtype)


def fused_self_attn_step_reference(
    x: torch.Tensor,  # [B, D]
    w: dict,  # prepare_self_attn
    ln: dict,  # self_ln {"scale", "bias"}
    cache_k: torch.Tensor,  # [T, B, D]
    cache_v: torch.Tensor,
    step: int,
    num_heads: int,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel J (the JAX ``_self_attn_kernel``)."""
    dt = x.dtype
    b, d = x.shape
    t_len = cache_k.shape[0]
    dh = d // num_heads
    qkv = _proj_reference(x.float(), w["qkv"], dt)
    q = qkv[:, :d].reshape(b, num_heads, dh)
    cache_k[step] = qkv[:, d : 2 * d].to(dt)
    cache_v[step] = qkv[:, 2 * d :].to(dt)
    ck = cache_k.float().reshape(t_len, b, num_heads, dh)
    cv = cache_v.float().reshape(t_len, b, num_heads, dh)
    scores = torch.einsum("bhd,tbhd->tbh", q, ck) * (1.0 / (dh**0.5))
    keep = (torch.arange(t_len, device=x.device) <= step)[:, None, None]
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(0, keepdim=True))
    p = p / p.sum(0, keepdim=True)
    ctx = torch.einsum("tbh,tbhd->bhd", p, cv).reshape(b, d)
    out = _proj_reference(ctx, w["o"], dt)
    return _post_ln_reference(x, out, ln, eps), cache_k, cache_v


def fused_cross_attn_step_reference(
    x: torch.Tensor,  # [B, D]
    w: dict,  # prepare_cross_attn
    ln: dict,  # cross_ln {"scale", "bias"}
    cross_k: torch.Tensor,  # [B, S, D] int8 or float
    cross_v: torch.Tensor,
    k_scale: torch.Tensor | None,  # [B, S] f32 (int8 K/V)
    v_scale: torch.Tensor | None,  # [B, D] f32 (int8 K/V)
    num_heads: int,
    eps: float,
    s_valid: int,
) -> torch.Tensor:
    """Plain version of kernel K (the JAX ``_cross_attn_kernel``)."""
    dt = x.dtype
    b, d = x.shape
    s_len = cross_k.shape[1]
    dh = d // num_heads
    int8_kv = cross_k.dtype == torch.int8
    q = _proj_reference(x.float(), w["q"], dt).reshape(b, num_heads, dh)
    kf = cross_k.float().reshape(b, s_len, num_heads, dh)
    scores = torch.einsum("bhd,bshd->bsh", q, kf)
    if int8_kv:
        scores = scores * k_scale.float()[:, :, None]
    scores = scores * (1.0 / (dh**0.5))
    if s_valid < s_len:
        keep = (torch.arange(s_len, device=x.device) < s_valid)[None, :, None]
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(1, keepdim=True))
    p = p / p.sum(1, keepdim=True)
    ctx = torch.einsum("bsh,bshd->bhd", p, cross_v.float().reshape(b, s_len, num_heads, dh))
    ctx = ctx.reshape(b, d)
    if int8_kv:
        ctx = ctx * v_scale.float()
    out = _proj_reference(ctx, w["o"], dt)
    return _post_ln_reference(x, out, ln, eps)


def _proj_in(x: torch.Tensor, proj: Proj) -> torch.Tensor:
    """CUDA: the input projection of bf16 rows x -> f32 [B, N]."""
    if isinstance(proj.w, Int8Weight):
        hq, sx = launch.ln_quant_rows(x)
        return launch.int8_gemm(hq, proj.w.w_t, sx, proj.w.scale, proj.bias, launch.GEMM_F32)
    return launch.bf16_gemm(x, proj.w, proj.bias, launch.BF16_F32)


def _ctx_dtype(proj: Proj) -> torch.dtype:
    """The attention core writes f32 context for an int8 out projection
    (row-quantized from f32) and bf16 context for a bf16 one."""
    return torch.float32 if isinstance(proj.w, Int8Weight) else torch.bfloat16


def _proj_out_ln(ctx: torch.Tensor, x: torch.Tensor, proj: Proj, ln: dict, eps: float):
    """CUDA: LN(x + bf16(O(ctx))) in bf16."""
    if isinstance(proj.w, Int8Weight):
        hq, sx = launch.ln_quant_rows(ctx)
        y = launch.int8_gemm(hq, proj.w.w_t, sx, proj.w.scale, proj.bias,
                             launch.GEMM_RESIDUAL_BF16, residual=x)
    else:
        y = launch.bf16_gemm(ctx, proj.w, proj.bias, launch.BF16_RESIDUAL, residual=x)
    return launch.ln_rows_bf16(y, (ln["scale"].float().contiguous(),
                                   ln["bias"].float().contiguous()), eps)


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")


def fused_self_attn_step(
    x: torch.Tensor,  # [B, D]
    w: dict,  # prepare_self_attn
    ln: dict,
    cache_k: torch.Tensor,  # [T, B, D], updated in place
    cache_v: torch.Tensor,
    step: int,
    num_heads: int,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel J: LN(x + SelfAttn(x)) for one decode step; writes row
    ``step`` of the caches in place.  Returns (x_out, cache_k, cache_v) as
    the JAX function does.  CPU tensors take the plain version; CUDA tensors
    launch the kernels or raise."""
    if x.device.type == "cpu":
        return fused_self_attn_step_reference(x, w, ln, cache_k, cache_v, step, num_heads, eps)
    _check_cuda(x, "fused_self_attn_step")
    x = x.contiguous()
    dh = x.shape[1] // num_heads
    qkv = _proj_in(x, w["qkv"])
    ctx = launch.self_attn_step(qkv, cache_k, cache_v, num_heads, step, 1.0 / (dh**0.5),
                                _ctx_dtype(w["o"]))
    out = _proj_out_ln(ctx, x, w["o"], ln, eps)
    fused_self_attn_step.launches += 1
    return out, cache_k, cache_v


fused_self_attn_step.launches = 0  # kernel J's CUDA launches (CPU calls do not count)


def fused_cross_attn_step(
    x: torch.Tensor,  # [B, D]
    w: dict,  # prepare_cross_attn
    ln: dict,
    cross_k: torch.Tensor,  # [B, S, D] int8 or bf16
    cross_v: torch.Tensor,
    k_scale: torch.Tensor | None,
    v_scale: torch.Tensor | None,
    num_heads: int,
    eps: float,
    s_valid: int,
) -> torch.Tensor:
    """Kernel K: LN(x + CrossAttn(x, enc)) for one decode step.  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    if x.device.type == "cpu":
        return fused_cross_attn_step_reference(
            x, w, ln, cross_k, cross_v, k_scale, v_scale, num_heads, eps, s_valid
        )
    _check_cuda(x, "fused_cross_attn_step")
    x = x.contiguous()
    dh = x.shape[1] // num_heads
    int8_kv = cross_k.dtype == torch.int8
    q = _proj_in(x, w["q"])
    ctx = launch.cross_attn_step(
        q, cross_k, cross_v, k_scale if int8_kv else None, v_scale if int8_kv else None,
        num_heads, s_valid, 1.0 / (dh**0.5), _ctx_dtype(w["o"]),
    )
    out = _proj_out_ln(ctx, x, w["o"], ln, eps)
    fused_cross_attn_step.launches += 1
    return out


fused_cross_attn_step.launches = 0  # kernel K's CUDA launches (CPU calls do not count)
