"""MLP block: [LN ->] fc1 -> GELU -> fc2 -> + x [-> LN].

Counterpart of ``manga_ocr_tpu/ops/fused_mlp.py`` ``fused_mlp_block``, which
takes either weight form:

- int8 (kernel B, ``_kernel_int8``; weights as ``(w_q, scale)`` or
  ``Int8Weight``): the serving encoder's pre-LN block with the sigmoid GELU,
  and the int8 decoder's step form LN(x + MLP(x)) (``pre_ln=False``,
  ``post_ln=True``, erf GELU).  On CUDA tensors it runs the kernels of
  ``csrc/encoder.cu``: [LN +] row quantization -> int8 fc1 with a dequant +
  bias + GELU epilogue (f32 out) -> row quantization of the GELU output ->
  int8 fc2 with a dequant + bias + residual epilogue [-> ``ln_rows_bf16``,
  ``csrc/mlp_bf16.cu``, for the post-LN].  The int8 GEMM reads its weights
  as [N, K]: ``int8_weight`` makes that copy once, and a plain
  ``(w_q, scale)`` tuple is transposed on every call.
- bf16 (kernel D, ``_kernel_bf16``; weights as plain [K, N] matrices): the
  unquantized encoder's pre-LN block and the step decoder's ``pre_ln=False``
  block, with an optional post-LN.  On CUDA tensors it runs the kernels of
  ``csrc/mlp_bf16.cu``: an LN row pass (pre- or post-LN) and two bf16
  tensor-core GEMMs whose epilogues add the f32 bias, apply the f32 GELU
  and round to bf16 (fc1), or round to bf16 and add the bf16 residual
  (fc2).

On CPU tensors each form runs its plain version, the same math in plain
PyTorch.  ``fused_mlp_block.launches`` counts kernel B's launches and
``fused_mlp_block_bf16.launches`` kernel D's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_fn, int8_matmul, ln32, quant_rows

_GELU_MODES = {"erf": launch.BF16_GELU_ERF, "sigmoid": launch.BF16_GELU_SIGMOID}
_INT8_GELU_MODES = {"erf": launch.GEMM_GELU_ERF_F32, "sigmoid": launch.GEMM_GELU_F32}


class Int8Weight(NamedTuple):
    """An int8 dense as the JAX function takes it, ``(w_q [K, N], scale
    [N])``, with the [N, K] copy the CUDA int8 GEMM reads (``int8_weight``
    makes it once)."""

    w_q: torch.Tensor
    scale: torch.Tensor
    w_t: torch.Tensor


def int8_weight(w_q: torch.Tensor, scale: torch.Tensor) -> Int8Weight:
    """``(w_q [..., K, N], scale [..., N])`` -> ``Int8Weight`` (also for
    layer-stacked [L, K, N] weights)."""
    return Int8Weight(w_q, scale.float().contiguous(), w_q.transpose(-1, -2).contiguous())


class Proj(NamedTuple):
    """One projection, prepared: ``w`` an ``Int8Weight`` (int8 W8A8) or a
    float [K, N] matrix in the compute dtype; ``bias`` f32 [N]."""

    w: Int8Weight | torch.Tensor
    bias: torch.Tensor


def prepare_proj(denses: list[dict], dtype: torch.dtype) -> Proj:
    """Concatenate dense params (``{"kernel", "bias"}`` or the quantized
    ``{"w_q", "scale", "bias"}``, [K, N] or layer-stacked [L, K, N]) along
    their output columns.  Every array of the result is a new tensor."""
    bias = torch.cat([p["bias"].float() for p in denses], dim=-1).contiguous()
    if "w_q" in denses[0]:
        w_q = torch.cat([p["w_q"] for p in denses], dim=-1).contiguous()
        scale = torch.cat([p["scale"].float() for p in denses], dim=-1)
        return Proj(int8_weight(w_q, scale), bias)
    return Proj(torch.cat([p["kernel"].to(dtype) for p in denses], dim=-1).contiguous(), bias)


def fused_mlp_block_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1,  # (int8 [D, I], f32 scales [I]) or Int8Weight
    b1: torch.Tensor,
    w2,  # (int8 [I, D], f32 scales [D]) or Int8Weight
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
    pre_ln: bool = True,
    post_ln: bool = False,
) -> torch.Tensor:
    """Plain version of kernel B: the JAX ``_kernel_int8`` chain on [..., D]
    rows, [LN ->] MLP -> + x [-> LN]."""
    if pre_ln and post_ln:
        raise ValueError("fused_mlp_block: pre_ln and post_ln are exclusive")
    (w1q, s1), (w2q, s2) = w1[:2], w2[:2]
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    h32 = ln32(xf, ln_scale, ln_bias, eps) if pre_ln else xf.float()
    hq, sx = quant_rows(h32)
    h = int8_matmul(hq, w1q).float() * sx * s1.float() + b1.float()
    h = gelu_fn(gelu_mode)(h)
    hq2, sx2 = quant_rows(h)
    o = int8_matmul(hq2, w2q).float() * sx2 * s2.float() + b2.float()
    r = xf + o.to(x.dtype)
    if post_ln:
        r = ln32(r, ln_scale, ln_bias, eps).to(x.dtype)
    return r.reshape(shape)


def fused_mlp_block_bf16_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
    pre_ln: bool = True,
    post_ln: bool = False,
) -> torch.Tensor:
    """Plain version of kernel D: the JAX ``_kernel_bf16`` chain on [..., D]
    rows, rounding to ``x.dtype`` where it does."""
    if pre_ln and post_ln:
        raise ValueError("fused_mlp_block: pre_ln and post_ln are exclusive")
    dt = x.dtype
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    h = ln32(xf, ln_scale, ln_bias, eps).to(dt) if pre_ln else xf
    h = h.float() @ w1.to(dt).float() + b1.float()
    h = gelu_fn(gelu_mode)(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2.float()
    r = xf + o.to(dt)
    if post_ln:
        r = ln32(r, ln_scale, ln_bias, eps).to(dt)
    return r.reshape(shape)


def fused_mlp_block_bf16(
    x: torch.Tensor,  # [B, S, D] or [M, D]
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,  # [D, I]
    b1: torch.Tensor,
    w2: torch.Tensor,  # [I, D]
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
    pre_ln: bool = True,
    post_ln: bool = False,
) -> torch.Tensor:
    """Kernel D: one bf16 [LN ->] MLP -> residual [-> LN] block.  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    if x.device.type == "cpu":
        return fused_mlp_block_bf16_reference(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_mode, pre_ln, post_ln
        )
    if pre_ln and post_ln:
        raise ValueError("fused_mlp_block: pre_ln and post_ln are exclusive")
    if gelu_mode not in _GELU_MODES:
        raise ValueError(f"fused_mlp_block: the CUDA kernel has no gelu_mode {gelu_mode!r}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp_block: the CUDA kernel takes bf16, got {x.dtype}")
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    ln = (ln_scale.float().contiguous(), ln_bias.float().contiguous())
    h = launch.ln_rows_bf16(xf, ln, eps) if pre_ln else xf
    h = launch.bf16_gemm(
        h, w1.to(torch.bfloat16).contiguous(), b1.float().contiguous(), _GELU_MODES[gelu_mode]
    )
    out = launch.bf16_gemm(
        h, w2.to(torch.bfloat16).contiguous(), b2.float().contiguous(), launch.BF16_RESIDUAL,
        residual=xf,
    )
    if post_ln:
        out = launch.ln_rows_bf16(out, ln, eps)
    fused_mlp_block_bf16.launches += 1
    return out.reshape(shape)


fused_mlp_block_bf16.launches = 0  # launches of the CUDA kernels (CPU calls do not count)


def fused_mlp_block(
    x: torch.Tensor,  # [B, S, D] or [M, D]
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1,  # (int8 [D, I], f32 scales [I]), Int8Weight, or a bf16 [D, I] kernel
    b1: torch.Tensor,
    w2,  # (int8 [I, D], f32 scales [D]), Int8Weight, or a bf16 [I, D] kernel
    b2: torch.Tensor,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
    pre_ln: bool = True,
    post_ln: bool = False,
) -> torch.Tensor:
    """One [LN ->] MLP -> residual [-> LN] block in either weight form, as
    the JAX function.  Weights as plain tensors go to kernel D
    (``fused_mlp_block_bf16``); ``(w_q, scale)`` tuples or ``Int8Weight`` to
    kernel B.  CPU tensors take the plain versions; CUDA tensors launch the
    kernels or raise."""
    if not isinstance(w1, tuple):
        return fused_mlp_block_bf16(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_mode, pre_ln, post_ln
        )
    if x.device.type == "cpu":
        return fused_mlp_block_reference(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_mode, pre_ln, post_ln
        )
    if pre_ln and post_ln:
        raise ValueError("fused_mlp_block: pre_ln and post_ln are exclusive")
    if gelu_mode not in _INT8_GELU_MODES:
        raise ValueError(f"fused_mlp_block: the CUDA kernel has no gelu_mode {gelu_mode!r}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp_block: the CUDA kernel takes bf16, got {x.dtype}")
    w1 = w1 if isinstance(w1, Int8Weight) else int8_weight(*w1)
    w2 = w2 if isinstance(w2, Int8Weight) else int8_weight(*w2)
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    ln = (ln_scale.float().contiguous(), ln_bias.float().contiguous())
    hq, sx = launch.ln_quant_rows(xf, ln if pre_ln else None, eps)
    h = launch.int8_gemm(hq, w1.w_t, sx, w1.scale, b1.float().contiguous(),
                         _INT8_GELU_MODES[gelu_mode])
    hq2, sx2 = launch.ln_quant_rows(h)
    out = launch.int8_gemm(hq2, w2.w_t, sx2, w2.scale, b2.float().contiguous(),
                           launch.GEMM_RESIDUAL_BF16, residual=xf)
    if post_ln:
        out = launch.ln_rows_bf16(out, ln, eps)
    fused_mlp_block.launches += 1
    return out.reshape(shape)


fused_mlp_block.launches = 0  # kernel B's CUDA launches (CPU calls do not count)
