"""Encoder attention: the attention layer (kernel A), the whole encoder
block (kernel H), the packed SDPA (kernel E) and the head-major SDPA
(kernel G).

Kernel A, x + O(SDPA(LN(x))), is the counterpart of
``manga_ocr_tpu/ops/flash_attention.py`` ``fused_attn_layer``
(``_attn_layer_kernel`` -> ``_attn_core``) in its default form, with either
projection form: int8 W8A8 q/k/v/o (``quant_rows`` activations, per-column
weight scales, ``(acc * sx) * scale + bias``) or float (the LN output
rounded to the compute dtype, ``dot + bias`` in f32).  q/k/v are cast to the
compute dtype; the softmax is f32, a reciprocal multiply, with keys at or
past ``valid_len`` masked; probabilities are cast to the compute dtype
before PV; the f32 context is row-quantized into the int8 o-projection, or
cast to the compute dtype before the float one; the residual is added in
the compute dtype.  Of the JAX kernel's variant flags, ``fuse_qkv``,
``batched_sdpa`` and ``parallel_grid`` schedule the same math (the CUDA path
always runs q|k|v as one GEMM) and are accepted; the pairs JAX refuses
raise its ``ValueError``.  The two that change the SDPA:

- ``sdpa_int8`` runs QK^T and PV on int8 with dynamic quantization, with
  either projection form: q and k rows per head with ``quant_rows``,
  ``logits = (acc * (sq * scale)) * sk[j]``, the masked reciprocal-multiply
  softmax in f32, p row-quantized in f32 (no cast), v per output column
  over the ``valid_len`` real rows only (``127 / amax``, amax at least
  1e-8), ``ctx = (acc * sp) * v_scale``;
- ``sdpa_headpack`` packs two dh heads into one 2*dh contraction against
  block-diagonal K and V on the TPU: the zero blocks add exact zeros, so it
  is the default SDPA in another summation order and runs A's default
  core.  JAX falls back to the per-head loop on an odd head count without
  a word; the port raises ``ValueError`` there instead.

On CUDA tensors A runs the kernels of ``csrc/``: int8, LN + row quant ->
one int8 GEMM over the concatenated q|k|v weights (bit-exact: each output
column's contraction is unchanged) -> the attention core -> row quant of
the context -> int8 o-projection with the residual in its epilogue; bf16,
``ln_rows_bf16`` -> one bf16 GEMM over q|k|v (bias epilogue, bf16 out) ->
the attention core (bf16 context) -> bf16 o-projection with the residual
epilogue; ``sdpa_int8`` swaps in the int8 attention core of
``csrc/encoder.cu``.  The weights come prepared (``ops.encoder_weights``)
or are prepared on the call.  On CPU tensors it runs
``fused_attn_layer_reference``.

Kernel H, ``fused_encoder_layer`` (counterpart of ``fused_encoder_layer`` ->
``_enc_layer_kernel``): a whole pre-LN block, A's attention half with every
key attended (JAX passes ``valid_len = S``), then kernel B's int8 MLP (GELU
in f32, then ``quant_rows``) or D's bf16 one (GELU, then the cast), the
GELU of ``gelu_mode``.  Attention and MLP must share the quantization mode.
On CUDA tensors one C entry point runs the whole block
(``csrc/encoder_layer.cu``).

Kernel E, ``attention_packed`` (counterpart of ``attention_packed`` ->
``_packed_kernel``, and ``mha_packed`` around it): SDPA alone on q/k/v
[B, S, H*dh] straight from the bf16 projections, f32 logits scaled after
the product, keys at or past ``valid_len`` masked, softmax as a division,
probabilities cast to bf16 before PV, the context cast to bf16 per head.

Kernel G, ``fused_attention`` (counterpart of ``fused_attention`` ->
``_attn_kernel``, and ``mha_fused`` around it): the same SDPA on q/k/v
[B, H, S, dh] (``vit.encode(fused_attention=True)``), every key attended.

E and G run the attention core of ``csrc/encoder.cu`` that A uses, with
their own strides; on CPU tensors their plain versions.  The TPU kernels
pad S to a multiple of 128 and mask the padded keys; the port runs S
unpadded.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.common import dense, merge_heads, split_heads
from manga_ocr_tpu_torch.ops.encoder_weights import (
    LayerWeights,
    flat_weights,
    is_int8,
    prepare_weights,
)
from manga_ocr_tpu_torch.ops.fused_mlp import (
    Proj,
    fused_mlp_block_bf16_reference,
    fused_mlp_block_reference,
    prepare_proj,
)
from manga_ocr_tpu_torch.ops.kernel_utils import NEG_INF, int8_matmul, ln32, quant_rows

CUDA_GELU_MODES = ("erf", "sigmoid")


def check_attn_variants(
    num_heads: int,
    fuse_qkv: bool = False,
    batched_sdpa: bool | str = False,
    sdpa_int8: bool = False,
    sdpa_headpack: bool = False,
    parallel_grid: bool = False,
) -> None:
    """The JAX ``fused_attn_layer``'s variant flags: its ``ValueError`` for
    the pairs it refuses, and a ``ValueError`` for ``sdpa_headpack`` on an
    odd head count (where JAX silently runs the per-head loop)."""
    del fuse_qkv, parallel_grid  # scheduling only: the same math
    if sdpa_int8 and batched_sdpa:
        raise ValueError(
            "sdpa_int8 is implemented for the per-(batch, head) SDPA loop "
            "only; disable batched_sdpa (it would silently run bf16 SDPA)"
        )
    if sdpa_headpack and (sdpa_int8 or batched_sdpa):
        raise ValueError(
            "sdpa_headpack is exclusive with sdpa_int8/batched_sdpa "
            "(one SDPA formulation per kernel)"
        )
    if sdpa_headpack and num_heads % 2:
        raise ValueError(f"sdpa_headpack packs heads in pairs; {num_heads} heads is odd")


def _sdpa_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int, divide: bool,
    p_dtype: torch.dtype,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v on f32 [..., S, dh] heads: keys at or past
    ``valid_len`` masked, the softmax a division (``divide``) or a
    reciprocal multiply, p rounded to ``p_dtype`` before PV; f32 out."""
    s, dh = q.shape[-2], q.shape[-1]
    logits = (q @ k.transpose(-1, -2)) * (1.0 / (dh**0.5))
    if valid_len < s:
        keep = torch.arange(s, device=q.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True) if divide else p * (1.0 / p.sum(-1, keepdim=True))
    return p.to(p_dtype).float() @ v


def _sdpa_int8_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """A's ``sdpa_int8`` SDPA on f32 [..., S, dh] heads -> f32 context.  The
    int8 products are summed in f32, which is exact here: every partial sum
    is an integer below 2^24 (dh * 127^2 for QK^T, S * 127^2 for PV)."""
    s, dh = q.shape[-2], q.shape[-1]
    qq, sq = quant_rows(q)
    kq, sk = quant_rows(k)
    acc = qq.float() @ kq.float().transpose(-1, -2)
    logits = acc * (sq * (1.0 / (dh**0.5))) * sk.transpose(-1, -2)
    keep = torch.arange(s, device=q.device) < valid_len
    if valid_len < s:
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p * (1.0 / p.sum(-1, keepdim=True))
    pq, sp = quant_rows(p)
    # v per output column over the real rows only (the pads would coarsen
    # every real value's step)
    v = torch.where(keep[:, None], v, torch.zeros_like(v))
    v_amax = v.abs().amax(-2, keepdim=True).clamp_min(1e-8)
    v_q = torch.round(v * (127.0 / v_amax))
    return (pq.float() @ v_q) * sp * (v_amax * (1.0 / 127.0))


def attn_block_reference(
    x: torch.Tensor,
    p: dict,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    num_heads: int,
    eps: float,
    valid_len: int | None,
    divide: bool,
    sdpa_int8: bool = False,
) -> torch.Tensor:
    """x + Attention(LN(x)) on [B, S, D], int8 or float projections, as
    ``_attn_core`` (``divide=False``, the default or the ``sdpa_int8`` SDPA)
    or the stack's ``_one_layer`` (``divide=True``) computes it."""
    b, s, d = x.shape
    dt = x.dtype
    dh = d // num_heads
    h32 = ln32(x, ln_scale, ln_bias, eps).reshape(b * s, d)
    int8 = "w_q" in p["q"]

    def proj(w, rows, sx):
        if int8:
            return int8_matmul(rows, w["w_q"]).float() * sx * w["scale"].float() + w["bias"].float()
        return rows.float() @ w["kernel"].to(dt).float() + w["bias"].float()

    hq, sx = quant_rows(h32) if int8 else (h32.to(dt), None)
    q, k, v = (proj(p[n], hq, sx).to(dt).reshape(b, s, num_heads, dh).transpose(1, 2).float()
               for n in ("q", "k", "v"))
    valid = s if valid_len is None else valid_len
    if sdpa_int8:
        ctx = _sdpa_int8_reference(q, k, v, valid)
    else:
        ctx = _sdpa_reference(q, k, v, valid, divide, dt)
    ctx = ctx.transpose(1, 2).reshape(b * s, d)  # f32
    out = proj(p["o"], *quant_rows(ctx)) if int8 else proj(p["o"], ctx.to(dt), None)
    return x + out.to(dt).reshape(b, s, d)


def fused_attn_layer_reference(
    x: torch.Tensor,
    p: dict,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    num_heads: int,
    eps: float = 1e-12,
    valid_len: int | None = None,
    **variants,
) -> torch.Tensor:
    """Plain version of kernel A (``_attn_core``) on [B, S, D]; the variant
    flags as ``fused_attn_layer`` takes them."""
    check_attn_variants(num_heads, **variants)
    return attn_block_reference(x, p, ln_scale, ln_bias, num_heads, eps, valid_len, divide=False,
                                sdpa_int8=bool(variants.get("sdpa_int8")))


def fused_attn_layer(
    x: torch.Tensor,  # [B, S, D]
    p: dict,  # attention params: q/k/v/o as {"kernel", "bias"} or {"w_q", "scale", "bias"}
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    num_heads: int,
    eps: float = 1e-12,
    valid_len: int | None = None,  # keys at or past this index are masked
    prepared: tuple[Proj, Proj] | None = None,  # (q|k|v, o) of ops.encoder_weights
    **variants,
) -> torch.Tensor:
    """Kernel A: x + Attention(LN(x)).  ``variants``: the JAX kernel's flags
    (``fuse_qkv``, ``batched_sdpa``, ``sdpa_int8``, ``sdpa_headpack``,
    ``parallel_grid``, see the module docstring).  CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise."""
    check_attn_variants(num_heads, **variants)
    sdpa_int8 = bool(variants.get("sdpa_int8"))
    if x.device.type == "cpu":
        return attn_block_reference(x, p, ln_scale, ln_bias, num_heads, eps, valid_len, False,
                                    sdpa_int8)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_attn_layer: the CUDA kernel takes bf16, got {x.dtype}")
    b, s, d = x.shape
    dh = d // num_heads
    if prepared is None:
        prepared = (prepare_proj([p["q"], p["k"], p["v"]], x.dtype), prepare_proj([p["o"]], x.dtype))
    qkv_w, o_w = prepared
    xf = x.reshape(b * s, d).contiguous()
    ln = (ln_scale.float().contiguous(), ln_bias.float().contiguous())
    valid = s if valid_len is None else valid_len
    scale = 1.0 / (dh**0.5)
    int8 = is_int8(qkv_w)
    if int8:
        hq, sx = launch.ln_quant_rows(xf, ln, eps)
        qkv = launch.int8_gemm(hq, qkv_w.w.w_t, sx, qkv_w.w.scale, qkv_w.bias, launch.GEMM_BF16)
        ctx = launch.attention(qkv, b, s, num_heads, valid, scale, sdpa_int8=sdpa_int8)
        cq, csx = launch.ln_quant_rows(ctx)
        out = launch.int8_gemm(cq, o_w.w.w_t, csx, o_w.w.scale, o_w.bias,
                               launch.GEMM_RESIDUAL_BF16, residual=xf)
    else:
        h = launch.ln_rows_bf16(xf, ln, eps)
        qkv = launch.bf16_gemm(h, qkv_w.w, qkv_w.bias, launch.BF16_BIAS)
        ctx = launch.attention(qkv, b, s, num_heads, valid, scale, out_dtype=torch.bfloat16,
                               sdpa_int8=sdpa_int8)
        out = launch.bf16_gemm(ctx, o_w.w, o_w.bias, launch.BF16_RESIDUAL, residual=xf)
    fused_attn_layer.launches += 1
    fused_attn_layer.launches_by_form["int8" if int8 else "bf16"] += 1
    if sdpa_int8:
        fused_attn_layer.launches_by_form["sdpa_int8"] += 1
    return out.reshape(b, s, d)


fused_attn_layer.launches = 0  # launches of the CUDA kernels (CPU calls do not count)
# launches by form: the projections ("int8", "bf16") and the int8 SDPA ("sdpa_int8")
fused_attn_layer.launches_by_form = {"int8": 0, "bf16": 0, "sdpa_int8": 0}


def layer_is_int8(p: dict, name: str) -> bool:
    """Whether a layer's params are int8; attention and MLP must agree."""
    int8 = "w_q" in p["attn"]["q"]
    if ("w_q" in p["mlp"]["fc1"]) != int8:
        raise ValueError(f"{name}: attention and MLP must share the quantization mode")
    return int8


def encoder_block_reference(
    x: torch.Tensor, p: dict, num_heads: int, eps: float, gelu_mode: str, divide: bool
) -> torch.Tensor:
    """x += Attn(LN1(x)); x += MLP(LN2(x)) on [B, S, D] with every key
    attended: H's block (``divide=False``) or I's (``divide=True``)."""
    x = attn_block_reference(x, p["attn"], p["ln1"]["scale"], p["ln1"]["bias"], num_heads, eps,
                             None, divide)
    fc1, fc2 = p["mlp"]["fc1"], p["mlp"]["fc2"]
    ln = (p["ln2"]["scale"], p["ln2"]["bias"])
    if "w_q" in fc1:
        return fused_mlp_block_reference(x, *ln, (fc1["w_q"], fc1["scale"]), fc1["bias"],
                                         (fc2["w_q"], fc2["scale"]), fc2["bias"], eps, gelu_mode)
    return fused_mlp_block_bf16_reference(x, *ln, fc1["kernel"], fc1["bias"], fc2["kernel"],
                                          fc2["bias"], eps, gelu_mode)


def fused_encoder_layer_reference(
    x: torch.Tensor, p: dict, num_heads: int, eps: float = 1e-12, gelu_mode: str = "erf"
) -> torch.Tensor:
    """Plain version of kernel H (``_enc_layer_kernel``) on [B, S, D]."""
    layer_is_int8(p, "fused_encoder_layer")
    return encoder_block_reference(x, p, num_heads, eps, gelu_mode, divide=False)


def fused_encoder_layer(
    x: torch.Tensor,  # [B, S, D]
    p: dict,  # layer params: attn{q,k,v,o}, ln1, ln2, mlp{fc1,fc2}
    num_heads: int,
    eps: float = 1e-12,
    gelu_mode: str = "erf",
    prepared: LayerWeights | None = None,  # this layer's ops.encoder_weights
    scratch: tuple | None = None,  # launch.encoder_scratch of B*S rows
) -> torch.Tensor:
    """Kernel H: one whole pre-LN ViT block.  CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise.  ``prepared`` and
    ``scratch`` are made on the call when not given."""
    int8 = layer_is_int8(p, "fused_encoder_layer")
    if x.device.type == "cpu":
        return encoder_block_reference(x, p, num_heads, eps, gelu_mode, divide=False)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_encoder_layer: the CUDA kernel takes bf16, got {x.dtype}")
    if gelu_mode not in CUDA_GELU_MODES:
        raise ValueError(f"fused_encoder_layer: the CUDA kernel has no gelu_mode {gelu_mode!r}")
    w = prepared if prepared is not None else prepare_weights(p, x.dtype)
    b, s, d = x.shape
    if scratch is None:
        scratch = launch.encoder_scratch(b * s, d, w.fc1.bias.shape[-1], int8, x.device)
    weights = [None if t is None else t.unsqueeze(0) for t in flat_weights(w)]  # [1, ...]
    out = launch.encoder_layers(x.contiguous(), weights, 0, 1, False, scratch, num_heads, eps,
                                1.0 / ((d // num_heads) ** 0.5), gelu_mode == "sigmoid")
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0  # kernel H's CUDA launches (CPU calls do not count)


def attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    valid_len: int | None = None,
) -> torch.Tensor:
    """Plain version of ``_packed_kernel`` on q/k/v [B, S, H*dh]."""
    b, s, d = q.shape

    def heads(t):
        return split_heads(t, num_heads).float()

    ctx = _sdpa_reference(heads(q), heads(k), heads(v), s if valid_len is None else valid_len,
                          True, v.dtype)  # [B, H, S, dh] f32
    return merge_heads(ctx).to(q.dtype)


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


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_attn_kernel`` on q/k/v [B, H, S, dh]: every key
    attended, the softmax a division, p rounded to the input dtype."""
    ctx = _sdpa_reference(q.float(), k.float(), v.float(), q.shape[-2], True, q.dtype)
    return ctx.to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel G: softmax(q k^T / sqrt(dh)) v on [B, H, S, dh].  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"fused_attention: the CUDA kernel takes bf16, got {q.dtype}")
    s, dh = q.shape[-2], q.shape[-1]
    out = launch.attention_heads(q.contiguous(), k.contiguous(), v.contiguous(), s,
                                 1.0 / (dh**0.5))
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # launches of the CUDA kernel (CPU calls do not count)


def mha_fused(
    x_q: torch.Tensor, x_kv: torch.Tensor, p: dict, num_heads: int, use_kernels: bool = True
) -> torch.Tensor:
    """Multi-head attention through kernel G (or its plain version,
    ``use_kernels=False``): the q/k/v projections, the heads split out,
    G, the heads merged, the output projection."""
    q = split_heads(dense(x_q, p["q"]["kernel"], p["q"]["bias"]), num_heads)
    k = split_heads(dense(x_kv, p["k"]["kernel"], p["k"]["bias"]), num_heads)
    v = split_heads(dense(x_kv, p["v"]["kernel"], p["v"]["bias"]), num_heads)
    attn = fused_attention if use_kernels else fused_attention_reference
    return dense(merge_heads(attn(q, k, v)), p["o"]["kernel"], p["o"]["bias"])
