"""BERT-style decoder (counterpart of ``manga_ocr_tpu/models/decoder.py``).

Post-LN blocks: x = LN(x + SelfAttn(x)); x = LN(x + CrossAttn(x));
x = LN(x + MLP(x)); the LM head is dense + GELU + LN, then the vocab
projection.  Two decode forms:

- the serving decode (``step_kernel="fused_loop"``) reads the packed cross
  K/V slabs ``precompute_cross_kv_packed`` makes; the loop itself is kernel
  C (``ops/decode_loop.py``);
- the step-by-step decode (``step_kernel="xla"``): ``decode_step_greedy``
  over a ``KVCache`` and a ``CrossKV`` (bf16, or int8 with scales), with
  two kernels behind config flags: ``head_kernel="fused"`` runs kernel F
  (``ops/fused_head.py``) and ``step_mlp_kernel="fused"`` runs kernel D in
  its ``pre_ln=False`` form (``ops/fused_mlp.py``);
- the fused whole-layer step decode (``step_kernel="fused_layer"``): per
  layer kernel J (self-attention and the cache insert), kernel K (cross-
  attention over a ``CrossKVPacked``, int8 with scales or in the compute
  dtype) and kernel B's post-LN step form (int8 weights from
  ``models.quantize.quantize_decoder``; kernel D for float weights), over a
  packed cache L x [T, B, D].  ``prepare_fused_layer`` builds those
  kernels' weights once per decode.

The self-attention cache is updated in place (the JAX package returns new
buffers); ``KVCache`` keeps the JAX layouts: [B, H, T, dh] per layer for
the ``xla`` step, [T, B, D] for ``fused_layer``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.models.config import DecoderConfig
from manga_ocr_tpu_torch.models.params import layer_params
from manga_ocr_tpu_torch.ops import decode_layer
from manga_ocr_tpu_torch.ops.common import NEG_INF, dense, gelu, layer_norm, softmax
from manga_ocr_tpu_torch.ops.fused_head import fused_greedy_head, fused_greedy_head_reference
from manga_ocr_tpu_torch.ops.fused_mlp import (
    Int8Weight,
    fused_mlp_block,
    fused_mlp_block_bf16_reference,
    fused_mlp_block_reference,
    int8_weight,
)


class KVCache(NamedTuple):
    """Self-attention cache: per-layer tuples of [B, H, T, dh] buffers (the
    ``xla`` step) or [T, B, D] buffers (``fused_layer``)."""

    k: tuple
    v: tuple


class CrossKV(NamedTuple):
    """Per-layer cross-attention K/V, [L, B, H, dh, S] (encoder positions
    last, the JAX layout), in the compute dtype; or int8 with ``k_scale``
    [L, B, H, S] (over dh) and ``v_scale`` [L, B, H, dh] (over S)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


class CrossKVPacked(NamedTuple):
    """Cross-attention K/V, heads merged: k/v [L, B, S, D] in the compute
    dtype; or int8 with ``k_scale`` [L, B, S] (per token row, over D) and
    ``v_scale`` [L, B, D] (per channel, over S), both f32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype, device) -> KVCache:
    """Zeroed per-layer buffers in the layout of ``cfg.step_kernel``:
    [max_len, B, D] for ``fused_layer`` (kernel J inserts a [B, D] row),
    else [B, H, max_len, dh]."""
    if cfg.step_kernel == "fused_layer":
        shape = (max_len, batch, cfg.hidden_size)
    else:
        shape = (batch, cfg.num_heads, max_len, cfg.head_dim)

    def zeros():
        return tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers))

    return KVCache(zeros(), zeros())


def embed(params: dict, tokens: torch.Tensor, position_offset: int, cfg: DecoderConfig) -> torch.Tensor:
    """Word + absolute position + token-type(0) embeddings, then LN.
    ``tokens``: [B, S] int.  Positions past the table take its last row, as
    JAX's gather clamps (the chunked decode may run up to ``chunk_size - 1``
    steps past the last position; their tokens are sliced off)."""
    s = tokens.shape[-1]
    table = params["pos_embed"]
    pos = torch.arange(position_offset, position_offset + s, device=table.device)
    we = params["tok_embed"][tokens.long()]
    x = we + table[pos.clamp(max=table.shape[0] - 1)] + params["tok_type"]
    return layer_norm(x, params["emb_ln"]["scale"], params["emb_ln"]["bias"], cfg.layer_norm_eps)


def precompute_cross_kv(
    params: dict, enc_out: torch.Tensor, cfg: DecoderConfig, int8: bool | None = None
) -> CrossKV:
    """Project the encoder output to per-layer cross K/V once per dispatch,
    in the [L, B, H, dh, S] layout; ``int8`` (default ``cfg.cross_kv_int8``)
    stores it quantized: K per (l, b, h, s) over dh, V per (l, b, h, d) over
    S, with the weight quantizer's division and clip."""
    if int8 is None:
        int8 = cfg.cross_kv_int8
    b, s, _ = enc_out.shape
    ca = params["layers"]["cross_attn"]
    ks, vs = [], []
    for l in range(cfg.num_layers):
        k = dense(enc_out, ca["k"]["kernel"][l], ca["k"]["bias"][l])
        v = dense(enc_out, ca["v"]["kernel"][l], ca["v"]["bias"][l])
        ks.append(k.reshape(b, s, cfg.num_heads, cfg.head_dim).permute(0, 2, 3, 1))
        vs.append(v.reshape(b, s, cfg.num_heads, cfg.head_dim).permute(0, 2, 3, 1))
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if not int8:
        return CrossKV(k_all, v_all)
    k32, v32 = k_all.float(), v_all.float()
    k_scale = k32.abs().amax(-2).clamp_min(1e-8) / 127.0
    v_scale = v32.abs().amax(-1).clamp_min(1e-8) / 127.0
    k_q = torch.clamp(torch.round(k32 / k_scale[..., None, :]), -127, 127).to(torch.int8)
    v_q = torch.clamp(torch.round(v32 / v_scale[..., None]), -127, 127).to(torch.int8)
    return CrossKV(k_q, v_q, k_scale, v_scale)


def precompute_cross_kv_packed(
    params: dict, enc_out: torch.Tensor, cfg: DecoderConfig, int8: bool | None = None
) -> CrossKVPacked:
    """Project the encoder output to per-layer cross K/V once per dispatch:
    [L, B, S, D] slabs in ``enc_out.dtype``.  ``dense`` is column-independent,
    so per-layer projections equal the JAX package's one wide matmul.
    ``int8`` (default ``cfg.cross_kv_int8``) stores them quantized: K per
    (l, b, s) row over D, V per (l, b, d) channel over S, with the weight
    quantizer's division, clip and half-to-even rounding.  Calls on CUDA
    tensors are counted (``calls``): kernel C's ``fuse_kv`` form computes
    its slabs inside its launch, and a run can show that none was made
    here."""
    if int8 is None:
        int8 = cfg.cross_kv_int8
    if enc_out.device.type == "cuda":
        precompute_cross_kv_packed.calls += 1
    ca = params["layers"]["cross_attn"]
    ks, vs = [], []
    for l in range(cfg.num_layers):
        ks.append(dense(enc_out, ca["k"]["kernel"][l], ca["k"]["bias"][l]))
        vs.append(dense(enc_out, ca["v"]["kernel"][l], ca["v"]["bias"][l]))
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if not int8:
        return CrossKVPacked(k_all, v_all)
    k32, v32 = k_all.float(), v_all.float()
    k_scale = k32.abs().amax(-1).clamp_min(1e-8) / 127.0  # [L, B, S]
    v_scale = v32.abs().amax(-2).clamp_min(1e-8) / 127.0  # [L, B, D]
    k_q = torch.clamp(torch.round(k32 / k_scale[..., None]), -127, 127).to(torch.int8)
    v_q = torch.clamp(torch.round(v32 / v_scale[..., None, :]), -127, 127).to(torch.int8)
    return CrossKVPacked(k_q, v_q, k_scale, v_scale)


precompute_cross_kv_packed.calls = 0  # calls on CUDA tensors (CPU calls do not count)


def prepare_fused_layer(params: dict, cfg: DecoderConfig, dtype) -> list[dict]:
    """Per layer, the weights of kernels J, K and B in the form their
    wrappers take: the q|k|v concatenation, the int8 GEMM's [N, K] copies,
    f32 biases and LN params.  Built once per decode, not per step."""

    def ln(p):
        return {"scale": p["scale"].float().contiguous(), "bias": p["bias"].float().contiguous()}

    def mlp_w(p):
        if "w_q" in p:
            return int8_weight(p["w_q"], p["scale"])
        return p["kernel"].to(dtype).contiguous()

    layers = []
    for l in range(cfg.num_layers):
        lp = layer_params(params["layers"], l)
        fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
        layers.append({
            "self": decode_layer.prepare_self_attn(lp["self_attn"], dtype),
            "self_ln": ln(lp["self_ln"]),
            "cross": decode_layer.prepare_cross_attn(lp["cross_attn"], dtype),
            "cross_ln": ln(lp["cross_ln"]),
            "w1": mlp_w(fc1), "b1": fc1["bias"].float().contiguous(),
            "w2": mlp_w(fc2), "b2": fc2["bias"].float().contiguous(),
            "mlp_ln": ln(lp["mlp_ln"]),
        })
    return layers


def lm_head(params: dict, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Prediction head: dense + exact GELU + LN, then the vocab projection.
    Returns float32 logits."""
    t = params["head"]["transform"]
    x = gelu(dense(x, t["dense"]["kernel"], t["dense"]["bias"]))
    x = layer_norm(x, t["ln"]["scale"], t["ln"]["bias"], cfg.layer_norm_eps)
    p = params["head"]["proj"]
    return x.float() @ p["kernel"].to(x.dtype).float() + p["bias"].float()


def decode_step(
    params: dict, token: torch.Tensor, step: int, cache: KVCache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One incremental decode step -> (logits [B, V] f32, cache)."""
    x, cache = decode_hidden(params, token, step, cache, cross_kv, cfg, use_kernels, prepared)
    return lm_head(params, x, cfg), cache


def decode_step_greedy(
    params: dict, token: torch.Tensor, step: int, cache: KVCache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One greedy decode step -> (next token ids [B] int32, cache).  With
    ``cfg.head_kernel == "fused"`` the head is kernel F (its plain version
    when ``use_kernels`` is False); otherwise logits and argmax."""
    x, cache = decode_hidden(params, token, step, cache, cross_kv, cfg, use_kernels, prepared)
    if cfg.head_kernel == "fused":
        head = fused_greedy_head if use_kernels else fused_greedy_head_reference
        t, p = params["head"]["transform"], params["head"]["proj"]
        nxt = head(x, t["dense"]["kernel"], t["dense"]["bias"], t["ln"]["scale"],
                   t["ln"]["bias"], p["kernel"], p["bias"], eps=cfg.layer_norm_eps)
        return nxt, cache
    return torch.argmax(lm_head(params, x, cfg), dim=-1).to(torch.int32), cache


def _cross_attend(q, ck, cv, k_scale, v_scale, sqrt_dh, dtype) -> torch.Tensor:
    """q [B, H, dh] against K/V [B, H, dh, S] (int8 when scaled, the scales
    applied after the contractions) -> ctx [B, H, dh] in ``dtype``."""
    cs = torch.einsum("bhd,bhds->bhs", q.float(), ck.to(dtype).float())
    if k_scale is not None:
        cs = cs * k_scale
    cp = softmax(cs / sqrt_dh)
    ctx = torch.einsum("bhs,bhds->bhd", cp.to(dtype).float(), cv.to(dtype).float())
    if v_scale is not None:
        ctx = ctx * v_scale
    return ctx.to(dtype)


def decode_hidden(
    params: dict, token: torch.Tensor, step: int, cache: KVCache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Decode step up to (excluding) the LM head -> (hidden [B, D], cache).
    Writes this step's K/V into ``cache`` at ``step``.  ``fused_layer``
    takes a ``CrossKVPacked`` and the packed cache, and ``prepared``
    (``prepare_fused_layer``; made here when None)."""
    if cfg.step_kernel == "fused_layer":
        if prepared is None:
            prepared = prepare_fused_layer(params, cfg, cache.k[0].dtype)
        return _decode_hidden_fused(params, token, step, cache, cross_kv, cfg, use_kernels,
                                    prepared)
    heads, dh = cfg.num_heads, cfg.head_dim
    d = heads * dh
    dt = cache.k[0].dtype
    x = embed(params, token[:, None], step, cfg)[:, 0, :].to(dt)
    b = x.shape[0]
    max_len = cache.k[0].shape[-2]
    valid = (torch.arange(max_len, device=x.device) <= step)[None, None, :]
    sqrt_dh = torch.sqrt(torch.tensor(float(dh), device=x.device))  # f32, as in JAX
    eps = cfg.layer_norm_eps
    for l in range(cfg.num_layers):
        lp = layer_params(params["layers"], l)
        # -- causal self-attention against the running cache ----------------
        sa = lp["self_attn"]
        wqkv = torch.cat([sa[n]["kernel"] for n in ("q", "k", "v")], dim=1)
        bqkv = torch.cat([sa[n]["bias"] for n in ("q", "k", "v")])
        qkv = dense(x, wqkv, bqkv)
        q = qkv[:, :d].reshape(b, heads, dh)
        ck, cv = cache.k[l], cache.v[l]
        ck[:, :, step] = qkv[:, d : 2 * d].reshape(b, heads, dh)
        cv[:, :, step] = qkv[:, 2 * d :].reshape(b, heads, dh)
        scores = torch.einsum("bhd,bhtd->bht", q.float(), ck.float()) / sqrt_dh
        probs = softmax(torch.where(valid, scores, torch.full_like(scores, NEG_INF)))
        ctx = torch.einsum("bht,bhtd->bhd", probs.to(dt).float(), cv.float())
        out = dense(ctx.to(dt).reshape(b, d), sa["o"]["kernel"], sa["o"]["bias"])
        x = layer_norm(out + x, lp["self_ln"]["scale"], lp["self_ln"]["bias"], eps)
        # -- cross-attention over the precomputed encoder K/V ----------------
        ca = lp["cross_attn"]
        q = dense(x, ca["q"]["kernel"], ca["q"]["bias"]).reshape(b, heads, dh)
        scaled = cross_kv.k_scale is not None
        cctx = _cross_attend(
            q, cross_kv.k[l], cross_kv.v[l], cross_kv.k_scale[l] if scaled else None,
            cross_kv.v_scale[l] if scaled else None, sqrt_dh, dt,
        )
        out = dense(cctx.reshape(b, d), ca["o"]["kernel"], ca["o"]["bias"])
        x = layer_norm(out + x, lp["cross_ln"]["scale"], lp["cross_ln"]["bias"], eps)
        # -- MLP ---------------------------------------------------------------
        fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
        if cfg.step_mlp_kernel == "fused":
            # post-LN block LN(x + MLP(x)): the kernel computes x + MLP(x)
            # (pre_ln off), the LN follows
            mlp = fused_mlp_block if use_kernels else fused_mlp_block_bf16_reference
            one = torch.ones((d,), dtype=torch.float32, device=x.device)
            y = mlp(x, one, torch.zeros_like(one), fc1["kernel"], fc1["bias"], fc2["kernel"],
                    fc2["bias"], pre_ln=False)
            x = layer_norm(y, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"], eps)
        else:
            hdn = dense(gelu(dense(x, fc1["kernel"], fc1["bias"])), fc2["kernel"], fc2["bias"])
            x = layer_norm(hdn + x, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"], eps)
    return x, cache


def _decode_hidden_fused(
    params: dict, token: torch.Tensor, step: int, cache: KVCache, cross_kv: CrossKVPacked,
    cfg: DecoderConfig, use_kernels: bool, prepared: list,
) -> tuple[torch.Tensor, KVCache]:
    """``decode_hidden`` through the fused step kernels: per layer J, K and
    B's post-LN step form (D's for float weights), or their plain versions
    when ``use_kernels`` is False."""
    x = embed(params, token[:, None], step, cfg)[:, 0, :].to(cache.k[0].dtype)
    s_enc = cross_kv.k.shape[-2]
    eps, heads = cfg.layer_norm_eps, cfg.num_heads
    if use_kernels:
        self_attn = decode_layer.fused_self_attn_step
        cross_attn = decode_layer.fused_cross_attn_step
    else:
        self_attn = decode_layer.fused_self_attn_step_reference
        cross_attn = decode_layer.fused_cross_attn_step_reference
    scaled = cross_kv.k_scale is not None
    for l, w in enumerate(prepared):
        x, _, _ = self_attn(x, w["self"], w["self_ln"], cache.k[l], cache.v[l], step, heads, eps)
        x = cross_attn(
            x, w["cross"], w["cross_ln"], cross_kv.k[l], cross_kv.v[l],
            cross_kv.k_scale[l] if scaled else None, cross_kv.v_scale[l] if scaled else None,
            heads, eps, s_enc,
        )
        if use_kernels:
            mlp = fused_mlp_block
        elif isinstance(w["w1"], Int8Weight):
            mlp = fused_mlp_block_reference
        else:
            mlp = fused_mlp_block_bf16_reference
        x = mlp(x, w["mlp_ln"]["scale"], w["mlp_ln"]["bias"], w["w1"], w["b1"], w["w2"], w["b2"],
                eps=eps, pre_ln=False, post_ln=True)
    return x, cache
