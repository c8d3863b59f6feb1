"""BERT-style decoder (counterpart of ``manga_ocr_tpu/models/decoder.py``).

Post-LN blocks: x = LN(x + SelfAttn(x)); x = LN(x + CrossAttn(x));
x = LN(x + MLP(x)); the LM head is dense + GELU + LN, then the vocab
projection.  ``forward_full`` runs the blocks over whole teacher-forced
sequences (training's forward, plain and differentiable).  The decode forms:

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

Tensor parallelism: ``embed``, ``precompute_cross_kv``, ``forward_full``,
``lm_head`` and the ``xla`` step (``decode_hidden``,
``decode_step_greedy``) also take a list of a data row's model columns
(``parallel.mesh.shard_params``' decoder trees), with one cross-K/V and one
cache a column, each over its heads (``column_cfg``).  The vocab-sharded
token table is looked up per shard with the other shards' ids masked to
zero, then summed (exact: one shard is nonzero); the logits are put
together in column order, and the greedy argmax takes each shard's first
maximum, then the first shard that holds the largest (the lower index
wins a tie, as one ``argmax`` over the whole vocab does).  The replicated
work (embeddings' sums, LNs, residuals, the head's transform) runs once,
on column 0's device.
"""

from __future__ import annotations

import dataclasses

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.models.config import DecoderConfig
from manga_ocr_tpu_torch.models.params import layer_params
from manga_ocr_tpu_torch.ops import decode_layer
from manga_ocr_tpu_torch.ops.common import (
    NEG_INF,
    columns,
    dense,
    gelu,
    layer_norm,
    mha,
    mlp,
    row_parallel,
    softmax,
    spread,
    tree_device,
)
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


def column_cfg(cfg: DecoderConfig, n: int) -> DecoderConfig:
    """One of ``n`` model columns' view of the decoder: its heads and width
    (``head_dim`` kept), for its cross-K/V and cache."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               hidden_size=cfg.hidden_size // n)


def _token_rows(cols: list, tokens: torch.Tensor) -> torch.Tensor:
    """The token table's rows of ``tokens``; over vocab shards each shard's
    rows with the ids outside it masked to zero, summed in column order."""
    if len(cols) == 1:
        return cols[0]["tok_embed"][tokens.long()]
    dev = tree_device(cols[0])
    rows = cols[0]["tok_embed"].shape[0]
    we = None
    for c, p in enumerate(cols):
        t = tokens.to(p["tok_embed"].device).long() - c * rows
        inside = (t >= 0) & (t < rows)
        e = p["tok_embed"][t.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0).to(dev)
        we = e if we is None else we + e
    return we


def embed(params, tokens: torch.Tensor, position_offset: int, cfg: DecoderConfig) -> torch.Tensor:
    """Word + absolute position + token-type(0) embeddings, then LN.
    ``tokens``: [B, S] int.  Positions past the table take its last row, as
    JAX's gather clamps (the chunked decode may run up to ``chunk_size - 1``
    steps past the last position; their tokens are sliced off).  ``params``
    may be a list of model columns'."""
    cols = columns(params)
    params = cols[0]
    s = tokens.shape[-1]
    table = params["pos_embed"]
    pos = torch.arange(position_offset, position_offset + s, device=table.device)
    we = _token_rows(cols, tokens)
    x = we + table[pos.clamp(max=table.shape[0] - 1)] + params["tok_type"]
    return layer_norm(x, params["emb_ln"]["scale"], params["emb_ln"]["bias"], cfg.layer_norm_eps)


def precompute_cross_kv(
    params, enc_out: torch.Tensor, cfg: DecoderConfig, int8: bool | None = None
):
    """Project the encoder output to per-layer cross K/V once per dispatch,
    in the [L, B, H, dh, S] layout; ``int8`` (default ``cfg.cross_kv_int8``)
    stores it quantized: K per (l, b, h, s) over dh, V per (l, b, h, d) over
    S, with the weight quantizer's division and clip.  A list of model
    columns' params gives a list of ``CrossKV``, each over its column's
    heads on its device."""
    if isinstance(params, list):
        ccfg = column_cfg(cfg, len(params))
        return [precompute_cross_kv(p, e, ccfg, int8)
                for p, e in zip(params, spread(enc_out, [tree_device(p) for p in params]))]
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


def _post_ln_block(x, residual, ln, eps):
    return layer_norm(x + residual, ln["scale"], ln["bias"], eps)


def forward_full(
    params,
    tokens: torch.Tensor,
    enc_out: torch.Tensor,
    cfg: DecoderConfig,
    attention_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Teacher-forced forward over whole sequences -> logits [B, S, V] f32.

    ``tokens`` [B, S] int; causal self-attention, ANDed with the optional key
    mask ``attention_mask`` [B, S] (nonzero = attend); full cross-attention
    over ``enc_out`` [B, S_enc, D].  Plain ops only, so autograd runs through
    it (training's loss).  ``params`` may be a list of model columns' (the
    logits put together on column 0's device)."""
    cols = columns(params)
    s = tokens.shape[1]
    x = embed(cols, tokens, 0, cfg).to(enc_out.dtype)
    mask = torch.ones((s, s), dtype=torch.bool, device=enc_out.device).tril()[None, None]
    if attention_mask is not None:
        mask = mask & (attention_mask.to(enc_out.device) != 0)[:, None, None, :]
    eps = cfg.layer_norm_eps
    for l in range(cfg.num_layers):
        lps = [layer_params(c["layers"], l) for c in cols]
        lp = lps[0]
        x = _post_ln_block(mha(x, x, [p["self_attn"] for p in lps], cfg.num_heads, mask=mask),
                           x, lp["self_ln"], eps)
        x = _post_ln_block(mha(x, enc_out, [p["cross_attn"] for p in lps], cfg.num_heads), x,
                           lp["cross_ln"], eps)
        x = _post_ln_block(mlp(x, [p["mlp"] for p in lps]), x, lp["mlp_ln"], eps)
    return lm_head(cols, x, cfg)


def _vocab_logits(params, x: torch.Tensor, cfg: DecoderConfig) -> list:
    """The head's transform (dense + exact GELU + LN, on column 0's params),
    then each column's float32 logits over its vocab shard."""
    cols = columns(params)
    t = cols[0]["head"]["transform"]
    x = gelu(dense(x, t["dense"]["kernel"], t["dense"]["bias"]))
    x = layer_norm(x, t["ln"]["scale"], t["ln"]["bias"], cfg.layer_norm_eps)
    out = []
    for c, xc in zip(cols, spread(x, [tree_device(c) for c in cols])):
        p = c["head"]["proj"]
        out.append(xc.float() @ p["kernel"].to(xc.dtype).float() + p["bias"].float())
    return out


def lm_head(params, x: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Prediction head: dense + exact GELU + LN, then the vocab projection.
    Returns float32 logits (a list of model columns' params: the shards put
    together on column 0's device)."""
    shards = _vocab_logits(params, x, cfg)
    if len(shards) == 1:
        return shards[0]
    return torch.cat([t.to(shards[0].device) for t in shards], dim=-1)


def _argmax(shards: list) -> torch.Tensor:
    """The greedy token over vocab shards [B, V/n] each -> [B] int32 on the
    first shard's device: every shard's first maximum, then the first shard
    holding the largest."""
    if len(shards) == 1:
        return torch.argmax(shards[0], dim=-1).to(torch.int32)
    dev = shards[0].device
    rows = shards[0].shape[-1]
    best_val = best_idx = None
    for c, lg in enumerate(shards):
        idx = torch.argmax(lg, dim=-1)
        val = lg.gather(-1, idx[:, None])[:, 0].to(dev)
        idx = idx.to(dev) + c * rows
        if best_val is None:
            best_val, best_idx = val, idx
        else:
            take = val > best_val
            best_val = torch.where(take, val, best_val)
            best_idx = torch.where(take, idx, best_idx)
    return best_idx.to(torch.int32)


def decode_step(
    params: dict, token: torch.Tensor, step: int, cache: KVCache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One incremental decode step -> (logits [B, V] f32, cache)."""
    x, cache = decode_hidden(params, token, step, cache, cross_kv, cfg, use_kernels, prepared)
    return lm_head(params, x, cfg), cache


def decode_step_greedy(
    params, token: torch.Tensor, step: int, cache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One greedy decode step -> (next token ids [B] int32, cache).  With
    ``cfg.head_kernel == "fused"`` the head is kernel F (its plain version
    when ``use_kernels`` is False); otherwise logits and argmax (over the
    vocab shards of a list of model columns' params)."""
    x, cache = decode_hidden(params, token, step, cache, cross_kv, cfg, use_kernels, prepared)
    if cfg.head_kernel == "fused":
        head = fused_greedy_head if use_kernels else fused_greedy_head_reference
        t, p = params["head"]["transform"], params["head"]["proj"]
        nxt = head(x, t["dense"]["kernel"], t["dense"]["bias"], t["ln"]["scale"],
                   t["ln"]["bias"], p["kernel"], p["bias"], eps=cfg.layer_norm_eps)
        return nxt, cache
    return _argmax(_vocab_logits(params, x, cfg)), cache


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
    params, token: torch.Tensor, step: int, cache, cross_kv,
    cfg: DecoderConfig, use_kernels: bool = True, prepared: list | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Decode step up to (excluding) the LM head -> (hidden [B, D], cache).
    Writes this step's K/V into ``cache`` at ``step``.  ``fused_layer``
    takes a ``CrossKVPacked`` and the packed cache, and ``prepared``
    (``prepare_fused_layer``; made here when None).  The ``xla`` step also
    takes a list of model columns' params with their lists of caches and
    ``CrossKV``s (the hidden state on column 0's device)."""
    if cfg.step_kernel == "fused_layer":
        if prepared is None:
            prepared = prepare_fused_layer(params, cfg, cache.k[0].dtype)
        return _decode_hidden_fused(params, token, step, cache, cross_kv, cfg, use_kernels,
                                    prepared)
    cols, caches, crosses = columns(params), columns(cache), columns(cross_kv)
    heads, dh = cfg.num_heads // len(cols), cfg.head_dim
    d = heads * dh
    dt = caches[0].k[0].dtype
    x = embed(cols, token[:, None], step, cfg)[:, 0, :].to(dt)
    b = x.shape[0]
    devices = [x.device] if len(cols) == 1 else [tree_device(c) for c in cols]
    max_len = caches[0].k[0].shape[-2]
    valid = [(torch.arange(max_len, device=dv) <= step)[None, None, :] for dv in devices]
    sqrt_dh = [torch.sqrt(torch.tensor(float(dh), device=dv)) for dv in devices]  # f32, as JAX
    eps = cfg.layer_norm_eps
    for l in range(cfg.num_layers):
        lps = [layer_params(c["layers"], l) for c in cols]
        lp = lps[0]
        # -- causal self-attention against each column's running cache -------
        ctx = []
        for c, (sa, xc) in enumerate(zip([p["self_attn"] for p in lps], spread(x, devices))):
            wqkv = torch.cat([sa[n]["kernel"] for n in ("q", "k", "v")], dim=1)
            bqkv = torch.cat([sa[n]["bias"] for n in ("q", "k", "v")])
            qkv = dense(xc, wqkv, bqkv)
            q = qkv[:, :d].reshape(b, heads, dh)
            ck, cv = caches[c].k[l], caches[c].v[l]
            ck[:, :, step] = qkv[:, d : 2 * d].reshape(b, heads, dh)
            cv[:, :, step] = qkv[:, 2 * d :].reshape(b, heads, dh)
            scores = torch.einsum("bhd,bhtd->bht", q.float(), ck.float()) / sqrt_dh[c]
            probs = softmax(torch.where(valid[c], scores, torch.full_like(scores, NEG_INF)))
            cc = torch.einsum("bht,bhtd->bhd", probs.to(dt).float(), cv.float())
            ctx.append(cc.to(dt).reshape(b, d))
        out = row_parallel(ctx, [p["self_attn"]["o"] for p in lps])
        x = layer_norm(out + x, lp["self_ln"]["scale"], lp["self_ln"]["bias"], eps)
        # -- cross-attention over the precomputed encoder K/V ----------------
        ctx = []
        for c, (ca, xc) in enumerate(zip([p["cross_attn"] for p in lps], spread(x, devices))):
            q = dense(xc, ca["q"]["kernel"], ca["q"]["bias"]).reshape(b, heads, dh)
            kv = crosses[c]
            scaled = kv.k_scale is not None
            cc = _cross_attend(
                q, kv.k[l], kv.v[l], kv.k_scale[l] if scaled else None,
                kv.v_scale[l] if scaled else None, sqrt_dh[c], dt,
            )
            ctx.append(cc.reshape(b, d))
        out = row_parallel(ctx, [p["cross_attn"]["o"] for p in lps])
        x = layer_norm(out + x, lp["cross_ln"]["scale"], lp["cross_ln"]["bias"], eps)
        # -- MLP ---------------------------------------------------------------
        fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
        if cfg.step_mlp_kernel == "fused":
            # post-LN block LN(x + MLP(x)): the kernel computes x + MLP(x)
            # (pre_ln off), the LN follows
            fn = fused_mlp_block if use_kernels else fused_mlp_block_bf16_reference
            one = torch.ones((d,), dtype=torch.float32, device=x.device)
            y = fn(x, one, torch.zeros_like(one), fc1["kernel"], fc1["bias"], fc2["kernel"],
                   fc2["bias"], pre_ln=False)
            x = layer_norm(y, lp["mlp_ln"]["scale"], lp["mlp_ln"]["bias"], eps)
        else:
            hdn = mlp(x, [p["mlp"] for p in lps])
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
