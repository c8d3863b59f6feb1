"""The whole greedy decode (kernel C).

Counterpart of ``manga_ocr_tpu/ops/decode_loop.py`` ``greedy_decode_loop`` in
its serving form: bf16 decoder weights, bf16 cross-K/V slabs, first-max
argmax, one chain, precomputed slabs.  On CUDA tensors the whole loop is one
launch of ``csrc/decode_loop.cu``; on CPU tensors
``greedy_decode_loop_reference`` runs it as a Python loop over steps with
the same done-masking: PAD after EOS, lengths that count BOS and EOS, and
the optional ``stop_lengths`` instrument (rows behave as if EOS fired at
that length).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_erf, ln32

_SMEM_LIMIT = 227 * 1024 - 1024  # per-block opt-in limit less static scratch
_ROWS_PER_BLOCK = (1, 2, 4, 8)
# 512-thread blocks at <= 64 registers a thread: two fit on one SM.
_BLOCKS_PER_SM = 2
_EXIT_CHUNK = 8  # plain version: early-exit check every 8 steps


def _layer_weights(lp: dict, l: int, dt) -> dict:
    """Layer ``l``'s tensors in the kernel's layout: weights [K, N] in ``dt``,
    biases and LN parameters f32, self q|k|v concatenated along N."""
    sa, ca, mlp = lp["self_attn"], lp["cross_attn"], lp["mlp"]

    def w(p):
        return p["kernel"][l].to(dt).contiguous()

    def f(t):
        return t[l].float().contiguous()

    return {
        "wqkv": torch.cat([sa[n]["kernel"][l] for n in ("q", "k", "v")], 1).to(dt).contiguous(),
        "bqkv": torch.cat([sa[n]["bias"][l] for n in ("q", "k", "v")]).float().contiguous(),
        "wo": w(sa["o"]), "bo": f(sa["o"]["bias"]),
        "slns": f(lp["self_ln"]["scale"]), "slnb": f(lp["self_ln"]["bias"]),
        "cwq": w(ca["q"]), "cbq": f(ca["q"]["bias"]),
        "cwo": w(ca["o"]), "cbo": f(ca["o"]["bias"]),
        "clns": f(lp["cross_ln"]["scale"]), "clnb": f(lp["cross_ln"]["bias"]),
        "w1": w(mlp["fc1"]), "b1": f(mlp["fc1"]["bias"]),
        "w2": w(mlp["fc2"]), "b2": f(mlp["fc2"]["bias"]),
        "mlns": f(lp["mlp_ln"]["scale"]), "mlnb": f(lp["mlp_ln"]["bias"]),
    }


_LAYER_ORDER = (
    "wqkv", "bqkv", "wo", "bo", "slns", "slnb", "cwq", "cbq", "cwo", "cbo",
    "clns", "clnb", "w1", "b1", "w2", "b2", "mlns", "mlnb",
)


def _common_weights(params: dict, steps: int, dt) -> dict:
    head = params["head"]
    return {
        "tok_emb": params["tok_embed"].to(dt).contiguous(),
        "pos_emb": params["pos_embed"][:steps].to(dt).contiguous(),
        "tok_type": params["tok_type"].to(dt).contiguous(),
        "elns": params["emb_ln"]["scale"].float().contiguous(),
        "elnb": params["emb_ln"]["bias"].float().contiguous(),
        "twt": head["transform"]["dense"]["kernel"].to(dt).contiguous(),
        "tbt": head["transform"]["dense"]["bias"].float().contiguous(),
        "hlns": head["transform"]["ln"]["scale"].float().contiguous(),
        "hlnb": head["transform"]["ln"]["bias"].float().contiguous(),
        "wp": head["proj"]["kernel"].to(dt).contiguous(),
        "bp": head["proj"]["bias"].float().contiguous(),
    }


def _check_serving_form(params_decoder: dict, cross, options: dict) -> None:
    """Raise for the JAX kernel's forms that are not ported.  ``head_phased``
    is accepted either way: both head forms keep the first maximum.  The
    kernel reads float slabs, as the JAX one does: int8 slabs (with scales)
    raise."""
    if "w_q" in params_decoder["layers"]["self_attn"]["q"]:
        raise NotImplementedError("greedy_decode_loop: an int8 decoder is not ported")
    if cross.k_scale is not None:
        raise NotImplementedError("greedy_decode_loop: int8 cross-K/V slabs are not ported")
    for name, value in options.items():
        if name == "head_phased" or (name == "chains" and value in (None, 1)):
            continue
        if name in ("ablate", "enc_raw", "fuse_kv") and not value:
            continue
        raise NotImplementedError(f"greedy_decode_loop: option {name}={value!r} is not ported")


def _attend(q32, k, v, heads: int, dt):
    """q [B, D] f32, K/V [B, T, D] -> ctx [B, D] f32 (plain version)."""
    b, t, d = k.shape
    dh = d // heads
    qb = q32.to(dt).float().reshape(b, heads, dh)
    scores = torch.einsum("bhd,bthd->bht", qb, k.float().reshape(b, t, heads, dh))
    scores = scores * (1.0 / (dh**0.5))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    p = (p * (1.0 / p.sum(-1, keepdim=True))).to(dt).float()
    ctx = torch.einsum("bht,bthd->bhd", p, v.float().reshape(b, t, heads, dh))
    return ctx.reshape(b, d)


def _proj(h32, w, b, dt):
    """``h32.astype(dt)`` @ w with f32 accumulation, plus the f32 bias."""
    return h32.to(dt).float() @ w.float() + b


class _PlainDecoder:
    """The plain version's per-step state: prepared weights and the
    self-attention caches of one batch; ``logits(prev, t)`` runs step ``t``
    for tokens ``prev`` [B] and returns the f32 vocab logits [B, V]."""

    def __init__(self, params_decoder: dict, cross, cfg, steps: int, dtype):
        self.dt, self.cfg = dtype, cfg
        self.k_slabs, self.v_slabs = cross.k, cross.v  # [L, B, S, D]
        n_layers, batch, _, d = cross.k.shape
        dev = cross.k.device
        self.d = d
        self.c = _common_weights(params_decoder, steps, dtype)
        self.layers = [_layer_weights(params_decoder["layers"], l, dtype) for l in range(n_layers)]
        self.cache_k = [torch.zeros((batch, steps, d), dtype=dtype, device=dev)
                        for _ in range(n_layers)]
        self.cache_v = [torch.zeros_like(t) for t in self.cache_k]

    def logits(self, prev: torch.Tensor, t: int) -> torch.Tensor:
        dt, d, c, eps, heads = self.dt, self.d, self.c, self.cfg.layer_norm_eps, self.cfg.num_heads

        def post_ln(x, out, scale, bias):
            return ln32(x + out.to(dt), scale, bias, eps).to(dt)

        emb = c["tok_emb"][prev.long()] + c["pos_emb"][t] + c["tok_type"]
        x = ln32(emb, c["elns"], c["elnb"], eps).to(dt)
        for l, w in enumerate(self.layers):
            ck, cv = self.cache_k[l], self.cache_v[l]
            qkv = _proj(x, w["wqkv"], w["bqkv"], dt)
            ck[:, t] = qkv[:, d : 2 * d].to(dt)
            cv[:, t] = qkv[:, 2 * d :].to(dt)
            ctx = _attend(qkv[:, :d], ck[:, : t + 1], cv[:, : t + 1], heads, dt)
            x = post_ln(x, _proj(ctx, w["wo"], w["bo"], dt), w["slns"], w["slnb"])
            q = _proj(x, w["cwq"], w["cbq"], dt)
            ctx = _attend(q, self.k_slabs[l], self.v_slabs[l], heads, dt)
            x = post_ln(x, _proj(ctx, w["cwo"], w["cbo"], dt), w["clns"], w["clnb"])
            h = gelu_erf(_proj(x, w["w1"], w["b1"], dt))
            x = post_ln(x, _proj(h, w["w2"], w["b2"], dt), w["mlns"], w["mlnb"])
        h = gelu_erf(_proj(x, c["twt"], c["tbt"], dt))
        h = ln32(h, c["hlns"], c["hlnb"], eps).to(dt)
        return _proj(h, c["wp"], c["bp"], dt)


def greedy_decode_loop_reference(
    params_decoder: dict, cross, cfg, steps: int, dtype=torch.bfloat16, stop_lengths=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole decode: a Python loop over steps."""
    batch, dev = cross.k.shape[1], cross.k.device
    model = _PlainDecoder(params_decoder, cross, cfg, steps, dtype)
    tokens = torch.full((batch, steps + 1), cfg.pad_token_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = cfg.bos_token_id
    lengths = torch.ones((batch,), dtype=torch.int32, device=dev)
    prev = torch.full((batch,), cfg.bos_token_id, dtype=torch.long, device=dev)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    stops = None if stop_lengths is None else torch.as_tensor(stop_lengths, device=dev)
    for t in range(steps):
        if t % _EXIT_CHUNK == 0 and bool(done.all()):
            break
        nxt = torch.argmax(model.logits(prev, t), dim=-1)  # first maximum
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        tokens[:, t + 1] = nxt.to(torch.int32)
        lengths += (~done).to(torch.int32)
        prev = nxt
        newly = nxt == cfg.eos_token_id
        if stops is not None:
            newly = newly | (t + 2 >= stops)
        done = done | newly
    return tokens, lengths


def teacher_forced_gaps(
    params_decoder: dict, cross, cfg, tokens: torch.Tensor, dtype=torch.bfloat16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score a decoded token matrix [B, steps+1] with the plain version fed
    those same tokens.  Returns (gaps, top), both [B, steps] f32: ``top`` is
    the largest logit of step t and ``gaps`` is ``top`` minus the logit of
    the token emitted at step t + 1.  A greedy decode agrees with the plain
    model exactly where its gaps are 0; numerical noise shows as small gaps
    at near-ties.  Positions at or past a row's length are meaningless."""
    steps = tokens.shape[1] - 1
    model = _PlainDecoder(params_decoder, cross, cfg, steps, dtype)
    gaps = torch.empty((tokens.shape[0], steps), dtype=torch.float32, device=tokens.device)
    top = torch.empty_like(gaps)
    for t in range(steps):
        lg = model.logits(tokens[:, t], t)
        top[:, t] = lg.amax(-1)
        gaps[:, t] = top[:, t] - lg.gather(1, tokens[:, t + 1].long()[:, None])[:, 0]
    return gaps, top


def rows_per_block(batch: int, device) -> int:
    """The fewest rows per block whose grid runs in one wave of co-resident
    blocks: the kernel's time grows about linearly with the rows a block
    owns (measured on the H100: 326, 548, 836 ms for 1, 2, 4 rows at B=32),
    so more rows per block only pay once a second wave would cost more."""
    slots = _BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    for r in _ROWS_PER_BLOCK:
        if -(-batch // r) <= slots:
            return r
    return _ROWS_PER_BLOCK[-1]


def greedy_decode_loop(
    params_decoder: dict,
    cross,  # decoder.CrossKVPacked with bf16 (or f32 on CPU) k/v [L, B, S, D]
    cfg,  # DecoderConfig
    steps: int,
    dtype=torch.bfloat16,
    stop_lengths=None,  # [B] int32 forced stop lengths (benchmark instrument)
    **options,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` greedy decode steps -> (tokens [B, steps+1] int32
    starting with BOS, lengths [B] int32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.  The JAX kernel's
    int8-decoder, ``fuse_kv``, ``chains > 1`` and ``ablate`` forms raise
    ``NotImplementedError``."""
    _check_serving_form(params_decoder, cross, options)
    if cross.k.device.type == "cpu":
        return greedy_decode_loop_reference(
            params_decoder, cross, cfg, steps, dtype, stop_lengths
        )
    if dtype != torch.bfloat16:
        raise ValueError(f"greedy_decode_loop: the CUDA kernel takes bf16, got {dtype}")
    dev = cross.k.device
    n_layers, batch, s_len, d = cross.k.shape
    heads = cfg.num_heads
    dh = d // heads
    inter, vocab = cfg.intermediate_size, cfg.vocab_size
    if d % 8 or dh % 8 or dh * heads != d or heads > 16 or n_layers > 4 or inter % 2 or vocab % 2:
        raise ValueError(
            f"greedy_decode_loop: unsupported shape (D={d}, heads={heads}, "
            f"layers={n_layers}, I={inter}, V={vocab})"
        )
    if steps > params_decoder["pos_embed"].shape[0]:
        raise ValueError(f"greedy_decode_loop: {steps} steps exceed the position table")
    for t, name in ((cross.k, "cross k"), (cross.v, "cross v")):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"greedy_decode_loop: {name} must be contiguous bf16 on {dev}")
    rows = rows_per_block(batch, dev)
    big_n = max(3 * d, inter, d)
    smem = (rows * (2 * d + big_n) + heads * max(steps, s_len)) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"greedy_decode_loop: {smem} bytes of shared memory per block")

    c = _common_weights(params_decoder, steps, torch.bfloat16)
    layers = [
        _layer_weights(params_decoder["layers"], l, torch.bfloat16) for l in range(n_layers)
    ]
    cache_k = torch.empty((n_layers, batch, steps, d), dtype=torch.bfloat16, device=dev)
    cache_v = torch.empty_like(cache_k)
    stops = None
    if stop_lengths is not None:
        stops = torch.as_tensor(stop_lengths, dtype=torch.int32, device=dev).contiguous()
        if stops.shape != (batch,):
            raise ValueError(f"greedy_decode_loop: stop_lengths must be [{batch}]")
    tokens = torch.empty((batch, steps + 1), dtype=torch.int32, device=dev)
    lengths = torch.empty((batch,), dtype=torch.int32, device=dev)
    for t in (*c.values(), *(v for w in layers for v in w.values())):
        if t.device != dev:
            raise ValueError(f"greedy_decode_loop: decoder weights must be on {dev}")
    ptrs = [c[k].data_ptr() for k in (
        "tok_emb", "pos_emb", "tok_type", "elns", "elnb", "twt", "tbt", "hlns", "hlnb",
        "wp", "bp",
    )]
    ptrs += [cross.k.data_ptr(), cross.v.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
             stops.data_ptr() if stops is not None else 0]
    for w in layers:
        ptrs += [w[k].data_ptr() for k in _LAYER_ORDER]
    ints = [batch, d, heads, inter, vocab, n_layers, s_len, steps,
            cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id, rows]
    launch.decode_loop(ptrs, ints, 1.0 / (dh**0.5), cfg.layer_norm_eps, tokens, lengths)
    greedy_decode_loop.launches += 1
    return tokens, lengths


greedy_decode_loop.launches = 0  # launches of the CUDA kernel (CPU calls do not count)
