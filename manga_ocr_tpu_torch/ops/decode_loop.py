"""The whole greedy decode (kernel C).

Counterpart of ``manga_ocr_tpu/ops/decode_loop.py`` ``greedy_decode_loop``
in every form of the JAX kernel:

- the decoder weights: bf16, or int8 from ``models.quantize.quantize_decoder``
  (``int8_w``: each projection row-quantizes its f32 input with
  ``quant_rows``, sums int8 x int8 exactly, then ``(acc * sx) * scale +
  bias``; the head stays bf16, as ``quantize_decoder`` leaves it);
- the cross-attention source: precomputed slabs ([L, B, S, D], in the
  compute dtype; int8 slabs with scales are dequantized outside the loop,
  as the JAX wrapper does), or the raw encoder output (``fuse_kv``:
  ``enc_raw`` [B, S_pad, D] before the encoder's final LN, ``s_valid`` real
  rows, ``enc_final_ln``): the final LN with the DECODER's eps, a cast to
  the compute dtype, the cross-K/V projections with f32 sums plus the f32
  bias and a cast, inside the same launch;
- ``ablate`` (diagnosis: skip the named stages "self", "cross", "mlp",
  "head" -- under "head" the next token is ``prev + 1``, and a token past
  the vocab embeds as a zero row, as the JAX one-hot does) and
  ``gelu_mode`` (the MLP's GELU, "erf" or "sigmoid"; the head keeps erf).

``chains``, ``head_phased``, ``group``, ``vocab_tile``, ``vmem_budget_mb``
and ``interpret`` schedule the JAX kernel on the TPU and change no token
(both head forms keep the first maximum); they are accepted and checked
(positive ints), and schedule nothing here.

On CUDA tensors the whole loop is one launch of ``csrc/decode_loop.cuh``
(the C entry point in ``csrc/decode_loop.cu``, one source per form); on
CPU tensors ``greedy_decode_loop_reference`` runs it as a Python loop over
steps with the same done-masking: PAD after EOS, lengths that count BOS
and EOS, and the optional ``stop_lengths`` instrument (rows behave as if
EOS fired at that length).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_erf, gelu_fn, int8_matmul, ln32, quant_rows

_SMEM_LIMIT = 227 * 1024 - 1024  # per-block opt-in limit less static scratch
_ROWS_PER_BLOCK = (1, 2, 4, 8)
# 512-thread blocks at <= 64 registers a thread: two fit on one SM.
_BLOCKS_PER_SM = 2
_EXIT_CHUNK = 8  # plain version: early-exit check every 8 steps
_KV_TILE = 8  # fuse_kv: encoder rows per projection tile (csrc/decode_loop.cuh)
# ``ablate`` stages, as the kernel's bitmask (bit i = _STAGES[i] skipped)
_STAGES = ("self", "cross", "mlp", "head")
_SELF, _CROSS, _MLP, _HEAD = 1, 2, 4, 8
_GELU_MODES = ("erf", "sigmoid")
_DENSES = (("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v"), ("self_attn", "o"),
           ("cross_attn", "q"), ("cross_attn", "o"), ("mlp", "fc1"), ("mlp", "fc2"))


def _parse_options(
    cfg,
    ablate: str = "",
    gelu_mode: str = "erf",
    chains: int | None = None,
    head_phased: bool | None = None,
    group: int = 32,
    vocab_tile: int = 512,
    vmem_budget_mb: int = 110,
    interpret: bool = False,
) -> tuple[int, str]:
    """The JAX kernel's options -> (``ablate`` bitmask, ``gelu_mode``).
    ``ablate`` is tested by substring, as the JAX kernel tests it."""
    del head_phased, interpret  # both head forms keep the first maximum
    chains = getattr(cfg, "loop_chains", 1) if chains is None else chains
    for name, value in (("chains", chains), ("group", group), ("vocab_tile", vocab_tile),
                        ("vmem_budget_mb", vmem_budget_mb)):
        if isinstance(value, bool) or not isinstance(value, int) or value < 1:
            raise ValueError(f"greedy_decode_loop: {name} must be a positive int, got {value!r}")
    if gelu_mode not in _GELU_MODES:
        raise ValueError(f"greedy_decode_loop: gelu_mode {gelu_mode!r} not in {_GELU_MODES}")
    if not isinstance(ablate, str):
        raise ValueError(f"greedy_decode_loop: ablate must be a string, got {ablate!r}")
    return sum(1 << i for i, name in enumerate(_STAGES) if name in ablate), gelu_mode


def _is_int8_decoder(params_decoder: dict) -> bool:
    """Whether the decoder's projections are int8 (``quantize_decoder``);
    the eight projections the kernel reads must agree."""
    layers = params_decoder["layers"]
    forms = {"w_q" in layers[a][n] for a, n in _DENSES}
    if len(forms) > 1:
        raise ValueError("greedy_decode_loop: the decoder's projections mix int8 and float")
    return forms.pop()


def _dense(p: dict, l: int, dt) -> dict:
    """Layer ``l`` of a dense: ``w`` [K, N] (int8, with f32 ``s``, or in
    ``dt``) and the f32 bias ``b`` (JAX's ``_dense_int8_or``)."""
    if "w_q" in p:
        return {"w": p["w_q"][l], "s": p["scale"][l].float(), "b": p["bias"][l].float()}
    return {"w": p["kernel"][l].to(dt), "b": p["bias"][l].float()}


def _layer_weights(lp: dict, l: int, dt) -> dict:
    """Layer ``l``'s projections (self q|k|v concatenated along N) and LNs."""
    sa, ca, mlp = lp["self_attn"], lp["cross_attn"], lp["mlp"]
    qkv = [_dense(sa[n], l, dt) for n in ("q", "k", "v")]

    def ln(p):
        return p["scale"][l].float(), p["bias"][l].float()

    return {
        "qkv": {k: torch.cat([d[k] for d in qkv], -1) for k in qkv[0]},
        "o": _dense(sa["o"], l, dt), "cq": _dense(ca["q"], l, dt), "co": _dense(ca["o"], l, dt),
        "fc1": _dense(mlp["fc1"], l, dt), "fc2": _dense(mlp["fc2"], l, dt),
        "self_ln": ln(lp["self_ln"]), "cross_ln": ln(lp["cross_ln"]), "mlp_ln": ln(lp["mlp_ln"]),
    }


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


def _float_slabs(cross, dt) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-K/V slabs [L, B, S, D] in ``dt``; int8 slabs are
    dequantized as the JAX wrapper does it: K by its per-(l, b, s) scale, V
    by its per-(l, b, d) scale, in f32, then cast."""
    if cross.k_scale is None:
        return cross.k.to(dt), cross.v.to(dt)
    return ((cross.k.float() * cross.k_scale[..., None]).to(dt),
            (cross.v.float() * cross.v_scale[:, :, None, :]).to(dt))


def _fused_cross_slabs(
    params_decoder: dict, enc_raw: torch.Tensor, s_valid: int, enc_final_ln: dict | None,
    eps: float, dt,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fuse_kv``'s prologue: the first ``s_valid`` rows of
    the raw encoder output, the encoder's final LN (f32 statistics, the
    decoder's ``eps``), cast to ``dt``; per layer the cross k and v
    projections (f32 sums plus the f32 bias), cast to ``dt`` -> [L, B,
    s_valid, D] each.  Rows at or past ``s_valid`` are never attended."""
    e = enc_raw[:, :s_valid]
    e = ln32(e, enc_final_ln["scale"], enc_final_ln["bias"], eps) if enc_final_ln else e.float()
    e = e.to(dt).float()
    ca = params_decoder["layers"]["cross_attn"]
    n_layers = ca["k"]["kernel"].shape[0]

    def proj(p, l):
        return (e @ p["kernel"][l].to(dt).float() + p["bias"][l].float()).to(dt)

    return (torch.stack([proj(ca["k"], l) for l in range(n_layers)]),
            torch.stack([proj(ca["v"], l) for l in range(n_layers)]))


def _slabs(params_decoder, cross, cfg, dt, enc_raw, s_valid, enc_final_ln):
    """The plain version's cross-K/V slabs from either source."""
    if (cross is None) == (enc_raw is None):
        raise ValueError("greedy_decode_loop: give the cross slabs or enc_raw, not both")
    if enc_raw is None:
        return _float_slabs(cross, dt)
    s_valid = enc_raw.shape[1] if s_valid is None else s_valid
    return _fused_cross_slabs(params_decoder, enc_raw, s_valid, enc_final_ln, cfg.layer_norm_eps, dt)


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


def _proj(h32, w: dict, dt):
    """f32 rows [B, K] -> f32 [B, N].  int8: ``quant_rows`` of the f32 rows,
    exact int32 sums, ``(acc * sx) * scale + bias``; float: the rows cast to
    ``dt``, f32 sums of exact products, plus the f32 bias."""
    if "s" in w:
        hq, sx = quant_rows(h32)
        return int8_matmul(hq, w["w"]).float() * sx * w["s"] + w["b"]
    return h32.to(dt).float() @ w["w"].float() + w["b"]


class _PlainDecoder:
    """The plain version's per-step state: prepared weights and the
    self-attention caches of one batch; ``logits(prev, t)`` runs step ``t``
    for tokens ``prev`` [B] and returns the f32 vocab logits [B, V]."""

    def __init__(self, params_decoder: dict, slabs, cfg, steps: int, dtype, stages: int = 0,
                 gelu_mode: str = "erf"):
        self.dt, self.cfg, self.stages, self.gelu = dtype, cfg, stages, gelu_fn(gelu_mode)
        self.k_slabs, self.v_slabs = slabs  # [L, B, S, D]
        n_layers, batch, _, d = self.k_slabs.shape
        dev = self.k_slabs.device
        self.d = d
        self.c = _common_weights(params_decoder, steps, dtype)
        self.layers = [_layer_weights(params_decoder["layers"], l, dtype) for l in range(n_layers)]
        self.cache_k = [torch.zeros((batch, steps, d), dtype=dtype, device=dev)
                        for _ in range(n_layers)]
        self.cache_v = [torch.zeros_like(t) for t in self.cache_k]

    def logits(self, prev: torch.Tensor, t: int) -> torch.Tensor:
        dt, d, c, eps, heads = self.dt, self.d, self.c, self.cfg.layer_norm_eps, self.cfg.num_heads

        def post_ln(x, out, ln):
            return ln32(x + out.to(dt), *ln, eps).to(dt)

        # a token past the vocab (``prev + 1`` under ablate="head") embeds as
        # a zero row, as the JAX kernel's one-hot matmul gives
        tok = prev.long()
        vocab = c["tok_emb"].shape[0]
        tok_row = c["tok_emb"][tok.clamp(max=vocab - 1)]
        tok_row = torch.where((tok < vocab)[:, None], tok_row, torch.zeros_like(tok_row))
        x = ln32(tok_row + c["pos_emb"][t] + c["tok_type"], c["elns"], c["elnb"], eps).to(dt)
        for l, w in enumerate(self.layers):
            if not self.stages & _SELF:
                ck, cv = self.cache_k[l], self.cache_v[l]
                qkv = _proj(x.float(), w["qkv"], dt)
                ck[:, t] = qkv[:, d : 2 * d].to(dt)
                cv[:, t] = qkv[:, 2 * d :].to(dt)
                ctx = _attend(qkv[:, :d], ck[:, : t + 1], cv[:, : t + 1], heads, dt)
                x = post_ln(x, _proj(ctx, w["o"], dt), w["self_ln"])
            if not self.stages & _CROSS:
                q = _proj(x.float(), w["cq"], dt)
                ctx = _attend(q, self.k_slabs[l], self.v_slabs[l], heads, dt)
                x = post_ln(x, _proj(ctx, w["co"], dt), w["cross_ln"])
            if not self.stages & _MLP:
                h = self.gelu(_proj(x.float(), w["fc1"], dt))
                x = post_ln(x, _proj(h, w["fc2"], dt), w["mlp_ln"])
        h = gelu_erf(_proj(x.float(), {"w": c["twt"], "b": c["tbt"]}, dt))
        h = ln32(h, c["hlns"], c["hlnb"], eps).to(dt)
        return _proj(h.float(), {"w": c["wp"], "b": c["bp"]}, dt)


def greedy_decode_loop_reference(
    params_decoder: dict,
    cross,
    cfg,
    steps: int,
    dtype=torch.bfloat16,
    stop_lengths=None,
    enc_raw: torch.Tensor | None = None,
    s_valid: int | None = None,
    enc_final_ln: dict | None = None,
    **options,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the whole decode, every form: a Python loop over
    steps (arguments as ``greedy_decode_loop``)."""
    stages, gelu_mode = _parse_options(cfg, **options)
    _is_int8_decoder(params_decoder)
    slabs = _slabs(params_decoder, cross, cfg, dtype, enc_raw, s_valid, enc_final_ln)
    batch, dev = slabs[0].shape[1], slabs[0].device
    model = _PlainDecoder(params_decoder, slabs, cfg, steps, dtype, stages, gelu_mode)
    tokens = torch.full((batch, steps + 1), cfg.pad_token_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = cfg.bos_token_id
    lengths = torch.ones((batch,), dtype=torch.int32, device=dev)
    prev = torch.full((batch,), cfg.bos_token_id, dtype=torch.long, device=dev)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    stops = None if stop_lengths is None else torch.as_tensor(stop_lengths, device=dev)
    for t in range(steps):
        if t % _EXIT_CHUNK == 0 and bool(done.all()):
            break
        if stages & _HEAD:  # the layers' output reaches no token
            nxt = prev + 1
        else:
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
    params_decoder: dict, cross, cfg, tokens: torch.Tensor, dtype=torch.bfloat16, **options
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score a decoded token matrix [B, steps+1] with the plain version fed
    those same tokens.  Returns (gaps, top), both [B, steps] f32: ``top`` is
    the largest logit of step t and ``gaps`` is ``top`` minus the logit of
    the token emitted at step t + 1.  A greedy decode agrees with the plain
    model exactly where its gaps are 0; numerical noise shows as small gaps
    at near-ties.  Positions at or past a row's length are meaningless.
    ``options`` as ``greedy_decode_loop`` takes them (``ablate`` of "head"
    has no logits to score)."""
    stages, gelu_mode = _parse_options(cfg, **options)
    if stages & _HEAD:
        raise ValueError("teacher_forced_gaps: ablate 'head' leaves no logits to score")
    steps = tokens.shape[1] - 1
    model = _PlainDecoder(params_decoder, _float_slabs(cross, dtype), cfg, steps, dtype, stages,
                          gelu_mode)
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


def _smem_bytes(rows: int, d: int, heads: int, inter: int, steps: int, s_len: int,
               int8_w: bool, fuse_kv: bool) -> int:
    """Dynamic shared memory of one block (``csrc/decode_loop.cuh``
    ``smem_floats``): per row the residual, the wide buffer and the context
    (f32), the per-head scores, the int8 rows of ``int8_w``; ``fuse_kv``'s
    prologue reuses it for two [8, D] tiles."""
    big_n = max(3 * d, inter, d)
    main = (rows * (2 * d + big_n) + heads * max(steps, s_len)) * 4 + (rows * big_n if int8_w else 0)
    return max(main, 2 * _KV_TILE * d * 4) if fuse_kv else main


def _packed_int8(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> [K/4, N, 4]: each 32-bit word holds four consecutive
    k of one column, so a thread's ``__dp4a`` runs along K while a warp reads
    consecutive columns (the bf16 GEMV's [K, N] access pattern)."""
    k, n = w.shape
    return w.reshape(k // 4, 4, n).permute(0, 2, 1).contiguous()


def _kernel_dense(w: dict) -> list:
    """(weight, scale or None, bias) in the kernel's layout."""
    if "s" in w:
        return [_packed_int8(w["w"]), w["s"].contiguous(), w["b"].contiguous()]
    return [w["w"].to(torch.bfloat16).contiguous(), None, w["b"].contiguous()]


def _kernel_layer(lp: dict, l: int, fuse_kv: bool) -> list:
    """Layer ``l``'s tensors in ``csrc/decode_loop.cuh``'s LayerW order
    (None for a null pointer)."""
    w = _layer_weights(lp, l, torch.bfloat16)
    out = []
    for names in (("qkv", "o"), ("cq", "co"), ("fc1", "fc2")):
        ln = {"qkv": "self_ln", "cq": "cross_ln", "fc1": "mlp_ln"}[names[0]]
        for name in names:
            out += _kernel_dense(w[name])
        out += [t.contiguous() for t in w[ln]]
    if fuse_kv:
        ca = lp["cross_attn"]
        out += [ca[n]["kernel"][l].to(torch.bfloat16).contiguous() if part == "kernel"
                else ca[n]["bias"][l].float().contiguous()
                for n in ("k", "v") for part in ("kernel", "bias")]
    else:
        out += [None] * 4
    return out


def _count(forms: tuple[str, ...]) -> None:
    greedy_decode_loop.launches += 1
    for form in forms:
        greedy_decode_loop.launches_by_form[form] += 1


def greedy_decode_loop(
    params_decoder: dict,
    cross,  # decoder.CrossKVPacked [L, B, S, D] (int8 with scales, or float); None with enc_raw
    cfg,  # DecoderConfig
    steps: int,
    dtype=torch.bfloat16,
    stop_lengths=None,  # [B] int32 forced stop lengths (benchmark instrument)
    enc_raw: torch.Tensor | None = None,  # fuse_kv: [B, S_pad, D] encoder output before its final LN
    s_valid: int | None = None,  # fuse_kv: the real rows of enc_raw (default S_pad)
    enc_final_ln: dict | None = None,  # fuse_kv: the encoder's final LN {"scale", "bias"}
    **options,  # ablate, gelu_mode, chains, head_phased, group, vocab_tile, vmem_budget_mb, interpret
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` greedy decode steps -> (tokens [B, steps+1] int32
    starting with BOS, lengths [B] int32), in any form of the module
    docstring.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    stages, gelu_mode = _parse_options(cfg, **options)
    int8_w = _is_int8_decoder(params_decoder)
    fuse_kv = enc_raw is not None
    src = enc_raw if fuse_kv else (cross.k if cross is not None else None)
    if src is None or (fuse_kv and cross is not None):
        raise ValueError("greedy_decode_loop: give the cross slabs or enc_raw, not both")
    if src.device.type == "cpu":
        return greedy_decode_loop_reference(
            params_decoder, cross, cfg, steps, dtype, stop_lengths, enc_raw, s_valid, enc_final_ln,
            **options,
        )
    if dtype != torch.bfloat16:
        raise ValueError(f"greedy_decode_loop: the CUDA kernel takes bf16, got {dtype}")
    dev = src.device
    n_layers, d = params_decoder["layers"]["self_ln"]["scale"].shape
    heads = cfg.num_heads
    dh = d // heads
    inter, vocab = cfg.intermediate_size, cfg.vocab_size
    if d % 8 or dh % 8 or dh * heads != d or heads > 16 or n_layers > 4 or inter % 8 or vocab % 2:
        raise ValueError(
            f"greedy_decode_loop: unsupported shape (D={d}, heads={heads}, "
            f"layers={n_layers}, I={inter}, V={vocab})"
        )
    if steps > params_decoder["pos_embed"].shape[0]:
        raise ValueError(f"greedy_decode_loop: {steps} steps exceed the position table")
    if fuse_kv:
        batch, s_enc, _ = enc_raw.shape
        s_len = s_enc if s_valid is None else s_valid
        if enc_raw.dtype != torch.bfloat16 or not enc_raw.is_contiguous() or \
                enc_raw.shape[2] != d or not 1 <= s_len <= s_enc:
            raise ValueError(f"greedy_decode_loop: enc_raw must be contiguous bf16 [B, S, {d}] "
                             f"with 1 <= s_valid <= S, got {tuple(enc_raw.shape)}, {s_valid}")
        # the kernel writes each block's slabs here before its first step
        k_slab = torch.empty((n_layers, batch, s_len, d), dtype=torch.bfloat16, device=dev)
        v_slab = torch.empty_like(k_slab)
        final_ln = None
        if enc_final_ln is not None:
            final_ln = [enc_final_ln[n].float().contiguous() for n in ("scale", "bias")]
    else:
        k_slab, v_slab = _float_slabs(cross, torch.bfloat16)
        _, batch, s_len, _ = k_slab.shape
        s_enc, final_ln = s_len, None
        for t, name in ((k_slab, "cross k"), (v_slab, "cross v")):
            if not t.is_contiguous() or t.device != dev or t.shape != (n_layers, batch, s_len, d):
                raise ValueError(f"greedy_decode_loop: {name} must be contiguous "
                                 f"[{n_layers}, B, S, {d}] on {dev}")
    # the kernels that read ablate / the sigmoid GELU are built for one row
    # per block only (diagnosis forms; compiled apart from the serving ones)
    rows = 1 if stages or gelu_mode == "sigmoid" else rows_per_block(batch, dev)
    smem = _smem_bytes(rows, d, heads, inter, steps, s_len, int8_w, fuse_kv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"greedy_decode_loop: {smem} bytes of shared memory per block")

    c = _common_weights(params_decoder, steps, torch.bfloat16)
    layers = [_kernel_layer(params_decoder["layers"], l, fuse_kv) for l in range(n_layers)]
    cache_k = torch.empty((n_layers, batch, steps, d), dtype=torch.bfloat16, device=dev)
    cache_v = torch.empty_like(cache_k)
    stops = None
    if stop_lengths is not None:
        stops = torch.as_tensor(stop_lengths, dtype=torch.int32, device=dev).contiguous()
        if stops.shape != (batch,):
            raise ValueError(f"greedy_decode_loop: stop_lengths must be [{batch}]")
    tokens = torch.empty((batch, steps + 1), dtype=torch.int32, device=dev)
    lengths = torch.empty((batch,), dtype=torch.int32, device=dev)
    tensors = [*c.values(), *(t for w in layers for t in w if t is not None)]
    if final_ln is not None:
        tensors += final_ln
    for t in tensors:
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"greedy_decode_loop: decoder weights must be 16-byte aligned on {dev}")

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = [c[k].data_ptr() for k in (
        "tok_emb", "pos_emb", "tok_type", "elns", "elnb", "twt", "tbt", "hlns", "hlnb",
        "wp", "bp",
    )]
    ptrs += [k_slab.data_ptr(), v_slab.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
             ptr(stops), ptr(enc_raw), *(ptr(t) for t in (final_ln or (None, None)))]
    for w in layers:
        ptrs += [ptr(t) for t in w]
    ints = [batch, d, heads, inter, vocab, n_layers, s_len, steps,
            cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id, rows, int(int8_w), int(fuse_kv),
            s_enc, stages, int(gelu_mode == "sigmoid")]
    launch.decode_loop(ptrs, ints, 1.0 / (dh**0.5), cfg.layer_norm_eps, tokens, lengths)
    _count(tuple(f for f, on in (("int8_w", int8_w), ("fuse_kv", fuse_kv)) if on))
    return tokens, lengths


greedy_decode_loop.launches = 0  # launches of the CUDA kernel (CPU calls do not count)
# launches by form: "int8_w" (int8 decoder weights) and "fuse_kv" (slabs in the launch)
greedy_decode_loop.launches_by_form = {"int8_w": 0, "fuse_kv": 0}
