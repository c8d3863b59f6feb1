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
  bias and a cast, computed once per decode before its first step;
- ``ablate`` (diagnosis: skip the named stages "self", "cross", "mlp",
  "head" -- under "head" the next token is ``prev + 1``, and a token past
  the vocab embeds as a zero row, as the JAX one-hot does) and
  ``gelu_mode`` (the MLP's GELU, "erf" or "sigmoid"; the head keeps erf).

``chains``, ``head_phased``, ``group``, ``vocab_tile``, ``vmem_budget_mb``
and ``interpret`` schedule the JAX kernel on the TPU and change no token
(both head forms keep the first maximum); they are accepted and checked
(positive ints), and schedule nothing here.

On CUDA tensors the whole loop is one launch of ``csrc/decode_cluster.cu``
(a thread-block cluster per tile of rows, one decoder head per CTA,
tensor-core projections: bf16, or s8 in its int8_w kernel) for bf16 or
int8 weights, the erf GELU and no ablate, at the shapes ``decode_form``
finds it takes; under ``fuse_kv`` the prologue ``cross_kv_prologue``
first writes the slabs (the final LN's row pass and the cross k/v
products on the bf16 GEMM, ``csrc/mlp_bf16.cu``; ``quantize_decoder``
leaves the cross k/v weights float).  The diagnosis forms (ablate, the
sigmoid GELU), the other shapes and ``kernel="loop"`` are one launch of
``csrc/decode_loop.cuh`` (the C entry point in ``csrc/decode_loop.cu``,
one source per form; its ``fuse_kv`` forms compute the slabs inside the
launch), whose rows per block follow the compiled kernel's occupancy.
Each kernel reads its weights in its own layout, prepared once per set of
params (``loop_weights``, ``cluster_weights``, ``cross_kv_weights``).  On
CPU tensors ``greedy_decode_loop_reference`` runs it as a Python loop over
steps with the same done-masking: PAD after EOS, lengths that count BOS
and EOS, and the optional ``stop_lengths`` instrument (rows behave as if
EOS fired at that length).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops import encoder_weights as ew
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_erf, gelu_fn, int8_matmul, ln32, quant_rows

_SMEM_LIMIT = 227 * 1024 - 1024  # per-block opt-in limit less static scratch
_ROWS_PER_BLOCK = (1, 2, 4, 8)
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


def rows_for_slots(batch: int, slots) -> int:
    """The fewest rows per block (of ``_ROWS_PER_BLOCK``) whose grid fits in
    ``slots`` co-resident blocks (an int, or a function of the rows)."""
    for r in _ROWS_PER_BLOCK:
        if -(-batch // r) <= (slots(r) if callable(slots) else slots):
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


def _loop_rows(batch: int, dev, int8_w: bool, fuse_kv: bool, opts: bool, smem_of) -> int:
    """Rows per block of the present kernel, from its compiled occupancy:
    the blocks of each row count that one SM holds (registers and shared
    memory of that very instantiation, asked of the CUDA runtime)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if opts:  # the ablate / sigmoid-GELU kernels are built for one row only
        return 1
    return rows_for_slots(batch, lambda r: sms * launch.decode_loop_blocks_per_sm(
        dev, int8_w, fuse_kv, opts, r, smem_of(r)))


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
    return out + (_cross_kv_layer(lp["cross_attn"], l) if fuse_kv else [None] * 4)


def _cross_kv_layer(ca: dict, l: int) -> list:
    """Layer ``l``'s cross k and v weights as ``fuse_kv`` reads them: bf16
    [D, D] and the f32 bias, k then v."""
    return [ca[n]["kernel"][l].to(torch.bfloat16).contiguous() if part == "kernel"
            else ca[n]["bias"][l].float().contiguous()
            for n in ("k", "v") for part in ("kernel", "bias")]


def _own(tensors: list) -> list:
    """Copies of ``tensors`` (None kept): a cast or ``contiguous`` of a leaf
    already in that form returns the leaf itself, and the prepared-weights
    cache must hold no reference to the params it is keyed on."""
    return [None if t is None else t.clone() for t in tensors]


def _loop_weights(params_decoder: dict, fuse_kv: bool) -> tuple[dict, list]:
    """The present kernel's weights: the common tensors (the whole position
    table; a call reads its first ``steps`` rows) and each layer's list."""
    n_layers = params_decoder["layers"]["self_ln"]["scale"].shape[0]
    c = _common_weights(params_decoder, params_decoder["pos_embed"].shape[0], torch.bfloat16)
    return (dict(zip(c, _own(list(c.values())))),
            [_own(_kernel_layer(params_decoder["layers"], l, fuse_kv)) for l in range(n_layers)])


def loop_weights(params_decoder: dict, fuse_kv: bool) -> tuple[dict, list]:
    """``_loop_weights`` once per set of params (``encoder_weights.prepared``:
    an in-place write to a leaf prepares anew)."""
    return ew.prepared(params_decoder, ("decode_loop", fuse_kv),
                       lambda: _loop_weights(params_decoder, fuse_kv))


# -- the cluster kernel (csrc/decode_cluster.cu) -------------------------------
CLUSTER_ROWS = 16  # decoder rows of one cluster's tile
CLUSTER_WARPS = 16  # warps of one CTA (one per row in attention)
_CLUSTER_SIZES = (1, 2, 4, 8)  # heads = CTAs of a cluster (8: the portable maximum)
_MAX_TILES = 6  # n8 tiles a warp holds at once (csrc/decode_cluster.cu MAX_T)
# the projections of a step, in the kernel's plan order: (K, N slice) of each
_PLAN_ORDER = ("qkv", "o", "cq", "co", "fc1", "fc2", "tr", "vocab")


def pack_fragments(w: torch.Tensor, heads: int) -> torch.Tensor:
    """bf16 or int8 [K, N] -> [heads, N/heads/8, K/(16v), 32, 4v] with v
    the values of one 32-bit fragment register (2 bf16, 4 int8): CTA h's
    column slice h * N/heads ... in the order the cluster kernel reads its
    ``mma.sync`` B fragments (m16n8k16 bf16, m16n8k32 s8).  Entry [h, j,
    p, lane, v r + e] is W[k, n] with n = h * N/heads + 8j + lane/4 and k =
    16v p + 8v (r/2) + 4v (r%2) + v (lane%4) + e: one 16-byte load gives a
    lane its two k steps' fragments of tile j (bf16: k = 32p + 16(r/2) +
    8(r%2) + 2(lane%4) + e), and a warp's load reads 512 contiguous bytes."""
    k, n = w.shape
    v = 4 // w.element_size()
    nt = n // heads // 8
    t = w.reshape(k // (16 * v), 2, 2, 4, v, heads, nt, 8)  # [p, kk, half, q, e, h, j, g]
    t = t.permute(5, 6, 0, 7, 3, 1, 2, 4)  # [h, j, p, g, q, kk, half, e]
    return t.reshape(heads, nt, k // (16 * v), 32, 4 * v).contiguous()


def _head_major_qkv(sa: dict, l: int, heads: int, dt) -> dict:
    """Self q|k|v of layer ``l`` as one ``_dense`` (weight, bias and, int8,
    the scales) with columns ordered per head: [q_h | k_h | v_h] for h = 0
    .. heads-1, so CTA h's slice is its own head's three."""
    qkv = [_dense(sa[n], l, dt) for n in ("q", "k", "v")]
    dh = qkv[0]["w"].shape[1] // heads
    cols = [slice(h * dh, (h + 1) * dh) for h in range(heads)]
    return {key: torch.cat([p[key][..., c] for c in cols for p in qkv], -1) for key in qkv[0]}


def vocab_slice(vocab: int, heads: int) -> int:
    """Vocab columns of one CTA: the vocab padded to heads x a multiple of 8
    (padded columns have zero weights and are never chosen)."""
    return -(-vocab // (8 * heads)) * 8


def _cluster_weights(params_decoder: dict, heads: int) -> tuple[list, list]:
    """The cluster kernel's weights in its pointer order: the common
    tensors, then per layer (qkv, o, cq, co, fc1, fc2: packed weight --
    bf16, or int8 under ``quantize_decoder`` -- and per-head f32 bias; the
    three LNs after their stage; int8: the six f32 per-column scales
    last)."""
    dt = torch.bfloat16
    int8 = _is_int8_decoder(params_decoder)
    lp = params_decoder["layers"]
    c = _common_weights(params_decoder, params_decoder["pos_embed"].shape[0], dt)
    d, vocab = c["wp"].shape
    vs = vocab_slice(vocab, heads)
    wp = torch.zeros((d, heads * vs), dtype=dt, device=c["wp"].device)
    wp[:, :vocab] = c["wp"]
    bp = torch.zeros((heads * vs,), dtype=torch.float32, device=c["bp"].device)
    bp[:vocab] = c["bp"]
    common = [c["tok_emb"], c["pos_emb"], c["tok_type"], c["elns"], c["elnb"],
              pack_fragments(c["twt"], heads), c["tbt"], c["hlns"], c["hlnb"],
              pack_fragments(wp, heads), bp]
    layers = []
    for l in range(lp["self_ln"]["scale"].shape[0]):
        w = _layer_weights(lp, l, dt)
        w["qkv"] = _head_major_qkv(lp["self_attn"], l, heads, dt)
        out = []
        for name, ln in (("qkv", None), ("o", "self_ln"), ("cq", None), ("co", "cross_ln"),
                         ("fc1", None), ("fc2", "mlp_ln")):
            out += [pack_fragments(w[name]["w"], heads), w[name]["b"].contiguous()]
            out += list(w[ln]) if ln else []
        if int8:
            out += [w[name]["s"].contiguous() for name in _PLAN_ORDER[:6]]
        layers.append(_own(out))
    return _own(common), layers


def cluster_weights(params_decoder: dict, heads: int) -> tuple[list, list]:
    """``_cluster_weights`` once per set of params and head count (the
    int8 form under a key of its own)."""
    key = "decode_cluster_int8" if _is_int8_decoder(params_decoder) else "decode_cluster"
    return ew.prepared(params_decoder, (key, heads),
                       lambda: _cluster_weights(params_decoder, heads))


def _proj_plan(k: int, n_slice: int, argmax: bool = False, pair: int = 32) -> tuple[int, int]:
    """How a CTA's 16 warps split one projection of K inputs onto its
    ``n_slice`` columns (n8 tiles): ``kp`` parts along K (each of whole
    k-pairs of ``pair`` values, 32 bf16 or 64 int8; their sums are added
    in part order) times 16/kp groups of tiles, each warp holding up to
    ``t`` tiles at once; the least k-pairs a warp walks, then the fewest
    parts.  The vocab takes no K split (its argmax is read from the
    accumulators).  Each part adds one pass over the slice, behind a
    barrier, counted as one k-pair."""
    nt, n_pairs = n_slice // 8, k // pair
    best = None
    for kp in (1, 2, 4, 8, 16):
        if n_pairs % kp or (argmax and kp > 1):
            continue
        groups = CLUSTER_WARPS // kp
        t = min(_MAX_TILES, -(-nt // groups))
        rounds = -(-nt // (groups * t))
        cost = rounds * (t * (n_pairs // kp) + kp)
        if best is None or cost < best[0]:
            best = (cost, kp, t)
    return best[1], best[2]


def cluster_plan(d: int, heads: int, inter: int, vocab: int, steps: int, s_len: int,
                 int8: bool = False) -> dict:
    """The cluster kernel's split of one decode at these widths: per
    projection (K, N slice, kp, t) in ``_PLAN_ORDER`` and the dynamic shared
    memory of one CTA at 16 rows a tile (``cluster_smem``; the kernel widens
    a tile only where that fits).  ``int8``: the int8_w kernel, whose six
    layer projections walk K in pairs of k32 steps (64 values) and whose
    int8 GELU(fc1) slices are exchanged in 16-byte pieces.  Raises
    ``ValueError`` for a shape the kernel does not take."""
    dh = d // heads if heads else 0
    why = None
    if heads not in _CLUSTER_SIZES:
        why = f"heads={heads} not in {_CLUSTER_SIZES}"
    elif dh * heads != d or dh % 16 or dh > 128:
        why = f"head dim {d}/{heads} not a multiple of 16 up to 128"
    elif d % 64 or inter % 32 or inter % heads or (inter // heads) % 8:
        why = (f"D={d} or I={inter} (D a multiple of 64, I of 32, split into slices of "
               f"multiples of 8)")
    elif int8 and (inter % 64 or (inter // heads) % 16):
        why = f"I={inter} under int8_w (a multiple of 64, split into slices of multiples of 16)"
    if why is not None:
        raise ValueError(f"greedy_decode_loop: the cluster kernel does not take {why}")
    ds, fs, vs = d // heads, inter // heads, vocab_slice(vocab, heads)
    shapes = {"qkv": (d, 3 * dh), "o": (d, ds), "cq": (d, dh), "co": (d, ds), "fc1": (d, fs),
              "fc2": (inter, ds), "tr": (d, ds), "vocab": (d, vs)}
    plans = {name: (*shapes[name], *_proj_plan(*shapes[name], argmax=name == "vocab",
                                               pair=64 if int8 and i < 6 else 32))
             for i, name in enumerate(_PLAN_ORDER)}
    smem = cluster_smem(CLUSTER_ROWS, d, heads, inter, steps, s_len, int8)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"greedy_decode_loop: the cluster kernel needs {smem} bytes of shared "
                         f"memory per CTA")
    return {"plans": plans, "smem": smem, "vocab_slice": vs}


def cluster_smem(rows: int, d: int, heads: int, inter: int, steps: int, s_len: int,
                 int8: bool = False) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel at ``rows``
    rows a tile (``csrc/decode_cluster.cu`` ``smem_bytes``): the residual
    rows, the gathered rows (bf16 [rows, max(D, I)], f32 [rows, D], or the
    attention's per-(row, 32-key chunk) f32 sums and per-warp scratch;
    int8: in it, the D-wide bf16 rows followed by the int8 rows [rows, D +
    16], 3D + 32 bytes a row within the f32 rows' 4D), the projection
    output, two exchange buffers, the scores, the argmax candidates and the
    row state (int8: and the row scales and slice maxima)."""
    dh = d // heads
    fs = inter // heads
    keys = max(steps, s_len)
    n_ch = -(-keys // 32)
    u = max(rows * (max(d, inter) + 8) * 2, rows * d * 4,
            rows * n_ch * dh * 4 + CLUSTER_WARPS * 32 * 8 * 4)
    return (rows * (d + 8) * 2 + u + rows * max(3 * dh, fs, dh) * 4 + 2 * rows * max(2 * fs, 4 * dh)
            + rows * keys * 4 + 2 * CLUSTER_WARPS * rows * 4 + 2 * rows * 4 + 3 * rows * 4
            + (2 * rows * 4 if int8 else 0))


def decode_form(params_decoder: dict, cfg, steps: int, s_len: int, fuse_kv: bool,
                stages: int, gelu_mode: str) -> str:
    """Which kernel runs a CUDA decode, by form and shape alone, before any
    launch: "cluster" (``csrc/decode_cluster.cu``) for bf16 or int8
    (``quantize_decoder``) weights, the erf GELU and no ablate -- over
    precomputed slabs, or under ``fuse_kv`` after ``cross_kv_prologue`` --
    at the shapes ``cluster_plan`` and, under ``fuse_kv``, the prologue's
    GEMM (K = N = D) take; "loop" (``csrc/decode_loop.cuh``) for the
    diagnosis forms and every other shape."""
    if stages or gelu_mode != "erf":
        return "loop"
    d = params_decoder["layers"]["self_ln"]["scale"].shape[1]
    try:
        cluster_plan(d, cfg.num_heads, cfg.intermediate_size, cfg.vocab_size, steps, s_len,
                     _is_int8_decoder(params_decoder))
    except ValueError:
        return "loop"
    if fuse_kv and (d % launch.GEMM_BK or d % 8):
        return "loop"
    return "cluster"


def cross_kv_weights(params_decoder: dict) -> list:
    """``fuse_kv``'s prologue weights, per layer ``_cross_kv_layer``, once
    per set of params."""
    ca = params_decoder["layers"]["cross_attn"]
    return ew.prepared(params_decoder, ("cross_kv",), lambda: [
        _own(_cross_kv_layer(ca, l)) for l in range(ca["k"]["kernel"].shape[0])])


def cross_kv_prologue(
    params_decoder: dict, enc_raw: torch.Tensor, s_valid: int, enc_final_ln: dict | None,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fuse_kv``'s slabs on the card, for the cluster kernel: the first
    ``s_valid`` rows of ``enc_raw`` [B, S, D] bf16 (copied to be contiguous
    only where ``s_valid < S``), the final LN's row pass
    (``launch.ln_rows_bf16``, the decoder's ``eps``; the rows as they are
    without ``enc_final_ln``), then per layer the cross k and v products on
    the bf16 GEMM (``launch.bf16_gemm``, bias epilogue) written straight
    into the slabs -> K, V [L, B, s_valid, D] bf16, ``_fused_cross_slabs``'
    roundings.  Every launch is on the current stream: the decode that
    reads the slabs follows them with no host synchronisation."""
    batch, s_enc, d = enc_raw.shape
    rows = enc_raw[:, :s_valid]
    if s_valid < s_enc:
        rows = rows.contiguous()
    e = rows.view(batch * s_valid, d)
    if enc_final_ln is not None:
        e = launch.ln_rows_bf16(e, tuple(enc_final_ln[n].float().contiguous()
                                         for n in ("scale", "bias")), eps)
    layers = cross_kv_weights(params_decoder)
    k_slab = torch.empty((len(layers), batch, s_valid, d), dtype=torch.bfloat16,
                         device=enc_raw.device)
    v_slab = torch.empty_like(k_slab)
    for l, (wk, bk, wv, bv) in enumerate(layers):
        launch.bf16_gemm(e, wk, bk, launch.BF16_BIAS, out=k_slab[l].view(batch * s_valid, d))
        launch.bf16_gemm(e, wv, bv, launch.BF16_BIAS, out=v_slab[l].view(batch * s_valid, d))
    return k_slab, v_slab


def _count(forms: tuple[str, ...]) -> None:
    greedy_decode_loop.launches += 1
    for form in forms:
        greedy_decode_loop.launches_by_form[form] += 1


def _check_ptrs(tensors, dev) -> None:
    for t in tensors:
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"greedy_decode_loop: decoder weights must be 16-byte aligned on {dev}")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_cluster(params_decoder, cfg, steps, k_slab, v_slab, stops, tokens, lengths,
                    prof=None) -> None:
    """The decode on the cluster kernel, bf16 or int8 weights (shapes
    checked by the caller through ``decode_form``; ``prof`` as
    ``launch.decode_cluster`` takes it)."""
    n_layers, batch, s_len, d = k_slab.shape
    heads = cfg.num_heads
    int8 = _is_int8_decoder(params_decoder)
    plan = cluster_plan(d, heads, cfg.intermediate_size, cfg.vocab_size, steps, s_len, int8)
    common, layers = cluster_weights(params_decoder, heads)
    _check_ptrs([*common, *(t for w in layers for t in w)], k_slab.device)
    cache_k = torch.empty((n_layers, batch, steps, d), dtype=torch.bfloat16, device=k_slab.device)
    cache_v = torch.empty_like(cache_k)
    ptrs = [t.data_ptr() for t in common]
    ptrs += [k_slab.data_ptr(), v_slab.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
             _ptr(stops)]
    for w in layers:
        ptrs += [t.data_ptr() for t in w]
    ints = [batch, d, heads, cfg.intermediate_size, cfg.vocab_size, plan["vocab_slice"], n_layers,
            s_len, steps, cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id]
    for name in _PLAN_ORDER:
        ints += plan["plans"][name][2:]
    clusters, seated, rows = launch.decode_cluster(ptrs, ints, 1.0 / ((d // heads) ** 0.5),
                                                   cfg.layer_norm_eps, tokens, lengths, prof,
                                                   int8)
    greedy_decode_loop.last_grid = {"form": "cluster", "clusters": clusters, "seated": seated,
                                    "rows_per_tile": rows, "tiles": -(-batch // rows),
                                    "ctas_per_cluster": heads}


# the stages of a profiled cluster launch (csrc/decode_cluster.cu N_STAGES;
# "row quantization" only under int8_w: GELU(fc1)'s slice max and int8
# slice, around the cluster barrier of its row max, which counts under
# "exchanges"; the other rows are quantized inside the LN and exchange passes)
CLUSTER_STAGES = ("embed", "projections", "self attention", "cross attention", "exchanges",
                  "LN", "vocab argmax", "token exchange", "row quantization")


def cluster_stage_clocks(params_decoder: dict, cross, cfg, steps: int) -> dict:
    """A diagnosis: one launch of the cluster kernel's profiled instance on
    the card (the same decode; not counted as a launch) -> the SM clocks
    its first CTA spent in each of ``CLUSTER_STAGES``, summed over steps."""
    k_slab, v_slab = _float_slabs(cross, torch.bfloat16)
    _, batch, s_len, _ = k_slab.shape
    if decode_form(params_decoder, cfg, steps, s_len, False, 0, "erf") != "cluster":
        raise ValueError("cluster_stage_clocks: the cluster kernel does not take this decode")
    dev = k_slab.device
    tokens = torch.empty((batch, steps + 1), dtype=torch.int32, device=dev)
    lengths = torch.empty((batch,), dtype=torch.int32, device=dev)
    prof = torch.zeros(len(CLUSTER_STAGES), dtype=torch.int64, device=dev)
    _launch_cluster(params_decoder, cfg, steps, k_slab, v_slab, None, tokens, lengths, prof=prof)
    return dict(zip(CLUSTER_STAGES, prof.tolist()))


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
    kernel: str = "auto",  # "auto" (decode_form's choice), "cluster" or "loop" (the present kernel)
    **options,  # ablate, gelu_mode, chains, head_phased, group, vocab_tile, vmem_budget_mb, interpret
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``steps`` greedy decode steps -> (tokens [B, steps+1] int32
    starting with BOS, lengths [B] int32), in any form of the module
    docstring.  CPU tensors take the plain version; CUDA tensors launch a
    kernel (``decode_form`` says which, unless ``kernel`` names one; a
    "cluster" the form or shape does not allow raises ``ValueError``, on
    any device) or raise."""
    stages, gelu_mode = _parse_options(cfg, **options)
    int8_w = _is_int8_decoder(params_decoder)
    fuse_kv = enc_raw is not None
    src = enc_raw if fuse_kv else (cross.k if cross is not None else None)
    if src is None or (fuse_kv and cross is not None):
        raise ValueError("greedy_decode_loop: give the cross slabs or enc_raw, not both")
    if kernel not in ("auto", "cluster", "loop"):
        raise ValueError(f"greedy_decode_loop: kernel {kernel!r} not in auto, cluster, loop")
    s_len = (src.shape[1] if s_valid is None else s_valid) if fuse_kv else src.shape[2]
    form = decode_form(params_decoder, cfg, steps, s_len, fuse_kv, stages, gelu_mode)
    if kernel == "cluster" and form != "cluster":
        raise ValueError("greedy_decode_loop: the cluster kernel takes bf16 or int8 weights, "
                         "the erf GELU and no ablate, at the shapes of cluster_plan (and, under "
                         "fuse_kv, of the prologue's GEMM) only")
    if kernel == "loop":
        form = "loop"
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
    stops = None
    if stop_lengths is not None:
        stops = torch.as_tensor(stop_lengths, dtype=torch.int32, device=dev).contiguous()
        if stops.shape != (batch,):
            raise ValueError(f"greedy_decode_loop: stop_lengths must be [{batch}]")
    tokens = torch.empty((batch, steps + 1), dtype=torch.int32, device=dev)
    lengths = torch.empty((batch,), dtype=torch.int32, device=dev)
    forms = tuple(f for f, on in (("int8_w", int8_w), ("fuse_kv", fuse_kv)) if on)
    if form == "cluster":
        if fuse_kv:
            k_slab, v_slab = cross_kv_prologue(params_decoder, enc_raw, s_len, enc_final_ln,
                                               cfg.layer_norm_eps)
        _launch_cluster(params_decoder, cfg, steps, k_slab, v_slab, stops, tokens, lengths)
        _count(("cluster",) + forms)
        return tokens, lengths
    if fuse_kv:  # the kernel writes each block's slabs here before its first step
        k_slab = torch.empty((n_layers, batch, s_len, d), dtype=torch.bfloat16, device=dev)
        v_slab = torch.empty_like(k_slab)

    # the kernels that read ablate / the sigmoid GELU are built for one row
    # per block only (diagnosis forms; compiled apart from the serving ones)
    opts = bool(stages) or gelu_mode == "sigmoid"

    def smem_of(r):
        return _smem_bytes(r, d, heads, inter, steps, s_len, int8_w, fuse_kv)

    rows = _loop_rows(batch, dev, int8_w, fuse_kv, opts, smem_of)
    smem = smem_of(rows)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"greedy_decode_loop: {smem} bytes of shared memory per block")

    c, layers = loop_weights(params_decoder, fuse_kv)
    cache_k = torch.empty((n_layers, batch, steps, d), dtype=torch.bfloat16, device=dev)
    cache_v = torch.empty_like(cache_k)
    tensors = [*c.values(), *(t for w in layers for t in w if t is not None)]
    if final_ln is not None:
        tensors += final_ln
    _check_ptrs(tensors, dev)
    ptrs = [c[k].data_ptr() for k in (
        "tok_emb", "pos_emb", "tok_type", "elns", "elnb", "twt", "tbt", "hlns", "hlnb",
        "wp", "bp",
    )]
    ptrs += [k_slab.data_ptr(), v_slab.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
             _ptr(stops), _ptr(enc_raw), *(_ptr(t) for t in (final_ln or (None, None)))]
    for w in layers:
        ptrs += [_ptr(t) for t in w]
    ints = [batch, d, heads, inter, vocab, n_layers, s_len, steps,
            cfg.bos_token_id, cfg.eos_token_id, cfg.pad_token_id, rows, int(int8_w), int(fuse_kv),
            s_enc, stages, int(gelu_mode == "sigmoid")]
    launch.decode_loop(ptrs, ints, 1.0 / (dh**0.5), cfg.layer_norm_eps, tokens, lengths)
    greedy_decode_loop.last_grid = {
        "form": "loop", "rows_per_block": rows, "blocks": -(-batch // rows),
        "blocks_per_sm": launch.decode_loop_blocks_per_sm(dev, int8_w, fuse_kv, opts, rows, smem)}
    _count(forms)
    return tokens, lengths


greedy_decode_loop.launches = 0  # launches of a CUDA kernel (CPU calls do not count)
# launches by form: "cluster" (every launch of the cluster kernel), "int8_w"
# (int8 decoder weights, on either kernel) and "fuse_kv" (every decode from
# the raw encoder output: the cluster kernel after its prologue, or the
# present kernel with the slabs in its launch)
greedy_decode_loop.launches_by_form = {"cluster": 0, "int8_w": 0, "fuse_kv": 0}
greedy_decode_loop.last_grid = None  # the grid of the last CUDA launch (a record for chip_smoke)
