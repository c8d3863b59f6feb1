"""Thin launchers for the C entry points of ``csrc/`` (CUDA tensors only).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reported a CUDA error.  The public kernel wrappers
(``ops.fused_mlp``, ``ops.flash_attention``, ``ops.encoder_stack``,
``ops.decode_loop``, ``ops.fused_head``, ``ops.decode_layer``) chain them.
"""

from __future__ import annotations

import ctypes

import torch

from manga_ocr_tpu_torch.kernels import build

# int8_gemm epilogues
GEMM_BF16, GEMM_GELU_F32, GEMM_RESIDUAL_BF16, GEMM_F32, GEMM_GELU_ERF_F32 = 0, 1, 2, 3, 4
_GEMM_F32_OUT = (GEMM_GELU_F32, GEMM_F32, GEMM_GELU_ERF_F32)
# bf16_gemm epilogues
BF16_GELU_ERF, BF16_GELU_SIGMOID, BF16_RESIDUAL, BF16_F32, BF16_BIAS = 0, 1, 2, 3, 4


def _expect(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _expect_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read these with 16-byte vector loads."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def ln_quant_rows(
    x: torch.Tensor, ln: tuple[torch.Tensor, torch.Tensor] | None = None, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] bf16 or f32 -> (int8 [M, K], f32 [M]): optional LN, then
    ``kernel_utils.quant_rows``."""
    m, k = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ln_quant_rows: expected bf16 or f32, got {x.dtype}")
    _expect(x, x.dtype, (m, k), "ln_quant_rows x")
    if ln is not None:
        for t, name in zip(ln, ("ln scale", "ln bias")):
            _expect(t, torch.float32, (k,), name)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = build.load()
    err = lib.mocr_ln_quant_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        ln[0].data_ptr() if ln is not None else None,
        ln[1].data_ptr() if ln is not None else None,
        int(ln is not None), float(eps), q.data_ptr(), sx.data_ptr(), m, k,
        build.stream_ptr(x.device),
    )
    build.check(err, "ln_quant_rows")
    return q, sx


def int8_gemm(
    a: torch.Tensor,
    b_t: torch.Tensor,
    sx: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor,
    mode: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """``epilogue((a[M, K] . b_t[N, K]^T) * sx[m] * sw[n] + bias[n])`` with
    ``mode`` one of GEMM_BF16 (bf16 out), GEMM_GELU_F32 (sigmoid GELU, f32
    out), GEMM_RESIDUAL_BF16 (bf16 out plus the bf16 ``residual``), GEMM_F32
    (f32 out), GEMM_GELU_ERF_F32 (erf-polynomial GELU, f32 out)."""
    m, k = a.shape
    n = b_t.shape[0]
    if k % 64 or n % 2:
        raise ValueError(f"int8_gemm: needs K % 64 == 0 and even N, got K={k} N={n}")
    _expect(a, torch.int8, (m, k), "int8_gemm a")
    _expect(b_t, torch.int8, (n, k), "int8_gemm b_t")
    _expect(sx, torch.float32, (m,), "int8_gemm sx")
    _expect(sw, torch.float32, (n,), "int8_gemm sw")
    _expect(bias, torch.float32, (n,), "int8_gemm bias")
    if mode == GEMM_RESIDUAL_BF16:
        _expect(residual, torch.bfloat16, (m, n), "int8_gemm residual")
    elif mode != GEMM_BF16 and mode not in _GEMM_F32_OUT:
        raise ValueError(f"int8_gemm: unknown mode {mode}")
    out_dtype = torch.float32 if mode in _GEMM_F32_OUT else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = build.load()
    err = lib.mocr_int8_gemm(
        a.data_ptr(), b_t.data_ptr(), sx.data_ptr(), sw.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        m, n, k, mode, build.stream_ptr(a.device),
    )
    build.check(err, "int8_gemm")
    return out


def _attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, in_strides: tuple[int, int, int],
    out: torch.Tensor, out_strides: tuple[int, int, int], batch: int, seq: int, heads: int,
    dh: int, valid_len: int, scale: float, divide: bool, sdpa_int8: bool = False,
) -> torch.Tensor:
    """The attention core on (batch, head, row) element strides, or, with
    ``sdpa_int8``, kernel A's int8 core (the softmax multiplies by the
    reciprocal); the caller has checked shapes, types and strides."""
    if dh % 2 or dh > 128 or (sdpa_int8 and (dh % 4 or divide)):
        raise ValueError(f"attention: head dim {dh} unsupported (even, <= 128; int8: dh % 4 == 0 "
                         f"and no division)")
    lib = build.load()
    if sdpa_int8:
        err = lib.mocr_attention_sdpa_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *in_strides, out.data_ptr(), *out_strides,
            int(out.dtype == torch.bfloat16), batch, seq, heads, dh, int(valid_len), float(scale),
            build.stream_ptr(q.device),
        )
    else:
        err = lib.mocr_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *in_strides, out.data_ptr(), *out_strides,
            int(out.dtype == torch.bfloat16), int(divide), batch, seq, heads, dh, int(valid_len),
            float(scale), build.stream_ptr(q.device),
        )
    build.check(err, "attention")
    return out


def attention(
    qkv: torch.Tensor, batch: int, seq: int, heads: int, valid_len: int, scale: float,
    out_dtype: torch.dtype = torch.float32, sdpa_int8: bool = False,
) -> torch.Tensor:
    """qkv [B*S, 3D] bf16 (q | k | v) -> ctx [B*S, D] in ``out_dtype`` (f32
    or bf16); the softmax multiplies by the reciprocal of its sum (kernel
    A's ``_attn_core``); ``sdpa_int8``: its int8 QK^T and PV form."""
    d = qkv.shape[1] // 3
    dh = d // heads
    if dh * heads != d:
        raise ValueError(f"attention: D={d} is not a multiple of {heads} heads")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention: output dtype {out_dtype}")
    _expect(qkv, torch.bfloat16, (batch * seq, 3 * d), "attention qkv")
    ctx = torch.empty((batch * seq, d), dtype=out_dtype, device=qkv.device)
    return _attention(qkv, qkv[:, d:], qkv[:, 2 * d:], (seq * 3 * d, dh, 3 * d), ctx,
                      (seq * d, dh, d), batch, seq, heads, dh, valid_len, scale, divide=False,
                      sdpa_int8=sdpa_int8)


def decode_loop(
    ptrs: list[int], ints: list[int], scale: float, eps: float,
    tokens: torch.Tensor, lengths: torch.Tensor,
) -> None:
    """Launch the whole-decode kernel on pointers the caller validated."""
    lib = build.load()
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    err = lib.mocr_decode_loop(
        c_ptrs, len(ptrs), c_ints, len(ints), float(scale), float(eps),
        tokens.data_ptr(), lengths.data_ptr(), build.stream_ptr(tokens.device),
    )
    build.check(err, "greedy_decode_loop")


def ln_rows_bf16(
    x: torch.Tensor, ln: tuple[torch.Tensor, torch.Tensor], eps: float
) -> torch.Tensor:
    """[M, K] bf16 -> bf16 ``ln32(x)`` (f32 statistics, one rounding)."""
    m, k = x.shape
    _expect(x, torch.bfloat16, (m, k), "ln_rows_bf16 x")
    for t, name in zip(ln, ("ln scale", "ln bias")):
        _expect(t, torch.float32, (k,), name)
    y = torch.empty_like(x)
    lib = build.load()
    err = lib.mocr_ln_rows_bf16(
        x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), float(eps), y.data_ptr(), m, k,
        build.stream_ptr(x.device),
    )
    build.check(err, "ln_rows_bf16")
    return y


def bf16_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor,
    mode: int,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """``epilogue(a[M, K] . b[K, N] + bias[N])`` in bf16 with f32
    accumulation; ``mode`` one of BF16_GELU_ERF, BF16_GELU_SIGMOID (the GELU
    in f32, then bf16), BF16_RESIDUAL (bf16, then plus the bf16
    ``residual``), BF16_F32 (f32 out) or BF16_BIAS (bf16 out)."""
    m, k = a.shape
    n = b.shape[1]
    if k % 32 or n % 8:
        raise ValueError(f"bf16_gemm: needs K % 32 == 0 and N % 8 == 0, got K={k} N={n}")
    _expect(a, torch.bfloat16, (m, k), "bf16_gemm a")
    _expect(b, torch.bfloat16, (k, n), "bf16_gemm b")
    _expect(bias, torch.float32, (n,), "bf16_gemm bias")
    _expect_aligned(a, "bf16_gemm a")
    _expect_aligned(b, "bf16_gemm b")
    if mode == BF16_RESIDUAL:
        _expect(residual, torch.bfloat16, (m, n), "bf16_gemm residual")
    elif mode not in (BF16_GELU_ERF, BF16_GELU_SIGMOID, BF16_F32, BF16_BIAS):
        raise ValueError(f"bf16_gemm: unknown mode {mode}")
    out_dtype = torch.float32 if mode == BF16_F32 else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = build.load()
    err = lib.mocr_bf16_gemm(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        m, n, k, mode, build.stream_ptr(a.device),
    )
    build.check(err, "bf16_gemm")
    return out


def attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, valid_len: int, scale: float
) -> torch.Tensor:
    """q/k/v [B, S, D] bf16 -> [B, S, D] bf16 context (softmax by division)."""
    b, s, d = q.shape
    dh = d // heads
    if dh * heads != d:
        raise ValueError(f"attention_packed: D={d} is not a multiple of {heads} heads")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _expect(t, torch.bfloat16, (b, s, d), f"attention_packed {name}")
    strides = (s * d, dh, d)
    return _attention(q, k, v, strides, torch.empty_like(q), strides, b, s, heads, dh, valid_len,
                      scale, divide=True)


def attention_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int, scale: float
) -> torch.Tensor:
    """q/k/v [B, H, S, dh] bf16 -> [B, H, S, dh] bf16 (softmax by division)."""
    b, h, s, dh = q.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _expect(t, torch.bfloat16, (b, h, s, dh), f"attention_heads {name}")
    strides = (h * s * dh, s * dh, dh)
    return _attention(q, k, v, strides, torch.empty_like(q), strides, b, s, h, dh, valid_len,
                      scale, divide=True)


def _scratch_spec(m: int, d: int, inter: int, int8: bool) -> list:
    """(shape, dtype) of each scratch array of ``csrc/encoder_layer.cu`` at
    ``m`` rows, in its order: rows, row scales, q|k|v, context, the residual
    between the halves, the MLP hidden (None: unused by the form)."""
    bf16, f32 = torch.bfloat16, torch.float32
    if int8:
        return [((m, inter), torch.int8), ((m,), f32), ((m, 3 * d), bf16), ((m, d), f32),
                ((m, d), bf16), ((m, inter), f32)]
    return [((m, d), bf16), None, ((m, 3 * d), bf16), ((m, d), bf16), ((m, d), bf16),
            ((m, inter), bf16)]


def encoder_scratch(
    m: int, d: int, inter: int, int8: bool, device
) -> tuple[torch.Tensor | None, ...]:
    """The scratch of ``encoder_layers`` at ``m`` rows."""
    return tuple(None if spec is None else torch.empty(spec[0], dtype=spec[1], device=device)
                 for spec in _scratch_spec(m, d, inter, int8))


def _expect_weights(weights: list, lead: tuple, d: int, inter: int, name: str) -> bool:
    """Check the 16 weight arrays of ``csrc/encoder_layer.cu`` (leading
    dims ``lead``); returns whether they are the int8 form."""
    if len(weights) != 16:
        raise ValueError(f"{name}: expected 16 weight arrays, got {len(weights)}")
    int8 = weights[0].dtype == torch.int8
    wdt, f32 = (torch.int8 if int8 else torch.bfloat16), torch.float32

    def mat(k, n):  # the int8 GEMM reads [N, K], the bf16 GEMM [K, N]
        return (n, k) if int8 else (k, n)

    specs = [(mat(d, 3 * d), wdt), ((3 * d,), f32), ((3 * d,), f32),
             (mat(d, d), wdt), ((d,), f32), ((d,), f32), ((d,), f32), ((d,), f32),
             (mat(d, inter), wdt), ((inter,), f32), ((inter,), f32),
             (mat(inter, d), wdt), ((d,), f32), ((d,), f32), ((d,), f32), ((d,), f32)]
    for i, (t, (shape, dtype)) in enumerate(zip(weights, specs)):
        if i in (1, 4, 9, 12) and not int8:  # int8 scales: none in the bf16 form
            if t is not None:
                raise ValueError(f"{name}: weight {i}: the bf16 form takes no scales")
            continue
        if t is None:
            raise ValueError(f"{name}: weight {i} is missing")
        _expect(t, dtype, lead + shape, f"{name} weight {i}")
    return int8


def encoder_layers(
    x: torch.Tensor, weights: list, first: int, count: int, divide: bool, scratch: tuple,
    heads: int, eps: float, scale: float, gelu_sigmoid: bool,
) -> torch.Tensor:
    """Whole pre-LN blocks [first, first + count) of stacked [L, ...] weights
    (the 16 arrays of ``ops.encoder_weights.flat_weights``) on x [B, S, D]
    bf16, in one call, with the ``encoder_scratch`` of B*S rows -> [B, S, D]
    bf16.  Kernel H is one layer with ``divide=False`` (the softmax
    multiplies by the reciprocal of its sum), kernel I a slab with
    ``divide=True``."""
    b, s, d = x.shape
    inter = weights[10].shape[-1]
    n_l = weights[0].shape[0]
    if not (0 <= first and count >= 1 and first + count <= n_l):
        raise ValueError(f"encoder_layers: layers [{first}, {first + count}) of {n_l}")
    if d % heads:
        raise ValueError(f"encoder_layers: D={d} is not a multiple of {heads} heads")
    if d % 64 or inter % 64:
        raise ValueError(f"encoder_layers: needs D and I multiples of 64, got D={d} I={inter}")
    int8 = _expect_weights(weights, (n_l,), d, inter, "encoder_layers")
    _expect(x, torch.bfloat16, (b, s, d), "encoder_layers x")
    specs = _scratch_spec(b * s, d, inter, int8)
    if len(scratch) != len(specs):
        raise ValueError(f"encoder_layers: expected {len(specs)} scratch arrays")
    for i, (t, spec) in enumerate(zip(scratch, specs)):
        if spec is None:
            if t is not None:
                raise ValueError(f"encoder_layers: scratch {i} is unused by this form")
        else:
            _expect(t, spec[1], spec[0], f"encoder_layers scratch {i}")
    c_w = (ctypes.c_void_p * 16)(*(None if t is None else t[first].data_ptr() for t in weights))
    c_s = (ctypes.c_void_p * 6)(*(None if t is None else t.data_ptr() for t in scratch))
    out = torch.empty_like(x)
    lib = build.load()
    err = lib.mocr_encoder_layers(c_w, 16, c_s, 6, x.data_ptr(), out.data_ptr(), int(count),
                                  int(int8), int(gelu_sigmoid), int(divide), b, s, d, heads,
                                  inter, float(eps), float(scale), build.stream_ptr(x.device))
    build.check(err, "encoder_layers")
    return out


def fused_head(
    x: torch.Tensor,
    wt: torch.Tensor,
    bt: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wp: torch.Tensor,
    bp: torch.Tensor,
    eps: float,
    n_split: int,
    rows_per_block: int,
) -> torch.Tensor:
    """x [B, D] bf16 -> first-argmax ids [B] int32 of the greedy head."""
    b, d = x.shape
    v = wp.shape[1]
    if d % 2 or v % (2 * n_split):
        raise ValueError(f"fused_head: unsupported D={d}, V={v}, n_split={n_split}")
    _expect(x, torch.bfloat16, (b, d), "fused_head x")
    _expect(wt, torch.bfloat16, (d, d), "fused_head wt")
    _expect(wp, torch.bfloat16, (d, v), "fused_head wp")
    for t, name, n in ((bt, "bt", d), (lns, "ln scale", d), (lnb, "ln bias", d), (bp, "bp", v)):
        _expect(t, torch.float32, (n,), f"fused_head {name}")
    part_v = torch.empty((b, n_split), dtype=torch.float32, device=x.device)
    part_i = torch.empty((b, n_split), dtype=torch.int32, device=x.device)
    ids = torch.empty((b,), dtype=torch.int32, device=x.device)
    lib = build.load()
    err = lib.mocr_fused_head(
        x.data_ptr(), wt.data_ptr(), bt.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), b, d, v, n_split, rows_per_block, float(eps),
        part_v.data_ptr(), part_i.data_ptr(), ids.data_ptr(), build.stream_ptr(x.device),
    )
    build.check(err, "fused_head")
    return ids


def self_attn_step(
    qkv: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    heads: int,
    step: int,
    scale: float,
    ctx_dtype: torch.dtype,
) -> torch.Tensor:
    """qkv [B, 3D] f32 (q | k | v) -> ctx [B, D] in ``ctx_dtype`` (f32 or
    bf16); writes k and v (rounded to bf16) into row ``step`` of the bf16
    caches [T, B, D] in place."""
    t_len, b, d = cache_k.shape
    dh = d // heads
    if dh * heads != d or not 0 <= step < t_len:
        raise ValueError(f"self_attn_step: D={d}, heads={heads}, step={step}, T={t_len}")
    _expect(qkv, torch.float32, (b, 3 * d), "self_attn_step qkv")
    _expect(cache_k, torch.bfloat16, (t_len, b, d), "self_attn_step cache_k")
    _expect(cache_v, torch.bfloat16, (t_len, b, d), "self_attn_step cache_v")
    if ctx_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"self_attn_step: ctx dtype {ctx_dtype}")
    ctx = torch.empty((b, d), dtype=ctx_dtype, device=qkv.device)
    lib = build.load()
    err = lib.mocr_self_attn_step(
        qkv.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), ctx.data_ptr(),
        int(ctx_dtype == torch.bfloat16), b, t_len, heads, dh, int(step), float(scale),
        build.stream_ptr(qkv.device),
    )
    build.check(err, "self_attn_step")
    return ctx


def cross_attn_step(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor | None,
    v_scale: torch.Tensor | None,
    heads: int,
    s_valid: int,
    scale: float,
    ctx_dtype: torch.dtype,
) -> torch.Tensor:
    """q [B, D] f32 against K/V [B, S, D] (int8 with k_scale [B, S] and
    v_scale [B, D] f32, or bf16 without scales) -> ctx [B, D] in
    ``ctx_dtype`` (f32 or bf16)."""
    b, s, d = k.shape
    dh = d // heads
    if dh * heads != d:
        raise ValueError(f"cross_attn_step: D={d}, heads={heads}")
    _expect(q, torch.float32, (b, d), "cross_attn_step q")
    int8 = k.dtype == torch.int8
    for t, name in ((k, "k"), (v, "v")):
        _expect(t, torch.int8 if int8 else torch.bfloat16, (b, s, d), f"cross_attn_step {name}")
    if int8:
        _expect(k_scale, torch.float32, (b, s), "cross_attn_step k_scale")
        _expect(v_scale, torch.float32, (b, d), "cross_attn_step v_scale")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("cross_attn_step: scales come with int8 K/V only")
    if ctx_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_attn_step: ctx dtype {ctx_dtype}")
    ctx = torch.empty((b, d), dtype=ctx_dtype, device=q.device)
    lib = build.load()
    err = lib.mocr_cross_attn_step(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None, int(int8),
        ctx.data_ptr(), int(ctx_dtype == torch.bfloat16), b, s, heads, dh, int(s_valid),
        float(scale), build.stream_ptr(q.device),
    )
    build.check(err, "cross_attn_step")
    return ctx
