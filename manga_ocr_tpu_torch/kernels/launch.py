"""Thin launchers for the C entry points of ``csrc/`` (CUDA tensors only).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reported a CUDA error.  The public kernel wrappers
(``ops.fused_mlp``, ``ops.flash_attention``, ``ops.decode_loop``,
``ops.fused_head``, ``ops.decode_layer``) chain them.
"""

from __future__ import annotations

import ctypes

import torch

from manga_ocr_tpu_torch.kernels import build

# int8_gemm epilogues
GEMM_BF16, GEMM_GELU_F32, GEMM_RESIDUAL_BF16, GEMM_F32, GEMM_GELU_ERF_F32 = 0, 1, 2, 3, 4
_GEMM_F32_OUT = (GEMM_GELU_F32, GEMM_F32, GEMM_GELU_ERF_F32)
# bf16_gemm epilogues
BF16_GELU_ERF, BF16_GELU_SIGMOID, BF16_RESIDUAL, BF16_F32 = 0, 1, 2, 3


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


def attention(
    qkv: torch.Tensor, batch: int, seq: int, heads: int, valid_len: int, scale: float
) -> torch.Tensor:
    """qkv [B*S, 3D] bf16 (q | k | v) -> ctx [B*S, D] f32."""
    d = qkv.shape[1] // 3
    dh = d // heads
    if dh * heads != d or dh % 2 or dh > 128:
        raise ValueError(f"attention: head dim {dh} unsupported (even, <= 128)")
    _expect(qkv, torch.bfloat16, (batch * seq, 3 * d), "attention qkv")
    ctx = torch.empty((batch * seq, d), dtype=torch.float32, device=qkv.device)
    lib = build.load()
    err = lib.mocr_attention(
        qkv.data_ptr(), ctx.data_ptr(), batch, seq, heads, dh, int(valid_len),
        float(scale), build.stream_ptr(qkv.device),
    )
    build.check(err, "attention")
    return ctx


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
    ``residual``) or BF16_F32 (f32 out)."""
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
    elif mode not in (BF16_GELU_ERF, BF16_GELU_SIGMOID, BF16_F32):
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
    """q/k/v [B, S, D] bf16 -> [B, S, D] bf16 context."""
    b, s, d = q.shape
    dh = d // heads
    if dh * heads != d or dh % 2 or dh > 128:
        raise ValueError(f"attention_packed: head dim {dh} unsupported (even, <= 128)")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _expect(t, torch.bfloat16, (b, s, d), f"attention_packed {name}")
    out = torch.empty_like(q)
    lib = build.load()
    err = lib.mocr_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, heads, dh,
        int(valid_len), float(scale), build.stream_ptr(q.device),
    )
    build.check(err, "attention_packed")
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
