"""Thin launchers for the C entry points of ``csrc/`` (CUDA tensors only).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, and launches through ``build.call``: with its
tensors' device current, on PyTorch's current stream there, raising if the
launch reported a CUDA error.  The public kernel wrappers
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


# ln_quant_rows (csrc/encoder.cu) holds a row in the registers of up to 8
# warps, at most 8 16-byte chunks a lane.
LN_QUANT_MAX_CHUNKS = 8 * 32 * 8


def ln_quant_rows(
    x: torch.Tensor, ln: tuple[torch.Tensor, torch.Tensor] | None = None, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] bf16 or f32 -> (int8 [M, K], f32 [M]): optional LN, then
    ``kernel_utils.quant_rows``.  Raises ValueError, before any build or
    launch, for what the kernel (each row in registers, read in 16-byte
    chunks) does not take: M < 1, K not a multiple of 8 or over
    LN_QUANT_MAX_CHUNKS 16-byte chunks, x or the LN parameters not 16-byte
    aligned."""
    m, k = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ln_quant_rows: expected bf16 or f32, got {x.dtype}")
    if m < 1 or k < 8 or k % 8 or k * x.element_size() > 16 * LN_QUANT_MAX_CHUNKS:
        raise ValueError(f"ln_quant_rows: needs M >= 1 and K a multiple of 8 of at most "
                         f"{LN_QUANT_MAX_CHUNKS} 16-byte chunks, got M={m} K={k} {x.dtype}")
    _expect_aligned(x, "ln_quant_rows x")
    for t, name in zip(ln or (), ("ln scale", "ln bias")):
        _expect_aligned(t, f"ln_quant_rows {name}")
    _expect(x, x.dtype, (m, k), "ln_quant_rows x")
    for t, name in zip(ln or (), ("ln scale", "ln bias")):
        _expect(t, torch.float32, (k,), name)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    build.call(
        x.device, "ln_quant_rows", "mocr_ln_quant_rows",
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        ln[0].data_ptr() if ln is not None else None,
        ln[1].data_ptr() if ln is not None else None,
        int(ln is not None), float(eps), q.data_ptr(), sx.data_ptr(), m, k,
    )
    return q, sx


# The GEMMs of csrc/gemm_sm90.cuh (the bf16 GEMM of csrc/mlp_bf16.cu, the
# int8 GEMM of csrc/gemm_int8.cu) read A and B through TMA boxes of 128
# bytes along K (and along N for the bf16 B): K a multiple of 64, rows
# 16-byte strided (N % 8 == 0), 16-byte aligned bases; their epilogues
# write 16-byte pieces, read the residual in 16-byte pieces and the
# per-column vectors (bias, int8 weight scales) in pairs.
GEMM_BK = 64


def _check_gemm(name: str, a: torch.Tensor, b: tuple, n: int, vectors: tuple,
                residual: torch.Tensor | None) -> None:
    """The shapes the GEMMs take: M >= 1, K a multiple of GEMM_BK, N a
    multiple of 8, 16-byte aligned A, B ((tensor, name)) and residual,
    8-byte aligned per-column ``vectors`` ((tensor, name) each)."""
    m, k = a.shape
    if m < 1 or k < GEMM_BK or k % GEMM_BK or n < 8 or n % 8:
        raise ValueError(f"{name}: needs M >= 1, K a multiple of {GEMM_BK} and N a multiple "
                         f"of 8, got M={m} K={k} N={n}")
    _expect_aligned(a, f"{name} a")
    _expect_aligned(b[0], f"{name} {b[1]}")
    if residual is not None:
        _expect_aligned(residual, f"{name} residual")
    for t, vname in vectors:
        if t.data_ptr() % 8:
            raise ValueError(f"{name} {vname}: expected an 8-byte aligned tensor")


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
    (f32 out), GEMM_GELU_ERF_F32 (erf-polynomial GELU, f32 out).  Raises
    ValueError, before any build or launch, for what the kernel does not
    take (``_check_gemm``)."""
    m, k = a.shape
    n = b_t.shape[0]
    _check_gemm("int8_gemm", a, (b_t, "b_t"), n, ((sw, "sw"), (bias, "bias")), residual)
    if mode != GEMM_BF16 and mode != GEMM_RESIDUAL_BF16 and mode not in _GEMM_F32_OUT:
        raise ValueError(f"int8_gemm: unknown mode {mode}")
    _expect(a, torch.int8, (m, k), "int8_gemm a")
    _expect(b_t, torch.int8, (n, k), "int8_gemm b_t")
    _expect(sx, torch.float32, (m,), "int8_gemm sx")
    _expect(sw, torch.float32, (n,), "int8_gemm sw")
    _expect(bias, torch.float32, (n,), "int8_gemm bias")
    if mode == GEMM_RESIDUAL_BF16:
        _expect(residual, torch.bfloat16, (m, n), "int8_gemm residual")
    out_dtype = torch.float32 if mode in _GEMM_F32_OUT else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    build.call(
        a.device, "int8_gemm", "mocr_int8_gemm",
        a.data_ptr(), b_t.data_ptr(), sx.data_ptr(), sw.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(), m, n, k, mode,
    )
    return out


# The attention core (csrc/encoder.cu) holds a query tile's scores over at
# most this many keys in registers, and copies q/k/v rows in 16-byte pieces.
CORE_MAX_KEYS = 208
CORE_DH_MAX = 128


def _check_core(seq: int, dh: int, name: str) -> None:
    """The shapes the attention core takes: a head dim that is a multiple
    of 8 up to 128, and at most CORE_MAX_KEYS keys."""
    if dh % 8 or not 8 <= dh <= CORE_DH_MAX:
        raise ValueError(f"{name}: head dim {dh} unsupported (a multiple of 8, <= {CORE_DH_MAX})")
    if not 1 <= seq <= CORE_MAX_KEYS:
        raise ValueError(f"{name}: sequence length {seq} unsupported (1..{CORE_MAX_KEYS} keys)")


def _attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, in_strides: tuple[int, int, int],
    out: torch.Tensor, out_strides: tuple[int, int, int], batch: int, seq: int, heads: int,
    dh: int, valid_len: int, scale: float, divide: bool, sdpa_int8: bool = False,
) -> torch.Tensor:
    """The attention core on (batch, head, row) element strides, or, with
    ``sdpa_int8``, kernel A's int8 core (the softmax multiplies by the
    reciprocal); the caller has checked shapes and types.  Raises
    ValueError, before any build or launch, for what the core does not
    take: see ``_check_core``; q/k/v element strides that are not multiples
    of 8 or bases not 16-byte aligned (its cp.async copies), odd output
    strides."""
    if sdpa_int8:
        if dh % 4 or dh > 128 or divide:
            raise ValueError(f"attention: sdpa_int8 takes head dims that are multiples of 4, "
                             f"<= 128, and no division; got dh={dh}, divide={divide}")
    else:
        _check_core(seq, dh, "attention")
        if any(st % 8 for st in in_strides):
            raise ValueError(f"attention: q/k/v element strides {tuple(in_strides)} must be "
                             f"multiples of 8 (16-byte cp.async pieces)")
        if any(st % 2 for st in out_strides):
            raise ValueError(f"attention: output element strides {tuple(out_strides)} must be "
                             f"even (pairs are stored together)")
        for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
            _expect_aligned(t, f"attention {name}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *in_strides, out.data_ptr(),
            *out_strides, int(out.dtype == torch.bfloat16))
    if sdpa_int8:
        build.call(q.device, "attention", "mocr_attention_sdpa_int8", *ptrs, batch, seq, heads,
                   dh, int(valid_len), float(scale))
    else:
        build.call(q.device, "attention", "mocr_attention", *ptrs, int(divide), batch, seq,
                   heads, dh, int(valid_len), float(scale))
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
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    build.call(
        tokens.device, "greedy_decode_loop", "mocr_decode_loop",
        c_ptrs, len(ptrs), c_ints, len(ints), float(scale), float(eps),
        tokens.data_ptr(), lengths.data_ptr(),
    )


def decode_loop_blocks_per_sm(device, int8_w: bool, fuse_kv: bool, opts: bool, rows: int,
                              smem: int) -> int:
    """Blocks of the present decode kernel's form (``rows`` per block,
    ``smem`` dynamic bytes) that one SM holds, as the CUDA runtime reports
    for the compiled kernel (its registers and shared memory)."""
    key = (torch.device(device).index, int8_w, fuse_kv, opts, rows, smem)
    if key not in _BLOCKS_PER_SM:
        out = ctypes.c_int(0)
        build.call(device, "greedy_decode_loop occupancy", "mocr_decode_loop_blocks_per_sm",
                   int(int8_w), int(fuse_kv), int(opts), rows, smem, ctypes.byref(out),
                   stream=False)
        if out.value < 1:
            raise RuntimeError(f"greedy_decode_loop: {rows} rows per block do not fit on an SM")
        _BLOCKS_PER_SM[key] = out.value
    return _BLOCKS_PER_SM[key]


_BLOCKS_PER_SM: dict = {}


def decode_cluster(
    ptrs: list[int], ints: list[int], scale: float, eps: float,
    tokens: torch.Tensor, lengths: torch.Tensor, prof: torch.Tensor | None = None,
    int8: bool = False,
) -> tuple[int, int, int]:
    """Launch kernel C's cluster kernel on pointers the caller validated
    -> (clusters launched, clusters the card seats at once
    (``cudaOccupancyMaxActiveClusters``), rows of a tile).  ``int8`` runs
    its int8_w kernel (s8 projections; each layer's pointers then end with
    the six projections' scales).  ``prof`` (int64 zeros on the card,
    one per stage) runs the profiled instance, which adds its first CTA's
    clocks per stage there."""
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    clusters = (ctypes.c_int * 3)()
    build.call(
        tokens.device, "greedy_decode_loop (cluster)", "mocr_decode_cluster",
        c_ptrs, len(ptrs), c_ints, len(ints), float(scale), float(eps), int(int8),
        tokens.data_ptr(), lengths.data_ptr(), clusters, 0 if prof is None else prof.data_ptr(),
    )
    return clusters[0], clusters[1], clusters[2]


def ln_rows_bf16(
    x: torch.Tensor, ln: tuple[torch.Tensor, torch.Tensor], eps: float
) -> torch.Tensor:
    """[M, K] bf16 -> bf16 ``ln32(x)`` (f32 statistics, one rounding)."""
    m, k = x.shape
    _expect(x, torch.bfloat16, (m, k), "ln_rows_bf16 x")
    for t, name in zip(ln, ("ln scale", "ln bias")):
        _expect(t, torch.float32, (k,), name)
    y = torch.empty_like(x)
    build.call(x.device, "ln_rows_bf16", "mocr_ln_rows_bf16",
               x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), float(eps), y.data_ptr(), m, k)
    return y


def bf16_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor,
    mode: int,
    residual: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``epilogue(a[M, K] . b[K, N] + bias[N])`` in bf16 with f32
    accumulation; ``mode`` one of BF16_GELU_ERF, BF16_GELU_SIGMOID (the GELU
    in f32, then bf16), BF16_RESIDUAL (bf16, then plus the bf16
    ``residual``), BF16_F32 (f32 out) or BF16_BIAS (bf16 out).  ``out``, if
    given, is written and returned: a contiguous [M, N] tensor of the
    output's dtype on a's device.  Raises ValueError, before any build or
    launch, for what the kernel does not take (``_check_gemm``; an ``out``
    that is not 16-byte aligned or not as above)."""
    m, k = a.shape
    n = b.shape[1]
    _check_gemm("bf16_gemm", a, (b, "b"), n, ((bias, "bias"),), residual)
    if out is not None:
        _expect_aligned(out, "bf16_gemm out")
    if mode not in (BF16_GELU_ERF, BF16_GELU_SIGMOID, BF16_RESIDUAL, BF16_F32, BF16_BIAS):
        raise ValueError(f"bf16_gemm: unknown mode {mode}")
    _expect(a, torch.bfloat16, (m, k), "bf16_gemm a")
    _expect(b, torch.bfloat16, (k, n), "bf16_gemm b")
    _expect(bias, torch.float32, (n,), "bf16_gemm bias")
    if mode == BF16_RESIDUAL:
        _expect(residual, torch.bfloat16, (m, n), "bf16_gemm residual")
    out_dtype = torch.float32 if mode == BF16_F32 else torch.bfloat16
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    else:
        _expect(out, out_dtype, (m, n), "bf16_gemm out")
        if out.device != a.device:
            raise ValueError(f"bf16_gemm out: expected a tensor on {a.device}, got {out.device}")
    build.call(
        a.device, "bf16_gemm", "mocr_bf16_gemm",
        a.data_ptr(), b.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(), m, n, k, mode,
    )
    return out


def check_gelu_erf_rcp(device) -> int:
    """The number of f32 inputs (of all 2^32 bit patterns) on which
    common.cuh's gelu_erf<true> (the bf16 GEMM's: the erf polynomial's
    reciprocal by the branch-free rcp_ge1) differs from gelu_erf<false>
    (the division); 0 is the kernel's claim."""
    mismatches = torch.zeros((1,), dtype=torch.int64, device=device)
    build.call(mismatches.device, "check_gelu_erf_rcp", "mocr_check_gelu_erf_rcp",
               mismatches.data_ptr())
    return int(mismatches.item())


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
    _check_core(s, d // heads, "encoder_layers")
    int8 = _expect_weights(weights, (n_l,), d, inter, "encoder_layers")
    for i in (0, 3, 8, 11, 6, 7, 14, 15):  # the GEMMs' B operands (TMA), the LN parameters
        _expect_aligned(weights[i][first], f"encoder_layers weight {i}")
    _expect(x, torch.bfloat16, (b, s, d), "encoder_layers x")
    _expect_aligned(x, "encoder_layers x")  # the o GEMM's residual
    specs = _scratch_spec(b * s, d, inter, int8)
    if len(scratch) != len(specs):
        raise ValueError(f"encoder_layers: expected {len(specs)} scratch arrays")
    for i, (t, spec) in enumerate(zip(scratch, specs)):
        if spec is None:
            if t is not None:
                raise ValueError(f"encoder_layers: scratch {i} is unused by this form")
        else:
            _expect(t, spec[1], spec[0], f"encoder_layers scratch {i}")
            _expect_aligned(t, f"encoder_layers scratch {i}")  # GEMM operands and outputs
    c_w = (ctypes.c_void_p * 16)(*(None if t is None else t[first].data_ptr() for t in weights))
    c_s = (ctypes.c_void_p * 6)(*(None if t is None else t.data_ptr() for t in scratch))
    out = torch.empty_like(x)
    build.call(x.device, "encoder_layers", "mocr_encoder_layers",
               c_w, 16, c_s, 6, x.data_ptr(), out.data_ptr(), int(count), int(int8),
               int(gelu_sigmoid), int(divide), b, s, d, heads, inter, float(eps), float(scale))
    return out


# Kernel F (csrc/fused_head.cu): its row pass holds a row of D f32 values
# in one warp's registers, and its vocab product writes one partial per
# row and HEAD_SLOT columns.
HEAD_MAX_D = 1024
HEAD_SLOT = 64


def fused_head(
    x: torch.Tensor,
    wt: torch.Tensor,
    bt: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wp: torch.Tensor,
    bp: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """x [B, D] bf16 -> first-argmax ids [B] int32 of the greedy head: the
    transform on the bf16 GEMM, the GELU + LN row pass, the vocab product
    with its argmax epilogue, the reduce of the slots' partials.  Raises
    ValueError, before any build or launch, for what the kernels do not
    take: D not a multiple of 64 or over HEAD_MAX_D, V not a multiple of
    HEAD_SLOT, an operand not 16-byte aligned."""
    b, d = x.shape
    v = wp.shape[1]
    if b < 1 or d < 64 or d % 64 or d > HEAD_MAX_D or v < HEAD_SLOT or v % HEAD_SLOT:
        raise ValueError(f"fused_head: needs B >= 1, D a multiple of 64 up to {HEAD_MAX_D} and "
                         f"V a multiple of {HEAD_SLOT}, got B={b} D={d} V={v}")
    _expect(x, torch.bfloat16, (b, d), "fused_head x")
    _expect(wt, torch.bfloat16, (d, d), "fused_head wt")
    _expect(wp, torch.bfloat16, (d, v), "fused_head wp")
    for t, name, n in ((bt, "bt", d), (lns, "ln scale", d), (lnb, "ln bias", d), (bp, "bp", v)):
        _expect(t, torch.float32, (n,), f"fused_head {name}")
    for t, name in ((x, "x"), (wt, "wt"), (bt, "bt"), (lns, "ln scale"), (lnb, "ln bias"),
                    (wp, "wp"), (bp, "bp")):
        _expect_aligned(t, f"fused_head {name}")
    h32 = torch.empty((b, d), dtype=torch.float32, device=x.device)
    hb = torch.empty((b, d), dtype=torch.bfloat16, device=x.device)
    part_v = torch.empty((b, v // HEAD_SLOT), dtype=torch.float32, device=x.device)
    part_i = torch.empty((b, v // HEAD_SLOT), dtype=torch.int32, device=x.device)
    ids = torch.empty((b,), dtype=torch.int32, device=x.device)
    build.call(
        x.device, "fused_head", "mocr_fused_head",
        x.data_ptr(), wt.data_ptr(), bt.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        wp.data_ptr(), bp.data_ptr(), b, d, v, float(eps), h32.data_ptr(), hb.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), ids.data_ptr(),
    )
    return ids


# Kernels J's and K's attention cores (csrc/decode_layer.cu): J streams
# its keys through a ring of STEP_STAGES stages of up to STEP_CHUNK keys
# (within STEP_RING_BYTES), and K stages a head's K and V whole (a stage
# each) where they take at most STEP_WHOLE_BYTES, else through the same
# ring.  Ring rows lie an odd number of 16-byte pieces apart
# (``_ring_stride``).
STEP_MAX_CLUSTER, STEP_STAGES = 8, 2
STEP_CHUNK, STEP_RING_BYTES, STEP_WHOLE_BYTES = 128, 96 * 1024, 128 * 1024
SMEM_LIMIT = 232448  # a block's shared memory, opted in
_STEP_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _ring_stride(row_bytes: int) -> int:
    return 16 * (-(-row_bytes // 16) | 1)


def attn_step_plan(batch: int, heads: int, dh: int, keys: int, kv_bytes: int,
                   self_attn: bool, align: int = 16) -> dict:
    """How a J (``self_attn``; ``keys`` the cache length T) or K (``keys``
    = S) attention core runs on ``batch`` rows: ``cluster`` CTAs a row (the
    largest of 8, 4, 2, 1 dividing ``heads``; ``grid`` CTAs in all; one
    thread-block cluster under the int8 output), ``heads_per_cta``, the
    cp.async ``width`` (the largest of 16, 8, 4 bytes dividing both the
    head's row of ``dh`` values of ``kv_bytes`` each and ``align``, the K/V
    bases' alignment; 0: plain loads), the ``chunk`` of keys a ring stage
    holds (K: all S where K and V fit whole), and the CTA's dynamic shared
    memory ``smem`` (``step_layout`` in the source).
    Raises ValueError for what no plan fits."""
    if batch < 1 or heads < 1 or dh < 1 or keys < 1 or kv_bytes not in (1, 2):
        raise ValueError(f"attn_step_plan: B={batch}, heads={heads}, dh={dh}, keys={keys}, "
                         f"kv_bytes={kv_bytes}")
    cluster = next(c for c in (8, 4, 2, 1) if heads % c == 0)
    hpc, row = heads // cluster, dh * kv_bytes
    width = next((w for w in (16, 8, 4) if row % w == 0 and align % w == 0), 0)
    rs = _ring_stride(row)
    if not self_attn and STEP_STAGES * keys * rs <= STEP_WHOLE_BYTES:
        chunk = keys
    else:
        chunk = max(1, min(STEP_CHUNK, STEP_RING_BYTES // (STEP_STAGES * rs)))
    scales = (_align16(keys * 4) + _align16(dh * 4)) if not self_attn and kv_bytes == 1 else 0
    smem = (_align16(STEP_STAGES * chunk * rs) + _align16((3 if self_attn else 1) * dh * 4)
            + _align16(keys * 4) + scales + _align16(dh * 4) + _align16(hpc * dh * 4)
            + (32 + STEP_MAX_CLUSTER) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attn_step_plan: {keys} keys of dh={dh} need {smem} bytes of shared "
                         f"memory, over {SMEM_LIMIT}")
    return {"cluster": cluster, "grid": batch * cluster, "heads_per_cta": hpc, "width": width,
            "chunk": chunk, "smem": smem}


def _base_align(*ts: torch.Tensor) -> int:
    """The largest power of two up to 16 dividing every tensor's address."""
    return min(16, *(t.data_ptr() & -t.data_ptr() or 16 for t in ts))


def _step_out(b: int, d: int, ctx_dtype: torch.dtype, device, name: str):
    if ctx_dtype not in _STEP_MODES:
        raise ValueError(f"{name}: ctx dtype {ctx_dtype}")
    out = torch.empty((b, d), dtype=ctx_dtype, device=device)
    sx = torch.empty((b,), dtype=torch.float32, device=device) if ctx_dtype == torch.int8 else None
    return out, sx


def self_attn_step(
    qkv: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    heads: int,
    step: int,
    scale: float,
    ctx_dtype: torch.dtype,
):
    """qkv [B, 3D] f32 (q | k | v) -> ctx [B, D] in ``ctx_dtype``: f32,
    bf16, or int8, then (q [B, D], sx [B] f32): ``quant_rows`` of the f32
    context, bit for bit.  Writes k and v (rounded to bf16) into row
    ``step`` of the bf16 caches [T, B, D] in place."""
    t_len, b, d = cache_k.shape
    dh = d // heads
    if dh * heads != d or not 0 <= step < t_len:
        raise ValueError(f"self_attn_step: D={d}, heads={heads}, step={step}, T={t_len}")
    _expect(qkv, torch.float32, (b, 3 * d), "self_attn_step qkv")
    _expect(cache_k, torch.bfloat16, (t_len, b, d), "self_attn_step cache_k")
    _expect(cache_v, torch.bfloat16, (t_len, b, d), "self_attn_step cache_v")
    out, sx = _step_out(b, d, ctx_dtype, qkv.device, "self_attn_step")
    plan = attn_step_plan(b, heads, dh, t_len, 2, True, _base_align(cache_k, cache_v))
    build.call(
        qkv.device, "self_attn_step", "mocr_self_attn_step",
        qkv.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        sx.data_ptr() if sx is not None else None, _STEP_MODES[ctx_dtype], b, t_len, heads, dh,
        int(step), float(scale), plan["cluster"], plan["width"], plan["chunk"], plan["smem"],
    )
    return (out, sx) if sx is not None else out


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
):
    """q [B, D] f32 against K/V [B, S, D] (int8 with k_scale [B, S] and
    v_scale [B, D] f32, or bf16 without scales) -> ctx [B, D] in
    ``ctx_dtype`` (f32, bf16, or int8 as ``self_attn_step``'s)."""
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
    out, sx = _step_out(b, d, ctx_dtype, q.device, "cross_attn_step")
    plan = attn_step_plan(b, heads, dh, s, k.element_size(), False, _base_align(k, v))
    build.call(
        q.device, "cross_attn_step", "mocr_cross_attn_step",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None, int(int8),
        out.data_ptr(), sx.data_ptr() if sx is not None else None, _STEP_MODES[ctx_dtype], b, s,
        heads, dh, int(s_valid), float(scale), plan["cluster"], plan["width"], plan["chunk"],
        plan["smem"],
    )
    return (out, sx) if sx is not None else out
