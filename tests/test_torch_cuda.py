"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; without them every test skips (the
decision is made inside the fixture, never at import).  Run on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
does not need and may not have.)

Shapes are small but satisfy the kernels' constraints (both GEMMs K % 64
== 0 and N % 8 == 0, head dims multiples of
8, at most 208 keys in the attention core, vocab a multiple of 512; the
decode-step kernels J and K also at dh 96; the whole encoder blocks H and
I at D 128, I 256, three stacked layers; the attention core also at dh 16,
48 and 128 and on ragged sequence lengths).
Tolerances: see chip_smoke.py — the int8
products are exact, so encoder outputs differ by at most a few bf16 ulps of
the largest output; decode tokens are scored by the plain version fed the
kernel's tokens (teacher forcing); a head id passes when the plain logit
there is within 2^-6 of the top logit.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

pytestmark = pytest.mark.cuda

ENC_MAX_REL = 2.0**-5
DECODE_GAP_REL = 2.0**-6
HEAD_GAP_REL = 2.0**-6


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _randn(rng, shape, device, dtype=torch.float32):
    """Standard normal values made with numpy (not torch's global RNG)."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)


def _quantized_dense(rng, k, n, device):
    from manga_ocr_tpu_torch.ops.quant import quantize_weight_per_col

    w_q, scale = quantize_weight_per_col(torch.from_numpy(rng.normal(size=(k, n)) * 0.05))
    return {"w_q": w_q.to(device), "scale": scale.to(device),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(n,))).float().to(device)}


def test_attention_layer_kernel_matches_plain(device):
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    d, heads = 128, 2
    p = {n: _quantized_dense(rng, d, d, device) for n in "qkvo"}
    x = torch.from_numpy(rng.normal(size=(3, 37, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    for valid in (37, 30):
        before = fa.fused_attn_layer.launches
        got = fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid)
        want = fa.fused_attn_layer_reference(x, p, *ln, heads, valid_len=valid)
        assert fa.fused_attn_layer.launches == before + 1
        err = float((got.float() - want.float()).abs().max())
        assert err <= ENC_MAX_REL * float(want.float().abs().max())


def test_mlp_block_kernel_matches_plain(device):
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(1)
    d, inter = 128, 256
    fc1, fc2 = _quantized_dense(rng, d, inter, device), _quantized_dense(rng, inter, d, device)
    x = torch.from_numpy(rng.normal(size=(70, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    args = (x, *ln, (fc1["w_q"], fc1["scale"]), fc1["bias"], (fc2["w_q"], fc2["scale"]),
            fc2["bias"])
    got = fm.fused_mlp_block(*args, gelu_mode="sigmoid")
    want = fm.fused_mlp_block_reference(*args, gelu_mode="sigmoid")
    err = float((got.float() - want.float()).abs().max())
    assert err <= ENC_MAX_REL * float(want.float().abs().max())


def _within(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err <= ENC_MAX_REL * float(want.float().abs().max())


@pytest.mark.parametrize("form", ["pre_ln", "no_ln", "post_ln"])
def test_bf16_mlp_block_kernel_matches_plain(device, form):
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(5)
    d, inter = 128, 256
    w1 = torch.from_numpy(rng.normal(size=(d, inter)) * 0.05).to(device, torch.bfloat16)
    w2 = torch.from_numpy(rng.normal(size=(inter, d)) * 0.05).to(device, torch.bfloat16)
    b1 = torch.from_numpy(0.1 * rng.normal(size=(inter,))).float().to(device)
    b2 = torch.from_numpy(0.1 * rng.normal(size=(d,))).float().to(device)
    ln = (torch.from_numpy(1 + 0.1 * rng.normal(size=(d,))).float().to(device),
          torch.from_numpy(0.1 * rng.normal(size=(d,))).float().to(device))
    kw = {"pre_ln": dict(pre_ln=True), "no_ln": dict(pre_ln=False),
          "post_ln": dict(pre_ln=False, post_ln=True)}[form]
    for rows in (70, 5):  # partial row tiles
        x = torch.from_numpy(rng.normal(size=(rows, d))).to(device, torch.bfloat16)
        for gelu_mode in ("erf", "sigmoid"):
            before = fm.fused_mlp_block_bf16.launches
            got = fm.fused_mlp_block(x, *ln, w1, b1, w2, b2, gelu_mode=gelu_mode, **kw)
            want = fm.fused_mlp_block_bf16_reference(x, *ln, w1, b1, w2, b2,
                                                     gelu_mode=gelu_mode, **kw)
            assert fm.fused_mlp_block_bf16.launches == before + 1
            assert _within(got, want)


_GEMM_MODES = ("gelu_erf", "gelu_sigmoid", "residual", "f32", "bias")


def _gemm_case(rng, m, n, k, mode, device):
    """The bf16 GEMM (TMA + wgmma) and its plain version on one shape and
    epilogue mode; numpy-made inputs."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.fused_mlp import bf16_gemm_reference

    code = {"gelu_erf": launch.BF16_GELU_ERF, "gelu_sigmoid": launch.BF16_GELU_SIGMOID,
            "residual": launch.BF16_RESIDUAL, "f32": launch.BF16_F32,
            "bias": launch.BF16_BIAS}[mode]
    a = _randn(rng, (m, k), device, torch.bfloat16)
    b = (_randn(rng, (k, n), device) * 0.05).to(torch.bfloat16)
    bias = _randn(rng, (n,), device) * 0.1
    res = _randn(rng, (m, n), device, torch.bfloat16) if mode == "residual" else None
    got = launch.bf16_gemm(a, b, bias, code, res)
    want = bf16_gemm_reference(a, b, bias, code, res)
    assert got.dtype == want.dtype and got.shape == (m, n)
    assert bool(torch.isfinite(got.float()).all())
    return got, want


@pytest.mark.parametrize("n", [8, 768, 2304])
@pytest.mark.parametrize("m", [1, 5, 70, 197, 1000])
@pytest.mark.parametrize("mode", _GEMM_MODES)
def test_bf16_gemm_matches_plain_on_ragged_shapes(device, mode, m, n):
    """Every epilogue at ragged row counts (TMA zero-fills the rows past M;
    the stores are masked) and narrow to wide N (one partial 64-column box
    at N 8), K 768."""
    got, want = _gemm_case(np.random.default_rng(m * 7 + n), m, n, 768, mode, device)
    assert _within(got, want)


@pytest.mark.parametrize("k", [64, 128, 3072])
@pytest.mark.parametrize("mode", _GEMM_MODES)
def test_bf16_gemm_matches_plain_across_depths(device, mode, k):
    """One k tile, two, and fc2's 48 (the ring wraps many times)."""
    got, want = _gemm_case(np.random.default_rng(k), 197, 768, k, mode, device)
    assert _within(got, want)


def test_bf16_gemm_gelu_equals_gelu_erf_on_every_input(device):
    """The GEMM's GELU (common.cuh's gelu_erf<true>: the erf polynomial
    with a branch-free reciprocal) gives the bits of the division form
    that kernels B, C and F use on all 2^32 f32 inputs."""
    from manga_ocr_tpu_torch.kernels import launch

    assert launch.check_gelu_erf_rcp(device) == 0


def test_bf16_gemm_matches_plain_at_encoder_rows(device):
    """The q|k|v product at B=256: M = 256 x 197 rows, the 128 x 256 tiles
    and the persistent grid's many tiles per block."""
    got, want = _gemm_case(np.random.default_rng(11), 256 * 197, 2304, 768, "bias", device)
    assert _within(got, want)


_INT8_GEMM_MODES = ("bf16", "gelu_sigmoid", "residual", "f32", "gelu_erf")
# The GELU modes compute expf and a division, whose last bit may differ
# between the kernel's and PyTorch's builds of them; the others must be
# bit for bit (exact int32 sums, the same f32 roundings).
INT8_GELU_REL = 2.0**-20


def _int8_gemm_held(rng, m, n, k, mode, device):
    """The int8 GEMM (TMA + s8 wgmma) against its plain version on one
    shape and epilogue mode, numpy-made inputs over the whole int8 range."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.fused_mlp import int8_gemm_reference

    code = {"bf16": launch.GEMM_BF16, "gelu_sigmoid": launch.GEMM_GELU_F32,
            "residual": launch.GEMM_RESIDUAL_BF16, "f32": launch.GEMM_F32,
            "gelu_erf": launch.GEMM_GELU_ERF_F32}[mode]

    def ints(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(device)

    def scales(n_, top):
        return torch.from_numpy(rng.uniform(0.5, 1.5, n_).astype(np.float32) * top).to(device)

    args = (ints(m, k), ints(n, k), scales(m, 4.0 / 127), scales(n, 0.08 / 127),
            _randn(rng, (n,), device) * 0.1, code,
            _randn(rng, (m, n), device, torch.bfloat16) if mode == "residual" else None)
    got, want = launch.int8_gemm(*args), int8_gemm_reference(*args)
    assert got.dtype == want.dtype and got.shape == (m, n)
    assert bool(torch.isfinite(got.float()).all())
    if mode.startswith("gelu"):
        err = float((got - want).abs().max())
        return err <= INT8_GELU_REL * float(want.abs().max())
    return torch.equal(got, want)


@pytest.mark.parametrize("n", [8, 200, 768, 2304])
@pytest.mark.parametrize("m", [1, 17, 70, 197, 1000])
@pytest.mark.parametrize("mode", _INT8_GEMM_MODES)
def test_int8_gemm_matches_plain_on_ragged_shapes(device, mode, m, n):
    """Every epilogue at ragged row counts (TMA zero-fills the rows past M;
    the stores are masked) and N from one partial box row to 2304 (B_t's
    rows past N read as zeros), K 768."""
    assert _int8_gemm_held(np.random.default_rng(m * 11 + n), m, n, 768, mode, device)


@pytest.mark.parametrize("k", [64, 128, 192, 768, 3072])
@pytest.mark.parametrize("mode", _INT8_GEMM_MODES)
def test_int8_gemm_matches_plain_across_depths(device, mode, k):
    """Half a 128-k stage (TMA zero-fills the rest), one, one and a half,
    the encoder's 768 and fc2's 3072 (the ring wraps many times)."""
    assert _int8_gemm_held(np.random.default_rng(k + 1), 197, 768, k, mode, device)


@pytest.mark.parametrize("n,k,mode", [(2304, 768, "bf16"), (3072, 768, "gelu_sigmoid"),
                                      (768, 3072, "residual")])
def test_int8_gemm_matches_plain_at_encoder_rows(device, n, k, mode):
    """The encoder's products at B=256: M = 256 x 197 rows, the 128 x 256
    tiles and the persistent grid's many tiles per block."""
    assert _int8_gemm_held(np.random.default_rng(n + k), 256 * 197, n, k, mode, device)


@pytest.mark.parametrize("k,dtype", [(768, torch.bfloat16), (768, torch.float32),
                                     (3072, torch.float32), (2048, torch.float32),
                                     (8192, torch.float32), (64, torch.bfloat16),
                                     (192, torch.float32)])
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "no_ln"])
def test_ln_quant_rows_matches_plain(device, ln, m, k, dtype):
    """The row pass (a row in the registers of 1, 2, 4 or 8 warps) against
    ``quant_rows(ln32(x))``: without LN bit for bit (the row max and the
    roundings are the same); with LN the f32 statistics are summed in
    another order, which may move a value across an int8 rounding step."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.kernel_utils import ln32, quant_rows

    rng = np.random.default_rng(m * 7 + k)
    x = _randn(rng, (m, k), device, dtype) * 3.0
    lnp = (1 + 0.1 * _randn(rng, (k,), device), 0.1 * _randn(rng, (k,), device))
    q, sx = launch.ln_quant_rows(x, lnp if ln else None)
    want_q, want_sx = quant_rows(ln32(x, *lnp, 1e-12) if ln else x.float())
    if ln:
        assert int((q.int() - want_q.int()).abs().max()) <= 1
        torch.testing.assert_close(sx, want_sx[:, 0], atol=0, rtol=1e-5)
    else:
        assert torch.equal(q, want_q) and torch.equal(sx, want_sx[:, 0])


def test_packed_attention_kernel_matches_plain(device):
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 37, 128))).to(device, torch.bfloat16)
               for _ in range(3))
    for valid in (37, 30):
        before = fa.attention_packed.launches
        got = fa.attention_packed(q, k, v, 2, valid_len=valid)
        want = fa.attention_packed_reference(q, k, v, 2, valid_len=valid)
        assert fa.attention_packed.launches == before + 1
        assert got.dtype == torch.bfloat16 and _within(got, want)


@pytest.mark.parametrize("batch,d,vocab", [(3, 64, 1024), (40, 64, 1024), (1, 768, 6144),
                                            (17, 768, 6144), (40, 768, 6144), (256, 768, 6144)])
def test_greedy_head_kernel_ids_are_top_under_plain_logits(device, batch, d, vocab):
    """Kernel F (the transform on the bf16 GEMM, the row pass, the vocab
    product with its argmax epilogue, the reduce): one launch counted per
    call, each id within HEAD_GAP_REL of the plain top logit; then ties
    planted exactly (zero weight columns, the same large bias) inside one
    64-column slot, across slots of one 256-column tile and across tiles,
    each giving exactly the lowest tied id."""
    from manga_ocr_tpu_torch.ops import fused_head as fh

    rng = np.random.default_rng(7)
    w_scale = 0.2 * (64 / d) ** 0.5  # logits of one size at every width

    def t(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return torch.from_numpy(shift + scale * rng.normal(size=shape)).to(device, dtype)

    args = [t(batch, d, dtype=torch.bfloat16), t(d, d, scale=w_scale, dtype=torch.bfloat16),
            t(d, scale=0.1), t(d, scale=0.1, shift=1.0), t(d, scale=0.1),
            t(d, vocab, scale=w_scale, dtype=torch.bfloat16), t(vocab, scale=0.1)]
    before = fh.fused_greedy_head.launches
    ids = fh.fused_greedy_head(*args)
    assert fh.fused_greedy_head.launches == before + 1
    assert ids.dtype == torch.int32 and ids.shape == (batch,)
    logits = fh.head_logits_reference(*args)
    top = logits.amax(-1)
    gap = top - logits.gather(1, ids.long()[:, None])[:, 0]
    assert float((gap / top.abs()).max()) <= HEAD_GAP_REL
    for ties in ([40, 9], [200, 140], [vocab - 100, 300, vocab - 1]):
        wp, bp = args[5].clone(), args[6].clone()
        wp[:, ties] = 0
        bp[ties] = 1000.0
        ids = fh.fused_greedy_head(*args[:5], wp, bp)
        assert ids.tolist() == [min(ties)] * batch


def test_greedy_head_kernel_refuses_what_it_does_not_take(device):
    from manga_ocr_tpu_torch.ops import fused_head as fh

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    for d, x_dtype in ((96, torch.bfloat16), (64, torch.float32)):
        args = (zeros(4, d, dtype=x_dtype), zeros(d, d, dtype=torch.bfloat16), zeros(d),
                zeros(d), zeros(d), zeros(d, 512, dtype=torch.bfloat16), zeros(512))
        before = fh.fused_greedy_head.launches
        with pytest.raises(ValueError):
            fh.fused_greedy_head(*args)
        assert fh.fused_greedy_head.launches == before


def test_kernel_wrappers_reject_what_they_do_not_take(device):
    from manga_ocr_tpu_torch.kernels import launch

    a = torch.zeros((4, 96), dtype=torch.int8, device=device)  # K % 64 != 0
    with pytest.raises(ValueError):
        launch.int8_gemm(a, a, torch.zeros(4, device=device), torch.zeros(4, device=device),
                         torch.zeros(4, device=device), launch.GEMM_BF16)


def test_decode_loop_kernel_tokens_are_greedy_under_plain_model(device):
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 0, device)["decoder"], torch.bfloat16)
    enc = _randn(np.random.default_rng(20), (5, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for stops in (None, torch.tensor([2, 4, 6, 8, 30], device=device)):
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, stop_lengths=stops)
        assert tokens.shape == (5, 21) and bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        live = torch.arange(20, device=device)[None, :] + 1 < lengths[:, None]
        assert float((gaps[live] / top[live].abs()).max()) <= DECODE_GAP_REL
        if stops is not None:
            assert bool((lengths <= stops).all())


@pytest.mark.parametrize("batch", [1, 17, 40, 600])
def test_decode_cluster_kernel_tokens_are_greedy_under_plain_model(device, batch):
    """The serving form's cluster kernel (H = 4: clusters of 4 CTAs, 16-row
    tiles, the last one ragged; at B=600 more 16-row tiles than the card
    seats clusters, so wider tiles of two m16 row tiles a CTA) with stop
    lengths ending rows at different steps: a launch counted under
    "cluster", its tokens scored by the plain decoder (teacher forcing),
    lengths within the stops."""
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 3, device)["decoder"], torch.bfloat16)
    rng = np.random.default_rng(30 + batch)
    enc = _randn(rng, (batch, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    stops = torch.from_numpy(rng.integers(2, 24, size=batch).astype(np.int32)).to(device)
    for stop_lengths in (None, stops):
        before = dl.greedy_decode_loop.launches_by_form["cluster"]
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20,
                                                stop_lengths=stop_lengths, kernel="cluster")
        assert dl.greedy_decode_loop.launches_by_form["cluster"] == before + 1
        grid = dl.greedy_decode_loop.last_grid
        assert grid["form"] == "cluster" and grid["clusters"] <= grid["seated"]
        tiles16 = -(-batch // 16)
        assert grid["rows_per_tile"] == (16 if tiles16 <= grid["seated"]
                                         else -(-batch // grid["seated"]))
        assert tokens.shape == (batch, 21)
        assert bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL
        past = torch.arange(21, device=device)[None, :] >= lengths[:, None]
        assert bool((tokens[past] == cfg.decoder.pad_token_id).all())
        if stop_lengths is not None:
            assert bool((lengths <= stops).all())


def test_decode_cluster_and_present_kernel_agree_under_teacher_forcing(device):
    """The present kernel's serving form, forced with kernel="loop", on the
    same inputs: both token matrices greedy under the plain decoder."""
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 4, device)["decoder"], torch.bfloat16)
    enc = _randn(np.random.default_rng(40), (9, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for kernel in ("loop", "cluster"):
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, kernel=kernel)
        assert dl.greedy_decode_loop.last_grid["form"] == kernel
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


def _int8_decoder(seed, device):
    """The tiny decoder under quantize_decoder (int8 weights and f32 scales
    kept, the rest bf16)."""
    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder

    cfg = MangaOCRConfig.tiny()
    params = init_params(cfg, seed, device)["decoder"]
    return cfg, _cast_quantized(quantize_decoder(params), torch.bfloat16)


def test_decode_cluster_int8_and_present_kernel_agree_under_teacher_forcing(device):
    """int8_w on the cluster kernel's int8 instance (by default and under
    kernel="cluster") and on the present kernel (kernel="loop"), on the
    same inputs: each launch counted under its kernel and "int8_w", both
    token matrices greedy under the plain int8 decoder."""
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg, params = _int8_decoder(6, device)
    enc = _randn(np.random.default_rng(41), (9, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for kernel, form in (("auto", "cluster"), ("cluster", "cluster"), ("loop", "loop")):
        before = dict(dl.greedy_decode_loop.launches_by_form)
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, kernel=kernel)
        assert dl.greedy_decode_loop.last_grid["form"] == form
        after = dl.greedy_decode_loop.launches_by_form
        assert after["int8_w"] == before["int8_w"] + 1
        assert after["cluster"] == before["cluster"] + (form == "cluster")
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


@pytest.mark.parametrize("batch", [17, 40])
def test_decode_cluster_int8_with_stop_lengths_and_a_ragged_tile(device, batch):
    """The int8 instance at H = 4 (clusters of 4 CTAs, the cluster-wide
    row max over four slices) with a ragged last tile of 16 rows and stop
    lengths ending rows at different steps: tokens greedy under the plain
    int8 decoder, PAD past each length, lengths within the stops."""
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg, params = _int8_decoder(7, device)
    assert cfg.decoder.num_heads == 4
    rng = np.random.default_rng(50 + batch)
    enc = _randn(rng, (batch, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    stops = torch.from_numpy(rng.integers(2, 24, size=batch).astype(np.int32)).to(device)
    for stop_lengths in (None, stops):
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20,
                                                stop_lengths=stop_lengths, kernel="cluster")
        grid = dl.greedy_decode_loop.last_grid
        assert grid["form"] == "cluster" and grid["ctas_per_cluster"] == 4
        assert grid["rows_per_tile"] == 16 and batch % 16  # a ragged last tile
        assert tokens.shape == (batch, 21)
        assert bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL
        past = torch.arange(21, device=device)[None, :] >= lengths[:, None]
        assert bool((tokens[past] == cfg.decoder.pad_token_id).all())
        if stop_lengths is not None:
            assert bool((lengths <= stops).all())


def _live_rel_gap(gaps, top, lengths):
    live = torch.arange(gaps.shape[1], device=gaps.device)[None, :] + 1 < lengths[:, None]
    return float((gaps[live] / top[live].abs()).max())


@pytest.mark.parametrize("form", ["int8_w", "fuse_kv", "int8_w+fuse_kv"])
def test_decode_loop_new_forms_tokens_are_greedy_under_plain_model(device, form):
    """Kernel C's int8-decoder and cross-K/V-from-the-raw-output forms, all
    on the cluster kernel (int8_w on its int8 instance; fuse_kv after its
    prologue): the kernel's tokens scored by the plain decoder (teacher
    forcing); under fuse_kv on the slabs of the LN'd real rows (S_valid of
    a padded raw output)."""
    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops.common import layer_norm

    cfg = MangaOCRConfig.tiny()
    params = init_params(cfg, 0, device)["decoder"]
    if "int8_w" in form:
        params = quantize_decoder(params)
    params = _cast_quantized(params, torch.bfloat16)  # int8 weights and f32 scales kept
    s_valid = cfg.encoder.seq_len
    rng = np.random.default_rng(21)
    raw = (2 * _randn(rng, (5, s_valid + 3, 64), device) + 0.5).to(torch.bfloat16)
    fln = {"scale": 1 + 0.1 * _randn(rng, (64,), device), "bias": 0.1 * _randn(rng, (64,), device)}
    enc = layer_norm(raw[:, :s_valid], fln["scale"], fln["bias"], cfg.decoder.layer_norm_eps)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    before = dict(dl.greedy_decode_loop.launches_by_form)
    if "fuse_kv" in form:
        tokens, lengths = dl.greedy_decode_loop(params, None, cfg.decoder, 20, enc_raw=raw,
                                                s_valid=s_valid, enc_final_ln=fln)
    else:
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20)
    for f in ("int8_w", "fuse_kv"):
        assert dl.greedy_decode_loop.launches_by_form[f] == before[f] + (f in form)
    assert dl.greedy_decode_loop.launches_by_form["cluster"] == before["cluster"] + 1
    assert dl.greedy_decode_loop.last_grid["form"] == "cluster"
    assert tokens.shape == (5, 21) and bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
    gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
    assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


@pytest.mark.parametrize("final_ln", [True, False], ids=["final_ln", "no_final_ln"])
def test_cross_kv_prologue_slabs_match_plain_at_full_width(device, final_ln):
    """fuse_kv's prologue (the final LN's row pass, the bf16 GEMM into the
    slabs) at D 768, two layers, B=17 and 197 real rows of 200, against
    the plain ``_fused_cross_slabs``: the largest difference at most one
    bf16 ulp of the largest magnitude (the f32 sums differ in order only),
    the mean relative difference at most 1e-3."""
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    rng = np.random.default_rng(50)
    d, n_l, eps = 768, 2, 1e-12
    cross = {n: {"kernel": 0.02 * _randn(rng, (n_l, d, d), device),
                 "bias": 0.1 * _randn(rng, (n_l, d), device)} for n in ("k", "v")}
    params = {"layers": {"cross_attn": cross}}
    raw = (2 * _randn(rng, (17, 200, d), device) + 0.5).to(torch.bfloat16)
    fln = ({"scale": 1 + 0.1 * _randn(rng, (d,), device), "bias": 0.1 * _randn(rng, (d,), device)}
           if final_ln else None)
    got = dl.cross_kv_prologue(params, raw, 197, fln, eps)
    want = dl._fused_cross_slabs(params, raw, 197, fln, eps, torch.bfloat16)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n_l, 17, 197, d) and g.dtype == torch.bfloat16
        top = float(w.float().abs().max())
        err = (g.float() - w.float()).abs()
        assert float(err.max()) <= 2.0 ** (np.floor(np.log2(top)) - 7)
        assert float(err.mean()) <= 1e-3 * float(w.float().abs().mean())


def test_decode_fuse_kv_runs_the_cluster_route_and_loop_keeps_the_present_kernel(device):
    """fuse_kv with bf16 weights: by default the prologue and the cluster
    kernel (counted under "cluster" and "fuse_kv"); kernel="loop" the
    present kernel's fuse_kv form (counted under "fuse_kv" only); both
    token matrices greedy under the plain decoder."""
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl
    from manga_ocr_tpu_torch.ops.common import layer_norm

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 5, device)["decoder"], torch.bfloat16)
    s_valid = cfg.encoder.seq_len
    rng = np.random.default_rng(24)
    raw = (2 * _randn(rng, (9, s_valid, 64), device) + 0.5).to(torch.bfloat16)
    fln = {"scale": 1 + 0.1 * _randn(rng, (64,), device), "bias": 0.1 * _randn(rng, (64,), device)}
    enc = layer_norm(raw, fln["scale"], fln["bias"], cfg.decoder.layer_norm_eps)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for kernel, form in (("auto", "cluster"), ("loop", "loop")):
        before = dict(dl.greedy_decode_loop.launches_by_form)
        tokens, lengths = dl.greedy_decode_loop(params, None, cfg.decoder, 20, enc_raw=raw,
                                                enc_final_ln=fln, kernel=kernel)
        assert dl.greedy_decode_loop.last_grid["form"] == form
        after = dl.greedy_decode_loop.launches_by_form
        assert after["fuse_kv"] == before["fuse_kv"] + 1
        assert after["cluster"] == before["cluster"] + (form == "cluster")
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


def test_bf16_gemm_refuses_a_wrong_out(device):
    from manga_ocr_tpu_torch.kernels import launch

    a = torch.zeros((5, 64), dtype=torch.bfloat16, device=device)
    b = torch.zeros((64, 16), dtype=torch.bfloat16, device=device)
    bias = torch.zeros((16,), device=device)
    for out in (torch.empty((5, 8), dtype=torch.bfloat16, device=device),
                torch.empty((5, 16), dtype=torch.float32, device=device),
                torch.empty((16, 5), dtype=torch.bfloat16, device=device).t()):
        with pytest.raises(ValueError, match="bf16_gemm out"):
            launch.bf16_gemm(a, b, bias, launch.BF16_BIAS, out=out)
    out = torch.full((5, 16), 7.0, dtype=torch.bfloat16, device=device)
    assert launch.bf16_gemm(a, b, bias, launch.BF16_BIAS, out=out) is out
    assert bool((out == 0).all())


@pytest.mark.parametrize("options", [dict(ablate="self"), dict(ablate="cross"),
                                     dict(ablate="mlp"), dict(gelu_mode="sigmoid")],
                         ids=["self", "cross", "mlp", "sigmoid"])
def test_decode_loop_ablate_and_gelu_tokens_are_greedy_under_plain_model(device, options):
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 1, device)["decoder"], torch.bfloat16)
    enc = _randn(np.random.default_rng(22), (5, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, **options)
    gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens, **options)
    assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


def test_decode_loop_ablate_head_emits_prev_plus_one(device):
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    dcfg = dataclasses.replace(cfg.decoder, eos_token_id=1000)  # past the vocab: never emitted
    params = mdl.cast_params(init_params(cfg, 2, device)["decoder"], torch.bfloat16)
    enc = _randn(np.random.default_rng(23), (3, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, dcfg)
    steps = 30  # prev + 1 runs past the 100-id vocab: zero embedding rows
    tokens, lengths = dl.greedy_decode_loop(params, cross, dcfg, steps, ablate="head")
    want = torch.arange(2, steps + 3, device=device, dtype=torch.int32)
    assert bool((tokens == want).all()) and bool((lengths == steps + 1).all())


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_sdpa_int8_attention_layer_kernel_matches_plain(device, int8):
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(9)
    d, heads = 128, 2
    p = {n: _step_dense(rng, d, d, device, int8) for n in "qkvo"}
    x = torch.from_numpy(rng.normal(size=(3, 37, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    for valid in (37, 30):
        before = dict(fa.fused_attn_layer.launches_by_form)
        got = fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid, sdpa_int8=True)
        want = fa.fused_attn_layer_reference(x, p, *ln, heads, valid_len=valid, sdpa_int8=True)
        assert fa.fused_attn_layer.launches_by_form["sdpa_int8"] == before["sdpa_int8"] + 1
        assert _within(got, want)
        # headpack is A's default core: bit for bit
        torch.testing.assert_close(fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid,
                                                       sdpa_headpack=True),
                                   fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid),
                                   atol=0, rtol=0)


def test_unquantized_engine_runs_through_e_d_and_c(device):
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.flash_attention import attention_packed, fused_attn_layer
    from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_block_bf16

    cfg = MangaOCRConfig.tiny()
    engine = TorchMangaOcrEngine(init_params(cfg, 0, "cpu"), cfg, CharTokenizer.synthetic(),
                                 max_length=10, device=device, quantize_int8=False)
    wrappers = (attention_packed, fused_mlp_block_bf16, greedy_decode_loop, fused_attn_layer,
                fused_mlp_block)
    before = [w.launches for w in wrappers]
    crops = [np.random.default_rng(i).integers(0, 256, (40, 60, 3), dtype=np.uint8)
             for i in range(3)]
    texts = engine.ocr_page(crops)
    after = [w.launches for w in wrappers]
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    layers = cfg.encoder.num_layers
    assert [a - b for a, b in zip(after, before)] == [layers, layers, 1, 0, 0]


def test_engine_runs_through_all_three_kernels(device):
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.flash_attention import fused_attn_layer
    from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block

    cfg = MangaOCRConfig.tiny()
    engine = TorchMangaOcrEngine(init_params(cfg, 0, "cpu"), cfg, CharTokenizer.synthetic(),
                                 max_length=10, device=device)
    before = [w.launches for w in (fused_attn_layer, fused_mlp_block, greedy_decode_loop)]
    crops = [np.random.default_rng(i).integers(0, 256, (40, 60, 3), dtype=np.uint8)
             for i in range(3)]
    texts = engine.ocr_page(crops)
    after = [w.launches for w in (fused_attn_layer, fused_mlp_block, greedy_decode_loop)]
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    layers = cfg.encoder.num_layers
    assert [a - b for a, b in zip(after, before)] == [layers, layers, 1]


@pytest.mark.parametrize("quantize_int8", [True, False], ids=["int8", "bf16"])
def test_aot_engine_replays_one_graph_a_shape_bit_equal_to_eager(device, quantize_int8):
    """``aot=True``: ``warmup`` captures the shapes it warms, an unwarmed
    shape is captured at its first dispatch, and a replay launches no
    wrapper (the graph runs the kernels); every page's rows equal the eager
    engine's bit for bit on both wires, coalesced and per bucket."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop

    cfg = MangaOCRConfig.tiny()
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    page = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((40, 60), (200, 90), (30, 30), (100, 400))]
    pages = [page, page[:1], page[::-1], page[1:]]
    eager = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), max_length=10,
                                device=device, quantize_int8=quantize_int8)
    want = [eager._page_rows(eager._dispatch_page(p, 1, None)) for p in pages]
    for wire in ("gray", "packed"):
        for coalesce in (True, False):
            engine = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), max_length=10,
                                         device=device, quantize_int8=quantize_int8, wire=wire,
                                         coalesce=coalesce, aot=True)
            assert engine._aot
            engine.warmup(bucket_hws=((256, 128), (128, 128)), batch_sizes=(8,), full=True)
            assert list(engine._graphs.captures) == [((256, 128), 8), ((128, 128), 8)]
            got = [engine._page_rows(engine._dispatch_page(p, 1, None)) for p in pages]
            assert len(engine._graphs.captures) == 3  # the 512x256 bucket at its first dispatch
            before = greedy_decode_loop.launches
            dispatched = [engine._dispatch_page(p, 1, None) for p in pages]
            again = [engine._page_rows(d) for d in dispatched]
            assert greedy_decode_loop.launches == before
            for g, a, w in zip(got, again, want):
                assert len(g) == len(w)
                for x, y, z in zip(g, a, w):
                    assert np.array_equal(x, z) and np.array_equal(y, z)


def test_bench_rung2_graph_replay_is_bit_equal_to_eager_and_phase_a_runs(device):
    """The bench's rung-2 call (``benchmark.ocr_fn`` on the serving config)
    recorded by ``engine.graphs.graphed``: every replay's rows equal the
    eager call's bit for bit and launch no wrapper; phase A at the tiny
    widths emits a positive scored line."""
    import functools

    from manga_ocr_tpu_torch import benchmark as bm
    from manga_ocr_tpu_torch.engine import graphs
    from manga_ocr_tpu_torch.models.params import init_params_numpy
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop

    cfg = MangaOCRConfig.tiny(vocab_size=512)
    host = init_params_numpy(cfg, 0, std=0.1)
    sp = bm._serving_params(host, device)
    _, serving = bm.rung_configs(cfg)
    with torch.inference_mode():
        px = bm._pixels(8, cfg.encoder.image_size, device)
        call = functools.partial(bm.ocr_fn(serving), sp, px)
        eager = call()
        replay = graphs.graphed(call, graphs.Recorder(device))
        before = greedy_decode_loop.launches
        outs = [replay() for _ in range(3)]
        assert greedy_decode_loop.launches == before
    for o in outs:
        assert torch.equal(o.tokens, eager.tokens) and torch.equal(o.lengths, eager.lengths)
    lines = []
    bm.run_model_only(host, cfg, batch_sizes=(8,), iters=2, device=device, emit=lines.append)
    assert lines and lines[-1]["value"] > 0


def test_aot_engine_serves_the_step_by_step_decode_eagerly(device):
    """``serving_kernels=False`` with ``aot=True`` on one card: the
    step-by-step decode reads its "done" flags on the host, so the engine
    captures no graph, serves from its warmup on, and its rows equal the
    eager engine's."""
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params

    cfg = MangaOCRConfig.tiny()
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    page = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((40, 60), (200, 90), (30, 30))]
    engines = [TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), max_length=10,
                                   device=device, serving_kernels=False, aot=aot)
               for aot in (False, True)]
    assert not engines[1]._aot and engines[1]._graphs is None
    engines[1].warmup(bucket_hws=((128, 128),), batch_sizes=(8,), full=True)
    want, got = (e._page_rows(e._dispatch_page(page, 1, None)) for e in engines)
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _step_dense(rng, k, n, device, int8):
    if int8:
        return _quantized_dense(rng, k, n, device)
    return {"kernel": torch.from_numpy(rng.normal(size=(k, n)) * 0.05).to(device, torch.bfloat16),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(n,))).float().to(device)}


def _step_ln(rng, d, device):
    return {"scale": torch.from_numpy(1 + 0.1 * rng.normal(size=(d,))).float().to(device),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(d,))).float().to(device)}


# D 192 split into 8, 4, 2, 6 and 16 heads: the attention cores' clusters
# of 8, 4, 2, 2 (three heads a CTA) and 8 (two) CTAs; J's bf16 rows of 48,
# 96, 192, 64 and 24 bytes, K's int8 rows of 24, 48, 96, 32 and 12 (cp.async
# of 16, 8 and 4 bytes).
_STEP_HEADS = dict(argvalues=[8, 4, 2, 6, 16],
                   ids=["h8_dh24", "h4_dh48", "h2_dh96", "h6_dh32", "h16_dh12"])


def _int8_context_is_quant_rows(core, *args):
    """The core's int8 context (q, sx) equals ln_quant_rows of the same
    core's f32 context on the same inputs, bit for bit."""
    from manga_ocr_tpu_torch.kernels import launch

    ctx = core(*args, torch.float32)
    hq, sx = core(*args, torch.int8)
    want_q, want_sx = launch.ln_quant_rows(ctx)
    return torch.equal(hq, want_q) and torch.equal(sx, want_sx)


@pytest.mark.parametrize("heads", **_STEP_HEADS)
@pytest.mark.parametrize("int8_w", [True, False], ids=["int8_w", "bf16_w"])
def test_self_attn_step_kernel_matches_plain(device, int8_w, heads):
    """Kernel J on both sides of the core's first two chunk edges (its ring
    of two stages wraps at the second), at step 0 and T-1, on a cache whose
    later rows hold noise (they must weigh nothing); the written row
    against the plain version's; the int8 context against ln_quant_rows."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops import decode_layer as dl

    rng = np.random.default_rng(8)
    d, b = 192, 5
    chunk = launch.attn_step_plan(b, heads, d // heads, 1, 2, True)["chunk"]
    t_len = 2 * chunk + 6
    steps = (0, chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk, 2 * chunk + 1, t_len - 1)
    w = dl.prepare_self_attn({n: _step_dense(rng, d, d, device, int8_w) for n in "qkvo"},
                             torch.bfloat16)
    ln = _step_ln(rng, d, device)
    ck = torch.from_numpy(rng.normal(size=(t_len, b, d))).to(device, torch.bfloat16)
    cv = torch.from_numpy(rng.normal(size=(t_len, b, d))).to(device, torch.bfloat16)
    pck, pcv = ck.clone(), cv.clone()
    for step in steps:
        x = torch.from_numpy(rng.normal(size=(b, d))).to(device, torch.bfloat16)
        before = dl.fused_self_attn_step.launches
        got, _, _ = dl.fused_self_attn_step(x, w, ln, ck, cv, step, heads, 1e-12)
        want, _, _ = dl.fused_self_attn_step_reference(x, w, ln, pck, pcv, step, heads, 1e-12)
        assert dl.fused_self_attn_step.launches == before + 1
        assert got.dtype == torch.bfloat16 and _within(got, want)
        assert _within(ck[step], pck[step]) and _within(cv[step], pcv[step])
        if int8_w:
            qkv = _randn(rng, (b, 3 * d), device)
            assert _int8_context_is_quant_rows(launch.self_attn_step, qkv, ck.clone(),
                                               cv.clone(), heads, step, (d // heads) ** -0.5)


@pytest.mark.parametrize("heads", **_STEP_HEADS)
@pytest.mark.parametrize("s_valid", [37, 30])
@pytest.mark.parametrize("int8_kv", [True, False], ids=["int8_kv", "bf16_kv"])
@pytest.mark.parametrize("int8_w", [True, False], ids=["int8_w", "bf16_w"])
def test_cross_attn_step_kernel_matches_plain(device, int8_w, int8_kv, s_valid, heads):
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops import decode_layer as dl

    rng = np.random.default_rng(9)
    d, s_len, b = 192, 37, 5
    w = dl.prepare_cross_attn({n: _step_dense(rng, d, d, device, int8_w) for n in "qo"},
                              torch.bfloat16)
    ln = _step_ln(rng, d, device)
    if int8_kv:
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(b, s_len, d))).to(device, torch.int8)
                for _ in range(2))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, size=(b, s_len))).float().to(device)
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, size=(b, d))).float().to(device)
    else:
        k, v = (torch.from_numpy(rng.normal(size=(b, s_len, d))).to(device, torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    x = torch.from_numpy(rng.normal(size=(b, d))).to(device, torch.bfloat16)
    before = dl.fused_cross_attn_step.launches
    got = dl.fused_cross_attn_step(x, w, ln, k, v, ks, vs, heads, 1e-12, s_valid)
    want = dl.fused_cross_attn_step_reference(x, w, ln, k, v, ks, vs, heads, 1e-12, s_valid)
    assert dl.fused_cross_attn_step.launches == before + 1
    assert got.dtype == torch.bfloat16 and _within(got, want)
    if int8_w:
        assert _int8_context_is_quant_rows(launch.cross_attn_step, _randn(rng, (b, d), device),
                                           k, v, ks, vs, heads, s_valid, (d // heads) ** -0.5)


@pytest.mark.parametrize("d,heads", [(144, 4), (96, 16), (60, 4), (192, 1), (261, 1)],
                         ids=["dh36", "dh6", "dh15", "dh192", "dh261"])
@pytest.mark.parametrize("form", ["self", "cross_int8", "cross_bf16"])
def test_step_attention_cores_match_plain_at_any_head_dim(device, form, d, heads):
    """The attention cores alone against their plain versions where the
    chains' GEMMs (K % 64) cannot run: head rows of 72, 12 and 30 bytes
    (bf16) or 36, 6 and 15 (int8) -- cp.async of 8 and 4 bytes, and plain
    loads --, one head on one CTA, a row of 261 values read value by value
    (more vectors than threads: the context sums in shared memory), K's
    ring where a head's K and V do not fit whole, K with no valid key (a
    uniform softmax); every output form (the int8 one against quant_rows
    of the core's own f32 context, bit for bit)."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops import decode_layer as dl
    from manga_ocr_tpu_torch.ops.kernel_utils import quant_rows

    rng = np.random.default_rng(14)
    b, keys = 3, 141
    scale = (d // heads) ** -0.5
    if form == "self":
        ck = _randn(rng, (keys, b, d), device, torch.bfloat16)
        cv = _randn(rng, (keys, b, d), device, torch.bfloat16)
        q = _randn(rng, (b, 3 * d), device)
        cases = [(lambda dt, s=s, c=(ck.clone(), cv.clone()): launch.self_attn_step(
                      q, *c, heads, s, scale, dt),
                  lambda s=s, c=(ck.clone(), cv.clone()): dl.self_attn_core_reference(
                      q, *c, s, heads)) for s in (0, 129, keys - 1)]
    else:
        if form == "cross_int8":
            k, v = (torch.from_numpy(rng.integers(-127, 128, size=(b, keys, d))).to(
                device, torch.int8) for _ in range(2))
            ks = torch.from_numpy(rng.uniform(0.005, 0.02, size=(b, keys))).float().to(device)
            vs = torch.from_numpy(rng.uniform(0.005, 0.02, size=(b, d))).float().to(device)
        else:
            k, v = (_randn(rng, (b, keys, d), device, torch.bfloat16) for _ in range(2))
            ks = vs = None
        q = _randn(rng, (b, d), device)
        cases = [(lambda dt, n=n: launch.cross_attn_step(q, k, v, ks, vs, heads, n, scale, dt),
                  lambda n=n: dl.cross_attn_core_reference(q, k, v, ks, vs, heads, n))
                 for n in (keys, 129, 0)]
    for core, plain in cases:
        want = plain()
        ctx = core(torch.float32)
        assert _within(ctx, want)
        assert _within(core(torch.bfloat16), want)
        hq, sx = core(torch.int8)
        want_q, want_sx = quant_rows(ctx)
        assert torch.equal(hq, want_q) and torch.equal(sx, want_sx[:, 0])


@pytest.mark.parametrize("rows", [5, 70])
def test_mlp_step_form_kernel_matches_plain(device, rows):
    """Kernel B's int8 decoder form: LN(x + MLP(x)) with the erf GELU, with
    prepared weights and with plain (w_q, scale) tuples."""
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(10)
    d, inter = 192, 384
    fc1, fc2 = _quantized_dense(rng, d, inter, device), _quantized_dense(rng, inter, d, device)
    ln = _step_ln(rng, d, device)
    x = torch.from_numpy(rng.normal(size=(rows, d))).to(device, torch.bfloat16)
    kw = dict(pre_ln=False, post_ln=True, gelu_mode="erf")
    for w1, w2 in (((fc1["w_q"], fc1["scale"]), (fc2["w_q"], fc2["scale"])),
                   (fm.int8_weight(fc1["w_q"], fc1["scale"]),
                    fm.int8_weight(fc2["w_q"], fc2["scale"]))):
        args = (x, ln["scale"], ln["bias"], w1, fc1["bias"], w2, fc2["bias"])
        before = fm.fused_mlp_block.launches
        got = fm.fused_mlp_block(*args, **kw)
        want = fm.fused_mlp_block_reference(*args, **kw)
        assert fm.fused_mlp_block.launches == before + 1
        assert got.dtype == torch.bfloat16 and _within(got, want)


def test_fused_layer_decode_runs_through_j_k_b_and_f(device):
    """The fused whole-layer step decode on a tiny int8 decoder: per step J
    and K once a layer, B once a layer, F once."""
    import dataclasses

    from manga_ocr_tpu_torch.engine.engine import _cast_quantized
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops import decode_layer as dl
    from manga_ocr_tpu_torch.ops import fused_head as fh
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    cfg = MangaOCRConfig.tiny(vocab_size=1024)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, step_kernel="fused_layer", head_kernel="fused", cross_kv_int8=True))
    raw = init_params(cfg, 0, device)
    params = {"decoder": _cast_quantized(quantize_decoder(raw["decoder"]), torch.bfloat16)}
    enc = _randn(np.random.default_rng(24), (3, cfg.encoder.seq_len, 64), device, torch.bfloat16)
    wrappers = (dl.fused_self_attn_step, dl.fused_cross_attn_step, fm.fused_mlp_block,
                fh.fused_greedy_head)
    before = [w.launches for w in wrappers]
    out = mdl.greedy_decode(params, enc, cfg, max_length=9, chunk_size=4)
    eos = out.tokens[:, 1:] == cfg.decoder.eos_token_id
    steps = 4 if bool(eos[:, :4].any(1).all()) else 8  # the loop stops after a chunk
    layers = cfg.decoder.num_layers
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        layers * steps, layers * steps, layers * steps, steps]
    assert out.tokens.shape == (3, 9) and bool((out.tokens[:, 0] == cfg.decoder.bos_token_id).all())


def _float_dense(rng, k, n, device):
    return {"kernel": torch.from_numpy(rng.normal(size=(k, n)) * 0.05).to(device, torch.bfloat16),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(n,))).float().to(device)}


def test_float_attention_layer_kernel_matches_plain(device):
    """Kernel A's bf16 form, with the weights prepared on the call and
    prepared once (ops.encoder_weights)."""
    from manga_ocr_tpu_torch.ops import flash_attention as fa
    from manga_ocr_tpu_torch.ops.fused_mlp import prepare_proj

    rng = np.random.default_rng(11)
    d, heads = 128, 2
    p = {n: _float_dense(rng, d, d, device) for n in "qkvo"}
    x = torch.from_numpy(rng.normal(size=(3, 37, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    prepared = (prepare_proj([p["q"], p["k"], p["v"]], torch.bfloat16),
                prepare_proj([p["o"]], torch.bfloat16))
    for valid in (37, 30):
        want = fa.fused_attn_layer_reference(x, p, *ln, heads, valid_len=valid)
        for prep in (None, prepared):
            before = fa.fused_attn_layer.launches
            got = fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid, prepared=prep)
            assert fa.fused_attn_layer.launches == before + 1
            assert got.dtype == torch.bfloat16 and _within(got, want)


def test_head_major_attention_kernel_matches_plain(device):
    """Kernel G on [B, H, S, dh], and kernel E unchanged beside it."""
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 2, 37, 64))).to(device, torch.bfloat16)
               for _ in range(3))
    before = fa.fused_attention.launches
    got = fa.fused_attention(q, k, v)
    assert fa.fused_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and _within(got, fa.fused_attention_reference(q, k, v))
    # the same heads packed as [B, S, H*dh] through kernel E: the same core
    packed = [t.transpose(1, 2).reshape(3, 37, 128).contiguous() for t in (q, k, v)]
    e = fa.attention_packed(*packed, 2)
    torch.testing.assert_close(e, got.transpose(1, 2).reshape(3, 37, 128), atol=0, rtol=0)


def _core_inputs(layout, rng, b, s, heads, dh, device):
    """q, k, v in a layout the attention core reads (A's q|k|v GEMM output,
    E's packed [B, S, D], G's [B, H, S, dh]), their (batch, head, row)
    strides, an output of the layout's shape with its strides, and the
    [B, H, S, dh] view of either."""
    d = heads * dh
    if layout == "heads":
        q, k, v = (_randn(rng, (b, heads, s, dh), device, torch.bfloat16) for _ in range(3))
        strides = (heads * s * dh, s * dh, dh)
        return (q, k, v), strides, (b, heads, s, dh), strides, lambda t: t
    if layout == "qkv":
        qkv = _randn(rng, (b * s, 3 * d), device, torch.bfloat16)
        q, k, v = qkv, qkv[:, d:], qkv[:, 2 * d:]
        strides = (s * 3 * d, dh, 3 * d)
    else:
        q, k, v = (_randn(rng, (b, s, d), device, torch.bfloat16) for _ in range(3))
        strides = (s * d, dh, d)

    def view(t):
        return t.reshape(b, s, -1)[..., :d].reshape(b, s, heads, dh).transpose(1, 2)
    return (q, k, v), strides, (b, s, d), (s * d, dh, d), view


@pytest.mark.parametrize("divide", [True, False], ids=["divide", "reciprocal"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 48, 64, 128])
@pytest.mark.parametrize("layout", ["qkv", "packed", "heads"])
def test_attention_core_matches_plain_on_ragged_shapes(device, layout, dh, out_dtype, divide):
    """The tensor-core attention core shared by A, E, G, H and I against
    its plain version: partial query and key tiles (S = 5, 17, 37, 197), a
    whole tile (16), the key mask (valid_len = S - 3); each head-dim form
    (16, 64, 128) and a head dim that the 64 form pads with zero columns
    (48)."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.flash_attention import _sdpa_reference

    rng = np.random.default_rng(15)
    heads, b = 3, 2
    for s in (5, 16, 17, 37, 197):
        (q, k, v), strides, out_shape, out_strides, view = _core_inputs(layout, rng, b, s, heads,
                                                                        dh, device)
        for valid in (s, s - 3):
            out = torch.empty(out_shape, dtype=out_dtype, device=device)
            launch._attention(q, k, v, strides, out, out_strides, b, s, heads, dh, valid,
                              1.0 / dh**0.5, divide)
            want = _sdpa_reference(view(q).float(), view(k).float(), view(v).float(), valid,
                                   divide, torch.bfloat16).to(out_dtype)
            assert _within(view(out), want), (s, valid)


def _layer_params(rng, device, int8, layers=None):
    """One layer's params (D 128, 2 heads, I 256), or ``layers`` stacked
    [L, ...] layers'; float weights stay f32 (the kernels and the plain
    versions round them to bf16)."""
    from manga_ocr_tpu_torch.models.config import EncoderConfig
    from manga_ocr_tpu_torch.models.params import init_params, layer_params
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder

    cfg = MangaOCRConfig(encoder=EncoderConfig(hidden_size=128, num_heads=2,
                                               intermediate_size=256, num_layers=layers or 1))
    enc = init_params(cfg, int(rng.integers(1 << 30)), device, std=0.05)["encoder"]
    for ln in ("ln1", "ln2"):
        for name, shift in (("scale", 1.0), ("bias", 0.0)):
            t = enc["layers"][ln][name]
            enc["layers"][ln][name] = shift + 0.1 * _randn(rng, tuple(t.shape), device)
    if int8:
        enc = quantize_encoder(enc, quantize_attn_proj=True)
    return enc["layers"] if layers else layer_params(enc["layers"], 0)


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_encoder_layer_kernel_matches_plain(device, int8, gelu_mode):
    """Kernel H: one C entry point per block, int8 and bf16."""
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(13)
    lp = _layer_params(rng, device, int8)
    x = torch.from_numpy(rng.normal(size=(3, 37, 128))).to(device, torch.bfloat16)
    before = fa.fused_encoder_layer.launches
    got = fa.fused_encoder_layer(x, lp, 2, gelu_mode=gelu_mode)
    assert fa.fused_encoder_layer.launches == before + 1
    want = fa.fused_encoder_layer_reference(x, lp, 2, gelu_mode=gelu_mode)
    assert got.dtype == torch.bfloat16 and _within(got, want)


@pytest.mark.parametrize("lpc", [1, 2, 3])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_encoder_stack_kernel_matches_plain(device, int8, lpc):
    """Kernel I over three stacked layers: ceil(3 / lpc) slab calls."""
    from manga_ocr_tpu_torch.ops import encoder_stack as es

    rng = np.random.default_rng(14)
    layers = _layer_params(rng, device, int8, layers=3)
    x = torch.from_numpy(rng.normal(size=(3, 37, 128))).to(device, torch.bfloat16)
    before = es.encoder_stack.launches
    got = es.encoder_stack(x, layers, 2, lpc=lpc, gelu_mode="sigmoid")
    assert es.encoder_stack.launches == before + -(-3 // lpc)
    want = es.encoder_stack_reference(x, layers, 2, lpc=lpc, gelu_mode="sigmoid")
    assert got.dtype == torch.bfloat16 and _within(got, want)


def test_merged_layer_engine_runs_through_h_and_c(device):
    """The reference engine (cfg as given) on a merged_layer encoder with
    the whole-loop decode: H once per layer, C once."""
    import dataclasses

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.flash_attention import fused_encoder_layer

    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attn_kernel="merged_layer"),
        decoder=dataclasses.replace(cfg.decoder, step_kernel="fused_loop"))
    engine = TorchMangaOcrEngine(init_params(cfg, 0, "cpu"), cfg, CharTokenizer.synthetic(),
                                 max_length=10, device=device, serving_kernels=False)
    before = [w.launches for w in (fused_encoder_layer, greedy_decode_loop)]
    crops = [np.random.default_rng(i).integers(0, 256, (40, 60, 3), dtype=np.uint8)
             for i in range(3)]
    texts = engine.ocr_page(crops)
    after = [w.launches for w in (fused_encoder_layer, greedy_decode_loop)]
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    assert [a - b for a, b in zip(after, before)] == [cfg.encoder.num_layers, 1]
