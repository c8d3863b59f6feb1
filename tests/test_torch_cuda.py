"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; without them every test skips (the
decision is made inside the fixture, never at import).  Run on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
does not need and may not have.)

Shapes are small but satisfy the kernels' constraints (int8 GEMM K % 64 ==
0 and even N, bf16 GEMM K % 32 == 0 and N % 8 == 0, head dims multiples of
8, vocab a multiple of 512; the decode-step kernels J and K also at dh 96;
the whole encoder blocks H and I at D 128, I 256, three stacked layers).
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


@pytest.mark.parametrize("batch", [3, 40])
def test_greedy_head_kernel_ids_are_top_under_plain_logits(device, batch):
    from manga_ocr_tpu_torch.ops import fused_head as fh

    rng = np.random.default_rng(7)
    d, vocab = 64, 1024

    def t(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return torch.from_numpy(shift + scale * rng.normal(size=shape)).to(device, dtype)

    args = (t(batch, d, dtype=torch.bfloat16), t(d, d, scale=0.2, dtype=torch.bfloat16),
            t(d, scale=0.1), t(d, scale=0.1, shift=1.0), t(d, scale=0.1),
            t(d, vocab, scale=0.2, dtype=torch.bfloat16), t(vocab, scale=0.1))
    before = fh.fused_greedy_head.launches
    ids = fh.fused_greedy_head(*args)
    assert fh.fused_greedy_head.launches == before + 1
    assert ids.dtype == torch.int32 and ids.shape == (batch,)
    logits = fh.head_logits_reference(*args)
    top = logits.amax(-1)
    gap = top - logits.gather(1, ids.long()[:, None])[:, 0]
    assert float((gap / top.abs()).max()) <= HEAD_GAP_REL


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
    enc = torch.randn((5, cfg.encoder.seq_len, 64), device=device).to(torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for stops in (None, torch.tensor([2, 4, 6, 8, 30], device=device)):
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, stop_lengths=stops)
        assert tokens.shape == (5, 21) and bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        live = torch.arange(20, device=device)[None, :] + 1 < lengths[:, None]
        assert float((gaps[live] / top[live].abs()).max()) <= DECODE_GAP_REL
        if stops is not None:
            assert bool((lengths <= stops).all())


def _live_rel_gap(gaps, top, lengths):
    live = torch.arange(gaps.shape[1], device=gaps.device)[None, :] + 1 < lengths[:, None]
    return float((gaps[live] / top[live].abs()).max())


@pytest.mark.parametrize("form", ["int8_w", "fuse_kv", "int8_w+fuse_kv"])
def test_decode_loop_new_forms_tokens_are_greedy_under_plain_model(device, form):
    """Kernel C's int8-decoder and in-kernel cross-K/V forms: the kernel's
    tokens scored by the plain decoder (teacher forcing); under fuse_kv on
    the slabs of the LN'd real rows (S_valid of a padded raw output)."""
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
    raw = (2 * torch.randn((5, s_valid + 3, 64), device=device) + 0.5).to(torch.bfloat16)
    fln = {"scale": 1 + 0.1 * torch.randn(64, device=device),
           "bias": 0.1 * torch.randn(64, device=device)}
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
    assert tokens.shape == (5, 21) and bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
    gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
    assert _live_rel_gap(gaps, top, lengths) <= DECODE_GAP_REL


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
    enc = torch.randn((5, cfg.encoder.seq_len, 64), device=device).to(torch.bfloat16)
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
    enc = torch.randn((3, cfg.encoder.seq_len, 64), device=device).to(torch.bfloat16)
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


def _step_dense(rng, k, n, device, int8):
    if int8:
        return _quantized_dense(rng, k, n, device)
    return {"kernel": torch.from_numpy(rng.normal(size=(k, n)) * 0.05).to(device, torch.bfloat16),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(n,))).float().to(device)}


def _step_ln(rng, d, device):
    return {"scale": torch.from_numpy(1 + 0.1 * rng.normal(size=(d,))).float().to(device),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(d,))).float().to(device)}


@pytest.mark.parametrize("heads", [2, 4], ids=["dh96", "dh48"])
@pytest.mark.parametrize("int8_w", [True, False], ids=["int8_w", "bf16_w"])
def test_self_attn_step_kernel_matches_plain(device, int8_w, heads):
    """Kernel J at steps 0, 5 and T-1 of a cache whose later rows hold
    noise (they must weigh nothing); the written row against the plain
    version's."""
    from manga_ocr_tpu_torch.ops import decode_layer as dl

    rng = np.random.default_rng(8)
    d, t_len, b = 192, 12, 5
    w = dl.prepare_self_attn({n: _step_dense(rng, d, d, device, int8_w) for n in "qkvo"},
                             torch.bfloat16)
    ln = _step_ln(rng, d, device)
    ck = torch.from_numpy(rng.normal(size=(t_len, b, d))).to(device, torch.bfloat16)
    cv = torch.from_numpy(rng.normal(size=(t_len, b, d))).to(device, torch.bfloat16)
    pck, pcv = ck.clone(), cv.clone()
    for step in (0, 5, t_len - 1):
        x = torch.from_numpy(rng.normal(size=(b, d))).to(device, torch.bfloat16)
        before = dl.fused_self_attn_step.launches
        got, _, _ = dl.fused_self_attn_step(x, w, ln, ck, cv, step, heads, 1e-12)
        want, _, _ = dl.fused_self_attn_step_reference(x, w, ln, pck, pcv, step, heads, 1e-12)
        assert dl.fused_self_attn_step.launches == before + 1
        assert got.dtype == torch.bfloat16 and _within(got, want)
        assert _within(ck[step], pck[step]) and _within(cv[step], pcv[step])


@pytest.mark.parametrize("s_valid", [37, 30])
@pytest.mark.parametrize("int8_kv", [True, False], ids=["int8_kv", "bf16_kv"])
@pytest.mark.parametrize("int8_w", [True, False], ids=["int8_w", "bf16_w"])
def test_cross_attn_step_kernel_matches_plain(device, int8_w, int8_kv, s_valid):
    from manga_ocr_tpu_torch.ops import decode_layer as dl

    rng = np.random.default_rng(9)
    d, heads, s_len, b = 192, 2, 37, 5
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
    enc = torch.randn((3, cfg.encoder.seq_len, 64), device=device).to(torch.bfloat16)
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
            enc["layers"][ln][name] = shift + 0.1 * torch.randn(t.shape, device=device)
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
