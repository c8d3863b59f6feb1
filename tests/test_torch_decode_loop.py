"""Kernel C's plain version against the JAX ``greedy_decode_loop`` (interpret
mode on the CPU) in float32 on the same tiny weights and encoder output:
tokens and lengths must be EXACT, as in tests/test_decode_loop.py.  Every
form of the JAX kernel: bf16 and int8 (``quantize_decoder``) decoder
weights; precomputed slabs (float, or int8 ones, which both dequantize) and
``fuse_kv`` (the raw encoder output, its final LN and the cross-K/V
projections in the loop, also on JAX's own seq-padded encoder output);
``ablate`` of each stage; the sigmoid GELU; the TPU scheduling knobs, which
change no token and must be positive.  Also the ``stop_lengths`` instrument,
the EOS done-masking, the cross-K/V precompute, and the teacher-forced
scorer used on the card."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models import vit as jvit
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.quantize import quantize_decoder as jax_quantize_decoder
from manga_ocr_tpu.ops.decode_loop import greedy_decode_loop as jax_loop
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.ops import decode_loop as tl
from manga_ocr_tpu_torch.ops.common import layer_norm
from port_config import port_config

STEPS = 11
S_PAD, S_VALID = 8, 5  # fuse_kv: raw encoder rows, of which the first S_VALID are real


def _setup(std, seed=0, batch=4, int8_w=False):
    """The JAX config (``_both`` hands the port its own), the decoder's
    numpy weights (JAX-quantized for ``int8_w``) and an encoder output."""
    cfg = MangaOCRConfig.tiny()
    np_dec = init_params_numpy(cfg, seed, std=std)["decoder"]
    if int8_w:
        np_dec = jax.tree.map(np.asarray, jax_quantize_decoder(np_dec))
    enc = np.random.default_rng(seed + 7).normal(size=(batch, cfg.encoder.seq_len, 64))
    return cfg, np_dec, enc.astype(np.float32)


def _raw_encoder(seed, batch=4, d=64):
    """A raw (pre-final-LN) encoder output of S_PAD rows and a final LN."""
    rng = np.random.default_rng(seed + 13)
    raw = (2.0 * rng.normal(size=(batch, S_PAD, d)) + 0.5).astype(np.float32)
    ln = {"scale": (1 + 0.2 * rng.normal(size=(d,))).astype(np.float32),
          "bias": (0.2 * rng.normal(size=(d,))).astype(np.float32)}
    return raw, ln


def _run_both(cfg, np_dec, cross_j, cross_t, stops=None, **kw):
    """The JAX kernel and the port's wrapper on the same inputs; ``kw`` go
    to both (numpy values become each package's arrays)."""
    def conv(v, mod):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v) if mod == "jax" else torch.from_numpy(v)
        if isinstance(v, dict):
            return {k: conv(a, mod) for k, a in v.items()}
        return v

    jt, jl = jax_loop(np_dec, cross_j, cfg.decoder, steps=STEPS, dtype=jnp.float32,
                      stop_lengths=None if stops is None else jnp.asarray(stops, jnp.int32),
                      **{k: conv(v, "jax") for k, v in kw.items()})
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    tt, tln = tl.greedy_decode_loop(
        tdp, cross_t(tdp, tcfg) if callable(cross_t) else cross_t, tcfg, STEPS,
        dtype=torch.float32,
        stop_lengths=None if stops is None else torch.tensor(stops, dtype=torch.int32),
        **{k: conv(v, "torch") for k, v in kw.items()},
    )
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tln.numpy())


def _both(cfg, np_dec, enc, stops=None, **kw):
    """Precomputed float slabs from ``enc``."""
    jcross = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=False)
    return _run_both(cfg, np_dec, jcross,
                     lambda tdp, tcfg: tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc),
                                                                       tcfg),
                     stops, **kw)


def _assert_same(pair):
    (jt, jl), (tt, tln) = pair
    assert tt.shape == jt.shape and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    return tt, tln


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
@pytest.mark.parametrize("std", [0.02, 0.1], ids=["hf_init", "wide"])
def test_plain_version_matches_jax_kernel_exactly(std, int8_w):
    cfg, np_dec, enc = _setup(std, int8_w=int8_w)
    tt, _ = _assert_same(_both(cfg, np_dec, enc, head_phased=True))
    assert tt.shape == (4, STEPS + 1)


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_stop_lengths_match_jax_kernel(int8_w):
    cfg, np_dec, enc = _setup(0.1, seed=1, int8_w=int8_w)
    stops = [2, 5, 9, 12]
    _, tln = _assert_same(_both(cfg, np_dec, enc, stops, head_phased=True))
    assert (tln <= np.asarray(stops)).all()


def test_int8_w_with_phased_head_and_chains_matches_jax():
    """JAX schedules the int8 form with two chains and the phased head
    (tests/test_decode_loop.py); the port runs the same tokens."""
    cfg, np_dec, enc = _setup(0.1, seed=2, int8_w=True)
    _assert_same(_both(cfg, np_dec, enc, head_phased=True, chains=2))


def test_int8_cross_slabs_are_dequantized_as_in_jax():
    """Int8 slabs with scales: both dequantize them before the loop."""
    cfg, np_dec, enc = _setup(0.1, seed=3)
    jcross = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=True)
    tcross = tdec.CrossKVPacked(*(torch.from_numpy(np.array(a)) for a in jcross))
    assert tcross.k.dtype == torch.int8
    tt, _ = _assert_same(_run_both(cfg, np_dec, jcross, tcross))
    assert len({tuple(r) for r in tt}) > 1


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_fuse_kv_matches_jax_kernel(int8_w):
    """fuse_kv on a raw encoder output of S_PAD rows, S_VALID real: the
    final LN (the decoder's eps) and the cross projections in the loop; the
    pad rows are never attended."""
    cfg, np_dec, _ = _setup(0.1, seed=4, int8_w=int8_w)
    raw, ln = _raw_encoder(4)
    tt, _ = _assert_same(_run_both(cfg, np_dec, None, None, enc_raw=raw, s_valid=S_VALID,
                                   enc_final_ln=ln))
    assert len({tuple(r) for r in tt}) > 1
    # the pad rows' values reach no token
    raw2 = raw.copy()
    raw2[:, S_VALID:] = 1e3
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    t2, _ = tl.greedy_decode_loop(tdp, None, tcfg, STEPS, dtype=torch.float32,
                                  enc_raw=torch.from_numpy(raw2), s_valid=S_VALID,
                                  enc_final_ln={k: torch.from_numpy(v) for k, v in ln.items()})
    np.testing.assert_array_equal(t2.numpy(), tt)


def test_fuse_kv_equals_precomputed_slabs_of_the_final_ln():
    """fuse_kv's slabs are the precompute's on the LN'd encoder rows."""
    cfg, np_dec, _ = _setup(0.1, seed=5)
    raw, ln = _raw_encoder(5)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    enc = layer_norm(torch.from_numpy(raw[:, :S_VALID]), tln["scale"], tln["bias"],
                     tcfg.layer_norm_eps)
    want = tl.greedy_decode_loop(tdp, tdec.precompute_cross_kv_packed(tdp, enc, tcfg), tcfg,
                                 STEPS, dtype=torch.float32)
    got = tl.greedy_decode_loop(tdp, None, tcfg, STEPS, dtype=torch.float32,
                                enc_raw=torch.from_numpy(raw), s_valid=S_VALID, enc_final_ln=tln)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_fuse_kv_on_jax_seq_padded_encoder_output(int8_w):
    """JAX's own raw encoder output, seq-padded 5 -> 8 (``seq_pad_to=8``,
    the pads row-local garbage), fed straight to both decodes with
    ``s_valid``, as tests/test_decode_loop.py does through ocr_forward."""
    cfg = MangaOCRConfig.tiny()
    params = init_params_numpy(cfg, 6, std=0.1)
    ecfg = dataclasses.replace(cfg.encoder, attn_kernel="fused_layer", mlp_kernel="fused",
                               seq_pad_to=S_PAD)
    px = np.random.default_rng(6).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jenc = jax.tree.map(jnp.asarray, params["encoder"])
    raw = np.asarray(jvit.encode(jenc, jnp.asarray(px), ecfg, raw_padded=True))
    assert raw.shape == (4, S_PAD, 64)
    np_dec = params["decoder"]
    if int8_w:
        np_dec = jax.tree.map(np.asarray, jax_quantize_decoder(np_dec))
    tt, _ = _assert_same(_run_both(cfg, np_dec, None, None, enc_raw=raw,
                                   s_valid=cfg.encoder.seq_len,
                                   enc_final_ln=params["encoder"]["final_ln"]))
    assert len({tuple(r) for r in tt}) > 1


@pytest.mark.parametrize("stage", ["self", "cross", "mlp", "head"])
def test_ablate_matches_jax_kernel(stage):
    """Each stage skipped; under "head" the next token is prev + 1 (BOS + 1
    is EOS with the default ids, so every row stops at step 1)."""
    cfg, np_dec, enc = _setup(0.1, seed=7)
    tt, tln = _assert_same(_both(cfg, np_dec, enc, ablate=stage))
    if stage == "head":
        np.testing.assert_array_equal(tt[:, 1], cfg.decoder.bos_token_id + 1)
        np.testing.assert_array_equal(tln, 2)


def test_ablate_head_embeds_ids_past_the_vocab_as_zero_rows():
    """prev + 1 walks past the vocab when EOS is out of reach: JAX's one-hot
    embeds such an id as a zero row; the port's gather must not index past
    its table."""
    cfg, np_dec, enc = _setup(0.1, seed=8)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, vocab_size=8, eos_token_id=100))
    np_dec = dict(np_dec, tok_embed=np_dec["tok_embed"][:8],
                  head=dict(np_dec["head"], proj={k: v[..., :8] for k, v in
                                                  np_dec["head"]["proj"].items()}))
    tt, tln = _assert_same(_both(cfg, np_dec, enc, ablate="head"))
    np.testing.assert_array_equal(tt, [list(range(2, STEPS + 3))] * 4)
    np.testing.assert_array_equal(tln, STEPS + 1)


def test_sigmoid_gelu_matches_jax_kernel():
    cfg, np_dec, enc = _setup(0.1, seed=9)
    _assert_same(_both(cfg, np_dec, enc, gelu_mode="sigmoid"))


@pytest.mark.parametrize("knobs", [dict(chains=2), dict(group=8, vocab_tile=64),
                                   dict(vmem_budget_mb=16, interpret=True, head_phased=False)],
                         ids=["chains", "group_vocab_tile", "vmem_interpret"])
def test_scheduling_knobs_change_no_token(knobs):
    cfg, np_dec, enc = _setup(0.1, seed=10)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    base = tl.greedy_decode_loop(tdp, cross, tcfg, STEPS)
    for g, w in zip(tl.greedy_decode_loop(tdp, cross, tcfg, STEPS, **knobs), base):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("bad", [dict(chains=0), dict(group=-8), dict(vocab_tile=0),
                                 dict(vmem_budget_mb=1.5), dict(gelu_mode="tanh"),
                                 dict(ablate=["head"])],
                         ids=["chains", "group", "vocab_tile", "vmem_budget_mb", "gelu_mode",
                              "ablate"])
def test_bad_options_raise(bad):
    cfg, np_dec, enc = _setup(0.02)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    for fn in (tl.greedy_decode_loop, tl.greedy_decode_loop_reference):
        with pytest.raises(ValueError):
            fn(tdp, cross, tcfg, STEPS, **bad)


def test_cross_source_must_be_one_of_two():
    cfg, np_dec, enc = _setup(0.02)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    for c, raw in ((None, None), (cross, torch.from_numpy(enc))):
        with pytest.raises(ValueError, match="not both"):
            tl.greedy_decode_loop(tdp, c, tcfg, STEPS, enc_raw=raw)


def test_model_greedy_decode_on_int8_decoder_matches_jax():
    """``model.greedy_decode`` under ``fused_loop`` on quantize_decoder
    params (kernel C's int8_w form over precomputed slabs)."""
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               step_kernel="fused_loop"))
    params = init_params_numpy(cfg, 11, std=0.1)
    params["decoder"] = jax.tree.map(np.asarray, jax_quantize_decoder(params["decoder"]))
    enc = np.random.default_rng(11).normal(size=(4, cfg.encoder.seq_len, 64)).astype(np.float32)
    want = jmdl.greedy_decode(jax.tree.map(jnp.asarray, params), jnp.asarray(enc), cfg,
                              max_length=12)
    got = tmdl.greedy_decode(params_from_jax(params, "cpu"), torch.from_numpy(enc),
                             port_config(cfg), max_length=12)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1


def test_eos_done_masking_matches_jax_kernel():
    """A head biased toward EOS: every row emits EOS at the first step, then
    PAD, and stops counting."""
    cfg, np_dec, enc = _setup(0.02, seed=2)
    d = cfg.decoder
    np_dec["head"]["proj"]["bias"] = np_dec["head"]["proj"]["bias"].copy()
    np_dec["head"]["proj"]["bias"][d.eos_token_id] = 1e4
    tt, tln = _assert_same(_both(cfg, np_dec, enc, head_phased=True))
    np.testing.assert_array_equal(tt[:, 1], d.eos_token_id)
    assert (tt[:, 2:] == d.pad_token_id).all()
    np.testing.assert_array_equal(tln, 2)


def test_cross_kv_precompute_matches_jax():
    cfg, np_dec, enc = _setup(0.1, seed=3)
    want = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=False)
    got = tdec.precompute_cross_kv_packed(params_from_jax(np_dec, "cpu"), torch.from_numpy(enc),
                                          port_config(cfg).decoder)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5, rtol=1e-5)


def test_embed_matches_jax():
    cfg, np_dec, _ = _setup(0.1, seed=4)
    toks = np.array([[2, 5, 7], [3, 0, 9]], np.int32)
    want = jdec.embed(np_dec, jnp.asarray(toks), 4, cfg.decoder)
    got = tdec.embed(params_from_jax(np_dec, "cpu"), torch.from_numpy(toks), 4,
                     port_config(cfg).decoder)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_teacher_forced_gaps_are_zero_on_own_tokens_in_bf16():
    cfg, np_dec, enc = _setup(0.1, seed=5)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc).bfloat16(), tcfg)
    tokens, lengths = tl.greedy_decode_loop(tdp, cross, tcfg, STEPS)
    gaps, top = tl.teacher_forced_gaps(tdp, cross, tcfg, tokens)
    assert gaps.shape == top.shape == (4, STEPS)
    live = torch.arange(STEPS)[None, :] + 1 < lengths[:, None]
    assert float(gaps[live].abs().max()) == 0.0
    # a token that is not the argmax shows a positive gap
    forced = tokens.clone()
    forced[:, 1] = (forced[:, 1] + 1) % cfg.decoder.vocab_size
    gaps2, _ = tl.teacher_forced_gaps(tdp, cross, tcfg, forced)
    assert bool((gaps2[:, 0] > 0).all())


def test_wrapper_counts_no_cpu_launches():
    cfg, np_dec, enc = _setup(0.02)
    tdp = params_from_jax(np_dec, "cpu")
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), port_config(cfg).decoder)
    before = (tl.greedy_decode_loop.launches, dict(tl.greedy_decode_loop.launches_by_form),
              tdec.precompute_cross_kv_packed.calls)
    tl.greedy_decode_loop(tdp, cross, port_config(cfg).decoder, 3)
    tl.greedy_decode_loop(tdp, None, port_config(cfg).decoder, 3, enc_raw=torch.from_numpy(enc))
    assert (tl.greedy_decode_loop.launches, tl.greedy_decode_loop.launches_by_form,
            tdec.precompute_cross_kv_packed.calls) == before
