"""Kernel C's plain version against the JAX ``greedy_decode_loop`` (interpret
mode on the CPU) in float32 on the same tiny weights and encoder output:
tokens and lengths must be EXACT, as in tests/test_decode_loop.py.  Covers
the ``stop_lengths`` instrument, the EOS done-masking, the cross-K/V
precompute, and the teacher-forced scorer used on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.ops.decode_loop import greedy_decode_loop as jax_loop
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.ops import decode_loop as tl
from port_config import port_config

STEPS = 11


def _setup(std, seed=0, batch=4):
    """The JAX config (``_both`` hands the port its own), the decoder's
    numpy weights and an encoder output."""
    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, seed, std=std)
    enc = np.random.default_rng(seed + 7).normal(size=(batch, cfg.encoder.seq_len, 64))
    return cfg, np_params["decoder"], enc.astype(np.float32)


def _both(cfg, np_dec, enc, stops=None):
    jcross = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=False)
    jt, jl = jax_loop(np_dec, jcross, cfg.decoder, steps=STEPS, dtype=jnp.float32,
                      head_phased=True,
                      stop_lengths=None if stops is None else jnp.asarray(stops, jnp.int32))
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    tcross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    tt, tln = tl.greedy_decode_loop(
        tdp, tcross, tcfg, STEPS, dtype=torch.float32,
        stop_lengths=None if stops is None else torch.tensor(stops, dtype=torch.int32),
    )
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tln.numpy())


@pytest.mark.parametrize("std", [0.02, 0.1], ids=["hf_init", "wide"])
def test_plain_version_matches_jax_kernel_exactly(std):
    cfg, np_dec, enc = _setup(std)
    (jt, jl), (tt, tln) = _both(cfg, np_dec, enc)
    assert tt.shape == (4, STEPS + 1) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)


def test_stop_lengths_match_jax_kernel():
    cfg, np_dec, enc = _setup(0.1, seed=1)
    stops = [2, 5, 9, 12]
    (jt, jl), (tt, tln) = _both(cfg, np_dec, enc, stops)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    assert (tln <= np.asarray(stops)).all()


def test_eos_done_masking_matches_jax_kernel():
    """A head biased toward EOS: every row emits EOS at the first step, then
    PAD, and stops counting."""
    cfg, np_dec, enc = _setup(0.02, seed=2)
    d = cfg.decoder
    np_dec["head"]["proj"]["bias"] = np_dec["head"]["proj"]["bias"].copy()
    np_dec["head"]["proj"]["bias"][d.eos_token_id] = 1e4
    (jt, jl), (tt, tln) = _both(cfg, np_dec, enc)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
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


@pytest.mark.parametrize(
    "option", [{"chains": 2}, {"ablate": "head"}, {"enc_raw": object()}, {"fuse_kv": True}]
)
def test_unported_forms_raise(option):
    cfg, np_dec, enc = _setup(0.02)
    tdp = params_from_jax(np_dec, "cpu")
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), port_config(cfg).decoder)
    with pytest.raises(NotImplementedError):
        tl.greedy_decode_loop(tdp, cross, port_config(cfg).decoder, STEPS, **option)


def test_int8_forms_raise():
    """Kernel C's int8-decoder form is not ported, and C reads float slabs
    (as the JAX kernel does): int8 slabs raise."""
    cfg, np_dec, enc = _setup(0.02)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    q = dict(tdp)
    q["layers"] = dict(tdp["layers"])
    q["layers"]["self_attn"] = dict(tdp["layers"]["self_attn"], q={"w_q": None})
    with pytest.raises(NotImplementedError):
        tl.greedy_decode_loop(q, cross, tcfg, STEPS)
    int8_cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg, int8=True)
    with pytest.raises(NotImplementedError):
        tl.greedy_decode_loop(tdp, int8_cross, tcfg, STEPS)


def test_wrapper_counts_no_cpu_launches():
    cfg, np_dec, enc = _setup(0.02)
    tdp = params_from_jax(np_dec, "cpu")
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), port_config(cfg).decoder)
    before = tl.greedy_decode_loop.launches
    tl.greedy_decode_loop(tdp, cross, port_config(cfg).decoder, 3)
    assert tl.greedy_decode_loop.launches == before
