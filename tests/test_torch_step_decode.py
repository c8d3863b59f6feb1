"""The step-by-step greedy decode (``models.model.greedy_decode`` with
``step_kernel="xla"``) against the JAX package's, in float32 on the same
numpy-made tiny weights and encoder output: tokens and lengths must be
IDENTICAL, for the head ``xla``/``fused`` (kernel F) x step MLP
``xla``/``fused`` (kernel D, ``pre_ln=False``) x bf16/int8 cross K/V, with
``stop_lengths``, and with a ``max_length`` that is not a multiple of
``chunk_size`` (the last chunk runs past it, and past the position table);
and ``ocr_forward`` through kernel C's ``fuse_kv`` form (``fuse_cross_kv``)
on a float and an int8 decoder.
The JAX kernels run in interpret mode on the CPU; the port gets its own
config with the same fields."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.quantize import quantize_decoder as jax_quantize_decoder
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.ops import fused_head, fused_mlp
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BATCH = 4


def _cfg(head="xla", mlp="xla", int8=False):
    cfg = MangaOCRConfig.tiny(vocab_size=512)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, step_kernel="xla", head_kernel=head, step_mlp_kernel=mlp,
        cross_kv_int8=int8,
    ))


def _setup(cfg, seed=0, std=0.1):
    np_params = init_params_numpy(cfg, seed, std=std)
    rng = np.random.default_rng(seed + 11)
    enc = rng.normal(size=(BATCH, cfg.encoder.seq_len, cfg.encoder.hidden_size))
    return np_params, enc.astype(np.float32)


def _both(cfg, np_params, enc, max_length=None, chunk_size=8, stops=None):
    fn = jax.jit(functools.partial(jmdl.greedy_decode, cfg=cfg, max_length=max_length,
                                   chunk_size=chunk_size))
    want = fn(np_params, jnp.asarray(enc),
              stop_lengths=None if stops is None else jnp.asarray(stops, jnp.int32))
    got = tmdl.greedy_decode(
        params_from_jax(np_params, "cpu"), torch.from_numpy(enc), port_config(cfg), max_length,
        chunk_size,
        stop_lengths=None if stops is None else torch.tensor(stops, dtype=torch.int32),
    )
    return (np.asarray(want.tokens), np.asarray(want.lengths)), (got.tokens.numpy(),
                                                                 got.lengths.numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cross", "int8_cross"])
@pytest.mark.parametrize("mlp", ["xla", "fused"])
@pytest.mark.parametrize("head", ["xla", "fused"])
def test_greedy_decode_matches_jax_exactly(head, mlp, int8):
    cfg = _cfg(head, mlp, int8)
    np_params, enc = _setup(cfg)
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc)
    assert tt.shape == (BATCH, cfg.max_length) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    assert len({tuple(r) for r in tt}) > 1  # rows differ: the input matters


def test_stop_lengths_match_jax():
    cfg = _cfg("fused", "fused", True)
    np_params, enc = _setup(cfg, seed=1)
    stops = [2, 5, 9, 30]
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc, stops=stops)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    np.testing.assert_array_equal(tln, [2, 5, 9, cfg.max_length])
    assert (tt[0, 2:] == cfg.decoder.pad_token_id).all()


def test_max_length_past_chunks_and_position_table_matches_jax():
    """max_length 32 in chunks of 10: the last chunk runs to step 39, past
    the 32-row position table (JAX's gather clamps; so does the port)."""
    cfg = _cfg("fused", "xla")
    np_params, enc = _setup(cfg, seed=2)
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc, max_length=32, chunk_size=10)
    assert tt.shape == (BATCH, 32)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)


def test_early_exit_and_eos_masking_match_jax():
    """A head biased toward EOS: every row stops at the first step and the
    loop exits after one chunk; rows then hold PAD."""
    cfg = _cfg("fused", "fused")
    np_params, enc = _setup(cfg, seed=3)
    bias = np_params["decoder"]["head"]["proj"]["bias"].copy()
    bias[cfg.decoder.eos_token_id] = 1e4
    np_params["decoder"]["head"]["proj"]["bias"] = bias
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    np.testing.assert_array_equal(tln, 2)
    assert (tt[:, 2:] == cfg.decoder.pad_token_id).all()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_precompute_cross_kv_matches_jax(int8):
    cfg = _cfg(int8=int8)
    np_params, enc = _setup(cfg, seed=4)
    want = jdec.precompute_cross_kv(np_params["decoder"], jnp.asarray(enc), cfg.decoder)
    got = tdec.precompute_cross_kv(params_from_jax(np_params["decoder"], "cpu"),
                                   torch.from_numpy(enc), port_config(cfg).decoder)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       atol=1e-5, rtol=1e-5)


def test_decode_step_logits_match_jax():
    cfg = _cfg()
    np_params, enc = _setup(cfg, seed=5)
    dcfg, tdcfg = cfg.decoder, port_config(cfg).decoder
    jcross = jdec.precompute_cross_kv(np_params["decoder"], jnp.asarray(enc), dcfg)
    jcache = jdec.init_cache(dcfg, BATCH, 6, jnp.float32)
    tp = params_from_jax(np_params["decoder"], "cpu")
    tcross = tdec.precompute_cross_kv(tp, torch.from_numpy(enc), tdcfg)
    tcache = tdec.init_cache(tdcfg, BATCH, 6, torch.float32, "cpu")
    tok = np.array([2, 7, 9, 11], np.int32)
    for step in range(3):
        jl, jcache = jdec.decode_step(np_params["decoder"], jnp.asarray(tok), jnp.int32(step),
                                      jcache, jcross, dcfg)
        tl, tcache = tdec.decode_step(tp, torch.from_numpy(tok), step, tcache, tcross, tdcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_step_decode_counts_no_cpu_launches():
    cfg = _cfg("fused", "fused")
    np_params, enc = _setup(cfg, seed=6)
    before = (fused_head.fused_greedy_head.launches, fused_mlp.fused_mlp_block_bf16.launches)
    tmdl.greedy_decode(params_from_jax(np_params, "cpu"), torch.from_numpy(enc), port_config(cfg),
                       6)
    assert (fused_head.fused_greedy_head.launches,
            fused_mlp.fused_mlp_block_bf16.launches) == before


@pytest.mark.parametrize("int8_w", [False, True], ids=["float_decoder", "int8_decoder"])
def test_ocr_forward_fuse_cross_kv_matches_jax(int8_w):
    """``ocr_forward`` under ``fused_loop`` with ``fuse_cross_kv``: the raw
    encoder output straight into kernel C's ``fuse_kv`` form, on a float and
    on a ``quantize_decoder`` decoder (tests/test_decode_loop.py)."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, step_kernel="fused_loop", fuse_cross_kv=True))
    np_params, _ = _setup(cfg, seed=7)
    if int8_w:
        np_params["decoder"] = jax.tree.map(np.asarray, jax_quantize_decoder(np_params["decoder"]))
    px = np.random.default_rng(7).normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    want = jmdl.ocr_forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(px), cfg,
                            max_length=12)
    tp = params_from_jax(np_params, "cpu")
    before = tdec.precompute_cross_kv_packed.calls
    got = tmdl.ocr_forward(tp, torch.from_numpy(px), port_config(cfg), max_length=12)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1
    plain = tmdl.ocr_forward(tp, torch.from_numpy(px), port_config(cfg), max_length=12,
                             use_kernels=False)
    torch.testing.assert_close(plain.tokens, got.tokens, atol=0, rtol=0)
    assert tdec.precompute_cross_kv_packed.calls == before
