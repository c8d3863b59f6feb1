"""The encoder's kernel variants end to end: the port's ``vit.encode`` and
``ocr_forward`` against the JAX package's on the same numpy-made tiny
weights and pixels, in float32, one configuration each:

- kernel A's float form: ``with_serving_kernels`` (``fused_layer``, fused
  MLP, sigmoid GELU, the 8-aligned token pad, the whole-loop decode) on
  unquantized params, and on ``quantize_encoder(quantize_attn_proj=False)``
  params (A's float form, then kernel B);
- kernel H: ``attn_kernel="merged_layer"`` on int8 and float params;
- kernel I: ``attn_kernel="stacked"``, ``stack_lpc`` 1, 2 and 3, on int8 and
  float params;
- kernel G: ``encode(fused_attention=True)`` with ``attn_kernel="xla"``
  (JAX reaches G only through ``encode``, so its tokens come from
  ``greedy_decode`` on each package's encoder output).

The encoder output must agree within 1e-4; the greedy tokens and lengths
at ``max_length=12`` must be equal.  Kernel A's SDPA variants run through
the same checks (``attn_sdpa_int8`` on int8 and float projections,
``attn_sdpa_headpack``, both under the int8 serving config that JAX
seq-pads).  Then A's variant flags through ``encode``: ``attn_sdpa_int8``
changes the output and ``attn_sdpa_headpack`` does not, the scheduling
flags give the unflagged output bit for bit, and the pairs JAX refuses
raise ``ValueError``; and ``encode(raw_padded=True)`` against JAX's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models import vit as jvit
from manga_ocr_tpu.models.config import MangaOCRConfig, with_serving_kernels
from manga_ocr_tpu.models.quantize import quantize_encoder as jax_quantize_encoder
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models import vit as tvit
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_LEN = 12
ENC_TOL = 1e-4


def _enc(cfg, **kw):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **kw))


def _configs():
    tiny = MangaOCRConfig.tiny()
    out = {
        "fused_layer_float": (with_serving_kernels(tiny), "float", None),
        "fused_layer_mlp_int8": (with_serving_kernels(tiny), "mlp_int8", None),
        "merged_int8": (_enc(tiny, attn_kernel="merged_layer", gelu_mode="sigmoid"), "int8", None),
        "merged_float": (_enc(tiny, attn_kernel="merged_layer"), "float", None),
        "fused_attention": (tiny, "float", True),
        # A's SDPA variants under the int8 serving config (seq-padded in JAX)
        "sdpa_int8_int8": (_enc(with_serving_kernels(tiny), attn_sdpa_int8=True), "int8", None),
        "sdpa_int8_float": (_enc(with_serving_kernels(tiny), attn_sdpa_int8=True), "float", None),
        "sdpa_headpack_int8": (_enc(with_serving_kernels(tiny), attn_sdpa_headpack=True), "int8",
                               None),
    }
    for lpc in (1, 2, 3):
        out[f"stacked_int8_lpc{lpc}"] = (
            _enc(tiny, attn_kernel="stacked", stack_lpc=lpc, gelu_mode="sigmoid"), "int8", None)
        out[f"stacked_float_lpc{lpc}"] = (
            _enc(tiny, attn_kernel="stacked", stack_lpc=lpc), "float", None)
    return out


CONFIGS = _configs()


def _params(cfg, kind, seed=0):
    params = init_params_numpy(port_config(cfg), seed, std=0.1)
    if kind != "float":
        params["encoder"] = jax.tree.map(np.asarray, jax_quantize_encoder(
            params["encoder"], quantize_attn_proj=kind == "int8"))
    return params


def _pixels(cfg, n=4, seed=1):
    s = cfg.encoder.image_size
    return np.random.default_rng(seed).normal(size=(n, s, s, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _run(name):
    """(JAX, port) encoder outputs and greedy results of one configuration."""
    cfg, kind, fused = CONFIGS[name]
    params, px = _params(cfg, kind), _pixels(cfg)
    tcfg, tparams = port_config(cfg), params_from_jax(params, "cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    j_enc = jvit.encode(jparams["encoder"], jnp.asarray(px), cfg.encoder, fused_attention=fused)
    t_enc = tvit.encode(tparams["encoder"], torch.tensor(px), tcfg.encoder, fused_attention=fused)
    if fused:
        j_out = jmdl.greedy_decode(jparams, j_enc, cfg, max_length=MAX_LEN)
        t_out = tmdl.greedy_decode(tparams, t_enc, tcfg, max_length=MAX_LEN)
    else:
        j_out = jmdl.ocr_forward(jparams, jnp.asarray(px), cfg, max_length=MAX_LEN)
        t_out = tmdl.ocr_forward(tparams, torch.tensor(px), tcfg, max_length=MAX_LEN)
    return (np.asarray(j_enc), t_enc.numpy(), np.asarray(j_out.tokens), np.asarray(j_out.lengths),
            t_out.tokens.numpy(), t_out.lengths.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_jax(name):
    j_enc, t_enc, *_ = _run(name)
    assert t_enc.shape == j_enc.shape
    np.testing.assert_allclose(t_enc, j_enc, atol=ENC_TOL, rtol=ENC_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_match_jax(name):
    *_, j_tok, j_len, t_tok, t_len = _run(name)
    np.testing.assert_array_equal(t_tok, j_tok)
    np.testing.assert_array_equal(t_len, j_len)
    assert len({tuple(r) for r in t_tok}) > 1  # tokens depend on the image


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_path_equals_cpu_wrappers(name):
    """``use_kernels=False`` (the plain versions, as ``chip_smoke.py`` runs
    them on the card) is what the wrappers run on CPU tensors."""
    cfg, kind, fused = CONFIGS[name]
    enc = params_from_jax(_params(cfg, kind), "cpu")["encoder"]
    px, ecfg = torch.tensor(_pixels(cfg, n=2)), port_config(cfg).encoder
    torch.testing.assert_close(
        tvit.encode(enc, px, ecfg, use_kernels=False, fused_attention=fused),
        tvit.encode(enc, px, ecfg, fused_attention=fused), atol=0, rtol=0)


def _fused_layer_setup(int8=True):
    cfg = _enc(MangaOCRConfig.tiny(), attn_kernel="fused_layer", mlp_kernel="fused")
    params = params_from_jax(_params(cfg, "int8" if int8 else "float", seed=2), "cpu")
    return port_config(cfg).encoder, params["encoder"], torch.tensor(_pixels(cfg, n=2, seed=3))


@pytest.mark.parametrize("flag", ["attn_sdpa_int8", "attn_sdpa_headpack"])
def test_numerics_variants_reach_the_kernel_in_encode(flag):
    """The flags reach kernel A through ``encode``, with the kernels and
    with their plain versions: ``sdpa_int8`` changes the output (it must
    not return the default SDPA's), ``sdpa_headpack`` is the default SDPA
    (another summation order in JAX) and gives its output bit for bit."""
    ecfg, enc, px = _fused_layer_setup()
    for use_kernels in (True, False):
        want = tvit.encode(enc, px, ecfg, use_kernels=use_kernels)
        got = tvit.encode(enc, px, dataclasses.replace(ecfg, **{flag: True}),
                          use_kernels=use_kernels)
        if flag == "attn_sdpa_int8":
            assert float((got - want).abs().max()) > 1e-4 * float(want.abs().max())
        else:
            torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_raw_padded_encode_matches_jax():
    """``encode(raw_padded=True)``: the stack's output before the final LN.
    JAX's int8 serving config returns its seq-padded rows (5 -> 8); the
    port's are the seq_len real rows, equal to JAX's first ones."""
    cfg = with_serving_kernels(MangaOCRConfig.tiny())
    params, px = _params(cfg, "int8", seed=4), _pixels(cfg, n=2, seed=5)
    want = np.asarray(jvit.encode(jax.tree.map(jnp.asarray, params["encoder"]), jnp.asarray(px),
                                  cfg.encoder, raw_padded=True))
    got = tvit.encode(params_from_jax(params, "cpu")["encoder"], torch.tensor(px),
                      port_config(cfg).encoder, raw_padded=True).numpy()
    s = cfg.encoder.seq_len
    assert want.shape == (2, 8, 64) and got.shape == (2, s, 64)
    np.testing.assert_allclose(got, want[:, :s], atol=ENC_TOL, rtol=ENC_TOL)


@pytest.mark.parametrize("flags", [{"attn_fuse_qkv": True}, {"batched_sdpa": True},
                                   {"batched_sdpa": "phased"}, {"parallel_grid": True}],
                         ids=["fuse_qkv", "batched_sdpa", "batched_sdpa_phased", "parallel_grid"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_scheduling_flags_encode_bit_identical(flags, int8):
    ecfg, enc, px = _fused_layer_setup(int8)
    want = tvit.encode(enc, px, ecfg)
    torch.testing.assert_close(tvit.encode(enc, px, dataclasses.replace(ecfg, **flags)), want,
                               atol=0, rtol=0)


@pytest.mark.parametrize("flags", [dict(attn_sdpa_int8=True, batched_sdpa=True),
                                   dict(attn_sdpa_headpack=True, attn_sdpa_int8=True),
                                   dict(attn_sdpa_headpack=True, batched_sdpa=True)],
                         ids=["sdpa_int8+batched_sdpa", "sdpa_headpack+sdpa_int8",
                              "sdpa_headpack+batched_sdpa"])
def test_exclusive_flag_pairs_raise_in_encode(flags):
    ecfg, enc, px = _fused_layer_setup()
    with pytest.raises(ValueError, match="exclusive|only"):
        tvit.encode(enc, px, dataclasses.replace(ecfg, **flags))
