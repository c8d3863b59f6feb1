"""Kernel I's plain version (``encoder_stack_reference``) against the JAX
``encoder_stack`` (interpret mode on the CPU) on the same numpy-made
stacked tiny layers, in float32: int8 (``quantize_encoder`` with int8
attention projections) and float weights, both GELUs, ``lpc`` 1, 2 and 3
(3 > L = 2 exercises the clamp of the slab loop).  Tolerance 1e-5: the int8
products are exact in both; f32 sums run in another order.  Also: the CPU
wrapper takes the plain version and counts no launch, a mixed
quantization and ``lpc`` < 1 raise, and ``encoder_weights`` prepares a
tree once and its layer views match the per-layer preparation."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import quantize as jquant
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.ops.encoder_stack import encoder_stack as jax_stack
from manga_ocr_tpu_torch.models.params import init_params_numpy, layer_params, params_from_jax
from manga_ocr_tpu_torch.ops import encoder_stack as ts
from manga_ocr_tpu_torch.ops import encoder_weights as ew
from port_config import port_config

TOL = 1e-5


def _setup(int8, seed=0):
    cfg = MangaOCRConfig.tiny()
    enc = init_params_numpy(port_config(cfg), seed, std=0.1)["encoder"]
    if int8:
        enc = jax.tree.map(np.asarray, jquant.quantize_encoder(enc, quantize_attn_proj=True))
    rng = np.random.default_rng(seed + 5)
    x = rng.normal(size=(2, cfg.encoder.seq_len, cfg.encoder.hidden_size)).astype(np.float32)
    return cfg.encoder, enc["layers"], x


@pytest.mark.parametrize("lpc", [1, 2, 3])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_plain_version_matches_jax_kernel(int8, lpc):
    ecfg, layers, x = _setup(int8)
    for gelu_mode in ("erf", "sigmoid"):
        want = np.asarray(jax_stack(jnp.asarray(x), jax.tree.map(jnp.asarray, layers),
                                    ecfg.num_heads, eps=ecfg.layer_norm_eps, lpc=lpc,
                                    gelu_mode=gelu_mode))
        got = ts.encoder_stack_reference(torch.tensor(x), params_from_jax(layers, "cpu"),
                                         ecfg.num_heads, ecfg.layer_norm_eps, lpc, gelu_mode)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=gelu_mode)


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    ecfg, layers, x = _setup(True, seed=1)
    tl, tx = params_from_jax(layers, "cpu"), torch.tensor(x)
    before = ts.encoder_stack.launches
    torch.testing.assert_close(ts.encoder_stack(tx, tl, ecfg.num_heads, lpc=2),
                               ts.encoder_stack_reference(tx, tl, ecfg.num_heads, lpc=2),
                               atol=0, rtol=0)
    assert ts.encoder_stack.launches == before


def test_mixed_quantization_and_bad_lpc_raise():
    ecfg, layers, x = _setup(True, seed=2)
    tl, tx = params_from_jax(layers, "cpu"), torch.tensor(x)
    with pytest.raises(ValueError, match="lpc"):
        ts.encoder_stack(tx, tl, ecfg.num_heads, lpc=0)
    tl["mlp"] = params_from_jax(_setup(False, seed=2)[1]["mlp"], "cpu")
    for fn in (ts.encoder_stack, ts.encoder_stack_reference):
        with pytest.raises(ValueError, match="quantization mode"):
            fn(tx, tl, ecfg.num_heads)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_prepared_weights_are_made_once_and_match_per_layer(int8):
    """The stacked preparation is cached per tree (a leaf replaced means a
    new preparation); layer views equal preparing each layer alone, hold no
    storage of the params, and flatten to the 16 arrays of the C entry."""
    _, layers, _ = _setup(int8, seed=3)
    tl = params_from_jax(layers, "cpu")
    w = ew.prepare_layers(tl, torch.float32)
    assert ew.prepare_layers(tl, torch.float32) is w
    ptrs = {t.data_ptr() for t in ew._leaves(tl)}
    for l in range(tl["ln1"]["scale"].shape[0]):
        view = ew.flat_weights(ew.layer_view(w, l))
        alone = ew.flat_weights(ew.prepare_weights(layer_params(tl, l), torch.float32))
        assert len(view) == 16 and [t is None for t in view] == [t is None for t in alone]
        for a, b in zip(view, alone):
            if a is not None:
                torch.testing.assert_close(a, b, atol=0, rtol=0)
                assert a.data_ptr() not in ptrs
    tl["ln2"]["bias"] = tl["ln2"]["bias"] + 1.0
    w2 = ew.prepare_layers(tl, torch.float32)
    assert w2 is not w
    torch.testing.assert_close(w2.ln2.bias, w.ln2.bias + 1.0, atol=0, rtol=0)


def test_prepared_weights_follow_in_place_writes():
    """Writing a leaf in place (as loading a state into existing tensors
    does) invalidates the cached preparation."""
    _, layers, _ = _setup(True, seed=4)
    tl = params_from_jax(layers, "cpu")
    w = ew.prepare_layers(tl, torch.float32)
    tl["attn"]["q"]["bias"].add_(1.0)
    w2 = ew.prepare_layers(tl, torch.float32)
    assert w2 is not w
    d = tl["attn"]["q"]["bias"].shape[-1]
    torch.testing.assert_close(w2.qkv.bias[:, :d], w.qkv.bias[:, :d] + 1.0, atol=0, rtol=0)
    torch.testing.assert_close(w2.qkv.bias[:, d:], w.qkv.bias[:, d:], atol=0, rtol=0)
    assert ew.prepare_layers(tl, torch.float32) is w2
