"""Kernels B and D's plain versions against the JAX ``fused_mlp_block``
(run in interpret mode on the CPU), in float32: B on int8-quantized tiny
weights, D on the same weights in their float (bf16-form) layout, pre-LN,
``pre_ln=False`` and ``post_ln``, both GELUs.  Tolerance 1e-5: the int8
products are exact in both and the float ops run in the same order; only
f32 sums (LN statistics, D's matmuls) differ in order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from manga_ocr_tpu.ops.quant import quantize_weight_per_col
from manga_ocr_tpu_torch.ops import fused_mlp as tm

TOL = 1e-5


def _inputs(seed=0, d=64, inter=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    lns = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lnb = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    w1 = quantize_weight_per_col(jnp.asarray(rng.normal(size=(d, inter)) * 0.1, jnp.float32))
    w2 = quantize_weight_per_col(jnp.asarray(rng.normal(size=(inter, d)) * 0.1, jnp.float32))
    b1 = (0.1 * rng.normal(size=(inter,))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return x, lns, lnb, tuple(np.asarray(a) for a in w1), b1, tuple(np.asarray(a) for a in w2), b2


def _t(a):
    if isinstance(a, tuple):
        return tuple(torch.tensor(v) for v in a)
    return torch.tensor(a)


@pytest.mark.parametrize("gelu_mode", ["sigmoid", "erf"])
def test_plain_version_matches_jax_kernel(gelu_mode):
    args = _inputs()
    jargs = [tuple(jnp.asarray(v) for v in a) if isinstance(a, tuple) else jnp.asarray(a)
             for a in args]
    want = np.asarray(jax_mlp(*jargs, eps=1e-12, gelu_mode=gelu_mode))
    got = tm.fused_mlp_block_reference(*[_t(a) for a in args], eps=1e-12, gelu_mode=gelu_mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    args = [_t(a) for a in _inputs(1)]
    before = tm.fused_mlp_block.launches
    got = tm.fused_mlp_block(*args, gelu_mode="sigmoid")
    want = tm.fused_mlp_block_reference(*args, gelu_mode="sigmoid")
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert tm.fused_mlp_block.launches == before


def test_flattened_rows_equal_batched_rows():
    args = [_t(a) for a in _inputs(2)]
    x = args[0]
    flat = tm.fused_mlp_block(x.reshape(-1, x.shape[-1]), *args[1:], gelu_mode="sigmoid")
    torch.testing.assert_close(
        flat.reshape(x.shape), tm.fused_mlp_block(*args, gelu_mode="sigmoid"), atol=0, rtol=0
    )


def _float_inputs(seed=0):
    """The same tiny block with float weight matrices (the bf16 form)."""
    rng = np.random.default_rng(seed + 100)
    x, lns, lnb, _, b1, _, b2 = _inputs(seed)
    w1 = (rng.normal(size=(64, 128)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(128, 64)) * 0.1).astype(np.float32)
    return x, lns, lnb, w1, b1, w2, b2


LN_FORMS = {"pre_ln": dict(pre_ln=True), "no_ln": dict(pre_ln=False),
            "post_ln": dict(pre_ln=False, post_ln=True)}


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
@pytest.mark.parametrize("form", list(LN_FORMS))
def test_bf16_form_plain_version_matches_jax_kernel(form, gelu_mode):
    args = _float_inputs()
    kw = dict(eps=1e-12, gelu_mode=gelu_mode, **LN_FORMS[form])
    want = np.asarray(jax_mlp(*[jnp.asarray(a) for a in args], **kw))
    got = tm.fused_mlp_block_bf16_reference(*[_t(a) for a in args], **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_bf16_form_dispatch_on_cpu_counts_nothing():
    args = [_t(a) for a in _float_inputs(1)]
    x = args[0]
    before = (tm.fused_mlp_block.launches, tm.fused_mlp_block_bf16.launches)
    want = tm.fused_mlp_block_bf16_reference(*args, pre_ln=False)
    got = tm.fused_mlp_block(x.reshape(-1, x.shape[-1]), *args[1:], pre_ln=False)
    torch.testing.assert_close(got.reshape(x.shape), want, atol=0, rtol=0)
    assert (tm.fused_mlp_block.launches, tm.fused_mlp_block_bf16.launches) == before


def test_bf16_form_rows_are_independent():
    """The step form runs [B, D] rows: a row's output does not depend on the
    other rows (the CUDA kernel masks partial row tiles)."""
    args = [_t(a) for a in _float_inputs(2)]
    x = args[0].reshape(-1, 64)
    full = tm.fused_mlp_block(x, *args[1:], pre_ln=False)
    part = tm.fused_mlp_block(x[3:7], *args[1:], pre_ln=False)
    torch.testing.assert_close(part, full[3:7], atol=1e-6, rtol=1e-6)


def test_int8_decoder_forms_and_bad_ln_flags_raise():
    """The int8 decoder's step form (pre_ln off, post_ln on) runs as its
    plain version on the CPU (held against JAX in test_torch_decode_layer);
    pre_ln with post_ln raises in both weight forms."""
    int8 = [_t(a) for a in _inputs()]
    got = tm.fused_mlp_block(*int8, pre_ln=False, post_ln=True)
    want = tm.fused_mlp_block_reference(*int8, pre_ln=False, post_ln=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for args in (int8, [_t(a) for a in _float_inputs()]):
        with pytest.raises(ValueError):
            tm.fused_mlp_block(*args, pre_ln=True, post_ln=True)
