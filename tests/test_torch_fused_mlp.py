"""Kernel B's plain version against the JAX ``fused_mlp_block`` (int8
path, run in interpret mode on the CPU) on int8-quantized tiny weights, in
float32.  Tolerance 1e-5: the int8 products are exact in both and the
float ops run in the same order; only f32 sums of the LN statistics differ
in order."""

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


def test_bf16_weight_form_is_not_ported():
    x, lns, lnb, (w1, _), b1, (w2, _), b2 = [_t(a) for a in _inputs()]
    with pytest.raises(NotImplementedError):
        tm.fused_mlp_block(x, lns, lnb, w1.float(), b1, w2.float(), b2)
