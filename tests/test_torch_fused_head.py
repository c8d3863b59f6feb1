"""Kernel F's plain version against the JAX ``fused_greedy_head`` (interpret
mode on the CPU), in float32 on numpy-made inputs: the ids must be
IDENTICAL, for vocabularies of one and of two 512-wide tiles (the
across-tile running argmax).  The JAX kernel asserts vocab % 512 == 0; the
port raises."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops.fused_head import fused_greedy_head as jax_head
from manga_ocr_tpu_torch.ops import fused_head as th


def _inputs(vocab, seed=0, b=6, d=64):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(b, d)).astype(np.float32),
        (rng.normal(size=(d, d)) * 0.2).astype(np.float32),
        (0.1 * rng.normal(size=(d,))).astype(np.float32),
        (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
        (0.1 * rng.normal(size=(d,))).astype(np.float32),
        (rng.normal(size=(d, vocab)) * 0.2).astype(np.float32),
        (0.1 * rng.normal(size=(vocab,))).astype(np.float32),
    ]


@pytest.mark.parametrize("vocab", [512, 1024])
def test_plain_version_ids_match_jax_kernel(vocab):
    args = _inputs(vocab)
    want = np.asarray(jax_head(*[jnp.asarray(a) for a in args], eps=1e-12))
    got = th.fused_greedy_head_reference(*[torch.tensor(a) for a in args], eps=1e-12)
    assert got.dtype == torch.int32 and got.shape == (6,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the ids are the argmax of the plain logits, which spread over both tiles
    logits = th.head_logits_reference(*[torch.tensor(a) for a in args])
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want)


def test_first_maximum_wins_across_tiles():
    """A logit tied in two tiles goes to the lower id, as the TPU kernel's
    strict > across tiles does."""
    args = [torch.tensor(a) for a in _inputs(1024, seed=1)]
    args[5] = torch.zeros_like(args[5])  # every logit is the bias
    bp = torch.zeros(1024)
    bp[[700, 100, 900]] = 5.0
    args[6] = bp
    ids = th.fused_greedy_head(*args)
    assert ids.tolist() == [100] * 6
    np.testing.assert_array_equal(
        np.asarray(jax_head(*[jnp.asarray(a.numpy()) for a in args])), ids.numpy()
    )


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    args = [torch.tensor(a) for a in _inputs(512, seed=2)]
    before = th.fused_greedy_head.launches
    torch.testing.assert_close(
        th.fused_greedy_head(*args), th.fused_greedy_head_reference(*args), atol=0, rtol=0
    )
    assert th.fused_greedy_head.launches == before


def test_vocab_not_a_tile_multiple_raises():
    args = [torch.tensor(a) for a in _inputs(100)]
    with pytest.raises(ValueError, match="multiple of 512"):
        th.fused_greedy_head(*args)
