"""Kernel F's plain versions against the JAX ``fused_greedy_head`` (interpret
mode on the CPU), in float32 on numpy-made inputs: the ids must be
IDENTICAL, for vocabularies of one and of two 512-wide tiles (the
across-tile running argmax).  The JAX kernel asserts vocab % 512 == 0; the
port raises.  The CUDA kernels' pieces each have a plain version (the
transform on ``bf16_gemm_reference``, the GELU + LN row pass, the vocab
product's per-slot partials, the in-order reduce): chained, they give the
head's hidden rows bit for bit and JAX's ids, planted ties included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manga_ocr_tpu.ops.fused_head import fused_greedy_head as jax_head
from manga_ocr_tpu.ops.kernel_utils import erf_poly
from manga_ocr_tpu_torch.kernels import build, launch
from manga_ocr_tpu_torch.ops import fused_head as th
from manga_ocr_tpu_torch.ops.fused_mlp import bf16_gemm_reference
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


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


@pytest.mark.parametrize("d", [64, 128])
def test_row_pass_chained_on_the_transform_gives_the_hidden_rows(d):
    """The transform's plain version (the bf16 GEMM's f32 mode) and then the
    GELU + LN row pass give ``head_hidden_reference``'s f32 rows bit for
    bit; both agree with ``_head_kernel``'s expressions in JAX to f32
    rounding (another evaluation order)."""
    x, wt, bt, lns, lnb, _, _ = _inputs(512, seed=3, b=17, d=d)
    xb, wtb = torch.tensor(x).bfloat16(), torch.tensor(wt).bfloat16()
    bt_, lns_, lnb_ = torch.tensor(bt), torch.tensor(lns), torch.tensor(lnb)
    h32 = bf16_gemm_reference(xb, wtb, bt_, launch.BF16_F32)
    got = th.head_rows_reference(h32, lns_, lnb_, 1e-12)
    want = th.head_hidden_reference(xb, wtb, bt_, lns_, lnb_, 1e-12)
    assert got.dtype == torch.float32 and got.shape == (17, d)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

    hj = jnp.asarray(h32.numpy())
    g = 0.5 * hj * (1.0 + erf_poly(hj * 0.7071067811865476))
    mean = jnp.mean(g, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(g - mean), axis=-1, keepdims=True)
    jax_rows = (g - mean) * jax.lax.rsqrt(var + 1e-12) * lns + lnb
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_rows), rtol=0, atol=1e-5)


def _planted(vocab, b, ties, seed):
    """Inputs whose vocab columns ``ties`` hold zero weights and the same
    large bias: every row's top logit is tied exactly at those columns."""
    args = _inputs(vocab, seed=seed, b=b)
    if ties:
        args[5][:, ties] = 0.0
        args[6][ties] = 50.0
    return args


# (vocab, planted tie columns): none; inside one 256-column tile (two
# 64-column slots, and one slot); across two 256-column tiles (and, at
# vocab 1024, across the JAX kernel's two 512-column tiles)
TIE_CASES = [(512, []), (512, [200, 140]), (512, [40, 9]), (512, [400, 100]),
             (1024, []), (1024, [230, 130]), (1024, [700, 300]), (1024, [900, 100, 1000])]


@pytest.mark.parametrize("b", [1, 6, 17])
@pytest.mark.parametrize("vocab,ties", TIE_CASES)
def test_slot_partials_and_reduce_give_jax_ids(vocab, ties, b):
    """The vocab product's per-slot (value, column) partials and the
    in-order reduce, on the plain logits, give the JAX kernel's ids; a
    planted tie goes to its lowest column."""
    args = _planted(vocab, b, ties, seed=4 + b)
    want = np.asarray(jax_head(*[jnp.asarray(a) for a in args], eps=1e-12))
    logits = th.head_logits_reference(*[torch.tensor(a) for a in args])
    value, col = th.vocab_partials_reference(logits)
    assert value.shape == col.shape == (b, vocab // th.VOCAB_SLOT)
    assert col.dtype == torch.int32
    ids = th.reduce_partials_reference(value, col)
    assert ids.dtype == torch.int32 and ids.shape == (b,)
    np.testing.assert_array_equal(ids.numpy(), want)
    if ties:
        assert ids.tolist() == [min(ties)] * b


def test_slot_partial_is_the_first_maximum_of_its_slot():
    logits = torch.zeros((2, 128))
    logits[0, [70, 66, 127]] = 3.0
    logits[1, 5] = -1.0  # slot 0 of row 1 is all zeros but column 5
    value, col = th.vocab_partials_reference(logits)
    assert value.tolist() == [[0.0, 3.0], [0.0, 0.0]]
    assert col.tolist() == [[0, 66], [0, 64]]


def test_head_weights_prepared_once_per_params():
    """``prepare_head`` converts once per set of params: a second call on the
    same tensors returns the same ``HeadWeights``; an in-place write to a
    leaf prepares anew."""
    args = [torch.tensor(a) for a in _inputs(512, seed=5)]
    args[1], args[5] = args[1].bfloat16(), args[5].bfloat16()
    w = th.prepare_head(*args[1:])
    assert th.prepare_head(*args[1:]) is w
    assert [t.dtype for t in w] == [torch.bfloat16, torch.float32, torch.float32,
                                    torch.float32, torch.bfloat16, torch.float32]
    for t, src in zip(w, args[1:]):
        assert t.is_contiguous() and t.data_ptr() != src.data_ptr()
        torch.testing.assert_close(t.float(), src.float(), atol=0, rtol=0)
    args[5].mul_(2.0)
    w2 = th.prepare_head(*args[1:])
    assert w2 is not w
    torch.testing.assert_close(w2.wp.float(), args[5].float(), atol=0, rtol=0)
    assert th.prepare_head(*args[1:]) is w2


@pytest.mark.parametrize("d,vocab,match", [(96, 512, "multiple of 64"),
                                           (1088, 512, "multiple of 64 up to 1024"),
                                           (64, 100, "multiple of 64")])
def test_launcher_refuses_what_the_kernels_do_not_take(d, vocab, match, monkeypatch):
    """``launch.fused_head`` raises before any build for a D the row pass
    and the GEMMs do not take and a vocab that is not whole slots."""
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail("built"))
    args = [torch.zeros(s) for s in ((3, d), (d, d), (d,), (d,), (d,), (d, vocab), (vocab,))]
    with pytest.raises(ValueError, match=match):
        launch.fused_head(*args, 1e-12)
