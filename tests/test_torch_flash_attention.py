"""Kernel A's plain version against the JAX ``fused_attn_layer`` (interpret
mode on the CPU) with int8-quantized tiny projections, in float32, with
``valid_len`` < S so the key mask is exercised; kernel E's plain version
against the JAX ``attention_packed`` (which pads S to 128 and masks the
padded keys) and ``mha_packed``.  Tolerance 1e-5: the int8 products are
exact in both; f32 sums (LN statistics, softmax, PV) run in another
order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops.flash_attention import attention_packed as jax_packed
from manga_ocr_tpu.ops.flash_attention import fused_attn_layer as jax_attn
from manga_ocr_tpu.ops.flash_attention import mha_packed as jax_mha_packed
from manga_ocr_tpu.ops.quant import quantize_weight_per_col
from manga_ocr_tpu_torch.ops import flash_attention as ta

TOL = 1e-5
HEADS = 4


def _inputs(seed=0, b=2, s=8, d=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = {}
    for name in ("q", "k", "v", "o"):
        w_q, scale = quantize_weight_per_col(jnp.asarray(rng.normal(size=(d, d)) * 0.2, jnp.float32))
        p[name] = {"w_q": np.asarray(w_q), "scale": np.asarray(scale),
                   "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32)}
    lns = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lnb = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    return x, p, lns, lnb


def _torch(x, p, lns, lnb):
    tp = {n: {k: torch.tensor(v) for k, v in d.items()} for n, d in p.items()}
    return torch.tensor(x), tp, torch.tensor(lns), torch.tensor(lnb)


@pytest.mark.parametrize("valid_len", [5, 8], ids=["masked", "unmasked"])
def test_plain_version_matches_jax_kernel(valid_len):
    x, p, lns, lnb = _inputs()
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    want = np.asarray(jax_attn(jnp.asarray(x), jp, jnp.asarray(lns), jnp.asarray(lnb), HEADS,
                               eps=1e-12, valid_len=valid_len))
    got = ta.fused_attn_layer_reference(*_torch(x, p, lns, lnb), HEADS, eps=1e-12,
                                        valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_masked_keys_do_not_reach_real_rows():
    """Rows past valid_len are padding: changing them must leave the real
    rows' outputs unchanged (every op is row-local except the masked keys)."""
    x, p, lns, lnb = _inputs(1)
    tx, tp, tl, tb = _torch(x, p, lns, lnb)
    base = ta.fused_attn_layer(tx, tp, tl, tb, HEADS, valid_len=5)
    tx2 = tx.clone()
    tx2[:, 5:] = 100.0
    moved = ta.fused_attn_layer(tx2, tp, tl, tb, HEADS, valid_len=5)
    torch.testing.assert_close(moved[:, :5], base[:, :5], atol=0, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    args = _torch(*_inputs(2))
    before = ta.fused_attn_layer.launches
    torch.testing.assert_close(
        ta.fused_attn_layer(*args, HEADS), ta.fused_attn_layer_reference(*args, HEADS),
        atol=0, rtol=0,
    )
    assert ta.fused_attn_layer.launches == before


@pytest.mark.parametrize(
    "variant", ["fuse_qkv", "batched_sdpa", "sdpa_int8", "sdpa_headpack", "parallel_grid"]
)
def test_unported_variants_raise(variant):
    args = _torch(*_inputs())
    with pytest.raises(NotImplementedError):
        ta.fused_attn_layer(*args, HEADS, **{variant: True})


def test_unquantized_projections_are_not_ported():
    x, p, lns, lnb = _torch(*_inputs())
    bf = {n: {"kernel": d["w_q"].float(), "bias": d["bias"]} for n, d in p.items()}
    with pytest.raises(NotImplementedError):
        ta.fused_attn_layer(x, bf, lns, lnb, HEADS)


def _qkv(seed=3, b=2, s=5, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(3)]


def test_packed_plain_version_matches_jax_kernel():
    q, k, v = _qkv()
    want = np.asarray(jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), HEADS))
    got = ta.attention_packed_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v), HEADS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_packed_valid_len_masks_keys_like_a_shorter_sequence():
    """Keys at or past valid_len weigh nothing: every query row equals the
    JAX kernel run on the first valid_len keys (rows past valid_len query
    the same keys), and the masked keys' values cannot reach the output."""
    q, k, v = _qkv(4, s=7)
    n = 4
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = ta.attention_packed(tq, tk, tv, HEADS, valid_len=n)
    want = np.asarray(jax_packed(jnp.asarray(q[:, :n]), jnp.asarray(k[:, :n]),
                                 jnp.asarray(v[:, :n]), HEADS))
    np.testing.assert_allclose(got[:, :n].numpy(), want, atol=TOL, rtol=TOL)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, n:], tv2[:, n:] = 50.0, -50.0
    torch.testing.assert_close(ta.attention_packed(tq, tk2, tv2, HEADS, valid_len=n), got,
                               atol=0, rtol=0)


def test_mha_packed_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {n: {"kernel": (rng.normal(size=(64, 64)) * 0.2).astype(np.float32),
             "bias": (0.1 * rng.normal(size=(64,))).astype(np.float32)} for n in "qkvo"}
    jp = {n: {k: jnp.asarray(a) for k, a in d.items()} for n, d in p.items()}
    tp = {n: {k: torch.tensor(a) for k, a in d.items()} for n, d in p.items()}
    want = np.asarray(jax_mha_packed(jnp.asarray(x), jnp.asarray(x), jp, HEADS))
    tx = torch.tensor(x)
    before = ta.attention_packed.launches
    got = ta.mha_packed(tx, tx, tp, HEADS)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(ta.mha_packed(tx, tx, tp, HEADS, use_kernels=False), got,
                               atol=0, rtol=0)
    assert ta.attention_packed.launches == before
