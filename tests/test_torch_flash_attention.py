"""Kernel A's plain version against the JAX ``fused_attn_layer`` (interpret
mode on the CPU) with int8-quantized and with float tiny projections, in
float32, with ``valid_len`` < S so the key mask is exercised, and A's
variant flags (the scheduling-only three give the unflagged output bit for
bit; ``sdpa_int8`` and ``sdpa_headpack`` against JAX, with headpack's odd
head count refused; the pairs JAX refuses raise its ValueError);
kernel H's plain version against the JAX ``fused_encoder_layer``, int8 and
float, both GELUs; kernel E's plain version against the JAX
``attention_packed`` (which pads S to 128 and masks the padded keys) and
``mha_packed``; kernel G's against the JAX ``fused_attention`` (S not a
multiple of 128) and ``mha_fused``.  Tolerance 1e-5: the int8 products are
exact in both; f32 sums (LN statistics, softmax, PV) run in another
order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops.flash_attention import attention_packed as jax_packed
from manga_ocr_tpu.ops.flash_attention import fused_attention as jax_fused_attention
from manga_ocr_tpu.ops.flash_attention import fused_attn_layer as jax_attn
from manga_ocr_tpu.ops.flash_attention import fused_encoder_layer as jax_layer
from manga_ocr_tpu.ops.flash_attention import mha_fused as jax_mha_fused
from manga_ocr_tpu.ops.flash_attention import mha_packed as jax_mha_packed
from manga_ocr_tpu.ops.quant import quantize_weight_per_col
from manga_ocr_tpu_torch.ops import flash_attention as ta

TOL = 1e-5
HEADS = 4


def _dense(rng, k, n, int8):
    w = rng.normal(size=(k, n)) * 0.2
    bias = (0.1 * rng.normal(size=(n,))).astype(np.float32)
    if not int8:
        return {"kernel": w.astype(np.float32), "bias": bias}
    w_q, scale = quantize_weight_per_col(jnp.asarray(w, jnp.float32))
    return {"w_q": np.asarray(w_q), "scale": np.asarray(scale), "bias": bias}


def _ln(rng, d):
    return {"scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32)}


def _inputs(seed=0, b=2, s=8, d=64, int8=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = {name: _dense(rng, d, d, int8) for name in ("q", "k", "v", "o")}
    ln = _ln(rng, d)
    return x, p, ln["scale"], ln["bias"]


def _torch(x, p, lns, lnb):
    tp = {n: {k: torch.tensor(v) for k, v in d.items()} for n, d in p.items()}
    return torch.tensor(x), tp, torch.tensor(lns), torch.tensor(lnb)


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("valid_len", [5, 8], ids=["masked", "unmasked"])
def test_plain_version_matches_jax_kernel(valid_len):
    x, p, lns, lnb = _inputs()
    want = np.asarray(jax_attn(jnp.asarray(x), _jax_tree(p), jnp.asarray(lns), jnp.asarray(lnb),
                               HEADS, eps=1e-12, valid_len=valid_len))
    got = ta.fused_attn_layer_reference(*_torch(x, p, lns, lnb), HEADS, eps=1e-12,
                                        valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("valid_len", [5, 8], ids=["masked", "unmasked"])
def test_float_plain_version_matches_jax_kernel(valid_len):
    """A's float form: unquantized q/k/v/o (the serving config on float
    params)."""
    x, p, lns, lnb = _inputs(7, int8=False)
    want = np.asarray(jax_attn(jnp.asarray(x), _jax_tree(p), jnp.asarray(lns), jnp.asarray(lnb),
                               HEADS, eps=1e-12, valid_len=valid_len))
    args = _torch(x, p, lns, lnb)
    got = ta.fused_attn_layer_reference(*args, HEADS, eps=1e-12, valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    before = ta.fused_attn_layer.launches
    torch.testing.assert_close(ta.fused_attn_layer(*args, HEADS, valid_len=valid_len), got,
                               atol=0, rtol=0)
    assert ta.fused_attn_layer.launches == before


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


@pytest.mark.parametrize("valid_len", [5, 8], ids=["masked", "unmasked"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_sdpa_int8_plain_version_matches_jax_kernel(int8, valid_len):
    """A's ``sdpa_int8`` form (int8 QK^T and PV, dynamic quantization) with
    either projection form.  The int8 sums are exact in both; the f32
    softmax and LN sums run in another order, which could flip one rounding
    of p's quantization (a step of 1/127 of a row's largest p): none does on
    these inputs, so the tolerance is 1e-4 of the largest output."""
    x, p, lns, lnb = _inputs(3, int8=int8)
    want = np.asarray(jax_attn(jnp.asarray(x), _jax_tree(p), jnp.asarray(lns), jnp.asarray(lnb),
                               HEADS, eps=1e-12, valid_len=valid_len, sdpa_int8=True))
    args = _torch(x, p, lns, lnb)
    got = ta.fused_attn_layer_reference(*args, HEADS, eps=1e-12, valid_len=valid_len,
                                        sdpa_int8=True)
    top = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * top, rtol=0)
    # the int8 SDPA is a different function from the default one
    base = ta.fused_attn_layer_reference(*args, HEADS, eps=1e-12, valid_len=valid_len)
    assert float((got - base).abs().max()) > 1e-4 * top
    before = dict(ta.fused_attn_layer.launches_by_form)
    torch.testing.assert_close(ta.fused_attn_layer(*args, HEADS, valid_len=valid_len,
                                                   sdpa_int8=True), got, atol=0, rtol=0)
    assert ta.fused_attn_layer.launches_by_form == before


def test_sdpa_int8_pad_rows_do_not_reach_real_rows():
    """v is quantized over the valid rows only: pad rows of any size leave
    the real rows' outputs unchanged."""
    x, p, lns, lnb = _inputs(4)
    tx, tp, tl, tb = _torch(x, p, lns, lnb)
    base = ta.fused_attn_layer(tx, tp, tl, tb, HEADS, valid_len=5, sdpa_int8=True)
    tx2 = tx.clone()
    tx2[:, 5:] = 100.0
    moved = ta.fused_attn_layer(tx2, tp, tl, tb, HEADS, valid_len=5, sdpa_int8=True)
    torch.testing.assert_close(moved[:, :5], base[:, :5], atol=0, rtol=0)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_sdpa_headpack_matches_jax_kernel(int8):
    """Two heads per block-diagonal contraction in JAX: the default SDPA in
    another summation order (the zero blocks add exact zeros)."""
    x, p, lns, lnb = _inputs(5, int8=int8)
    want = np.asarray(jax_attn(jnp.asarray(x), _jax_tree(p), jnp.asarray(lns), jnp.asarray(lnb),
                               HEADS, eps=1e-12, valid_len=5, sdpa_headpack=True))
    args = _torch(x, p, lns, lnb)
    got = ta.fused_attn_layer(*args, HEADS, valid_len=5, sdpa_headpack=True)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)
    torch.testing.assert_close(got, ta.fused_attn_layer(*args, HEADS, valid_len=5),
                               atol=0, rtol=0)


def test_sdpa_headpack_odd_head_count_raises():
    """JAX silently runs the per-head loop for an odd head count; the port
    refuses it, in the kernel and the plain version."""
    args = _torch(*_inputs(6, d=48))
    for fn in (ta.fused_attn_layer, ta.fused_attn_layer_reference):
        with pytest.raises(ValueError, match="odd"):
            fn(*args, 3, sdpa_headpack=True)
        fn(*args, 3)  # the default form takes three heads


@pytest.mark.parametrize("variant", ["fuse_qkv", "batched_sdpa", "parallel_grid"])
def test_scheduling_flags_are_noops(variant):
    """Scheduling only in JAX (the same math): the unflagged output, bit
    for bit, in both projection forms."""
    for int8 in (True, False):
        args = _torch(*_inputs(int8=int8))
        base = ta.fused_attn_layer(*args, HEADS, valid_len=5)
        for value in (True, "phased") if variant == "batched_sdpa" else (True,):
            got = ta.fused_attn_layer(*args, HEADS, valid_len=5, **{variant: value})
            torch.testing.assert_close(got, base, atol=0, rtol=0)


@pytest.mark.parametrize("pair", [("sdpa_int8", "batched_sdpa"), ("sdpa_headpack", "sdpa_int8"),
                                  ("sdpa_headpack", "batched_sdpa")], ids="+".join)
def test_exclusive_variant_pairs_raise_like_jax(pair):
    x, p, lns, lnb = _inputs()
    flags = {name: True for name in pair}
    with pytest.raises(ValueError) as jax_err:
        jax_attn(jnp.asarray(x), _jax_tree(p), jnp.asarray(lns), jnp.asarray(lnb), HEADS, **flags)
    args = _torch(x, p, lns, lnb)
    for fn in (ta.fused_attn_layer, ta.fused_attn_layer_reference):
        with pytest.raises(ValueError) as err:
            fn(*args, HEADS, **flags)
        assert str(err.value) == str(jax_err.value)


def _layer(seed, int8, b=2, s=5, d=64, inter=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = {"attn": {name: _dense(rng, d, d, int8) for name in ("q", "k", "v", "o")},
         "ln1": _ln(rng, d), "ln2": _ln(rng, d),
         "mlp": {"fc1": _dense(rng, d, inter, int8), "fc2": _dense(rng, inter, d, int8)}}
    return x, p


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_encoder_layer_plain_version_matches_jax_kernel(int8, gelu_mode):
    x, p = _layer(11, int8)
    want = np.asarray(jax_layer(jnp.asarray(x), _jax_tree(p), HEADS, eps=1e-12,
                                gelu_mode=gelu_mode))
    tx, tp = torch.tensor(x), _torch_tree(p)
    got = ta.fused_encoder_layer_reference(tx, tp, HEADS, eps=1e-12, gelu_mode=gelu_mode)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    before = ta.fused_encoder_layer.launches
    torch.testing.assert_close(ta.fused_encoder_layer(tx, tp, HEADS, gelu_mode=gelu_mode), got,
                               atol=0, rtol=0)
    assert ta.fused_encoder_layer.launches == before


def test_encoder_layer_mixed_quantization_raises():
    """JAX asserts that attention and MLP share the quantization mode; the
    port raises ValueError (kernel and plain version)."""
    x, p = _layer(12, True)
    p["mlp"] = _layer(12, False)[1]["mlp"]
    with pytest.raises(AssertionError):
        jax_layer(jnp.asarray(x), _jax_tree(p), HEADS)
    tx, tp = torch.tensor(x), _torch_tree(p)
    for fn in (ta.fused_encoder_layer, ta.fused_encoder_layer_reference):
        with pytest.raises(ValueError, match="quantization mode"):
            fn(tx, tp, HEADS)


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


def test_fused_attention_plain_version_matches_jax_kernel():
    """G on [B, H, S, dh] with S = 5: JAX pads to 128 and masks the pads."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, HEADS, 5, 16)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = ta.fused_attention_reference(tq, tk, tv)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    before = ta.fused_attention.launches
    torch.testing.assert_close(ta.fused_attention(tq, tk, tv), got, atol=0, rtol=0)
    assert ta.fused_attention.launches == before


def test_mha_fused_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {n: _dense(rng, 64, 64, int8=False) for n in "qkvo"}
    want = np.asarray(jax_mha_fused(jnp.asarray(x), jnp.asarray(x), _jax_tree(p), HEADS))
    tx, tp = torch.tensor(x), _torch_tree(p)
    got = ta.mha_fused(tx, tx, tp, HEADS)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(ta.mha_fused(tx, tx, tp, HEADS, use_kernels=False), got,
                               atol=0, rtol=0)
