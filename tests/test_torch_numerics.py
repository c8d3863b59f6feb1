"""The port's numerics helpers against the JAX package's: LN statistics,
per-row int8 quantization (half-even ties), the GELUs, the weight
quantizer, ``dense_int8`` and the reference attention ops.  int8 values
must match exactly, floats to <= 1e-6 (1e-5 where a matmul sums in
another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import quantize as jq
from manga_ocr_tpu.ops import common as jc
from manga_ocr_tpu.ops import kernel_utils as jk
from manga_ocr_tpu.ops import quant as jquant
from manga_ocr_tpu_torch.models import quantize as tq
from manga_ocr_tpu_torch.ops import common as tc
from manga_ocr_tpu_torch.ops import kernel_utils as tk
from manga_ocr_tpu_torch.ops import quant as tquant

ATOL = 1e-6


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_ln32_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 64)).astype(np.float32) * 3 + 1
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = _both(x), _both(s), _both(b)
    want = np.asarray(jk.ln32(jx, js, jb, 1e-12))
    got = tk.ln32(tx, ts, tb, 1e-12).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_quant_rows_matches_jax_and_rounds_half_to_even():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(8, 96)).astype(np.float32) * 5
    # a row with amax = 127 makes inv = 1 exactly, so these are exact .5 ties
    tie = np.zeros((1, 96), np.float32)
    tie[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    h = np.concatenate([h, tie])
    jh, th = _both(h)
    jq8, jsx = jk.quant_rows(jh)
    tq8, tsx = tk.quant_rows(th)
    assert tq8.dtype == torch.int8
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_allclose(tsx.numpy(), np.asarray(jsx), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tq8.numpy()[-1, :6], [127, 2, -4, 0, 0, 2])


@pytest.mark.parametrize("name", ["erf_poly", "gelu_erf", "gelu_sigmoid"])
def test_elementwise_matches_jax(name):
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    jx, tx = _both(x)
    want = np.asarray(getattr(jk, name)(jx))
    got = getattr(tk, name)(tx).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_exact_gelu_matches_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(tc.gelu(tx).numpy(), np.asarray(jc.gelu(jx)), atol=ATOL, rtol=0)


def test_dense_int8_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w_q, scale = jquant.quantize_weight_per_col(jnp.asarray(rng.normal(size=(64, 48)) * 0.1,
                                                            jnp.float32))
    bias = (0.1 * rng.normal(size=(48,))).astype(np.float32)
    want = np.asarray(jquant.dense_int8(jnp.asarray(x), w_q, scale, jnp.asarray(bias)))
    got = tquant.dense_int8(torch.tensor(x), torch.tensor(np.asarray(w_q)),
                            torch.tensor(np.asarray(scale)), torch.tensor(bias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "causal"])
def test_reference_mha_matches_jax(int8, masked):
    """``mha`` (split/merge heads, f32 softmax by division, probabilities in
    the compute dtype before PV) over float or int8 ``dense_any`` params."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    p = {n: {"kernel": (rng.normal(size=(64, 64)) * 0.2).astype(np.float32),
             "bias": (0.1 * rng.normal(size=(64,))).astype(np.float32)} for n in "qkvo"}
    jp = {n: {k: jnp.asarray(a) for k, a in d.items()} for n, d in p.items()}
    if int8:
        jp = {n: dict(zip(("w_q", "scale"), jquant.quantize_weight_per_col(d["kernel"])),
                      bias=d["bias"]) for n, d in jp.items()}
    tp = {n: {k: torch.tensor(np.asarray(a)) for k, a in d.items()} for n, d in jp.items()}
    mask = np.tril(np.ones((6, 6), bool))[None, None] if masked else None
    want = np.asarray(jc.mha(jnp.asarray(x), jnp.asarray(x), jp, 4,
                             mask=None if mask is None else jnp.asarray(mask)))
    tx = torch.tensor(x)
    got = tc.mha(tx, tx, tp, 4, mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    heads = tc.split_heads(tx, 4)
    assert heads.shape == (2, 4, 6, 16)
    torch.testing.assert_close(tc.merge_heads(heads), tx, atol=0, rtol=0)


def test_gelu_fn_dispatch():
    assert tk.gelu_fn("sigmoid") is tk.gelu_sigmoid
    assert tk.gelu_fn("erf") is tk.gelu_erf


def test_quantize_weight_per_col_matches_jax():
    w = np.random.default_rng(2).normal(size=(64, 48)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    jw, tw = _both(w)
    jq8, js = jquant.quantize_weight_per_col(jw)
    tq8, ts = tquant.quantize_weight_per_col(tw)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=1e-6)


def test_quantize_encoder_matches_jax():
    rng = np.random.default_rng(3)

    def dense(k, n):
        return {"kernel": rng.normal(size=(2, k, n)).astype(np.float32) * 0.02,
                "bias": rng.normal(size=(2, n)).astype(np.float32)}

    tree = {"layers": {"attn": {n: dense(16, 16) for n in "qkvo"},
                       "mlp": {"fc1": dense(16, 32), "fc2": dense(32, 16)}}}
    ttree = {"layers": {"attn": {n: {k: torch.from_numpy(v) for k, v in d.items()}
                                 for n, d in tree["layers"]["attn"].items()},
                        "mlp": {n: {k: torch.from_numpy(v) for k, v in d.items()}
                                for n, d in tree["layers"]["mlp"].items()}}}
    want = jq.quantize_encoder(tree, quantize_attn_proj=True)["layers"]
    got = tq.quantize_encoder(ttree, quantize_attn_proj=True)["layers"]
    for group in ("attn", "mlp"):
        for name, p in want[group].items():
            np.testing.assert_array_equal(got[group][name]["w_q"].numpy(), np.asarray(p["w_q"]))
            np.testing.assert_allclose(
                got[group][name]["scale"].numpy(), np.asarray(p["scale"]), atol=ATOL, rtol=1e-6
            )


def test_int8_matmul_is_exact_at_large_k():
    """K * 127^2 > 2^24: an f32 product would round; the helper must not."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(17, 3072)).astype(np.int8)
    b = rng.integers(-127, 128, size=(3072, 24)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = tk.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_bridge_keeps_values_and_dtypes():
    """The JAX package's own init tree (f32 and a bf16 cast of it) arrives
    in the port with identical values, dtypes and layout."""
    import jax

    from manga_ocr_tpu.models import model as jmdl
    from manga_ocr_tpu.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.params import params_from_jax

    cfg = MangaOCRConfig.tiny()
    tree = jmdl.init_params(cfg, jax.random.PRNGKey(0))
    for jtree, tdtype in ((tree, torch.float32), (jmdl.cast_params(tree, jnp.bfloat16), torch.bfloat16)):
        np_tree = jax.tree.map(np.asarray, jtree)
        got = params_from_jax(np_tree, "cpu")
        leaves = jax.tree_util.tree_leaves_with_path(np_tree)
        assert leaves
        for path, want in leaves:
            t = got
            for key in path:
                t = t[key.key]
            assert t.dtype == tdtype and tuple(t.shape) == want.shape
            np.testing.assert_array_equal(t.float().numpy(), want.astype(np.float32))
