"""The plain version of the port's int8 GEMM (``ops.fused_mlp.int8_gemm_reference``,
the function every int8 projection of kernels A, B, H, I, J and K launches
through ``kernels.launch.int8_gemm``) against the JAX expressions it
mirrors, and the launchers' refusal of the shapes the kernel does not take.

Each epilogue mode is held to the JAX expression of ``_kernel_int8``
(``manga_ocr_tpu/ops/fused_mlp.py``: ``acc.astype(f32) * sx * s + b``, then
the GELU; ``x + o.astype(x.dtype)`` for the residual) and of
``_attn_core``'s projections (``(...).astype(x.dtype)``) on the same
numpy-made int8 operands and f32 scales: bit for bit in the f32, bf16 and
residual modes (exact int32 sums, the same f32 roundings in the same
order); in the GELU modes within a few f32 ulps of the largest output, since
JAX's and PyTorch's ``exp`` may differ in the last bit.  Chained as kernel B
(fc1 with the GELU, row quantization, fc2 with the residual) and as kernel
A's two projections around its SDPA, it is shown equal bit for bit to those
kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu.ops.fused_mlp import _kernel_int8
from manga_ocr_tpu.ops.kernel_utils import gelu_fn as jax_gelu_fn
from manga_ocr_tpu_torch.kernels import build, launch
from manga_ocr_tpu_torch.ops import flash_attention as fa
from manga_ocr_tpu_torch.ops import fused_mlp as tm
from manga_ocr_tpu_torch.ops.kernel_utils import ln32, quant_rows
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = {
    "bf16": launch.GEMM_BF16,
    "gelu_sigmoid": launch.GEMM_GELU_F32,
    "residual": launch.GEMM_RESIDUAL_BF16,
    "f32": launch.GEMM_F32,
    "gelu_erf": launch.GEMM_GELU_ERF_F32,
}
# JAX's and PyTorch's exp may differ in the last bit: the GELU modes are
# held to a few f32 ulps of the largest output.
GELU_REL = 2.0**-20


def _inputs(seed=0, m=37, k=192, n=48):
    """int8 a [M, K] and b [K, N] over the whole int8 range, f32 row scales
    sx [M], column scales sw [N] and bias [N], a bf16-representable
    residual [M, N], as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    sx = (rng.uniform(0.5, 1.5, m) * 4.0 / 127).astype(np.float32)
    sw = (rng.uniform(0.5, 1.5, n) * 0.08 / 127).astype(np.float32)
    bias = (0.1 * rng.normal(size=(n,))).astype(np.float32)
    res = np.asarray(jnp.asarray(rng.normal(size=(m, n)), jnp.bfloat16).astype(jnp.float32))
    return a, b, sx, sw, bias, res


def _jax_gemm(mode, a, b, sx, sw, bias, res):
    """The JAX expression each mode mirrors."""
    acc = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(sx)[:, None] * jnp.asarray(sw) + jnp.asarray(bias)
    if mode.startswith("gelu"):
        return jax_gelu_fn(mode[5:])(y)
    if mode == "residual":
        return jnp.asarray(res, jnp.bfloat16) + y.astype(jnp.bfloat16)
    if mode == "f32":
        return y
    return y.astype(jnp.bfloat16)


def _torch_gemm(mode, a, b, sx, sw, bias, res):
    return tm.int8_gemm_reference(
        torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T)), torch.from_numpy(sx),
        torch.from_numpy(sw), torch.from_numpy(bias), MODES[mode],
        residual=torch.tensor(res).bfloat16() if mode == "residual" else None)


@pytest.mark.parametrize("shape", [(37, 192, 48), (1, 64, 8), (17, 3072, 16)],
                         ids=["m37", "m1", "k3072"])
@pytest.mark.parametrize("mode", list(MODES))
def test_int8_gemm_reference_matches_jax(mode, shape):
    m, k, n = shape
    args = _inputs(m + k + n, m, k, n)
    want = np.asarray(_jax_gemm(mode, *args).astype(jnp.float32))
    got = _torch_gemm(mode, *args)
    assert got.dtype == (torch.bfloat16 if mode in ("bf16", "residual") else torch.float32)
    assert got.shape == want.shape
    if mode.startswith("gelu"):
        np.testing.assert_allclose(got.numpy(), want, atol=GELU_REL * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


class _Out:
    """A stand-in for the kernel's output Ref: keeps what is stored."""

    def __setitem__(self, key, value):
        self.value = value


def _mlp_weights(seed, d=64, inter=128):
    """x [M, D] (bf16-representable), LN params and quantized fc1/fc2
    ([K, N] int8 with f32 column scales, f32 biases), as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(29, d)), jnp.bfloat16).astype(jnp.float32))
    lns = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    lnb = (0.1 * rng.normal(size=(d,))).astype(np.float32)

    def dense(k, n):
        return (rng.integers(-127, 128, (k, n), dtype=np.int8),
                (rng.uniform(0.5, 1.5, n) * 0.08 / 127).astype(np.float32),
                (0.1 * rng.normal(size=(n,))).astype(np.float32))
    return x, lns, lnb, dense(d, inter), dense(inter, d)


def _chain_b(x, lns, lnb, fc1, fc2, gelu_mode, pre_ln):
    """Kernel B as the CUDA wrapper chains it, with int8_gemm_reference in
    place of the GEMM: [LN +] row quantization, fc1 with the GELU, row
    quantization, fc2 with the residual."""
    tx = torch.tensor(x).bfloat16()
    h = ln32(tx, torch.tensor(lns), torch.tensor(lnb), 1e-12) if pre_ln else tx.float()
    hq, sx = quant_rows(h)
    gelu = launch.GEMM_GELU_ERF_F32 if gelu_mode == "erf" else launch.GEMM_GELU_F32
    w1, s1, b1 = (torch.from_numpy(v) for v in fc1)
    w2, s2, b2 = (torch.from_numpy(v) for v in fc2)
    h = tm.int8_gemm_reference(hq, w1.t().contiguous(), sx[:, 0], s1, b1, gelu)
    hq2, sx2 = quant_rows(h)
    return tm.int8_gemm_reference(hq2, w2.t().contiguous(), sx2[:, 0], s2, b2,
                                  launch.GEMM_RESIDUAL_BF16, residual=tx)


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "no_ln"])
@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_int8_gemm_reference_chain_is_kernel_b_plain_version(gelu_mode, pre_ln):
    """Kernel B's plain version is the GELU GEMM then the residual GEMM
    around the row quantizations, bit for bit."""
    x, lns, lnb, fc1, fc2 = _mlp_weights(3)
    got = _chain_b(x, lns, lnb, fc1, fc2, gelu_mode, pre_ln)
    want = tm.fused_mlp_block_reference(
        torch.tensor(x).bfloat16(), torch.tensor(lns), torch.tensor(lnb),
        tuple(torch.from_numpy(v) for v in fc1[:2]), torch.from_numpy(fc1[2]),
        tuple(torch.from_numpy(v) for v in fc2[:2]), torch.from_numpy(fc2[2]),
        gelu_mode=gelu_mode, pre_ln=pre_ln)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_int8_gemm_reference_chain_matches_jax_kernel_body(gelu_mode):
    """The same chain against ``_kernel_int8`` itself (pre-LN), run on plain
    arrays in place of its Refs.  Within one bf16 ulp of the largest
    output: JAX's and PyTorch's exp may differ in the last bit, which can
    move one GELU output across an int8 rounding step."""
    x, lns, lnb, fc1, fc2 = _mlp_weights(4)
    out = _Out()
    _kernel_int8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(fc1[0]), jnp.asarray(fc2[0]),
                 jnp.asarray(fc1[1]), jnp.asarray(fc2[1]), jnp.asarray(lns), jnp.asarray(lnb),
                 jnp.asarray(fc1[2]), jnp.asarray(fc2[2]), out, eps=1e-12, pre_ln=True,
                 post_ln=False, gelu_fn=jax_gelu_fn(gelu_mode))
    want = np.asarray(out.value.astype(jnp.float32))
    got = _chain_b(x, lns, lnb, fc1, fc2, gelu_mode, True).float().numpy()
    ulp = float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))
    np.testing.assert_allclose(got, want, atol=ulp, rtol=0)


@pytest.mark.parametrize("valid_len", [None, 9])
def test_int8_gemm_reference_chain_is_kernel_a_plain_version(valid_len):
    """Kernel A's int8 plain version is LN + row quantization, one bf16-out
    GEMM over the concatenated q|k|v weights, the SDPA, row quantization of
    the context and the residual GEMM, bit for bit (each column's
    contraction is the same in the concatenated product)."""
    rng = np.random.default_rng(5)
    b, s, d, heads = 2, 11, 64, 2
    x = torch.from_numpy(rng.normal(size=(b, s, d))).bfloat16()
    ln = (torch.from_numpy(1 + 0.1 * rng.normal(size=(d,))).float(),
          torch.from_numpy(0.1 * rng.normal(size=(d,))).float())

    def dense():
        return {"w_q": torch.from_numpy(rng.integers(-127, 128, (d, d), dtype=np.int8)),
                "scale": torch.from_numpy(rng.uniform(0.5, 1.5, d) * 0.08 / 127).float(),
                "bias": torch.from_numpy(0.1 * rng.normal(size=(d,))).float()}
    p = {n: dense() for n in "qkvo"}
    want = fa.fused_attn_layer_reference(x, p, *ln, heads, valid_len=valid_len)

    xf = x.reshape(b * s, d)
    hq, sx = quant_rows(ln32(xf, *ln, 1e-12))
    qkv_t = torch.cat([p[n]["w_q"] for n in "qkv"], 1).t().contiguous()
    qkv = tm.int8_gemm_reference(hq, qkv_t, sx[:, 0], torch.cat([p[n]["scale"] for n in "qkv"]),
                                 torch.cat([p[n]["bias"] for n in "qkv"]), launch.GEMM_BF16)
    q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(b, s, heads, d // heads).transpose(1, 2).float()
               for i in range(3))
    ctx = fa._sdpa_reference(q, k, v, s if valid_len is None else valid_len, False, x.dtype)
    cq, csx = quant_rows(ctx.transpose(1, 2).reshape(b * s, d))
    got = tm.int8_gemm_reference(cq, p["o"]["w_q"].t().contiguous(), csx[:, 0], p["o"]["scale"],
                                 p["o"]["bias"], launch.GEMM_RESIDUAL_BF16, residual=xf)
    torch.testing.assert_close(got.reshape(b, s, d), want, atol=0, rtol=0)


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=dtype)[1:n + 1].view(shape)


def _gemm_call(m=5, k=64, n=16, mode=launch.GEMM_BF16, a=None, b_t=None, sw=None, bias=None,
               residual=None):
    """launch.int8_gemm on CPU tensors (any of them may be given instead)."""
    a = torch.zeros((m, k), dtype=torch.int8) if a is None else a
    b_t = torch.zeros((n, a.shape[1]), dtype=torch.int8) if b_t is None else b_t
    n = b_t.shape[0]
    sw = torch.zeros((n,), dtype=torch.float32) if sw is None else sw
    bias = torch.zeros((n,), dtype=torch.float32) if bias is None else bias
    sx = torch.zeros((a.shape[0],), dtype=torch.float32)
    return launch.int8_gemm(a, b_t, sx, sw, bias, mode, residual)


@pytest.mark.parametrize("case,match", [
    (dict(k=96), "K a multiple of 64"),
    (dict(k=32), "K a multiple of 64"),
    (dict(n=12), "N a multiple of 8"),
    (dict(n=4), "N a multiple of 8"),
    (dict(m=0), "M >= 1"),
    (dict(a=_misaligned((5, 64), torch.int8)), "int8_gemm a: expected a 16-byte aligned"),
    (dict(b_t=_misaligned((16, 64), torch.int8)), "int8_gemm b_t: expected a 16-byte aligned"),
    (dict(mode=launch.GEMM_RESIDUAL_BF16, residual=_misaligned((5, 16), torch.bfloat16)),
     "int8_gemm residual: expected a 16-byte aligned"),
    (dict(sw=_misaligned((16,), torch.float32)), "int8_gemm sw: expected an 8-byte aligned"),
    (dict(bias=_misaligned((16,), torch.float32)), "int8_gemm bias: expected an 8-byte aligned"),
    (dict(mode=7), "unknown mode 7"),
], ids=["K96", "K32", "N12", "N4", "M0", "a_misaligned", "b_t_misaligned",
        "residual_misaligned", "sw_misaligned", "bias_misaligned", "mode7"])
def test_int8_gemm_refuses_what_it_does_not_take(case, match, monkeypatch):
    """Each limit of the TMA + s8 wgmma GEMM raises ValueError on the
    tensors' own checks, before any build or launch (here on CPU tensors,
    where a build would fail)."""

    def no_build(*args, **kwargs):
        raise AssertionError("the kernels were built before the shapes were checked")

    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(ValueError, match=match):
        _gemm_call(**case)


@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072), (3072, 768),
                                 (128, 384), (128, 128), (128, 256), (256, 128), (192, 576),
                                 (192, 384), (384, 192), (64, 8), (128, 200)])
def test_int8_gemm_takes_every_shape_its_callers_use(k, n, monkeypatch):
    """The shapes the port's callers pass (K 768 / 3072 with N 768 / 2304 /
    3072; the card tests' D 128, I 256, the step tests' D 192, I 384, and
    the GEMM card tests' K 64 and N 8 and 200) pass the limits: on CPU
    tensors the launcher gets as far as its device check."""
    monkeypatch.setattr(build, "load", lambda *a, **kw: pytest.fail("built on CPU tensors"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _gemm_call(m=3, k=k, n=n)


def _encoder_layers_call(misaligned=None, b=2, s=5, d=128, inter=256, heads=2):
    """launch.encoder_layers' int8 form on CPU tensors (one layer of int8
    weights); ``misaligned`` names the operand given a base one element
    past a 16-byte boundary: "x", "scratch i" or "weight i"."""
    i8, bf16, f32 = torch.int8, torch.bfloat16, torch.float32

    def arr(shape, dtype, name):
        return _misaligned(shape, dtype) if name == misaligned else torch.zeros(shape, dtype=dtype)

    mats = {0: (3 * d, d), 3: (d, d), 8: (inter, d), 11: (d, inter)}  # [N, K]
    vecs = {1: 3 * d, 2: 3 * d, 4: d, 5: d, 6: d, 7: d, 9: inter, 10: inter, 12: d, 13: d,
            14: d, 15: d}
    weights = [arr((1, *mats[i]), i8, f"weight {i}") if i in mats
               else arr((1, vecs[i]), f32, f"weight {i}") for i in range(16)]
    scratch = tuple(None if spec is None else arr(spec[0], spec[1], f"scratch {i}")
                    for i, spec in enumerate(launch._scratch_spec(b * s, d, inter, True)))
    return launch.encoder_layers(arr((b, s, d), bf16, "x"), weights, 0, 1, False, scratch,
                                 heads, 1e-12, 0.125, True)


@pytest.mark.parametrize("misaligned", ["x", "scratch 0", "scratch 2", "scratch 5", "weight 0",
                                        "weight 8", "weight 6"])
def test_encoder_layers_int8_refuses_misaligned_gemm_operands(misaligned, monkeypatch):
    """H's and I's int8 form refuses, before any build, an x, a scratch
    array or a weight that the chained int8 GEMMs could not read or write
    through TMA and 16-byte pieces (x is the o GEMM's residual), or LN
    parameters that ln_quant_rows could not read in 16-byte pieces.  The CPU
    tensors pass the dtype and shape checks with the device check lifted."""

    def expect_on_cpu(t, dtype, shape, name):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name

    class Built(Exception):
        pass

    def load(*args, **kwargs):
        raise Built

    monkeypatch.setattr(launch, "_expect", expect_on_cpu)
    monkeypatch.setattr(build, "load", load)
    with pytest.raises(ValueError, match=f"encoder_layers {misaligned}: expected a 16-byte"):
        _encoder_layers_call(misaligned)
    with pytest.raises(Built):  # aligned, the same call passes every check
        _encoder_layers_call()


def _ln_quant_call(m=5, k=768, dtype=torch.bfloat16, x=None, ln_scale=None):
    """launch.ln_quant_rows on CPU tensors (x or the LN scale may be given)."""
    x = torch.zeros((m, k), dtype=dtype) if x is None else x
    k = x.shape[1]
    ln = (torch.ones(k) if ln_scale is None else ln_scale, torch.zeros(k))
    return launch.ln_quant_rows(x, ln)


@pytest.mark.parametrize("case,match", [
    (dict(k=12), "K a multiple of 8"),
    (dict(k=4), "K a multiple of 8"),
    (dict(k=8200, dtype=torch.float32), "at most 2048 16-byte chunks"),
    (dict(k=16400), "at most 2048 16-byte chunks"),
    (dict(m=0), "M >= 1"),
    (dict(x=_misaligned((5, 768), torch.bfloat16)), "ln_quant_rows x: expected a 16-byte"),
    (dict(ln_scale=_misaligned((768,), torch.float32)),
     "ln_quant_rows ln scale: expected a 16-byte"),
], ids=["K12", "K4", "K8200_f32", "K16400_bf16", "M0", "x_misaligned", "ln_misaligned"])
def test_ln_quant_rows_refuses_what_it_does_not_take(case, match, monkeypatch):
    """Each limit of the row pass (a row in registers, 16-byte chunks)
    raises ValueError before any build or launch."""
    monkeypatch.setattr(build, "load", lambda *a, **kw: pytest.fail("built before the checks"))
    with pytest.raises(ValueError, match=match):
        _ln_quant_call(**case)


@pytest.mark.parametrize("k,dtype", [(768, torch.bfloat16), (768, torch.float32),
                                     (3072, torch.float32), (8192, torch.float32),
                                     (64, torch.bfloat16), (192, torch.float32),
                                     (384, torch.float32)])
def test_ln_quant_rows_takes_every_row_its_callers_pass(k, dtype, monkeypatch):
    """The encoder's LN rows (bf16, K 768), its context and GELU rows (f32,
    K 768 and 3072), the limit and the test widths pass the limits: on CPU
    tensors the launcher gets as far as its device check."""
    monkeypatch.setattr(build, "load", lambda *a, **kw: pytest.fail("built on CPU tensors"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _ln_quant_call(m=3, k=k, dtype=dtype)


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quant_rows_and_dense_int8_match_jax_bit_for_bit(scale):
    """The row quantization under every int8 GEMM's plain version, and the
    plain ``dense_int8``, take ``inv = 127 / amax`` rounded once, as JAX
    (and the kernels) do: the same int8 values and scales bit for bit."""
    from manga_ocr_tpu.ops.kernel_utils import quant_rows as jax_quant_rows
    from manga_ocr_tpu.ops.quant import dense_int8 as jax_dense_int8
    from manga_ocr_tpu_torch.ops.quant import dense_int8

    rng = np.random.default_rng(int(scale * 1000))
    h = (rng.normal(size=(257, 768)) * scale).astype(np.float32)
    want_q, want_sx = (np.asarray(t) for t in jax_quant_rows(jnp.asarray(h)))
    got_q, got_sx = quant_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_sx.numpy(), want_sx)
    w_q = rng.integers(-127, 128, (768, 64), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, 64) * 0.08 / 127).astype(np.float32)
    want = np.asarray(jax_dense_int8(jnp.asarray(h), jnp.asarray(w_q), jnp.asarray(w_s)))
    got = dense_int8(torch.from_numpy(h), torch.from_numpy(w_q), torch.from_numpy(w_s))
    np.testing.assert_array_equal(got.numpy(), want)
