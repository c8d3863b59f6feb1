"""The plain version of the port's bf16 GEMM (``ops.fused_mlp.bf16_gemm_reference``,
the function every bf16 projection of kernels A, D, H, I, J and K launches
through ``kernels.launch.bf16_gemm``) against the JAX expressions it mirrors,
and the launcher's refusal of the shapes the kernel does not take.

Each epilogue mode is held to its JAX expression on the same numpy-made bf16
inputs: ``_kernel_bf16``'s fc1 half (``gelu(dot + b1).astype(bf16)``) and
fc2 half (``x + (dot + b2).astype(bf16)``) in ``manga_ocr_tpu/ops/fused_mlp.py``,
``_one_layer``'s ``proj`` (``dot + b``, f32) and its bf16 cast in
``manga_ocr_tpu/ops/encoder_stack.py``.  Tolerance: one bf16 ulp of the
largest output; the f32 sums differ in order only, which moves a bf16
rounding by at most one ulp.  The GELU-then-residual chain is also run
through the JAX kernel body ``_kernel_bf16`` itself, and shown equal bit for
bit to kernel D's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu.ops.fused_mlp import _kernel_bf16
from manga_ocr_tpu.ops.kernel_utils import gelu_fn as jax_gelu_fn
from manga_ocr_tpu_torch.kernels import build, launch
from manga_ocr_tpu_torch.ops import fused_mlp as tm
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = {
    "gelu_erf": launch.BF16_GELU_ERF,
    "gelu_sigmoid": launch.BF16_GELU_SIGMOID,
    "residual": launch.BF16_RESIDUAL,
    "f32": launch.BF16_F32,
    "bias": launch.BF16_BIAS,
}


def _inputs(seed=0, m=37, k=64, n=48):
    """bf16-representable a [M, K], b [K, N], residual [M, N] and an f32 bias,
    as numpy f32 arrays."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))

    a = bf16(rng.normal(size=(m, k)))
    b = bf16(rng.normal(size=(k, n)) * 0.2)
    bias = (0.1 * rng.normal(size=(n,))).astype(np.float32)
    res = bf16(rng.normal(size=(m, n)))
    return a, b, bias, res


def _jax_gemm(mode, a, b, bias, res):
    """The JAX expression each mode mirrors, on bf16 operands."""
    h = jnp.asarray(a, jnp.bfloat16)
    w = jnp.asarray(b, jnp.bfloat16)
    y = jnp.dot(h, w, preferred_element_type=jnp.float32) + jnp.asarray(bias)
    if mode in ("gelu_erf", "gelu_sigmoid"):
        return jax_gelu_fn(mode[5:])(y).astype(jnp.bfloat16)
    if mode == "residual":
        return jnp.asarray(res, jnp.bfloat16) + y.astype(jnp.bfloat16)
    if mode == "f32":
        return y
    return y.astype(jnp.bfloat16)


def _one_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_gemm_reference_matches_jax(mode):
    a, b, bias, res = _inputs()
    want = np.asarray(_jax_gemm(mode, a, b, bias, res).astype(jnp.float32))
    got = tm.bf16_gemm_reference(
        torch.tensor(a).bfloat16(), torch.tensor(b).bfloat16(), torch.tensor(bias), MODES[mode],
        residual=torch.tensor(res).bfloat16() if mode == "residual" else None)
    assert got.dtype == (torch.float32 if mode == "f32" else torch.bfloat16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=_one_ulp(want), rtol=0)


class _Out:
    """A stand-in for the kernel's output Ref: keeps what is stored."""

    def __setitem__(self, key, value):
        self.value = value


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_bf16_gemm_reference_chain_matches_jax_kernel_body(gelu_mode):
    """fc1 (GELU mode) then fc2 (residual mode) against ``_kernel_bf16``
    itself (no LN), run on plain arrays in place of its Refs."""
    x, w1, b1, _ = _inputs(1, m=29, k=64, n=128)
    _, w2, b2, _ = _inputs(2, m=29, k=128, n=64)
    out = _Out()
    xb = jnp.asarray(x, jnp.bfloat16)
    _kernel_bf16(xb, jnp.asarray(w1, jnp.bfloat16), jnp.asarray(w2, jnp.bfloat16), None, None,
                 jnp.asarray(b1), jnp.asarray(b2), out, eps=1e-12, pre_ln=False, post_ln=False,
                 gelu_fn=jax_gelu_fn(gelu_mode))
    want = np.asarray(out.value.astype(jnp.float32))
    tx = torch.tensor(x).bfloat16()
    gelu = launch.BF16_GELU_ERF if gelu_mode == "erf" else launch.BF16_GELU_SIGMOID
    h = tm.bf16_gemm_reference(tx, torch.tensor(w1).bfloat16(), torch.tensor(b1), gelu)
    got = tm.bf16_gemm_reference(h, torch.tensor(w2).bfloat16(), torch.tensor(b2),
                                 launch.BF16_RESIDUAL, residual=tx)
    np.testing.assert_allclose(got.float().numpy(), want, atol=_one_ulp(want), rtol=0)


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_bf16_gemm_reference_chain_is_kernel_d_plain_version(gelu_mode):
    """Kernel D's plain version without LN is the GELU GEMM then the residual
    GEMM, bit for bit."""
    x, w1, b1, _ = _inputs(3, m=21, k=64, n=128)
    _, w2, b2, _ = _inputs(4, m=21, k=128, n=64)
    tx, tw1, tw2 = (torch.tensor(v).bfloat16() for v in (x, w1, w2))
    tb1, tb2 = torch.tensor(b1), torch.tensor(b2)
    ln = (torch.ones(64), torch.zeros(64))
    want = tm.fused_mlp_block_bf16_reference(tx, *ln, tw1, tb1, tw2, tb2, gelu_mode=gelu_mode,
                                             pre_ln=False)
    gelu = launch.BF16_GELU_ERF if gelu_mode == "erf" else launch.BF16_GELU_SIGMOID
    h = tm.bf16_gemm_reference(tx, tw1, tb1, gelu)
    got = tm.bf16_gemm_reference(h, tw2, tb2, launch.BF16_RESIDUAL, residual=tx)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=dtype)[1:n + 1].view(shape)


def _gemm_call(m=5, k=64, n=16, mode=launch.BF16_BIAS, a=None, b=None, bias=None,
               residual=None, out=None):
    """launch.bf16_gemm on CPU tensors (any of them may be given instead)."""
    a = torch.zeros((m, k), dtype=torch.bfloat16) if a is None else a
    b = torch.zeros((a.shape[1], n), dtype=torch.bfloat16) if b is None else b
    bias = torch.zeros((b.shape[1],), dtype=torch.float32) if bias is None else bias
    return launch.bf16_gemm(a, b, bias, mode, residual, out=out)


@pytest.mark.parametrize("case,match", [
    (dict(k=96), "K a multiple of 64"),
    (dict(k=32), "K a multiple of 64"),
    (dict(n=12), "N a multiple of 8"),
    (dict(m=0), "M >= 1"),
    (dict(a=_misaligned((5, 64), torch.bfloat16)), "bf16_gemm a: expected a 16-byte aligned"),
    (dict(b=_misaligned((64, 16), torch.bfloat16)), "bf16_gemm b: expected a 16-byte aligned"),
    (dict(mode=launch.BF16_RESIDUAL, residual=_misaligned((5, 16), torch.bfloat16)),
     "bf16_gemm residual: expected a 16-byte aligned"),
    (dict(bias=_misaligned((16,), torch.float32)), "bias: expected an 8-byte aligned"),
    (dict(out=_misaligned((5, 16), torch.bfloat16)), "bf16_gemm out: expected a 16-byte aligned"),
    (dict(mode=7), "unknown mode 7"),
], ids=["K96", "K32", "N12", "M0", "a_misaligned", "b_misaligned", "residual_misaligned",
        "bias_misaligned", "out_misaligned", "mode7"])
def test_bf16_gemm_refuses_what_it_does_not_take(case, match, monkeypatch):
    """Each limit of the TMA + wgmma GEMM raises ValueError on the tensors'
    own checks, before any build or launch (here on CPU tensors, where a
    build would fail)."""

    def no_build(*args, **kwargs):
        raise AssertionError("the kernels were built before the shapes were checked")

    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(ValueError, match=match):
        _gemm_call(**case)


def test_bf16_gemm_takes_every_shape_its_callers_use(monkeypatch):
    """The shapes the port's callers pass (K 768 / 3072 with N 768 / 2304 /
    3072; the card tests' D 128 and I 256) pass the limits: on CPU tensors
    the launcher gets as far as its device check."""
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail("built on CPU tensors"))
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768), (128, 384), (128, 256),
                 (256, 128)):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            _gemm_call(m=3, k=k, n=n)


def _encoder_layers_call(misaligned=None, b=2, s=5, d=128, inter=256, heads=2):
    """launch.encoder_layers' bf16 form on CPU tensors (one layer of random
    bf16 weights); ``misaligned`` names the operand given a base one
    element past a 16-byte boundary: "x", "scratch 3" or "weight 3"."""
    bf16, f32 = torch.bfloat16, torch.float32

    def arr(shape, dtype, name):
        return _misaligned(shape, dtype) if name == misaligned else torch.zeros(shape, dtype=dtype)

    mats = {0: (d, 3 * d), 3: (d, d), 8: (d, inter), 11: (inter, d)}
    vecs = {2: 3 * d, 5: d, 6: d, 7: d, 10: inter, 13: d, 14: d, 15: d}
    weights = [arr((1, *mats[i]), bf16, f"weight {i}") if i in mats
               else torch.zeros((1, vecs[i]), dtype=f32) if i in vecs else None
               for i in range(16)]
    scratch = tuple(None if spec is None else arr(spec[0], spec[1], f"scratch {i}")
                    for i, spec in enumerate(launch._scratch_spec(b * s, d, inter, False)))
    return launch.encoder_layers(arr((b, s, d), bf16, "x"), weights, 0, 1, False, scratch,
                                 heads, 1e-12, 0.125, False)


@pytest.mark.parametrize("misaligned", ["x", "scratch 3", "weight 3"])
def test_encoder_layers_refuses_misaligned_gemm_operands(misaligned, monkeypatch):
    """H's and I's bf16 form refuses, before any build, an x, a scratch
    array or a weight that the chained bf16 GEMMs could not read through
    TMA (x is the o GEMM's residual).  The CPU tensors pass the dtype and
    shape checks with the device check lifted."""

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
