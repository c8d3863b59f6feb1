"""The port's image ops (``manga_ocr_tpu_torch/ops/image.py``) against the
JAX package's, on seeded NumPy batches with ragged valid extents.

Byte for byte: grayscale and BGR, histograms, ``valid_mask``, equalizeHist,
the binary threshold, the 3x3 blur, the 90-degree turns and the skew-angle
fold.  Within stated tolerances, each for the reason its docstring gives:
the resize (``RESIZE_ATOL``, the tolerance of JAX's own resize test), the
rotation (exact at angle 0; elsewhere ``ROT_MAX_DIFF`` on at most
``ROT_MAX_SHARE`` of the pixels), the moment angle (``ANGLE_ATOL_DEG``) and
Otsu (equal thresholds except on JAX's own near-ties, at most
``OTSU_MAX_NEAR_TIE_SHARE`` of the images).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops import image as jim
from manga_ocr_tpu_torch.ops import image as tim
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RESIZE_ATOL = 1e-4
# cos/sin of an f32 angle may differ by an ulp between XLA and PyTorch, and
# a source coordinate near an integer then floors the other way: the
# interpolated value moves by a rounding step at most.
ROT_MAX_DIFF = 1
ROT_MAX_SHARE = 1e-3
# f32 moment sums over H*W pixels in another reduction order
ANGLE_ATOL_DEG = 1e-3
# JAX takes Otsu's class sums as f32 prefix sums of p and p*bin; the port
# takes exact integer prefix sums (so the card and the host agree).  Where
# the two largest between-class variances of JAX's own f32 values lie
# within this relative gap, f32 rounding decides JAX's pick.
OTSU_NEAR_TIE_REL = 2.0**-20
OTSU_MAX_NEAR_TIE_SHARE = 0.01

B, H, W = 8, 40, 56
SIZES = np.array([[40, 56], [30, 20], [12, 56], [40, 9], [1, 56], [40, 1], [25, 33], [2, 2]],
                 np.int32)


def _text_like(rng, n, h, w, angles=None):
    """Light paper with dark parallel strokes at a per-image angle, plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((n, h, w), np.uint8)
    for i in range(n):
        a = np.deg2rad(rng.uniform(-30, 30) if angles is None else angles[i])
        across = -np.sin(a) * (xx - w / 2) + np.cos(a) * (yy - h / 2)
        along = np.cos(a) * (xx - w / 2) + np.sin(a) * (yy - h / 2)
        ink = (np.abs(np.mod(across, 9.0) - 4.5) < 1.5) & (np.abs(along) < w * 0.35)
        img = np.where(ink, 20, 235) + rng.integers(-10, 11, size=(h, w))
        out[i] = np.clip(img, 0, 255)
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    gray = np.concatenate([_text_like(rng, 4, H, W),
                           rng.integers(0, 256, size=(3, H, W)).astype(np.uint8),
                           np.full((1, H, W), 77, np.uint8)])  # one degenerate image
    bgr = rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8)
    return gray, bgr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _mask(gray, sizes):
    return jim.valid_mask(gray.shape, _j(sizes)), tim.valid_mask(gray.shape, _t(sizes))


def test_color_conversions_byte_identical(batch):
    _, bgr = batch
    np.testing.assert_array_equal(tim.rgb_to_gray_u8(_t(bgr)).numpy(),
                                  np.asarray(jim.rgb_to_gray_u8(_j(bgr))))
    np.testing.assert_array_equal(tim.bgr_to_gray_u8(_t(bgr)).numpy(),
                                  np.asarray(jim.bgr_to_gray_u8(_j(bgr))))
    gray = bgr[..., 0]
    got = tim.gray_to_bgr(_t(gray))
    assert got.dtype == torch.uint8 and got.shape == (B, H, W, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jim.gray_to_bgr(_j(gray))))


def test_valid_mask_and_histograms_byte_identical(batch):
    gray, _ = batch
    jm, tm = _mask(gray, SIZES)
    assert tm.dtype == torch.bool
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for jmask, tmask in ((None, None), (jm, tm)):
        got = tim._hist256(_t(gray), tmask)
        assert got.dtype == torch.int32 and got.shape == (B, 256)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jim._hist256(_j(gray), jmask)))


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "valid_region"])
def test_equalize_hist_byte_identical(batch, masked):
    gray, _ = batch
    jm, tm = _mask(gray, SIZES) if masked else (None, None)
    got = tim.equalize_hist_u8(_t(gray), tm)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jim.equalize_hist_u8(_j(gray), jm)))
    np.testing.assert_array_equal(got[-1].numpy(), gray[-1])  # single-bin image: unchanged


def test_threshold_binary_byte_identical(batch):
    gray, _ = batch
    thresh = np.array([0, 17, 127.5, 128, 200, 254, 255, -1], np.float32)
    got = tim.threshold_binary(_t(gray), _t(thresh))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jim.threshold_binary(_j(gray), _j(thresh))))


def _jax_sigma_b(gray, mask):
    """JAX ``otsu_threshold``'s between-class variances, its own f32 math."""
    hist = jim._hist256(_j(gray), mask).astype(jnp.float32)
    p = hist / jnp.sum(hist, axis=1, keepdims=True)
    omega = jnp.cumsum(p, axis=1)
    mu = jnp.cumsum(p * jnp.arange(256, dtype=jnp.float32), axis=1)
    denom = omega * (1.0 - omega)
    num = (mu[:, -1:] * omega - mu) ** 2
    return np.asarray(jnp.where(denom > 1e-12, num / jnp.maximum(denom, 1e-12), 0.0))


def _near_tie(sigma) -> bool:
    """JAX's two largest between-class variances lie within
    OTSU_NEAR_TIE_REL of each other.  The bins of an empty-bin run after
    the first maximum repeat its value exactly in any arithmetic (both
    packages take the first), so the runner-up is the largest value outside
    that run."""
    first = int(np.argmax(sigma))
    run = first
    while run + 1 < sigma.size and sigma[run + 1] == sigma[first]:
        run += 1
    rest = np.concatenate([sigma[:first], sigma[run + 1:]])
    return rest.size > 0 and rest.max() >= sigma[first] * (1 - OTSU_NEAR_TIE_REL)


@pytest.fixture(scope="module")
def otsu_batch():
    """Text-like, uniform, two-level, blurred-and-equalized and sparse images:
    296 in all, at 40 x 56 with the ragged extents.  The blurred ones come
    from the port's equalize and blur, which the tests above hold byte for
    byte to JAX's."""
    rng = np.random.default_rng(3)
    text = _text_like(rng, 96, H, W)
    uniform = rng.integers(0, 256, size=(64, H, W)).astype(np.uint8)
    lo, hi = rng.integers(0, 128, 64), rng.integers(128, 256, 64)
    two = np.where(rng.random((64, H, W)) < rng.random((64, 1, 1)), lo[:, None, None],
                   hi[:, None, None]).astype(np.uint8)
    sparse = rng.choice(np.array([0, 40, 90, 91, 180, 255], np.uint8), size=(32, H, W))
    smooth = tim.gaussian_blur3_u8(tim.equalize_hist_u8(_t(text[:40]))).numpy()
    return np.concatenate([text, uniform, two, sparse, smooth])


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "valid_region"])
def test_otsu_thresholds_equal_but_for_jax_near_ties(otsu_batch, masked):
    gray = otsu_batch
    n = gray.shape[0]
    sizes = np.resize(SIZES, (n, 2)) if masked else None
    jm, tm = _mask(gray, sizes) if masked else (None, None)
    got = tim.otsu_threshold(_t(gray), tm)
    assert got.dtype == torch.float32
    got = got.numpy().astype(np.int64)
    want = np.asarray(jim.otsu_threshold(_j(gray), jm)).astype(np.int64)
    sigma = _jax_sigma_b(gray, jm)
    near_tie = np.array([_near_tie(s) for s in sigma])
    differ = got != want
    assert not (differ & ~near_tie).any(), np.nonzero(differ & ~near_tie)
    # where they differ, the port's pick is one of JAX's near-tied maxima
    rows = np.nonzero(differ)[0]
    top = sigma[rows].max(1)
    assert np.all(sigma[rows, got[rows]] >= top * (1 - OTSU_NEAR_TIE_REL))
    assert near_tie.sum() <= OTSU_MAX_NEAR_TIE_SHARE * n, near_tie.sum()
    binar = tim.otsu_binarize(_t(gray), tm).numpy()
    same = ~differ
    np.testing.assert_array_equal(binar[same],
                                  np.asarray(jim.otsu_binarize(_j(gray), jm))[same])


@pytest.mark.parametrize("ragged", [False, True], ids=["bucket_edge", "valid_edge"])
def test_gaussian_blur_byte_identical(batch, ragged):
    gray, _ = batch
    rng = np.random.default_rng(5)
    noisy = np.concatenate([gray, rng.integers(0, 256, size=(B, H, W)).astype(np.uint8)])
    sizes = np.concatenate([SIZES, SIZES[::-1]]) if ragged else None
    got = tim.gaussian_blur3_u8(_t(noisy), None if sizes is None else _t(sizes))
    want = jim.gaussian_blur3_u8(_j(noisy), None if sizes is None else _j(sizes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["rot90_cw", "rot90_ccw", "rot180"])
def test_rot90s_byte_identical(batch, fn):
    gray, bgr = batch
    for x in (gray, bgr, bgr[0], gray[0]):
        np.testing.assert_array_equal(getattr(tim, fn)(_t(x)).numpy(),
                                      np.asarray(getattr(jim, fn)(_j(x))))


def test_normalize_skew_angle_byte_identical():
    a = np.concatenate([np.linspace(-90, 90, 721, dtype=np.float32),
                        np.array([-45, 45, -45.000004, 45.000004, 0, -0.0, 89.99999],
                                 np.float32)])
    for max_abs in (45.0, 10.0):
        np.testing.assert_array_equal(
            tim.normalize_skew_angle(_t(a), max_abs).numpy(),
            np.asarray(jim.normalize_skew_angle(_j(a), max_abs)))


def test_cubic_weights_equal():
    t = np.linspace(0, 1, 33, dtype=np.float32)
    for g, w in zip(tim._cubic_weights(_t(t)), jim._cubic_weights(_j(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("interpolation", ["nearest", "linear", "cubic"])
def test_rotate_zero_angle_is_identity(batch, interpolation):
    gray, _ = batch
    zero = torch.zeros(B)
    np.testing.assert_array_equal(tim.rotate_image(_t(gray), zero, interpolation).numpy(), gray)
    np.testing.assert_array_equal(
        tim.rotate_image(_t(gray), zero, interpolation, sizes=_t(SIZES)).numpy(), gray)


@pytest.mark.parametrize("interpolation", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("ragged", [False, True], ids=["bucket_center", "valid_center"])
def test_rotate_matches_jax_within_tolerance(batch, interpolation, ragged):
    gray, _ = batch
    angles = np.array([7.5, -12.25, 90.0, -90.0, 33.3, 0.0, 180.0, 1e-3], np.float32)
    sizes = SIZES if ragged else None
    got = tim.rotate_image(_t(gray), _t(angles), interpolation,
                           sizes=None if sizes is None else _t(sizes))
    want = np.asarray(jim.rotate_image(_j(gray), _j(angles), interpolation,
                                       sizes=None if sizes is None else _j(sizes)))
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= ROT_MAX_DIFF, diff.max()
    assert (diff > 0).mean() <= ROT_MAX_SHARE, (diff > 0).mean()
    # float input keeps its dtype
    fgot = tim.rotate_image(_t(gray.astype(np.float32)), _t(angles), interpolation)
    assert fgot.dtype == torch.float32


@pytest.mark.parametrize("channels", [0, 3], ids=["gray", "bgr"])
def test_resize_bilinear_matches_jax(batch, channels):
    gray, bgr = batch
    x = bgr if channels else gray
    for oh, ow in ((32, 32), (17, 70), (80, 23)):
        got = tim.resize_bilinear(_t(x), oh, ow)
        want = np.asarray(jim.resize_bilinear(_j(x), oh, ow))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)
    mh, mw = tim._resize_mats(40, 56, 17, 70)
    jh, jw = jim._resize_mats(40, 56, 17, 70)
    np.testing.assert_array_equal(mh, jh)
    np.testing.assert_array_equal(mw, jw)


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "valid_region"])
def test_orientation_angle_moments_within_tolerance(masked):
    rng = np.random.default_rng(9)
    angles = np.array([-40, -25, -8, -1, 0, 3, 12, 29, 38, 75], np.float64)
    gray = _text_like(rng, len(angles), 64, 96, angles)
    gray[1, :, :] = 255  # no dark pixel: angle 0
    sizes = np.resize(np.array([[64, 96], [50, 70], [64, 60], [40, 96], [33, 80]], np.int32),
                      (len(angles), 2))
    jm, tm = _mask(gray, sizes) if masked else (None, None)
    got = tim.orientation_angle_moments(_t(gray), tm)
    want = np.asarray(jim.orientation_angle_moments(_j(gray), jm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ANGLE_ATOL_DEG)
    assert got[1] == 0.0
