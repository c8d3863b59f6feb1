"""The port's ``ocr_preprocess`` against the JAX package's on the fixture
crops (``tests/fixtures/eval``) for each orientation: with the valid extents,
and without them (every crop filling its bucket) on the gray wire.

With the extents, all 20 crops share one 256 x 256 bucket
(``batching.bucket_crops`` with that single bucket), so each JAX program
compiles once per orientation; the extents run from 42 to 193 pixels, wide
and tall.  Without them, the gray wire is the first default bucket
(16 x 128 x 128).  ``ocr_page_dual``'s own bucketing over the default
buckets is held against JAX by ``tests/test_torch_engine.py``, binarized
crops byte for byte.

NONE, HORIZONTAL and VERTICAL must be byte for byte (the angles too).  AUTO
rotates by the moment angle, whose f32 sums run in another order: its
angles are held to ``ANGLE_ATOL_DEG`` and its output to at most
``AUTO_MAX_PIXEL_SHARE`` differing pixels.  That angle tolerance needs the
reference's own f32 error to stay below it: on the whole 256 x 256 bucket
(65536 pixels, most of them edge padding) JAX's angles lie up to 1.07e-3
degrees from a float64 evaluation of the same moments, where the port's lie
within 5.4e-5; ``test_auto_angle_tracks_float64_moments_on_whole_large_images``
holds the port there to ``F64_ANGLE_ATOL_DEG`` of float64 instead."""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops import preprocess as jpp
from manga_ocr_tpu_torch.ops import image as tim
from manga_ocr_tpu_torch.ops import preprocess as tpp
from manga_ocr_tpu_torch.parallel import batching
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
ANGLE_ATOL_DEG = 1e-3
F64_ANGLE_ATOL_DEG = 1e-4
AUTO_MAX_PIXEL_SHARE = 1e-3
ORIENTATIONS = [tpp.ORIENT_AUTO, tpp.ORIENT_VERTICAL, tpp.ORIENT_HORIZONTAL, tpp.ORIENT_NONE]
IDS = ["auto", "vertical", "horizontal", "none"]


@pytest.fixture(scope="module")
def crops():
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))
    return [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]


@pytest.fixture(scope="module")
def bucket(crops):
    [bucket] = batching.bucket_crops(crops, buckets=((256, 256),))
    assert bucket.valid == len(crops) == 20
    return bucket


def _hold(orientation, got, want):
    (out, angles), (jout, jangles) = got, want
    jout, jangles = np.asarray(jout), np.asarray(jangles)
    assert out.dtype == torch.uint8 and out.shape == jout.shape
    assert angles.dtype == torch.float32 and angles.shape == jangles.shape
    assert set(np.unique(out.numpy())) <= {0, 255}
    if orientation == tpp.ORIENT_AUTO:
        np.testing.assert_allclose(angles.numpy(), jangles, rtol=0, atol=ANGLE_ATOL_DEG)
        assert (out.numpy() != jout).mean() <= AUTO_MAX_PIXEL_SHARE
    else:
        np.testing.assert_array_equal(angles.numpy(), jangles)
        np.testing.assert_array_equal(out.numpy(), jout)


@pytest.mark.parametrize("orientation", ORIENTATIONS, ids=IDS)
def test_ocr_preprocess_matches_jax_with_valid_extents(bucket, orientation):
    got = tpp.ocr_preprocess(torch.from_numpy(bucket.crops), orientation,
                             torch.from_numpy(bucket.sizes))
    want = jpp.ocr_preprocess(jnp.asarray(bucket.crops), orientation=orientation,
                              sizes=jnp.asarray(bucket.sizes))
    _hold(orientation, got, want)


@pytest.mark.parametrize("orientation", ORIENTATIONS, ids=IDS)
def test_ocr_preprocess_matches_jax_without_extents_on_gray_wire(crops, orientation):
    gray = batching.gray_u8_np(batching.bucket_crops(crops)[0].crops)  # [B, H, W]
    assert gray.shape == (16, 128, 128)
    got = tpp.ocr_preprocess(torch.from_numpy(gray), orientation)
    want = jpp.ocr_preprocess(jnp.asarray(gray), orientation=orientation)
    _hold(orientation, got, want)


def test_vertical_turns_only_wide_crops(bucket):
    _, angles = tpp.ocr_preprocess(torch.from_numpy(bucket.crops), tpp.ORIENT_VERTICAL,
                                   torch.from_numpy(bucket.sizes))
    wide = bucket.sizes[:, 1] > bucket.sizes[:, 0]
    np.testing.assert_array_equal(angles.numpy(), np.where(wide, 90.0, 0.0))


def _moment_angles_f64(gray):
    """``orientation_angle_moments`` over whole images, in float64."""
    mask = (gray < 255).astype(np.float64)
    yy, xx = np.mgrid[0:gray.shape[1], 0:gray.shape[2]].astype(np.float64)
    m00 = mask.sum((1, 2))
    safe = np.maximum(m00, 1.0)
    dx = xx[None] - ((mask * xx).sum((1, 2)) / safe)[:, None, None]
    dy = yy[None] - ((mask * yy).sum((1, 2)) / safe)[:, None, None]
    mu20, mu02, mu11 = ((mask * d).sum((1, 2)) / safe for d in (dx * dx, dy * dy, dx * dy))
    return np.where(m00 > 0, np.rad2deg(0.5 * np.arctan2(2.0 * mu11, mu20 - mu02)), 0.0)


def test_auto_angle_tracks_float64_moments_on_whole_large_images(bucket):
    gray = batching.gray_u8_np(bucket.crops)
    got = tim.orientation_angle_moments(torch.from_numpy(gray))
    np.testing.assert_allclose(got.numpy(), _moment_angles_f64(gray), rtol=0,
                               atol=F64_ANGLE_ATOL_DEG)
    _, angles = tpp.ocr_preprocess(torch.from_numpy(gray), tpp.ORIENT_AUTO)
    np.testing.assert_array_equal(angles.numpy(), tim.normalize_skew_angle(got).numpy())
