"""The port's manga-ocr input graph against the JAX package's
``model_preprocess``: bucket-padded uint8 crops with mixed valid extents,
BGR and gray-wire inputs, atol 1e-5 on the normalized pixels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.ops import preprocess as jpp
from manga_ocr_tpu.parallel import batching
from manga_ocr_tpu_torch.ops import image as tim
from manga_ocr_tpu_torch.ops import preprocess as tpp
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-5


def _batch(gray: bool):
    rng = np.random.default_rng(0)
    crops = [rng.integers(0, 256, size=hw + (3,)).astype(np.uint8)
             for hw in [(40, 60), (128, 128), (17, 99), (100, 30), (5, 128)]]
    (b,) = batching.bucket_crops(crops, buckets=((128, 128),), gray=gray)
    return b.crops, b.sizes


@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray_wire"])
def test_model_preprocess_matches_jax(gray):
    crops, sizes = _batch(gray)
    want = np.asarray(jpp.model_preprocess(jnp.asarray(crops), jnp.asarray(sizes), image_size=32))
    got = tpp.model_preprocess(torch.from_numpy(crops), torch.from_numpy(sizes), image_size=32)
    assert got.shape == want.shape == (crops.shape[0], 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_model_preprocess_without_sizes_matches_jax():
    crops, _ = _batch(False)
    want = np.asarray(jpp.model_preprocess(jnp.asarray(crops), image_size=48))
    got = tpp.model_preprocess(torch.from_numpy(crops), image_size=48)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_gray_matches_host_wire():
    """The port's grayscale equals the host gray wire bit for bit."""
    crops, _ = _batch(False)
    np.testing.assert_array_equal(
        tim.bgr_to_gray_u8(torch.from_numpy(crops)).numpy(), batching.gray_u8_np(crops)
    )


def test_orientation_constants_match():
    for name in ("ORIENT_AUTO", "ORIENT_VERTICAL", "ORIENT_HORIZONTAL", "ORIENT_NONE"):
        assert getattr(tpp, name) == getattr(jpp, name)
