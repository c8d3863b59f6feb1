"""The whole slice: ``TorchMangaOcrEngine(device="cpu", dtype=float32)``
against ``TpuMangaOcrEngine(dtype=float32)`` on the same numpy-made weights
and the same crops, in the three single-device configurations: int8
serving (JAX's CPU engine turns it on by itself), unquantized serving
(``quantize_int8=False``) and the exact reference path
(``serving_kernels=False``); the int8 serving engine with kernel A's int8
SDPA and kernel C's ``fuse_kv`` form; and ``serving_kernels=False`` on a
``fused_loop`` + ``fuse_cross_kv`` config; and ``ocr_page_dual`` on the
int8 serving engine and the reference path, with and without a second
engine.  The strings must be IDENTICAL.  Weights use
std 0.1 so the texts differ from crop to crop (and some rows end at EOS)."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.engine import TpuMangaOcrEngine
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer as PortTokenizer
from manga_ocr_tpu_torch.parallel import batching
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
MAX_LEN = 12


def _fixture_crops(n=8):
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))[:n]
    return [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]


def _random_crop(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def engine_pair():
    """``engine_pair(cfg, **kw)``: the JAX and the port's engine on the same
    std-0.1 weights, built once per configuration in this module, so a JAX
    engine keeps the programs it compiled for earlier tests."""
    built = {}

    def get(cfg=None, **kw):
        cfg = cfg or MangaOCRConfig.tiny()
        key = (repr(cfg), tuple(sorted(kw.items())))
        if key not in built:
            np_params = init_params_numpy(cfg, 0, std=0.1)
            jax_engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(),
                                           max_length=MAX_LEN, dtype=jnp.float32, **kw)
            torch_engine = TorchMangaOcrEngine(
                params_from_jax(np_params, "cpu"), port_config(cfg), PortTokenizer.synthetic(),
                max_length=MAX_LEN, dtype=torch.float32, device="cpu", **kw,
            )
            built[key] = jax_engine, torch_engine
        return built[key]

    return get


@pytest.fixture(scope="module")
def engines(engine_pair):
    return engine_pair()


@pytest.fixture(scope="module")
def page():
    return _fixture_crops() + [_random_crop(40, 60, 1), _random_crop(300, 90, 2),
                               _random_crop(100, 400, 3)]


def test_ocr_page_strings_identical_to_jax_engine(engines, page):
    jax_engine, torch_engine = engines
    want = jax_engine.ocr_page(page)
    got = torch_engine.ocr_page(page)
    assert got == want
    assert len(set(got)) > 3  # texts depend on the crop


@pytest.mark.parametrize("orientation", [0, 1, 2], ids=["auto", "vertical", "horizontal"])
def test_orientations_identical_to_jax_engine(engines, orientation):
    jax_engine, torch_engine = engines
    crops = [_random_crop(40, 90, 4), _random_crop(90, 40, 5)]
    assert torch_engine.ocr_page(crops, orientation) == jax_engine.ocr_page(crops, orientation)


def test_ocr_pages_streams_like_ocr_page(engines, page):
    _, torch_engine = engines
    pages = [page[:4], page[4:], [], page[2:6]]
    want = [torch_engine.ocr_page(p) for p in pages]
    assert torch_engine.ocr_pages(pages, lookahead=2) == want
    assert torch_engine.ocr_pages(pages, lookahead=0) == want


def test_crop_alone_equals_crop_in_batch(engines, page):
    _, torch_engine = engines
    alone = torch_engine.ocr_page([page[0]])[0]
    assert torch_engine.ocr_page([page[0], page[1], page[2]])[0] == alone


def test_perform_ocr_contract(engines, page):
    jax_engine, torch_engine = engines
    settings = {"orientation": "Vertical"}
    assert torch_engine.perform_ocr(page[0], settings) == jax_engine.perform_ocr(page[0], settings)
    assert torch_engine.perform_ocr(np.zeros((0, 0, 3), np.uint8)).startswith("[ERROR")
    assert torch_engine.perform_ocr(None).startswith("[ERROR")
    gray = np.full((32, 32), 128, np.uint8)
    out = torch_engine.perform_ocr(gray)
    assert isinstance(out, str) and not out.startswith("[ERROR")


def test_warm_set_and_warmup(engines):
    _, torch_engine = engines
    assert len(torch_engine.warm_set()) == len(batching.DEFAULT_BUCKETS) * len(
        batching.BATCH_SCHEDULE
    )
    torch_engine.warmup(bucket_hws=[(128, 128)], batch_sizes=[8])
    assert ((128, 128), 8) in torch_engine._warmed


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(MangaOCRConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMangaOcrEngine({}, cfg, PortTokenizer.synthetic(), device="cuda")


@pytest.mark.parametrize(
    "kw, dec", [({"quantize_int8": False}, {}), ({"serving_kernels": False}, {}),
                ({"serving_kernels": False}, {"step_kernel": "fused_loop", "fuse_cross_kv": True})],
    ids=["unquantized_serving", "reference_path", "fused_loop_fuse_cross_kv"],
)
def test_other_configurations_identical_to_jax_engine(engine_pair, kw, dec, page):
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **dec))
    jax_engine, torch_engine = engine_pair(cfg, **kw)
    assert torch_engine.cfg == port_config(jax_engine.cfg)
    assert all(v.dtype != torch.int8 for v in _leaves(torch_engine.params))
    got = torch_engine.ocr_page(page)
    assert got == jax_engine.ocr_page(page)
    assert len(set(got)) > 3


def test_int8_engine_with_sdpa_int8_and_fuse_cross_kv_identical_to_jax_engine(
        engine_pair, page):
    """The slice's serving path: the int8 engine with kernel A's int8 SDPA
    in the encoder and kernel C's fuse_kv form for the decode (JAX's
    ``with_serving_kernels`` keeps both flags, and so does the port's)."""
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attn_sdpa_int8=True),
        decoder=dataclasses.replace(cfg.decoder, fuse_cross_kv=True))
    jax_engine, torch_engine = engine_pair(cfg)
    assert torch_engine.cfg == port_config(jax_engine.cfg)
    assert torch_engine.cfg.encoder.attn_sdpa_int8 and torch_engine.cfg.decoder.fuse_cross_kv
    got = torch_engine.ocr_page(page)
    assert got == jax_engine.ocr_page(page)
    assert len(set(got)) > 3


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _dual_page():
    """The crops of JAX's dual-pass tests: three shape buckets (one of them
    wide, which Auto-Detect keeps wide), a 2-D and a [h, w, 1] grayscale
    crop and a flat one.  Four crops in the 128 x 128 bucket, so the raw
    and binarized rows fill the batch of 8 that ``page`` already compiled."""
    gray = np.random.default_rng(3).integers(0, 255, size=(50, 60)).astype(np.uint8)
    return [_random_crop(40, 60, 91), _random_crop(300, 90, 92), _random_crop(100, 400, 93),
            gray, gray[..., None], np.full((40, 50), 180, np.uint8)]


@pytest.fixture(scope="module")
def reference_engines(engine_pair):
    """The exact reference path (``serving_kernels=False``) in both packages."""
    return engine_pair(serving_kernels=False)


@pytest.mark.parametrize("which", ["int8_serving", "reference_path"])
def test_ocr_page_dual_pairs_identical_to_jax_engine(engines, reference_engines, which):
    """Both variants of every crop through one ``ocr_page`` (JAX
    ``tests/test_engine.py`` dual-pass cases: multi-bucket, grayscale)."""
    jax_engine, torch_engine = engines if which == "int8_serving" else reference_engines
    crops = _dual_page()
    got = torch_engine.ocr_page_dual(crops)
    assert got == jax_engine.ocr_page_dual(crops)
    assert len(got) == len(crops) and all(len(p) == 2 for p in got)
    assert got[:3] == torch_engine.ocr_page_dual(crops[:3])  # a crop alone = in the page
    assert torch_engine.ocr_page_dual([]) == jax_engine.ocr_page_dual([]) == []


class _Second:
    """A stand-in second engine that records what it is given."""

    def __init__(self):
        self.calls = []

    def perform_ocr(self, img, settings=None):
        self.calls.append((img, dict(settings or {})))
        return "second"


def test_ocr_page_dual_routes_the_second_engine_like_jax(engines):
    """With a second engine, it gets the binarized crops (byte-identical to
    JAX's, cropped to each crop's extent) with the caller's settings under
    the Tesseract(jpn) overrides; the raw crops go through ``ocr_page``."""
    jax_engine, torch_engine = engines
    crops = _dual_page()
    settings = {"orientation": "Vertical", "custom_knob": 7, "ocr_engine": "Manga-OCR"}
    got_second, want_second = _Second(), _Second()
    got = torch_engine.ocr_page_dual(crops, second_engine=got_second, settings=settings)
    want = jax_engine.ocr_page_dual(crops, second_engine=want_second, settings=settings)
    assert got == want
    assert [p[1] for p in got] == ["second"] * len(crops)
    assert [p[0] for p in got] == torch_engine.ocr_page(crops, 0)
    assert len(got_second.calls) == len(want_second.calls) == len(crops)
    for (img, s), (jimg, js), crop in zip(got_second.calls, want_second.calls, crops):
        assert img.dtype == np.uint8 and img.shape == crop.shape[:2] + (3,)
        np.testing.assert_array_equal(img, jimg)
        assert set(np.unique(img)) <= {0, 255}
        assert s == js
        assert s["ocr_engine"] == "Tesseract" and s["ocr_lang"] == "jpn"
        assert s["tesseract_lang"] == "jpn"
        assert s["orientation"] == "Vertical" and s["custom_knob"] == 7
    # no settings: the overrides alone
    only = _Second()
    torch_engine.ocr_page_dual(crops[:1], second_engine=only)
    assert only.calls[0][1] == {"ocr_engine": "Tesseract", "ocr_lang": "jpn",
                                "tesseract_lang": "jpn"}
