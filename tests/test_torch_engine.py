"""The whole slice: ``TorchMangaOcrEngine(device="cpu", dtype=float32)``
against ``TpuMangaOcrEngine(dtype=float32)`` on the same numpy-made weights
and the same crops, in the three single-device configurations: int8
serving (JAX's CPU engine turns it on by itself), unquantized serving
(``quantize_int8=False``) and the exact reference path
(``serving_kernels=False``); the int8 serving engine with kernel A's int8
SDPA and kernel C's ``fuse_kv`` form; and ``serving_kernels=False`` on a
``fused_loop`` + ``fuse_cross_kv`` config.  The strings must be IDENTICAL.  Weights use
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

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
MAX_LEN = 12


def _fixture_crops(n=8):
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))[:n]
    return [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]


def _random_crop(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def engines():
    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, 0, std=0.1)
    tok = CharTokenizer.synthetic()
    jax_engine = TpuMangaOcrEngine(np_params, cfg, tok, max_length=MAX_LEN, dtype=jnp.float32)
    torch_engine = TorchMangaOcrEngine(
        params_from_jax(np_params, "cpu"), port_config(cfg), PortTokenizer.synthetic(),
        max_length=MAX_LEN, dtype=torch.float32, device="cpu",
    )
    return jax_engine, torch_engine


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
def test_other_configurations_identical_to_jax_engine(kw, dec, page):
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **dec))
    np_params = init_params_numpy(cfg, 0, std=0.1)
    tok = CharTokenizer.synthetic()
    jax_engine = TpuMangaOcrEngine(np_params, cfg, tok, max_length=MAX_LEN, dtype=jnp.float32,
                                   **kw)
    torch_engine = TorchMangaOcrEngine(
        params_from_jax(np_params, "cpu"), port_config(cfg), PortTokenizer.synthetic(),
        max_length=MAX_LEN, dtype=torch.float32, device="cpu", **kw,
    )
    assert torch_engine.cfg == port_config(jax_engine.cfg)
    assert all(v.dtype != torch.int8 for v in _leaves(torch_engine.params))
    got = torch_engine.ocr_page(page)
    assert got == jax_engine.ocr_page(page)
    assert len(set(got)) > 3


def test_int8_engine_with_sdpa_int8_and_fuse_cross_kv_identical_to_jax_engine(page):
    """The slice's serving path: the int8 engine with kernel A's int8 SDPA
    in the encoder and kernel C's fuse_kv form for the decode (JAX's
    ``with_serving_kernels`` keeps both flags, and so does the port's)."""
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, attn_sdpa_int8=True),
        decoder=dataclasses.replace(cfg.decoder, fuse_cross_kv=True))
    np_params = init_params_numpy(cfg, 0, std=0.1)
    jax_engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), max_length=MAX_LEN,
                                   dtype=jnp.float32)
    torch_engine = TorchMangaOcrEngine(
        params_from_jax(np_params, "cpu"), port_config(cfg), PortTokenizer.synthetic(),
        max_length=MAX_LEN, dtype=torch.float32, device="cpu",
    )
    assert torch_engine.cfg == port_config(jax_engine.cfg)
    assert torch_engine.cfg.encoder.attn_sdpa_int8 and torch_engine.cfg.decoder.fuse_cross_kv
    got = torch_engine.ocr_page(page)
    assert got == jax_engine.ocr_page(page)
    assert len(set(got)) > 3


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_dual_pass_not_ported(engines, page):
    with pytest.raises(NotImplementedError):
        engines[1].ocr_page_dual(page[:2])
