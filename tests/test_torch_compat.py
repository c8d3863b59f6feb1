"""The port's ``MangaOcr`` callable (``manga_ocr_tpu_torch/compat.py``)
against the JAX package's: both constructors run unpatched on one tiny HF
checkpoint directory (weights std 0.1 so the texts differ from crop to crop,
``max_length`` 12 in its config.json) under ``force_cpu=True``, and return
the same strings for fixture crops given as PIL images, numpy arrays (BGR
and gray) and paths.  The error paths raise as JAX's do, the weights load at
the compute dtype (bf16 without ``force_cpu``), and without CUDA the port
raises instead of running on the CPU."""

import dataclasses
import glob
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from manga_ocr_tpu import compat as jcompat
from manga_ocr_tpu_torch import compat as tcompat
from manga_ocr_tpu_torch.models import convert as tconv
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
PATHS = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))[:6]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    cfg = dataclasses.replace(MangaOCRConfig.tiny(), max_length=12)
    path = str(tmp_path_factory.mktemp("hf_tiny"))
    tconv.save_hf_checkpoint(path, init_params(cfg, 0, "cpu", std=0.1), cfg,
                             tokenizer=CharTokenizer.synthetic())
    return path


@pytest.fixture(scope="module")
def readers(hf_dir, tmp_path_factory):
    """The port's and the JAX package's ``MangaOcr(hf_dir, force_cpu=True)``."""
    with pytest.MonkeyPatch.context() as mp:
        # the JAX constructor turns on its persistent compile cache
        mp.setenv("MANGA_OCR_TPU_XLA_CACHE", str(tmp_path_factory.mktemp("xla_cache")))
        port = tcompat.MangaOcr(hf_dir, force_cpu=True, microbatch_window_ms=5.0)
        ref = jcompat.MangaOcr(hf_dir, force_cpu=True, microbatch_window_ms=5.0)
    yield port, ref
    port.close()
    ref.close()


def _inputs(kind):
    if kind == "path":
        return list(PATHS)
    pil = [Image.open(p).convert("RGB") for p in PATHS]
    if kind == "pil":
        return pil
    bgr = [np.asarray(im)[..., ::-1].copy() for im in pil]
    if kind == "numpy":
        return bgr
    return [c.mean(axis=-1).astype(np.uint8) for c in bgr]  # gray [h, w]


@pytest.mark.parametrize("kind", ["pil", "numpy", "gray", "path"])
def test_strings_equal_jax_manga_ocr(readers, kind):
    port, ref = readers
    got = [port(x) for x in _inputs(kind)]
    want = [ref(x) for x in _inputs(kind)]
    assert got == want
    assert all(isinstance(t, str) for t in got) and len(set(got)) > 1


def test_loads_the_checkpoint_at_the_compute_dtype(readers, hf_dir):
    port, _ = readers
    params, cfg = tconv.load_hf_checkpoint(hf_dir)
    assert port.engine.device.type == "cpu" and port.engine.dtype == torch.float32
    assert port.engine.max_length == cfg.max_length == 12
    assert torch.equal(port.engine.params["decoder"]["tok_embed"],
                       params["decoder"]["tok_embed"])


def test_threaded_calls_equal_single_calls(readers):
    port, _ = readers
    crops = _inputs("numpy")
    want = [port.engine.ocr_page([c])[0] for c in crops]
    got = [None] * len(crops)

    def call(i):
        got[i] = port(crops[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(crops))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == want


def test_missing_checkpoint_dir_raises_as_jax(tmp_path):
    missing = str(tmp_path / "nope")
    for cls in (tcompat.MangaOcr, jcompat.MangaOcr):
        with pytest.raises(FileNotFoundError, match="checkpoint dir not found"):
            cls(missing)


def test_no_checkpoint_refuses_without_random_weights(monkeypatch):
    monkeypatch.delenv("MANGA_OCR_CHECKPOINT", raising=False)
    for cls in (tcompat.MangaOcr, jcompat.MangaOcr):
        with pytest.raises(RuntimeError, match="allow_random_weights"):
            cls()


def test_checkpoint_from_the_environment(monkeypatch, hf_dir):
    monkeypatch.setenv("MANGA_OCR_CHECKPOINT", hf_dir)
    reader = tcompat.MangaOcr(force_cpu=True)
    try:
        assert reader.engine.cfg.decoder.vocab_size == 100
    finally:
        reader.close()


def test_random_weights_opt_in(monkeypatch, capsys):
    """Random weights are the port's numpy init of seed 0 (the base config
    swapped for the tiny one to keep the test small), with a notice."""
    monkeypatch.delenv("MANGA_OCR_CHECKPOINT", raising=False)
    monkeypatch.setattr(MangaOCRConfig, "base", staticmethod(MangaOCRConfig.tiny))
    reader = tcompat.MangaOcr(force_cpu=True, allow_random_weights=True)
    try:
        assert "RANDOM weights" in capsys.readouterr().err
        want = init_params(MangaOCRConfig.tiny(), 0, "cpu")
        assert torch.equal(reader.engine.params["decoder"]["pos_embed"],
                           want["decoder"]["pos_embed"])
        assert isinstance(reader(np.full((40, 60, 3), 200, np.uint8)), str)
    finally:
        reader.close()


def test_unreadable_image_path_raises(readers, tmp_path):
    port, ref = readers
    for reader in (port, ref):
        with pytest.raises(FileNotFoundError):
            reader(str(tmp_path / "missing.png"))


def test_without_cuda_raises_after_loading_bf16(monkeypatch, hf_dir):
    """Without ``force_cpu`` the weights load in bf16 for the CUDA engine;
    without CUDA the engine's RuntimeError propagates (no CPU fallback)."""
    loads = []
    real = tconv.load_hf_checkpoint

    def spy(path, dtype=torch.float32, device="cpu"):
        loads.append(dtype)
        return real(path, dtype, device)

    monkeypatch.setattr(tconv, "load_hf_checkpoint", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompat.MangaOcr(hf_dir)
    assert loads == [torch.bfloat16]
