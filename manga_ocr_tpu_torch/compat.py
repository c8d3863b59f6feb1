"""The ``manga_ocr.MangaOcr`` callable on the port (counterpart of
``manga_ocr_tpu/compat.py``).

Reference-era callers construct the reader once and call it with a PIL
image (``reader = MangaOcr()`` then ``reader(pil_img)``), getting the OCR'd
string.  Behind it sit ``TorchMangaOcrEngine`` and a microbatcher, so many
concurrent per-crop callers still coalesce into page-size dispatches.
"""

from __future__ import annotations

import os
import sys

import numpy as np


class MangaOcr:
    """API-compatible replacement for ``manga_ocr.MangaOcr`` on the port.

    ``pretrained_model_name_or_path`` (else ``$MANGA_OCR_CHECKPOINT``) is a
    local HF checkpoint directory.  The engine runs on CUDA unless
    ``force_cpu``; without CUDA that raises, it never falls back to the CPU.
    Weights load at the compute dtype (bf16 on CUDA, f32 under
    ``force_cpu``), as the JAX package's ``MangaOcr`` loads them, so the int8
    scales come from the bf16-rounded weights."""

    def __init__(
        self,
        pretrained_model_name_or_path: str | None = None,
        force_cpu: bool = False,
        microbatch_window_ms: float = 10.0,
        allow_random_weights: bool = False,
    ):
        import torch

        from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
        from manga_ocr_tpu_torch.models import model as mdl
        from manga_ocr_tpu_torch.models.config import MangaOCRConfig
        from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint
        from manga_ocr_tpu_torch.models.params import init_params
        from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
        from manga_ocr_tpu_torch.runtime.pipeline import MicroBatcher

        path = pretrained_model_name_or_path or os.environ.get("MANGA_OCR_CHECKPOINT", "")
        dtype = torch.float32 if force_cpu else torch.bfloat16
        if path and os.path.isdir(path):
            params, cfg = load_hf_checkpoint(path, dtype)
            vocab = os.path.join(path, "vocab.txt")
            tok = (
                CharTokenizer.from_vocab_file(vocab)
                if os.path.exists(vocab)
                else CharTokenizer.synthetic()
            )
        else:
            if path:
                raise FileNotFoundError(
                    f"checkpoint dir not found: {path!r} (hub downloads are "
                    "not supported; pass a local dir)"
                )
            # The reference constructor loads real weights or fails; random
            # weights answering as if they were a model are an explicit opt-in.
            if not allow_random_weights:
                raise RuntimeError(
                    "MangaOcr: no checkpoint found. Pass a local checkpoint "
                    "dir (pretrained_model_name_or_path=...) or set "
                    "MANGA_OCR_CHECKPOINT. To run with RANDOM weights (test "
                    "output only), pass allow_random_weights=True."
                )
            print(
                "MangaOcr: running with RANDOM weights (no checkpoint) — "
                "output is not real OCR",
                file=sys.stderr,
                flush=True,
            )
            cfg = MangaOCRConfig.base()
            params = mdl.cast_params(init_params(cfg, 0, "cpu"), dtype)
            tok = CharTokenizer.synthetic()
        self.engine = TorchMangaOcrEngine(
            params, cfg, tok, dtype=dtype, device="cpu" if force_cpu else "cuda"
        )
        self._batcher = MicroBatcher(self.engine.ocr_page, window_ms=microbatch_window_ms)

    def __call__(self, img) -> str:
        """PIL image / numpy array / path -> OCR'd text."""
        return self._batcher.ocr(_to_bgr(img))

    def close(self) -> None:
        self._batcher.close()


def _to_bgr(img) -> np.ndarray:
    if isinstance(img, str):
        from manga_ocr_tpu_torch.core.files import safe_open_image

        arr = safe_open_image(img)
        if arr is None:
            raise FileNotFoundError(img)
        return arr
    if isinstance(img, np.ndarray):
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return img
    # PIL image
    rgb = np.asarray(img.convert("RGB"))
    return rgb[..., ::-1].copy()
