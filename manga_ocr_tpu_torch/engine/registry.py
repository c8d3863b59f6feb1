"""OCR engine registry + dispatch (the reference's engine/language layer;
the port's counterpart of ``manga_ocr_tpu/engine/registry.py``).

The reference's ``perform_ocr`` engine dispatch
(``src/ui/main_window.py:9774-9931``) and engine/language registry
(``populate_ocr_languages`` ``:3266-3347``):

- engines register under the reference's names (Manga-OCR, Tesseract,
  EasyOCR, PaddleOCR, DocTR, RapidOCR, AI_OCR, MOFRL-GPT, and the JAX
  package's "Latin (TPU)"),
- availability is probed lazily (optional host deps are never imported at
  module load),
- **Japanese always routes to Manga-OCR when available** (the reference
  suppresses Japanese entries of other engines, ``:3291-3316``),
- unknown engines / failures return ``"[ERROR: ...]"`` sentinel strings.

The code is the JAX package's, statement for statement, but for the
``device`` of ``EngineRegistry`` and ``make_default_registry`` (the
Latin path's ``ocr_preprocess`` runs there; ``"cuda"`` raises where CUDA is
unavailable), ``_latin_preprocess`` on the port's ``ocr_preprocess`` and
the Latin factory's ``TorchLatinEngine``.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Optional, Protocol

import numpy as np


def _err(msg: str) -> str:
    return f"[ERROR: {msg}]"


def _latin_preprocess(image: np.ndarray, settings: dict, device="cuda") -> np.ndarray:
    """Binarize via the preprocessing graph (``ops/preprocess.ocr_preprocess``
    on ``device``) for Latin OCR engines.

    Orientation passes straight through to the graph: the reference's Latin
    path (``preprocess_for_ocr``, ``main_window.py:4204-4232``) rotates
    +90° CCW *in the same (w, h) frame* (``warpAffine`` clips a wide crop)
    for "Vertical" when w > h, and applies NO rotation for "Horizontal" —
    exactly what ``ocr_preprocess``'s branches implement
    (``rotate_image`` is CCW-positive and cv2-parity-tested)."""
    import torch

    from manga_ocr_tpu_torch.ops import preprocess as pp
    from manga_ocr_tpu_torch.parallel import batching

    setting = str(settings.get("orientation", "Auto-Detect"))
    orientation = {
        "Auto-Detect": pp.ORIENT_AUTO,
        "Vertical": pp.ORIENT_VERTICAL,
        "Horizontal": pp.ORIENT_HORIZONTAL,
    }.get(setting, pp.ORIENT_AUTO)
    # Bucket-pad even the single crop, as the JAX package does: the bucket
    # set bounds the number of shapes the device sees, and ``sizes`` masks
    # the graph's statistics to the valid region (the same pattern as
    # engine.ocr_page_dual).  No fallback: a CUDA failure raises.
    [batch] = batching.bucket_crops([image])
    with torch.inference_mode():
        out, _ = pp.ocr_preprocess(
            torch.from_numpy(batch.crops).to(device), orientation=orientation,
            sizes=torch.from_numpy(batch.sizes).to(device),
        )
        h, w = batch.sizes[0]
        return out[0, :h, :w].cpu().numpy()


class OcrEngine(Protocol):
    def perform_ocr(self, cv_bgr_image: np.ndarray, settings: dict | None = None) -> str: ...


class EngineRegistry:
    def __init__(self, device="cuda"):
        # the device of the Latin path's preprocessing graph; "cuda" raises
        # where CUDA is unavailable rather than running on the CPU
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EngineRegistry: device='cuda' but CUDA is unavailable")
        self._engines: dict[str, object] = {}
        self._factories: dict[str, Callable[[], object]] = {}
        self._probes: dict[str, Callable[[], bool]] = {}

    def register(self, name: str, engine: object) -> None:
        self._engines[name] = engine

    def register_lazy(
        self,
        name: str,
        factory: Callable[[], object],
        probe: Callable[[], bool] | None = None,
    ) -> None:
        """``probe``: cheap availability check (package present / binary on
        PATH) so listing engines never constructs them — constructors may
        download pretrained weights (EasyOCR/DocTR/Paddle)."""
        self._factories[name] = factory
        if probe is not None:
            self._probes[name] = probe

    def get(self, name: str):
        if name in self._engines:
            return self._engines[name]
        if name in self._factories:
            try:
                engine = self._factories[name]()
            except Exception:
                engine = None
            if engine is not None:
                self._engines[name] = engine
                # constructed: the factory (and probe) are no longer needed
                del self._factories[name]
                self._probes.pop(name, None)
            # on failure the factory stays registered: a transient init
            # error (e.g. weights download while offline) must not disable
            # the engine for the process lifetime
            return engine
        return None

    def available_engines(self) -> list[str]:
        """Engines that are constructed, probe as available, or construct on
        demand.  Probed entries are NOT constructed here."""
        out = []
        for n in sorted(set(self._engines) | set(self._factories)):
            if n in self._engines:
                out.append(n)
            elif n in self._probes:
                try:
                    if self._probes[n]():
                        out.append(n)
                except Exception:
                    pass
            elif self.get(n) is not None:
                out.append(n)
        return out

    # -- dispatch (perform_ocr contract) ---------------------------------------

    def perform_ocr(self, image: np.ndarray, settings: dict) -> str:
        """Engine dispatch with the reference's crop-preparation rules
        (``run_standard_pipeline``, ``workers.py:281-352``):

        - Manga-OCR gets the raw crop (orientation handled in-engine),
        - AI engines get the pure raw crop,
        - other (Latin) engines get the binarized ``ocr_preprocess`` output,
          retrying with the raw crop when the result comes back empty."""
        name = settings.get("ocr_engine", "Manga-OCR")
        lang = str(settings.get("ocr_lang", "ja")).lower()
        # Japanese is forced to Manga-OCR when present (reference rule).
        if ("ja" in lang or "jp" in lang) and self.get("Manga-OCR") is not None:
            name = "Manga-OCR"
        engine = self.get(name)
        if engine is None:
            return _err(f"{name} not installed or initialized")
        try:
            if name in ("Manga-OCR", "AI_OCR", "MOFRL-GPT"):
                return engine.perform_ocr(image, settings)
            # Latin-engine path: preprocess, retry raw on empty result
            processed = _latin_preprocess(image, settings, self.device)
            out = engine.perform_ocr(processed, settings)
            if not (out or "").strip() or out.startswith("[ERROR"):
                out = engine.perform_ocr(image, settings)
            return out
        except Exception as e:
            return _err(f"{name}: {type(e).__name__}: {e}")

    def ocr_languages(self) -> dict[str, list[str]]:
        """Engine -> language entries (the OCR_LANGS combo contract)."""
        langs: dict[str, list[str]] = {}
        for name in self.available_engines():
            if name == "Manga-OCR":
                langs[name] = ["ja"]
            elif name == "Tesseract":
                langs[name] = ["en", "ja", "ko", "zh"]
            elif name in ("AI_OCR", "MOFRL-GPT"):
                langs[name] = ["any"]
            else:
                langs[name] = ["en", "ko", "zh"]  # ja suppressed: Manga-OCR wins
        return langs


# ---------------------------------------------------------------------------
# Host engine adapters (optional, for capability parity)
# ---------------------------------------------------------------------------


class TesseractEngine:
    """Tesseract via subprocess (the reference shells out via pytesseract,
    ``main_window.py:9921-9929``: --oem 1, --psm 5 vertical / 6 horizontal)."""

    def __init__(self, binary: str | None = None):
        self.binary = binary or shutil.which("tesseract")
        if not self.binary:
            raise RuntimeError("tesseract binary not found")

    def perform_ocr(self, image: np.ndarray, settings: dict | None = None) -> str:
        settings = settings or {}
        lang = settings.get("tesseract_lang", "eng")
        vertical = settings.get("orientation") == "Vertical"
        psm = "5" if vertical else "6"
        try:
            from PIL import Image

            with tempfile.NamedTemporaryFile(suffix=".png") as f:
                Image.fromarray(image[..., ::-1]).save(f.name)
                out = subprocess.run(
                    [self.binary, f.name, "stdout", "-l", lang, "--oem", "1", "--psm", psm],
                    capture_output=True,
                    timeout=60,
                )
            if out.returncode != 0:
                return _err(f"TESSERACT: {out.stderr.decode()[:200]}")
            return out.stdout.decode("utf-8", errors="replace").strip()
        except Exception as e:
            return _err(f"TESSERACT: {e}")


def make_default_registry(
    tpu_engine=None, ai_ocr=None, settings: dict | None = None, device="cuda"
) -> EngineRegistry:
    """Standard registry: the OCR engine + lazily-probed host engines.

    ``tpu_engine`` (the JAX package's keyword, kept so one call serves both
    packages) registers as ``"Manga-OCR"``.  ``settings``: when the
    ``tpu.latin_*_checkpoint`` paths are configured, the port's Latin engine
    (``engine/latin.py`` ``TorchLatinEngine`` on ``device``) registers as
    ``"Latin (TPU)"`` — CRAFT detection + CTC recognition as batched
    dispatches instead of the per-image EasyOCR call.  The engine names
    are the JAX package's, verbatim: a job's ``settings["ocr_engine"]``
    selects the same engine in both packages."""
    reg = EngineRegistry(device)
    if tpu_engine is not None:
        reg.register("Manga-OCR", tpu_engine)
    if ai_ocr is not None:
        reg.register("AI_OCR", ai_ocr)

    tpu_cfg = (settings or {}).get("tpu", {})
    craft_path = tpu_cfg.get("latin_craft_checkpoint", "")
    crnn_path = tpu_cfg.get("latin_crnn_checkpoint", "")
    if craft_path and crnn_path:

        def _latin():
            from manga_ocr_tpu_torch.engine.latin import TorchLatinEngine

            # charset resolution: explicit settings override > native
            # checkpoint manifest > DEFAULT_CHARSET (torch .pth case)
            return TorchLatinEngine.from_checkpoints(
                craft_path,
                crnn_path,
                charset=tpu_cfg.get("latin_charset") or None,
                device=device,
            )

        reg.register_lazy(
            "Latin (TPU)",
            _latin,
            probe=lambda: os.path.exists(craft_path) and os.path.exists(crnn_path),
        )
    reg.register_lazy(
        "Tesseract",
        TesseractEngine,
        probe=lambda: shutil.which("tesseract") is not None,
    )

    def _easyocr():
        import easyocr  # optional

        reader = easyocr.Reader(["en"], gpu=False)

        class _E:
            def perform_ocr(self, image, settings=None):
                res = reader.readtext(image[..., ::-1], detail=0, paragraph=True)
                return "\n".join(res)

        return _E()

    reg.register_lazy(
        "EasyOCR",
        _easyocr,
        probe=lambda: importlib.util.find_spec("easyocr") is not None,
    )

    def _paddleocr():
        from paddleocr import PaddleOCR  # optional

        # version-tolerant constructor (the reference probes 3 signatures,
        # main_window.py:3476-3501)
        for kwargs in (
            {"use_angle_cls": True, "lang": "en", "show_log": False},
            {"use_angle_cls": True, "lang": "en"},
            {"lang": "en"},
        ):
            try:
                ocr = PaddleOCR(**kwargs)
                break
            except TypeError:
                continue
        else:
            return None

        class _P:
            def perform_ocr(self, image, settings=None):
                result = ocr.ocr(image)
                lines = []
                for page in result or []:
                    for item in page or []:
                        try:
                            lines.append(item[1][0])
                        except (IndexError, TypeError):
                            continue
                return "\n".join(lines)

        return _P()

    reg.register_lazy(
        "PaddleOCR",
        _paddleocr,
        probe=lambda: importlib.util.find_spec("paddleocr") is not None,
    )

    def _doctr():
        from doctr.models import ocr_predictor  # optional

        predictor = ocr_predictor(pretrained=True)

        class _D:
            def perform_ocr(self, image, settings=None):
                res = predictor([image[..., ::-1]])
                words = []
                for page in res.pages:
                    for block in page.blocks:
                        for line in block.lines:
                            words.append(" ".join(w.value for w in line.words))
                return "\n".join(words)

        return _D()

    reg.register_lazy(
        "DocTR",
        _doctr,
        probe=lambda: importlib.util.find_spec("doctr") is not None,
    )

    def _rapidocr():
        from rapidocr_onnxruntime import RapidOCR  # optional

        ocr = RapidOCR()

        class _R:
            def perform_ocr(self, image, settings=None):
                result, _ = ocr(image)
                return "\n".join(item[1] for item in result or [])

        return _R()

    reg.register_lazy(
        "RapidOCR",
        _rapidocr,
        probe=lambda: importlib.util.find_spec("rapidocr_onnxruntime") is not None,
    )
    return reg
