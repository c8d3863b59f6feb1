"""Bubble/text detection orchestration -- the AutoDetector equivalent
(counterpart of ``manga_ocr_tpu/detect/detector.py``).

The reference's ``AutoDetectorWorker`` (``workers.py:438-485``) loops files
on a QThread, runs the ONNX/YOLO mask model per page, extracts contours, and
emits ``{'polygon', 'text'}`` dicts that become per-crop jobs.  Here
detection is batched: the pages of one shape go to the device in
``segment_pages`` dispatches of up to ``DISPATCH_PAGES``, and the host
traces polygons (``detect/contours.py``: cv2, the native tracer, or NumPy).
``from_checkpoint`` also opens ``.onnx`` segmenters, run page by page on
the ONNX executor (``models/convert_onnx.py``, ``OnnxWrappedDetector``).
Under a mesh (``parallel.mesh``) a dispatch of at least the data-axis size
is split across the data devices.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from manga_ocr_tpu_torch.core.geometry import Rect, polygon_bounding_rect
from manga_ocr_tpu_torch.detect import contours as cont
from manga_ocr_tpu_torch.detect import postprocess as post
from manga_ocr_tpu_torch.models import detector as seg
from manga_ocr_tpu_torch.parallel import mesh as meshlib


# Pages a segment_pages dispatch: above four, cuDNN's heuristics pick FFT
# convolutions for DetectorConfig() with ~26 GiB of workspace, and a page
# takes longer, not less (chip_smoke.py's phase "detection", PERF.md).
DISPATCH_PAGES = 4


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device, torch.float32)


class BubbleDetector:
    """Batched DL bubble detection with classical contour fallback.

    ``params``: the port's detector tree (``models.detector.init_params``,
    ``load_params``, ``params_from_jax``) or a ``UNet``; None leaves only the
    classical finder.  The weights are copied once, in f32, to ``device``
    (default ``"cuda"``, which raises where CUDA is unavailable rather than
    running on the CPU).

    ``mesh``: a ``parallel.mesh.Mesh`` whose devices replace ``device``
    (they must be of its type).  A shape group goes in dispatches of at most
    ``DISPATCH_PAGES`` pages a device; a dispatch of at least the data-axis
    size is zero-padded and split across the data devices (the weights
    replicated once, on the first such dispatch), a smaller one runs on the
    first device."""

    def __init__(
        self,
        params=None,
        cfg: seg.DetectorConfig | None = None,
        min_area: float = 200.0,
        mesh=None,
        device="cuda",
    ):
        self.device = meshlib.serving_devices(mesh, device, "BubbleDetector")[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BubbleDetector: device='cuda' but CUDA is unavailable")
        self.cfg = cfg or seg.DetectorConfig()
        self.mesh = mesh
        self.params = params
        self.min_area = min_area
        self._net = None
        self._params_repl = None  # one tree per data device, made on first use
        if params is not None:
            tree = params.tree() if isinstance(params, seg.UNet) else params
            self._net = seg.UNet(_tree_to(tree, self.device), self.cfg).requires_grad_(False)

    @staticmethod
    def from_checkpoint(
        path: str,
        cfg: seg.DetectorConfig | None = None,
        mesh=None,
        min_area: float = 200.0,
        device="cuda",
    ):
        """Load detector weights: a flat ``.npz`` written by either package
        (``models.detector.save_params``), or a real ``.onnx`` checkpoint
        (parsed and executed on ``device`` by ``models/convert_onnx.py`` --
        the reference's detector family, ``main_window.py:6776-6815``).
        ``mesh`` applies to the ``.npz`` form only: the ONNX executor runs on
        ``device`` alone and ignores it with a note on stderr."""
        if str(path).lower().endswith(".onnx"):
            from manga_ocr_tpu_torch.models.convert_onnx import OnnxBubbleDetector

            if mesh is not None:
                print(
                    "note: mesh ignored for .onnx detector checkpoints "
                    "(single-device executor); convert to the native .npz "
                    "form for sharded dispatch",
                    file=sys.stderr,
                )
            return OnnxWrappedDetector(OnnxBubbleDetector.from_file(path, device=device),
                                       min_area=min_area, device=device)
        cfg = cfg or seg.DetectorConfig()
        return BubbleDetector(seg.load_params(path, cfg), cfg, min_area=min_area, mesh=mesh,
                              device=device)

    # -- reference-compatible single-page mask -------------------------------

    def detect_bubble_mask(self, page_bgr: np.ndarray) -> np.ndarray | None:
        """Full-page 0/255 bubble mask (``detect_bubble_with_dl_model``
        contract, ``main_window.py:6843-6856``)."""
        if self.params is None:
            return None
        masks = self.detect_bubble_masks([page_bgr])
        return masks[0]

    # -- batched page API -----------------------------------------------------

    def detect_bubble_masks(self, pages_bgr: Sequence[np.ndarray]) -> list[np.ndarray]:
        """One dispatch per DISPATCH_PAGES pages of one shape a device."""
        if self.params is None:
            raise RuntimeError("detector has no weights loaded")
        by_shape: dict[tuple, list[int]] = {}
        for i, p in enumerate(pages_bgr):
            by_shape.setdefault(p.shape[:2], []).append(i)
        out: list[Optional[np.ndarray]] = [None] * len(pages_bgr)
        for (h, w), group in by_shape.items():
            for part in meshlib.dispatch_slices(len(group), DISPATCH_PAGES, self.mesh):
                idxs = group[part]
                rgb = np.ascontiguousarray(np.stack([pages_bgr[i][..., ::-1] for i in idxs]))
                masks = self._segment(rgb, h, w)
                for row, i in enumerate(idxs):
                    out[i] = masks[row]
        return out  # type: ignore[return-value]

    def _segment(self, rgb: np.ndarray, h: int, w: int) -> np.ndarray:
        """One dispatch's host masks: on the first device, or, where the mesh
        splits it, zero-padded and one call on each data device, all
        launched before any is read back."""
        if not meshlib.splits(self.mesh, rgb.shape[0]):
            return seg.segment_pages(self._net, rgb, self.cfg, h, w).cpu().numpy()
        if self._params_repl is None:
            self._params_repl = meshlib.dp_replicate(self._net.tree(), self.mesh)
        shards = zip(self._params_repl, meshlib.dp_shard_batch(rgb, self.mesh))
        return meshlib.dp_gather([seg.segment_pages(t, x, self.cfg, h, w) for t, x in shards],
                                 rgb.shape[0])

    def detect_bubbles(self, page_bgr: np.ndarray) -> list[dict]:
        """Page -> [{'polygon': [N,2], 'text': None}] (AutoDetector schema)."""
        mask = self.detect_bubble_mask(page_bgr)
        if mask is None:
            return []
        polys = cont.mask_to_polygons(mask, min_area=self.min_area)
        return [{"polygon": p, "text": None} for p in polys]

    def detect_pages(
        self,
        pages_bgr: Sequence[np.ndarray],
        split_extended: bool = True,
        progress: Callable[[int, int], None] | None = None,
    ) -> list[list[dict]]:
        """Batched multi-page detection -> per-page detection lists."""
        masks = self.detect_bubble_masks(list(pages_bgr))
        results = []
        for i, mask in enumerate(masks):
            polys = cont.mask_to_polygons(mask, min_area=self.min_area)
            dets = [{"polygon": p, "text": None} for p in polys]
            if split_extended:
                dets = post.split_extended_bubbles(dets)
            results.append(dets)
            if progress:
                progress(i + 1, len(masks))
        return results

    # -- classical fallback ----------------------------------------------------

    def find_bubble_mask(
        self, page_bgr: np.ndarray, text_rect: Rect
    ) -> np.ndarray | None:
        """DL mask restricted to the bubble containing ``text_rect``; falls
        back to the classical contour finder (``find_speech_bubble_mask``
        behavior, ``main_window.py:6858-6879``)."""
        if self.params is not None:
            mask = self.detect_bubble_mask(page_bgr)
            if mask is not None:
                picked = _component_containing(mask, text_rect)
                if picked is not None:
                    return picked
        return cont.find_speech_bubble_mask_contour(page_bgr, text_rect)


def detector_from_settings(settings: dict, dl_models: dict):
    """The reference's detector dispatch (``detect_bubble_with_dl_model``,
    ``main_window.py:6843-6856``): ``use_dl_detector`` gates the DL path;
    (``dl_provider``, ``dl_model_file``) select the model from the registry
    (the reference's ``self.dl_models``, ``:513-520``).  Returns None when
    the DL detector is off or unknown (callers fall back to the classical
    contour finder)."""
    if not settings.get("use_dl_detector"):
        return None
    key = (settings.get("dl_provider"), settings.get("dl_model_file"))
    return dl_models.get(key) or dl_models.get(settings.get("dl_model_file"))


class OnnxWrappedDetector(BubbleDetector):
    """BubbleDetector API over a real ``.onnx`` checkpoint (the ONNX
    executor, one page at a time)."""

    def __init__(self, onnx_det, min_area: float = 200.0, device="cuda"):
        super().__init__(params=None, min_area=min_area, device=device)
        self._onnx = onnx_det
        self.params = object()  # non-None: the DL path is live

    def detect_bubble_mask(self, page_bgr: np.ndarray) -> np.ndarray | None:
        return self._onnx.detect_bubble_mask(page_bgr)

    def detect_bubble_masks(self, pages_bgr: Sequence[np.ndarray]) -> list[np.ndarray]:
        return [self._onnx.detect_bubble_mask(p) for p in pages_bgr]


def _component_containing(mask: np.ndarray, rect: Rect) -> np.ndarray | None:
    """Isolate the mask component whose polygon contains the rect center."""
    cx, cy = rect.center()
    for poly in cont.mask_to_polygons(mask):
        if cont._point_in_polygon(cx, cy, poly):
            out = np.zeros_like(mask)
            cont.fill_polygon(out, poly, 255)
            return out
    return None


def crops_from_detections(
    page_bgr: np.ndarray, detections: Sequence[dict], mask_outside: bool = True
) -> tuple[list[np.ndarray], list[dict]]:
    """Detections -> crop images + job metadata (the reference's
    ``process_confirmed_polygon`` crop rule, ``main_window.py:6481-6518``:
    crop the bounding rect, white out pixels outside the polygon)."""
    h, w = page_bgr.shape[:2]
    crops, jobs = [], []
    for det in detections:
        poly = np.asarray(det["polygon"])
        rect = polygon_bounding_rect(poly).clamped(w, h)
        if rect.w < 2 or rect.h < 2:
            continue
        crop = page_bgr[rect.top : rect.bottom + 1, rect.left : rect.right + 1].copy()
        if mask_outside and len(poly) > 2:
            local = poly - np.array([rect.left, rect.top])
            m = np.zeros(crop.shape[:2], np.uint8)
            cont.fill_polygon(m, local, 255)
            crop[m == 0] = 255
        crops.append(crop)
        jobs.append({"rect": rect, "polygon": poly, "text": det.get("text")})
    return crops, jobs
