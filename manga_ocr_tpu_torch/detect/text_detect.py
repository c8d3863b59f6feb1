"""Text-region detection: morphological proposals + batched re-OCR (the
port's own copy of ``manga_ocr_tpu/detect/text_detect.py``).

Behavioral rebuild of the reference's "Text" detection mode
(``detect_text_with_ocr_engine`` ``main_window.py:9294-9320``; morphological
region proposal ``:9430-9460``;
per-region re-OCR ``:9530-9549``; polygon tightening ``:9725-9768``):

1. propose candidate text regions (adaptive threshold → dilate → external
   contours) — host-side,
2. OCR every proposal in ONE batched device dispatch (the reference loops
   regions through the engine one at a time),
3. tighten polygons to the ink bounding box (Otsu),
4. noise-filter and merge into reading blocks (``postprocess``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from manga_ocr_tpu_torch.core.geometry import (
    Rect,
    clamp_polygon,
    polygon_bounding_rect,
    polygon_from_rect,
)
from manga_ocr_tpu_torch.detect import contours as cont
from manga_ocr_tpu_torch.detect import postprocess as post


def propose_text_regions(
    page_bgr: np.ndarray,
    dilate_radius: int = 6,
    min_area: int = 80,
) -> list[np.ndarray]:
    """Morphological text-region proposals (adaptive threshold + dilation +
    external contours)."""
    if cont.HAS_CV2:
        import cv2

        gray = cv2.cvtColor(page_bgr, cv2.COLOR_BGR2GRAY)
    else:
        gray = (
            page_bgr[..., 2] * 0.299 + page_bgr[..., 1] * 0.587 + page_bgr[..., 0] * 0.114
        ).astype(np.uint8)
    ink = cont.adaptive_threshold_mean_inv(gray, block=25, c=15)
    from manga_ocr_tpu_torch.typeset.cleanup import dilate

    blob = dilate(ink, dilate_radius)
    polys = cont.mask_to_polygons(blob, min_area=min_area)
    h, w = gray.shape
    return [clamp_polygon(p, w, h) for p in polys]


def refine_polygon_with_image(page_bgr: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Tighten a region polygon to the Otsu ink bounding box inside it
    (``_refine_polygon_with_image`` behavior)."""
    h, w = page_bgr.shape[:2]
    rect = polygon_bounding_rect(polygon).clamped(w, h)
    if rect.w < 4 or rect.h < 4:
        return polygon
    crop = page_bgr[rect.top : rect.bottom + 1, rect.left : rect.right + 1]
    gray = (
        crop[..., 2] * 0.299 + crop[..., 1] * 0.587 + crop[..., 0] * 0.114
    ).astype(np.uint8)
    if cont.HAS_CV2:
        import cv2

        _, ink = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    else:
        ink = (gray < np.median(gray)).astype(np.uint8) * 255
    ys, xs = np.nonzero(ink)
    if len(xs) == 0:
        return polygon
    pad = 2
    tight = Rect(
        rect.left + max(0, int(xs.min()) - pad),
        rect.top + max(0, int(ys.min()) - pad),
        int(xs.max() - xs.min()) + 1 + 2 * pad,
        int(ys.max() - ys.min()) + 1 + 2 * pad,
    ).clamped(w, h)
    return polygon_from_rect(tight)


def craft_proposer(
    latin_engine,
) -> Callable[[np.ndarray], list[np.ndarray]]:
    """Proposal source backed by a CRAFT detector, duck-typed on
    ``latin_engine.detect_boxes(rgb) -> [(x, y, w, h)]`` (the port's
    ``engine.latin.TorchLatinEngine``) — the rebuild's equivalent of the
    reference's engine-specific box collectors (EasyOCR's collector at
    ``main_window.py:9322-9352`` reads boxes out of its internal CRAFT).

    Returns a ``page_bgr -> [polygon]`` callable for ``detect_text_regions``;
    the model's word boxes are grouped into lines (``craft_boxes.group_lines``)
    so the downstream merge/filter tail sees line-level regions like the
    morphological proposer produces."""
    from manga_ocr_tpu_torch.detect import craft_boxes

    def _propose(page_bgr: np.ndarray) -> list[np.ndarray]:
        rgb = np.ascontiguousarray(np.asarray(page_bgr)[..., ::-1])
        boxes = latin_engine.detect_boxes(rgb)
        h, w = rgb.shape[:2]
        polys = []
        for line in craft_boxes.group_lines(boxes):
            x0 = min(b[0] for b in line)
            y0 = min(b[1] for b in line)
            x1 = max(b[0] + b[2] for b in line)
            y1 = max(b[1] + b[3] for b in line)
            rect = Rect(x0, y0, x1 - x0, y1 - y0).clamped(w, h)
            if rect.w >= 2 and rect.h >= 2:
                polys.append(polygon_from_rect(rect))
        return polys

    return _propose


def detect_text_regions(
    page_bgr: np.ndarray,
    ocr_page: Callable[[Sequence[np.ndarray]], list[str]],
    advanced: bool = False,
    merge: bool = True,
    proposer: Callable[[np.ndarray], list[np.ndarray]] | None = None,
) -> list[tuple[str, np.ndarray]]:
    """Full text-mode detection -> [(text, polygon)].

    ``ocr_page`` is the batched engine entry; every proposal is recognized
    in one dispatch instead of the reference's per-region loop.  ``proposer``
    selects the proposal source: default is the morphological pass
    (reference ``:9430-9460``); pass ``craft_proposer(engine)`` for the
    native CRAFT detector."""
    h, w = page_bgr.shape[:2]
    proposals = (proposer or propose_text_regions)(page_bgr)
    if advanced:
        proposals = [refine_polygon_with_image(page_bgr, p) for p in proposals]
    crops, kept = [], []
    for poly in proposals:
        rect = polygon_bounding_rect(poly).clamped(w, h)
        if rect.w < 6 or rect.h < 6:
            continue
        crops.append(
            page_bgr[rect.top : rect.bottom + 1, rect.left : rect.right + 1]
        )
        kept.append(poly)
    if not crops:
        return []
    texts = ocr_page(crops)  # ONE padded device dispatch per bucket
    items = [
        (t, p)
        for t, p in zip(texts, kept)
        if t and not t.startswith("[ERROR")
    ]
    items = post.filter_detection_noise(items, (h, w), advanced=advanced)
    if merge:
        items = post.merge_text_boxes_to_blocks(items, (h, w), strict=advanced)
        items = post.filter_detection_noise(items, (h, w), advanced=advanced)
    return items
