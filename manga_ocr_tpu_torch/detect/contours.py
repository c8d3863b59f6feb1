"""Host-side contour extraction and the classical bubble finder (the port's
own copy of ``manga_ocr_tpu/detect/contours.py``).

Contours have data-dependent output shapes, so they stay on the host
(SURVEY §7.4): the device produces masks in one batched dispatch, the host
traces polygons.  Uses OpenCV when present, then the native C++ tracer
(``manga_ocr_tpu_torch.native``), then a pure-NumPy border-following
fallback, so the port has no hard cv2 dependency.  ``TIER_COUNTS`` counts
the calls of ``mask_to_polygons`` by the tier that ran.

The classical bubble finder mirrors the reference's contour fallback
(``_find_speech_bubble_mask_contour``, ``main_window.py:6753-6774``): pad
the text rect by 25 px, adaptive mean threshold (41, 5, inverted), external
contours, keep those containing the text center with area > 0.5×rect, fill
the largest into a page-size mask.
"""

from __future__ import annotations

import numpy as np

from manga_ocr_tpu_torch.core.geometry import Rect

try:
    import cv2

    HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False

TIER_COUNTS = {"cv2": 0, "native": 0, "numpy": 0}


# ---------------------------------------------------------------------------
# Mask -> polygons
# ---------------------------------------------------------------------------


def mask_to_polygons(mask: np.ndarray, min_area: float = 0.0) -> list[np.ndarray]:
    """External contours of a 0/255 uint8 mask as [N, 2] int arrays.

    Tiered: cv2 (exact reference behavior) → native C++ tracer
    (``manga_ocr_tpu_torch.native``) → pure NumPy."""
    if HAS_CV2:
        contours, _ = cv2.findContours(
            mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        polys = [c.reshape(-1, 2).astype(np.int32) for c in contours]
        TIER_COUNTS["cv2"] += 1
    else:
        from manga_ocr_tpu_torch import native

        polys = native.trace_external_contours(mask)
        if polys is None:
            polys = _trace_external_contours(mask)
            TIER_COUNTS["numpy"] += 1
        else:
            TIER_COUNTS["native"] += 1
    if min_area > 0:
        polys = [p for p in polys if _poly_area(p) >= min_area]
    return polys


def _poly_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0].astype(np.float64), poly[:, 1].astype(np.float64)
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _trace_external_contours(mask: np.ndarray) -> list[np.ndarray]:
    """Pure-NumPy external boundary tracing (Moore neighborhood)."""
    binary = (mask > 0).astype(np.uint8)
    h, w = binary.shape
    visited = np.zeros_like(binary, bool)
    # 8-neighborhood in clockwise order starting from W
    nbrs = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]
    polys = []
    # label connected components via simple BFS to pick one boundary each
    from collections import deque

    comp = np.zeros((h, w), np.int32)
    ncomp = 0
    for sy in range(h):
        row = binary[sy]
        for sx in np.nonzero(row)[0]:
            if comp[sy, sx]:
                continue
            ncomp += 1
            dq = deque([(sy, sx)])
            comp[sy, sx] = ncomp
            start = (sy, int(sx))
            while dq:
                cy, cx = dq.popleft()
                for dy, dx in nbrs:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx < w and binary[ny, nx] and not comp[ny, nx]:
                        comp[ny, nx] = ncomp
                        dq.append((ny, nx))
            # trace boundary from the top-left-most pixel of this component
            poly = _moore_trace(binary, start)
            if len(poly) >= 3:
                polys.append(np.asarray(poly, np.int32))
    return polys


def _moore_trace(binary: np.ndarray, start: tuple[int, int]) -> list:
    h, w = binary.shape
    moves = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)]

    def is_set(y, x):
        return 0 <= y < h and 0 <= x < w and binary[y, x]

    sy, sx = start
    contour = [(sx, sy)]
    prev_dir = 4  # came from the left
    cy, cx = sy, sx
    for _ in range(h * w * 4):
        found = False
        for i in range(8):
            d = (prev_dir + 6 + i) % 8  # backtrack then clockwise
            dy, dx = moves[d]
            ny, nx = cy + dy, cx + dx
            if is_set(ny, nx):
                cy, cx = ny, nx
                prev_dir = d
                if (cy, cx) == (sy, sx):
                    return contour
                contour.append((cx, cy))
                found = True
                break
        if not found:  # isolated pixel
            return contour
    return contour


# ---------------------------------------------------------------------------
# Classical bubble finder (fallback when the DL detector is off / misses)
# ---------------------------------------------------------------------------


def adaptive_threshold_mean_inv(
    gray: np.ndarray, block: int = 41, c: float = 5.0
) -> np.ndarray:
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_MEAN_C, THRESH_BINARY_INV)."""
    if HAS_CV2:
        return cv2.adaptiveThreshold(
            gray, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY_INV, block, c
        )
    # box-filter mean with reflected borders
    pad = block // 2
    padded = np.pad(gray.astype(np.float64), pad, mode="reflect")
    cs = padded.cumsum(0).cumsum(1)
    cs = np.pad(cs, ((1, 0), (1, 0)))
    h, w = gray.shape
    s = (
        cs[block:, block:]
        - cs[:-block, block:]
        - cs[block:, :-block]
        + cs[:-block, :-block]
    )[:h, :w]
    mean = s / (block * block)
    return np.where(gray.astype(np.float64) <= mean - c, 255, 0).astype(np.uint8)


def find_speech_bubble_mask_contour(
    full_image_bgr: np.ndarray, text_rect: Rect, padding: int = 25
) -> np.ndarray | None:
    """Classical bubble mask from local contours around a text rect."""
    h, w = full_image_bgr.shape[:2]
    search = text_rect.adjusted(-padding, -padding, padding, padding).clamped(w, h)
    if search.w <= 0 or search.h <= 0:
        return None
    # Rect right/bottom are INCLUSIVE (Qt convention, core/geometry.py) —
    # slice with +1 like every other consumer or the window loses its last
    # row/column and border bubbles get their outline cut
    region = full_image_bgr[
        search.top : search.bottom + 1, search.left : search.right + 1
    ]
    if region.size == 0:
        return None
    if HAS_CV2:
        gray = cv2.cvtColor(region, cv2.COLOR_BGR2GRAY)
    else:
        gray = (
            region[..., 2] * 0.299 + region[..., 1] * 0.587 + region[..., 0] * 0.114
        ).astype(np.uint8)
    thresh = adaptive_threshold_mean_inv(gray)
    polys = mask_to_polygons(thresh)
    if not polys:
        return None
    cx = text_rect.center()[0] - search.left
    cy = text_rect.center()[1] - search.top
    min_area = text_rect.w * text_rect.h * 0.5
    candidates = [
        p for p in polys if _point_in_polygon(cx, cy, p) and _poly_area(p) > min_area
    ]
    if not candidates:
        return None
    best = max(candidates, key=_poly_area)
    mask = np.zeros((h, w), np.uint8)
    shifted = best + np.array([search.left, search.top])
    fill_polygon(mask, shifted, 255)
    return mask


def _point_in_polygon(x: float, y: float, poly: np.ndarray) -> bool:
    if HAS_CV2:
        return cv2.pointPolygonTest(poly.reshape(-1, 1, 2), (float(x), float(y)), False) >= 0
    inside = False
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi + 1e-12) + xi:
            inside = not inside
        j = i
    return inside


def fill_polygon(mask: np.ndarray, poly: np.ndarray, value: int = 255) -> None:
    """Rasterize a filled polygon into ``mask`` in place."""
    if HAS_CV2:
        cv2.drawContours(mask, [poly.reshape(-1, 1, 2).astype(np.int32)], -1, value, -1)
        return
    h, w = mask.shape
    ys = np.clip(poly[:, 1], 0, h - 1)
    y0, y1 = int(ys.min()), int(ys.max())
    px, py = poly[:, 0].astype(np.float64), poly[:, 1].astype(np.float64)
    n = len(poly)
    for y in range(y0, y1 + 1):
        xs = []
        j = n - 1
        for i in range(n):
            if (py[i] > y) != (py[j] > y):
                xs.append(px[i] + (y - py[i]) / (py[j] - py[i]) * (px[j] - px[i]))
            j = i
        xs.sort()
        for k in range(0, len(xs) - 1, 2):
            a = max(0, int(np.ceil(xs[k])))
            b = min(w - 1, int(np.floor(xs[k + 1])))
            if b >= a:
                mask[y, a : b + 1] = value
