"""Text cleanup masks (the port's own copy of the mask half of
``manga_ocr_tpu/typeset/cleanup.py``).

The reference's cleanup stage (``_draw_single_area_impl``,
``main_window.py:6946-7067``) builds a mask -- cleanup polygon ∩ bubble
mask, dilated by ``inpaint_padding`` -- then erases under it.  The port has
the mask (``build_cleanup_mask``) and ``dilate`` (cv2, then the native box
dilation, then NumPy), which text-mode detection also uses.  Erasing
(inpainting, background fill) and the auto text color are not ported yet.
"""

from __future__ import annotations

import numpy as np

from manga_ocr_tpu_torch.detect import contours as cont

try:
    import cv2

    HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False


def build_cleanup_mask(
    image_shape: tuple,
    cleanup_polygon: np.ndarray,
    bubble_mask: np.ndarray | None = None,
    inpaint_padding: int = 2,
) -> np.ndarray:
    """0/255 mask of pixels to erase."""
    h, w = image_shape[:2]
    mask = np.zeros((h, w), np.uint8)
    cont.fill_polygon(mask, np.asarray(cleanup_polygon, np.int32), 255)
    if bubble_mask is not None:
        mask = np.where(bubble_mask > 0, mask, 0).astype(np.uint8)
    if inpaint_padding > 0:
        mask = dilate(mask, inpaint_padding)
    return mask


def dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    if HAS_CV2:
        k = cv2.getStructuringElement(cv2.MORPH_RECT, (2 * radius + 1, 2 * radius + 1))
        return cv2.dilate(mask, k)
    from manga_ocr_tpu_torch import native

    nat = native.dilate_box(mask, radius)
    if nat is not None:
        return nat
    # zero-pad by the radius so np.roll's wraparound lands in the padding
    # instead of the opposite edge (a bottom-row mask must not dilate into
    # the top of the page)
    out = np.pad(mask, radius)
    for axis in (0, 1):
        acc = out.copy()
        for d in range(1, radius + 1):
            acc = np.maximum(acc, np.roll(out, d, axis=axis))
            acc = np.maximum(acc, np.roll(out, -d, axis=axis))
        out = acc
    return out[radius:-radius, radius:-radius]
