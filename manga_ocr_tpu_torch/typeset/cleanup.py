"""Text cleanup: erase original text before typesetting (the port's own
copy of ``manga_ocr_tpu/typeset/cleanup.py``).

The reference's cleanup stage embedded in ``_draw_single_area_impl``
(``main_window.py:6946-7067``): build a mask (cleanup polygon ∩ bubble
mask, dilated by ``inpaint_padding``; ``dilate`` is cv2, then the native box
dilation, then NumPy), then erase by inpainting (a model such as
``models.inpaint.LamaInpainter`` first, then cv2 Telea/NS or a NumPy
neighbourhood fill) or by filling with the estimated background color
(Otsu-majority mean, ``get_background_color``, ``:6705-6728``).  Auto text
color picks white on dark backgrounds by luminance threshold
(``:6730-6751``).

One deliberate difference from the JAX package: when the inpainter raises,
``erase_area`` logs a warning that names the exception before it falls
through to the classical inpaint (the JAX package falls through silently).
"""

from __future__ import annotations

import logging

import numpy as np

from manga_ocr_tpu_torch.core.geometry import Rect
from manga_ocr_tpu_torch.detect import contours as cont

log = logging.getLogger(__name__)

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


def get_background_color(image_bgr: np.ndarray, region: Rect) -> tuple[int, int, int]:
    """Estimate the background color of a region: Otsu-split the gray values
    and average the majority class (text strokes are the minority)."""
    r = region.clamped(image_bgr.shape[1], image_bgr.shape[0])
    patch = image_bgr[r.top : r.bottom + 1, r.left : r.right + 1]
    if patch.size == 0:
        return (255, 255, 255)
    gray = (
        patch[..., 2] * 0.299 + patch[..., 1] * 0.587 + patch[..., 0] * 0.114
    ).astype(np.uint8)
    if HAS_CV2:
        t, _ = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    else:
        t = float(np.median(gray))
    above = gray > t
    majority = above if above.mean() >= 0.5 else ~above
    if not majority.any():
        majority = np.ones_like(above)
    color = patch[majority].mean(axis=0)
    return tuple(int(round(c)) for c in color)


def auto_text_color(
    image_bgr: np.ndarray, region: Rect, threshold: int = 128
) -> str:
    """White text on dark backgrounds, black otherwise (hex string)."""
    b, g, r = get_background_color(image_bgr, region)
    luminance = 0.299 * r + 0.587 * g + 0.114 * b
    return "#ffffff" if luminance < threshold else "#000000"


def inpaint(
    image_bgr: np.ndarray, mask: np.ndarray, radius: int = 3, method: str = "telea"
) -> np.ndarray:
    """Inpaint masked pixels.  cv2 Telea/NS when available; otherwise an
    iterative neighborhood-mean fill (good enough for flat bubble interiors,
    which is what manga cleanup erases)."""
    if HAS_CV2:
        flags = cv2.INPAINT_TELEA if method == "telea" else cv2.INPAINT_NS
        return cv2.inpaint(image_bgr, (mask > 0).astype(np.uint8), radius, flags)
    out = image_bgr.astype(np.float32)
    hole = mask > 0
    known = ~hole
    for _ in range(256):
        if not hole.any():
            break
        # average of known 4-neighbors
        acc = np.zeros_like(out)
        cnt = np.zeros(out.shape[:2], np.float32)
        for axis, d in ((0, 1), (0, -1), (1, 1), (1, -1)):
            shifted = np.roll(out, d, axis=axis)
            valid = np.roll(known, d, axis=axis)
            acc += shifted * valid[..., None]
            cnt += valid
        border = hole & (cnt > 0)
        if not border.any():
            break
        out[border] = acc[border] / cnt[border][..., None]
        known |= border
        hole &= ~border
    return np.clip(out, 0, 255).astype(np.uint8)


def erase_area(
    image_bgr: np.ndarray,
    cleanup_polygon: np.ndarray,
    cleanup_rect: Rect,
    bubble_mask: np.ndarray | None = None,
    use_inpaint: bool = True,
    use_background_box: bool = True,
    inpaint_padding: int = 2,
    inpainter=None,
) -> np.ndarray:
    """Full cleanup for one area -> new image (the reference's per-area
    erase ladder: LaMa-style model → cv2/numpy inpaint → background box).

    ``inpainter``: optional ``(image_bgr, mask_u8) -> image_bgr`` callable
    (e.g. ``models.inpaint.LamaInpainter``); exceptions fall through to the
    classical inpaint (logged), mirroring the reference's probing ladder."""
    out = image_bgr.copy()
    if use_inpaint:
        mask = build_cleanup_mask(out.shape, cleanup_polygon, bubble_mask, inpaint_padding)
        if mask.any():
            if inpainter is not None:
                try:
                    return np.asarray(inpainter(out, mask))
                except Exception as e:
                    log.warning("erase_area: the inpainter raised %s: %s; falling back to "
                                "the classical inpaint", type(e).__name__, e)
            return inpaint(out, mask)
    if use_background_box:
        color = get_background_color(out, cleanup_rect)
        r = cleanup_rect.clamped(out.shape[1], out.shape[0])
        out[r.top : r.bottom + 1, r.left : r.right + 1] = color
    return out


def erase_area_for_settings(
    image_bgr: np.ndarray,
    area,
    settings: dict,
    bubble_mask: np.ndarray | None = None,
    inpainters: dict | None = None,
) -> np.ndarray:
    """``erase_area`` driven by the reference job-settings dict
    (``get_current_settings`` keys): ``use_inpaint``/``use_background_box``
    (area overrides win, mirroring ``canvas.py:269-291``),
    ``inpaint_padding``, and ``inpaint_model_key`` selecting the DL
    inpainter tier ('big_lama' / 'anime_inpaint'; None → classical only)."""
    settings = settings or {}
    inpainters = inpainters or {}
    key = settings.get("inpaint_model_key")
    inpainter = inpainters.get(key) if key else None
    return erase_area(
        image_bgr,
        area.cleanup_polygon if area.cleanup_polygon is not None else area.polygon,
        area.cleanup_rect or area.rect,
        bubble_mask=bubble_mask,
        use_inpaint=bool(
            area.get_override("use_inpaint", settings.get("use_inpaint", True))
        ),
        use_background_box=bool(
            area.get_override(
                "use_background_box", settings.get("use_background_box", True)
            )
        ),
        inpaint_padding=int(settings.get("inpaint_padding", 2)),
        inpainter=inpainter,
    )
