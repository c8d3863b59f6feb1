"""The OCR preprocessing graphs (counterpart of ``model_preprocess`` and
``ocr_preprocess`` in ``manga_ocr_tpu/ops/preprocess.py``):

1. ``model_preprocess``, the manga-ocr input path: grayscale -> valid-region
   resize to 224 -> rescale -> normalize(0.5/0.5) -> 3-channel repeat.
2. ``ocr_preprocess``, the Latin-engine path of the reference
   (``main_window.py:4204``) that the dual pass feeds to its second engine:
   gray -> skew angle -> corrective rotation -> equalizeHist ->
   Gaussian(3,3) -> Otsu -> BGR, every statistic over the valid region.

Both are batched over bucket-padded crops on the input's device.
``unpack_packed_page`` rebuilds such a batch on the device from the
engine's packed wire (``parallel.batching.prep_page_packed``).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.ops import image as im

# Orientation modes (the reference's settings values).  Same numbers as the
# JAX package's constants, which the shared host batching code tests against.
ORIENT_AUTO = 0  # "Auto-Detect": no 90-degree turn; ocr_preprocess corrects skew
ORIENT_VERTICAL = 1
ORIENT_HORIZONTAL = 2
ORIENT_NONE = 3


def model_preprocess(
    crops_u8: torch.Tensor,
    sizes: torch.Tensor | None = None,
    image_size: int = 224,
) -> torch.Tensor:
    """[B, H, W, 3] uint8 BGR (or [B, H, W] already-gray) bucket-padded crops
    -> [B, S, S, 3] float32 normalized pixels.  ``sizes``: [B, 2] valid (h, w)
    extents; None means every crop fills the bucket."""
    gray = im.bgr_to_gray_u8(crops_u8) if crops_u8.ndim == 4 else crops_u8
    if sizes is None:
        b, h, w = gray.shape
        sizes = torch.tensor([h, w], dtype=torch.int32, device=gray.device).expand(b, 2)
    resized = im.resize_bilinear_valid(gray, sizes, image_size, image_size)
    norm = (resized / 255.0 - 0.5) / 0.5
    return norm[..., None].expand(*norm.shape, 3).contiguous()


def ocr_preprocess(
    crops_u8: torch.Tensor,
    orientation: int = ORIENT_AUTO,
    sizes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] uint8 BGR (or [B, H, W] already-gray) bucket-padded crops
    -> (binarized [B, H, W, 3] uint8 BGR, angles [B] float32): the
    reference's Latin-OCR preprocessing.

    ``orientation`` picks the rotation: AUTO the folded moment angle,
    VERTICAL 90 degrees (CCW, in the crop's own frame) where the valid
    extent is wider than tall, NONE and HORIZONTAL none at all.  ``sizes``:
    [B, 2] valid (h, w) per crop -- the skew moments, the equalizeHist LUT
    and the Otsu threshold see the valid region only, the blur reflects at
    its edge and the rotation turns about its center.  Callers crop the
    output back to the valid extent."""
    gray = im.bgr_to_gray_u8(crops_u8) if crops_u8.ndim == 4 else crops_u8
    b, h, w = gray.shape
    mask = None if sizes is None else im.valid_mask(gray.shape, sizes)
    if orientation == ORIENT_AUTO:
        angles = im.normalize_skew_angle(im.orientation_angle_moments(gray, mask))
    elif orientation == ORIENT_VERTICAL:
        if sizes is None:
            wide = torch.full((b,), w > h, device=gray.device)
        else:
            wide = sizes[:, 1] > sizes[:, 0]
        angles = torch.where(wide, 90.0, 0.0).to(torch.float32)
    else:
        angles = torch.zeros((b,), dtype=torch.float32, device=gray.device)
    if orientation in (ORIENT_NONE, ORIENT_HORIZONTAL):
        # the angles are zero by construction: no rotation at all (a
        # zero-angle bicubic rotation is the identity, bit for bit)
        rotated = gray
    else:
        rotated = im.rotate_image(gray, angles, interpolation="cubic", sizes=sizes)
    eq = im.equalize_hist_u8(rotated, mask)
    blurred = im.gaussian_blur3_u8(eq, sizes)
    binary = im.otsu_binarize(blurred, mask)
    return im.gray_to_bgr(binary), angles


def unpack_packed_page(
    flat: torch.Tensor, meta: torch.Tensor, bh: int, bw: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded gray batch from the row-packed wire
    (``parallel.batching.prep_page_packed``): ``flat`` [H_cap, bw] uint8
    holds each crop's width-padded rows height-tight, ``meta`` [B, 3] int32
    its (h, w, row_offset).  Crop i's row r is ``flat`` row ``offset_i +
    min(r, h_i - 1)``: clamping the row index is the height edge
    replication, so the batch is byte-identical to ``prep_page_gray``'s.
    One row gather on ``flat``'s device.  Returns (batch [B, bh, bw] uint8,
    sizes [B, 2] int32).  A zero-height crop's index -1 wraps to the
    buffer's last row, as ``jnp.take`` wraps it."""
    b = meta.shape[0]
    h = meta[:, 0:1]
    i = torch.minimum(torch.arange(bh, dtype=meta.dtype, device=meta.device)[None, :], h - 1)
    ridx = (meta[:, 2:3] + i).reshape(-1)
    ridx = torch.where(ridx < 0, ridx + flat.shape[0], ridx)
    batch = flat.index_select(0, ridx).reshape(b, bh, bw)
    return batch, meta[:, :2]
