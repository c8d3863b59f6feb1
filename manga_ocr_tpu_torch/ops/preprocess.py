"""The manga-ocr input graph (counterpart of ``model_preprocess`` in
``manga_ocr_tpu/ops/preprocess.py``): grayscale -> valid-region resize to
224 -> rescale -> normalize(0.5/0.5) -> 3-channel repeat.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.ops import image as im

# Orientation modes (the reference's settings values).  Same numbers as the
# JAX package's constants, which the shared host batching code tests against.
ORIENT_AUTO = 0  # "Auto-Detect": no 90-degree rotation on the model path
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
