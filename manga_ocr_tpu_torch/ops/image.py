"""Batched image ops of the manga-ocr input path (counterpart of the
grayscale and valid-region resize in ``manga_ocr_tpu/ops/image.py``).

The resize is a per-crop triangle-filter matrix over each crop's valid
extent (PIL's antialiased bilinear convention), applied as two batched
matmuls — not ``F.interpolate`` and not a resize of the whole padded bucket.
"""

from __future__ import annotations

import torch


def bgr_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 BGR -> [..., H, W] uint8, cv2 fixed-point math."""
    b = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    r = img[..., 2].to(torch.int32)
    y = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
    return y.to(torch.uint8)


def _triangle_matrix_dynamic(valid: torch.Tensor, full: int, out: int) -> torch.Tensor:
    """Per-image triangle-filter matrices [B, out, full] that resize the first
    ``valid[b]`` source pixels to ``out`` taps."""
    dev = valid.device
    v = valid.float().clamp_min(1.0)[:, None, None]  # [B, 1, 1]
    scale = v / float(out)
    support = torch.clamp_min(scale, 1.0)
    o = torch.arange(out, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(full, dtype=torch.float32, device=dev)[None, None, :]
    center = (o + 0.5) * scale
    w = 1.0 - ((s + 0.5) - center).abs() / support
    w = w.clamp_min(0.0) * (s < v)
    wsum = w.sum(-1, keepdim=True)
    return w / wsum.clamp_min(1e-30)


def resize_bilinear_valid(
    gray: torch.Tensor, sizes: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Antialiased per-crop valid-region resize for bucket-padded batches.

    ``gray``: [B, H, W]; ``sizes``: [B, 2] int32 valid (h, w) per crop.
    Returns float32 [B, out_h, out_w]."""
    x = gray.float()
    _, h, w = x.shape
    mh = _triangle_matrix_dynamic(sizes[:, 0], h, out_h)  # [B, out_h, H]
    mw = _triangle_matrix_dynamic(sizes[:, 1], w, out_w)  # [B, out_w, W]
    x = torch.bmm(mh, x)  # [B, out_h, W]
    return torch.bmm(x, mw.transpose(1, 2))
