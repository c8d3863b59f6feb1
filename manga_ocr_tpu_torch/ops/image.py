"""Batched image ops of the OCR preprocessing graphs (counterpart of
``manga_ocr_tpu/ops/image.py``).

Every function keeps the JAX function's math, rounding points and output
dtype, batched over [B, H, W] on the input's device:

- grayscale uses the ITU-R 601 fixed-point coefficients (cv2-compatible);
- histograms are integer scatter-adds (order-independent on the card);
- equalizeHist reproduces cv2's cdf-min LUT, rounding half to even;
- GaussianBlur(3,3,σ=0) is the fixed [1,2,1]/4 kernel as shifted adds with
  REFLECT_101 borders at the bucket edge or at each crop's valid edge, then
  ``floor(x + 0.5)``: the sums are exact in f32 for uint8 inputs (no
  ``conv2d``, whose f32 path may run in TF32 on the card);
- Otsu maximizes the between-class variance over a 256-bin histogram, the
  first maximum winning.  Its prefix sums are taken over the integer counts
  (exact) and σ_b is formed in f64, so the card and the host pick the same
  threshold; the JAX function's f32 prefix sums may pick the other bin of a
  near-tie (``tests/test_torch_image_ops.py`` counts those);
- rotation is inverse-mapped nearest/bilinear/bicubic sampling with
  BORDER_REPLICATE (``cos``/``sin`` of an f32 angle may differ by an ulp
  between libraries, so rotated pixels are held to a tolerance; angle 0 is a
  bit-exact identity);
- the resize is a PIL-convention triangle filter as two matmuls;
- orientation is the principal-axis angle of the dark pixels' second
  central moments (f32 sums, reduction order differs by device).

The resize over each crop's valid extent (``resize_bilinear_valid``) builds
per-crop triangle-filter matrices, applied as two batched matmuls -- not
``F.interpolate`` and not a resize of the whole padded bucket.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Color
# ---------------------------------------------------------------------------


def bgr_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 BGR -> [..., H, W] uint8, cv2 fixed-point math."""
    b = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    r = img[..., 2].to(torch.int32)
    y = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
    return y.to(torch.uint8)


def rgb_to_gray_u8(img: torch.Tensor) -> torch.Tensor:
    return bgr_to_gray_u8(img.flip(-1))


def gray_to_bgr(gray: torch.Tensor) -> torch.Tensor:
    return gray[..., None].repeat(*([1] * gray.ndim), 3)


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------


def _hist256(gray_u8: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-image 256-bin histogram. gray: [B, H, W] uint8 -> [B, 256] int32.

    ``mask`` ([B, H, W], nonzero = counted, added as its int32 value)
    restricts the histogram to each crop's valid region."""
    b = gray_u8.shape[0]
    offset = torch.arange(b, device=gray_u8.device, dtype=torch.int64)[:, None] * 256
    idx = (gray_u8.reshape(b, -1).to(torch.int64) + offset).reshape(-1)
    if mask is None:
        vals = torch.ones(idx.shape, dtype=torch.int32, device=gray_u8.device)
    else:
        vals = mask.reshape(-1).to(torch.int32)
    hist = torch.zeros(b * 256, dtype=torch.int32, device=gray_u8.device)
    return hist.scatter_add_(0, idx, vals).reshape(b, 256)


def valid_mask(shape: tuple, sizes: torch.Tensor) -> torch.Tensor:
    """[B, H, W] bool mask of the valid (unpadded) region per crop.

    ``sizes``: [B, 2] int32 (h, w) valid extents."""
    _, h, w = shape[:3]
    yy = torch.arange(h, dtype=torch.int32, device=sizes.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.int32, device=sizes.device)[None, None, :]
    return (yy < sizes[:, 0, None, None]) & (xx < sizes[:, 1, None, None])


def equalize_hist_u8(gray: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """cv2.equalizeHist for a batch [B, H, W] uint8.

    LUT: first occupied bin i0; scale = 255/(N - hist[i0]);
    lut[i] = round(cumsum(hist[i0+1..i]) * scale), lut[<=i0] = 0.
    Single-bin images pass through unchanged.  ``mask`` restricts the LUT
    statistics to the valid region (the LUT is applied everywhere)."""
    b, h, w = gray.shape
    hist = _hist256(gray, mask)  # [B, 256] int32
    n = hist.sum(1, dtype=torch.int32)
    cdf = torch.cumsum(hist, 1, dtype=torch.int32)
    i0 = torch.argmax((hist > 0).to(torch.uint8), dim=1)  # the first occupied bin
    h0 = torch.gather(hist, 1, i0[:, None])[:, 0]
    denom = (n - h0).to(torch.float32)
    scale = 255.0 / denom.clamp_min(1.0)
    shifted = (cdf - h0[:, None]).to(torch.float32)
    lut = torch.round(shifted * scale[:, None]).clamp(0, 255).to(torch.uint8)
    out = torch.gather(lut, 1, gray.reshape(b, -1).to(torch.int64)).reshape(b, h, w)
    return torch.where((denom <= 0)[:, None, None], gray, out)


def otsu_threshold(gray: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu threshold per image. [B, H, W] uint8 -> [B] float32 thresholds.

    Maximizes the between-class variance; ties go to the first maximum
    (cv2's ascending scan with a strict > update).  The class sums are exact
    integer prefix sums; ω, μ and σ_b are formed from them in f64."""
    hist = _hist256(gray, mask).to(torch.int64)  # [B, 256]
    bins = torch.arange(256, dtype=torch.int64, device=gray.device)
    n = hist.sum(1, keepdim=True).to(torch.float64)
    omega = torch.cumsum(hist, 1).to(torch.float64) / n
    mu = torch.cumsum(hist * bins, 1).to(torch.float64) / n
    mu_t = mu[:, -1:]
    denom = omega * (1.0 - omega)
    num = (mu_t * omega - mu) ** 2
    sigma_b = torch.where(denom > 1e-12, num / denom.clamp_min(1e-12), 0.0)
    return torch.argmax(sigma_b, dim=1).to(torch.float32)


def threshold_binary(gray: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """cv2 THRESH_BINARY: > thresh -> 255 else 0. thresh: [B]."""
    hi = gray.to(torch.float32) > thresh[:, None, None]
    return hi.to(torch.uint8) * 255


def otsu_binarize(gray: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    return threshold_binary(gray, otsu_threshold(gray, mask))


# ---------------------------------------------------------------------------
# Filtering
# ---------------------------------------------------------------------------


def _reflect_idx(n: int, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """REFLECT_101 neighbour indices [B, n] (up, down) within each row's
    first ``valid`` positions."""
    i = torch.arange(n, dtype=torch.int64, device=valid.device)[None, :]
    v = valid.to(torch.int64)[:, None]
    up = torch.minimum((i - 1).abs(), (v - 1).clamp_min(0))
    dn = torch.where(i + 1 < v, i + 1, (v - 2).clamp_min(0))
    return up, dn


def gaussian_blur3_u8(gray: torch.Tensor, sizes: torch.Tensor | None = None) -> torch.Tensor:
    """cv2.GaussianBlur(ksize=(3,3), sigma=0) on uint8 [B, H, W]: the fixed
    [1,2,1]/4 kernel separably with REFLECT_101 borders, ``floor(x + 0.5)``.

    ``sizes`` ([B, 2] valid (h, w)): reflect at each crop's valid boundary,
    not the bucket edge.  Without it, every crop fills its bucket."""
    x = gray.to(torch.float32)
    b, h, w = x.shape
    if sizes is None:
        sizes = torch.tensor([h, w], dtype=torch.int32, device=gray.device).expand(b, 2)
    for dim, n, view in ((1, h, (b, h, 1)), (2, w, (b, 1, w))):  # rows, then columns
        up, dn = (i.view(view).expand(b, h, w) for i in _reflect_idx(n, sizes[:, dim - 1]))
        x = (torch.gather(x, dim, up) + 2.0 * x + torch.gather(x, dim, dn)) * 0.25
    return torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _hw_dims(img: torch.Tensor) -> tuple[int, int]:
    return (-3, -2) if img.ndim >= 3 and img.shape[-1] <= 4 else (-2, -1)


def rot90_cw(img: torch.Tensor) -> torch.Tensor:
    """cv2.ROTATE_90_CLOCKWISE on [..., H, W] or [..., H, W, C]."""
    hw = _hw_dims(img)
    return torch.flip(img.transpose(*hw), dims=(hw[1],))


def rot90_ccw(img: torch.Tensor) -> torch.Tensor:
    hw = _hw_dims(img)
    return torch.flip(img.transpose(*hw), dims=(hw[0],))


def rot180(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, dims=_hw_dims(img))


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> tuple:
    """Keys bicubic weights for fractional offset t (cv2 INTER_CUBIC a=-0.75)."""
    t2, t3 = t * t, t * t * t
    w_m1 = a * t3 - 2 * a * t2 + a * t
    w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
    w_1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w_2 = -a * t3 + a * t2
    return w_m1, w_0, w_1, w_2


def rotate_image(
    gray: torch.Tensor,
    angle_deg: torch.Tensor,
    interpolation: str = "cubic",
    sizes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate [B, H, W] float/uint8 images about their center by per-image
    angles (degrees, CCW-positive like cv2.getRotationMatrix2D), sampling
    with BORDER_REPLICATE.  Output dtype matches input (uint8 rounds half to
    even).  ``sizes`` ([B, 2] valid (h, w)): rotate each padded crop about
    the center of its valid region."""
    b, h, w = gray.shape
    dev = gray.device
    x = gray.to(torch.float32).reshape(b, h * w)
    theta = angle_deg.to(torch.float32) * torch.tensor(math.pi / 180, dtype=torch.float32)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    if sizes is None:
        cx = torch.full((b,), float(w // 2), dtype=torch.float32, device=dev)
        cy = torch.full((b,), float(h // 2), dtype=torch.float32, device=dev)
    else:
        cx = torch.div(sizes[:, 1], 2, rounding_mode="floor").to(torch.float32)
        cy = torch.div(sizes[:, 0], 2, rounding_mode="floor").to(torch.float32)
    cx, cy = cx[:, None, None], cy[:, None, None]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    # inverse map: source = R(-theta) @ (dst - c) + c
    dx = xx[None] - cx
    dy = yy[None] - cy
    sx = cos * dx - sin * dy + cx
    sy = sin * dx + cos * dy + cy

    def sample(xf, yf):
        xi = xf.clamp(0, w - 1).to(torch.int64)
        yi = yf.clamp(0, h - 1).to(torch.int64)
        return torch.gather(x, 1, (yi * w + xi).reshape(b, -1)).reshape(b, h, w)

    if interpolation == "nearest":
        out = sample(torch.round(sx), torch.round(sy))
    elif interpolation == "linear":
        x0, y0 = torch.floor(sx), torch.floor(sy)
        tx, ty = sx - x0, sy - y0
        out = (
            sample(x0, y0) * (1 - tx) * (1 - ty)
            + sample(x0 + 1, y0) * tx * (1 - ty)
            + sample(x0, y0 + 1) * (1 - tx) * ty
            + sample(x0 + 1, y0 + 1) * tx * ty
        )
    else:  # cubic
        x0, y0 = torch.floor(sx), torch.floor(sy)
        tx, ty = sx - x0, sy - y0
        wx = _cubic_weights(tx)
        wy = _cubic_weights(ty)
        out = torch.zeros_like(tx)
        for j, wyj in enumerate(wy):
            row = torch.zeros_like(tx)
            for i, wxi in enumerate(wx):
                row = row + wxi * sample(x0 + (i - 1), y0 + (j - 1))
            out = out + wyj * row
    if gray.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out.to(gray.dtype)


def _triangle_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL-convention antialiased triangle (bilinear) filter as a dense
    row-stochastic matrix [out_size, in_size]."""
    scale = in_size / out_size
    support = max(1.0, scale)  # filter footprint grows when downscaling
    mat = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        js = np.arange(max(lo, 0), min(hi + 1, in_size))
        w = 1.0 - np.abs((js + 0.5) - center) / support
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s <= 0:  # fallback: nearest
            j = min(in_size - 1, max(0, int(center)))
            mat[i, j] = 1.0
        else:
            mat[i, js] = w / s
    return mat


@functools.lru_cache(maxsize=64)
def _resize_mats(in_h: int, in_w: int, out_h: int, out_w: int):
    return (
        _triangle_resize_matrix(in_h, out_h),
        _triangle_resize_matrix(in_w, out_w).T,
    )


@functools.lru_cache(maxsize=64)
def _resize_mats_on(in_h: int, in_w: int, out_h: int, out_w: int, device: torch.device):
    """``_resize_mats`` as f32 tensors on ``device``, copied there once per
    (sizes, device): a page batch does not wait on a host copy per call."""
    mh, mw = _resize_mats(in_h, in_w, out_h, out_w)
    return (torch.from_numpy(mh).to(device),
            torch.from_numpy(np.ascontiguousarray(mw)).to(device))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    channels_last: bool | None = None) -> torch.Tensor:
    """Antialiased bilinear resize (PIL-convention triangle filter), batched
    over leading dims, as two separable matmuls.  Input [..., H, W, C] when
    ``channels_last``, else [..., H, W]; returns float32.  ``channels_last``
    None guesses from the shape (a last dim of at most 4 is channels), which
    misreads a map of width 4 or less: callers that know the layout pass it."""
    x = img.to(torch.float32)
    if channels_last is None:
        channels_last = x.ndim >= 3 and img.shape[-1] <= 4
    if channels_last:
        x = torch.movedim(x, -1, -3)  # [..., C, H, W]
    mh, mw = _resize_mats_on(x.shape[-2], x.shape[-1], out_h, out_w, img.device)
    x = torch.matmul(mh, x)  # [out_h, H] @ [..., H, W]
    x = torch.matmul(x, mw)  # [..., out_h, W] @ [W, out_w]
    if channels_last:
        x = torch.movedim(x, -3, -1)
    return x


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


# ---------------------------------------------------------------------------
# Orientation (moment PCA reformulation of the reference's minAreaRect angle)
# ---------------------------------------------------------------------------


def orientation_angle_moments(
    gray: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-image text-skew angle from the dark-pixel (gray < 255) second
    central moments: degrees in (-90, 90], positive = CCW skew (pass it to
    ``rotate_image`` directly).  ``valid`` ([B, H, W]) excludes bucket
    padding from the sums; an image with no dark pixel gets 0."""
    _, h, w = gray.shape
    dev = gray.device
    mask = (gray < 255).to(torch.float32)
    if valid is not None:
        mask = mask * valid.to(torch.float32)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    m00 = mask.sum((1, 2))
    safe = m00.clamp_min(1.0)
    mx = (mask * xx[None]).sum((1, 2)) / safe
    my = (mask * yy[None]).sum((1, 2)) / safe
    dx = xx[None] - mx[:, None, None]
    dy = yy[None] - my[:, None, None]
    mu20 = (mask * dx * dx).sum((1, 2)) / safe
    mu02 = (mask * dy * dy).sum((1, 2)) / safe
    mu11 = (mask * dx * dy).sum((1, 2)) / safe
    # principal axis angle in image coords (y down): positive = CW on screen
    theta = 0.5 * torch.atan2(2.0 * mu11, mu20 - mu02)
    deg = torch.rad2deg(theta)
    return torch.where(m00 > 0, deg, 0.0)


def normalize_skew_angle(angle: torch.Tensor, max_abs_deg: float = 45.0) -> torch.Tensor:
    """Fold the PCA angle into a small corrective rotation (±90° symmetry),
    clipped to ±``max_abs_deg``."""
    a = torch.where(angle > 45.0, angle - 90.0, angle)
    a = torch.where(a < -45.0, a + 90.0, a)
    return a.clamp(-max_abs_deg, max_abs_deg)
