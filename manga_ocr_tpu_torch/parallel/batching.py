"""Padded, bucketed page batching (the port's own copy of what it uses from
``manga_ocr_tpu/parallel/batching.py``).

Every crop of a page is padded (edge-replicate) into the smallest shape
bucket that fits, and the batch dim is padded to a power-of-two schedule, so
each (bucket, batch) shape is one dispatch.  The gray wire ships one uint8
channel per pixel; ``prep_page_gray`` builds it in one native C++ pass per
bucket (``native/prep.cpp``) or, when the native library is unavailable or
a crop has an unusual channel count, with NumPy, byte for byte the same.
The packed wire (``prep_page_packed``, ``PackedBatch``) ships the same
bytes without the height padding, which the device restores
(``ops.preprocess.unpack_packed_page``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# (h, w) buckets ordered by area; chosen to cover manga bubble crop shapes:
# near-square, tall (vertical text), wide (horizontal banners).
DEFAULT_BUCKETS: tuple[tuple[int, int], ...] = (
    (128, 128),
    (256, 128),
    (128, 256),
    (256, 256),
    (512, 256),
    (256, 512),
    (512, 512),
    (1024, 512),
    (512, 1024),
)

BATCH_SCHEDULE = (8, 16, 32, 64, 128, 256, 512)


def pick_bucket(
    h: int, w: int, buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS
) -> tuple[int, int]:
    """Smallest bucket that contains (h, w); falls back to the largest."""
    best = None
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, (bh, bw))
    if best is not None:
        return best[1]
    return max(buckets, key=lambda b: b[0] * b[1])


def pad_batch_size(n: int, schedule: Sequence[int] = BATCH_SCHEDULE) -> int:
    for s in schedule:
        if n <= s:
            return s
    # beyond schedule: round up to multiple of the largest step
    top = schedule[-1]
    return ((n + top - 1) // top) * top


def gray_u8_np(img: np.ndarray) -> np.ndarray:
    """cv2's fixed-point BGR -> gray on the host, bit-identical to
    ``ops.image.bgr_to_gray_u8``: (1868 b + 9617 g + 4899 r + 8192) >> 14."""
    y = img[..., 2].astype(np.int32)  # r
    y *= 4899
    c = img[..., 1].astype(np.int32)  # g
    c *= 9617
    y += c
    np.multiply(img[..., 0], np.int32(1868), out=c, dtype=np.int32)  # b
    y += c
    y += 8192
    y >>= 14
    return y.astype(np.uint8)


def orient_crop(crop: np.ndarray, orientation: int) -> np.ndarray:
    """The per-crop orientation rule on the real crop dims: Vertical & w > h
    -> 90° CW; Horizontal & h > w -> 90° CCW (``preprocess.ORIENT_*``)."""
    h, w = crop.shape[:2]
    if orientation == 1 and w > h:  # ORIENT_VERTICAL -> ROTATE_90_CLOCKWISE
        return np.ascontiguousarray(np.rot90(crop, k=-1))
    if orientation == 2 and h > w:  # ORIENT_HORIZONTAL -> ROTATE_90_COUNTERCLOCKWISE
        return np.ascontiguousarray(np.rot90(crop, k=1))
    return crop


def fit_within(crop: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Downscale a crop (preserving aspect) to fit inside (bh, bw): an
    oversized crop is never truncated."""
    h, w = crop.shape[:2]
    if h <= bh and w <= bw:
        return crop
    from PIL import Image

    s = min(bh / h, bw / w)
    nh, nw = max(1, int(h * s)), max(1, int(w * s))
    img = Image.fromarray(crop)
    return np.asarray(img.resize((nw, nh), Image.BILINEAR))


@dataclasses.dataclass
class BucketedBatch:
    """One padded bucket: crops + bookkeeping to scatter results back."""

    bucket_hw: tuple[int, int]
    crops: np.ndarray  # [B_padded, bh, bw, 3] uint8 ([B, bh, bw] when gray)
    indices: list[int]  # original crop index per valid row
    valid: int  # number of real rows (rest are padding)
    sizes: np.ndarray = None  # [B_padded, 2] int32 valid (h, w) per row


def bucket_crops(
    crops: Sequence[np.ndarray],
    buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
    gray: bool = False,
) -> list[BucketedBatch]:
    """Group variable-size crops into padded fixed-shape batches with
    per-row valid (h, w) extents.  Crops that fit no bucket are downscaled
    into the one that costs the least resolution.  ``gray=True`` emits
    single-channel batches (grayscale commutes with the edge-replicate pad,
    so converting the assembled batch is exact)."""
    fitted = []
    for c in crops:
        c = np.ascontiguousarray(c)
        if c.ndim == 2:
            c = np.repeat(c[..., None], 3, axis=2)
        elif c.shape[2] == 1:
            c = np.repeat(c, 3, axis=2)
        h, w = c.shape[:2]
        if not any(h <= bh and w <= bw for bh, bw in buckets):
            best = max(buckets, key=lambda b: min(b[0] / h, b[1] / w))
            c = fit_within(c, *best)
        fitted.append(c)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, crop in enumerate(fitted):
        hw = pick_bucket(crop.shape[0], crop.shape[1], buckets)
        groups.setdefault(hw, []).append(i)

    out = []
    for hw, idxs in sorted(groups.items(), key=lambda kv: kv[0][0] * kv[0][1]):
        bh, bw = hw
        n = len(idxs)
        bn = pad_batch_size(n)
        arr = np.zeros((bn, bh, bw, 3), np.uint8)
        sizes = np.full((bn, 2), (bh, bw), np.int32)
        for row, i in enumerate(idxs):
            c = fitted[i]
            h, w = c.shape[:2]
            dst = arr[row]
            dst[:h, :w] = c
            if w < bw:
                dst[:h, w:] = c[:, -1:]
            if h < bh:
                dst[h:] = dst[h - 1]
            sizes[row] = (h, w)
        if bn > n:
            # repeat last row (content and extents) as batch padding
            arr[n:] = arr[n - 1] if n else 0
            if n:
                sizes[n:] = sizes[n - 1]
        if gray:
            arr = gray_u8_np(arr)
        out.append(BucketedBatch(hw, arr, idxs, n, sizes))
    return out


def scatter_results(
    batches: Sequence[BucketedBatch], per_batch_results: Sequence[Sequence]
) -> list:
    """Invert ``bucket_crops``: reassemble per-crop results in input order."""
    total = sum(b.valid for b in batches)
    out = [None] * total
    for batch, results in zip(batches, per_batch_results):
        for row, idx in enumerate(batch.indices):
            out[idx] = results[row]
    return out


def _native_prep_groups(
    crops: Sequence[np.ndarray],
    orientation: int,
    buckets: Sequence[tuple[int, int]],
):
    """Coerce each crop, resolve the per-crop rotation rule, downscale
    oversized crops, and group by bucket.  Returns ``(prepped, groups)``
    where ``prepped[i] = (contiguous crop, rot code, eff_h, eff_w)``, or None
    when a crop needs the NumPy path (a channel count other than 1 or 3)."""
    prepped: list[tuple[np.ndarray, int, int, int]] = []
    for c in crops:
        c = np.ascontiguousarray(np.asarray(c, np.uint8))
        if c.ndim == 3 and c.shape[2] not in (1, 3):
            return None
        if c.ndim == 3 and c.shape[2] == 1:
            c = c[..., 0]
        h, w = c.shape[:2]
        rot = 0
        if orientation == 1 and w > h:  # ORIENT_VERTICAL -> 90° CW
            rot = 1
        elif orientation == 2 and h > w:  # ORIENT_HORIZONTAL -> 90° CCW
            rot = 2
        eh, ew = (w, h) if rot else (h, w)
        if not any(eh <= bh and ew <= bw for bh, bw in buckets):
            # oversized: rotate + downscale host-side (rare), then rot=0
            c = orient_crop(c, orientation)
            best = max(buckets, key=lambda b: min(b[0] / eh, b[1] / ew))
            c = np.ascontiguousarray(fit_within(c, *best))
            rot = 0
            eh, ew = c.shape[:2]
        prepped.append((c, rot, eh, ew))

    groups: dict[tuple[int, int], list[int]] = {}
    for i, (_, _, eh, ew) in enumerate(prepped):
        groups.setdefault(pick_bucket(eh, ew, buckets), []).append(i)
    return prepped, groups


def prep_page_gray(
    crops: Sequence[np.ndarray],
    orientation: int,
    buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
) -> list[BucketedBatch]:
    """Host prep of the gray wire: orient + bucket + gray + edge-replicate
    pad, in one native pass per bucket when the native library loads (the
    rotation is applied to the source read pattern, so no rotated copy is
    made), else with NumPy (``orient_crop`` + ``bucket_crops(gray=True)``).
    Both give the same bytes."""
    from manga_ocr_tpu_torch import native

    if native.load() is None:
        return _prep_page_gray_numpy(crops, orientation, buckets)
    grouped = _native_prep_groups(crops, orientation, buckets)
    if grouped is None:
        return _prep_page_gray_numpy(crops, orientation, buckets)
    prepped, groups = grouped

    out = []
    for hw, idxs in sorted(groups.items(), key=lambda kv: kv[0][0] * kv[0][1]):
        bh, bw = hw
        n = len(idxs)
        bn = pad_batch_size(n)
        arr = np.empty((bn, bh, bw), np.uint8)
        sizes = np.empty((bn, 2), np.int32)
        rots = np.fromiter((prepped[i][1] for i in idxs), np.int32, count=n)
        for row, i in enumerate(idxs):
            sizes[row] = (prepped[i][2], prepped[i][3])
        native.prep_gray_batch([prepped[i][0] for i in idxs], rots, arr)
        if bn > n:
            arr[n:] = arr[n - 1]
            sizes[n:] = sizes[n - 1]
        out.append(BucketedBatch(hw, arr, idxs, n, sizes))
    return out


def _prep_page_gray_numpy(
    crops: Sequence[np.ndarray],
    orientation: int,
    buckets: Sequence[tuple[int, int]],
) -> list[BucketedBatch]:
    """The NumPy form of ``prep_page_gray``; takes the same inputs, 2D and
    [h, w, 1] grayscale crops included."""
    expanded = []
    for c in crops:
        c = np.asarray(c, np.uint8)
        if c.ndim == 2:
            c = np.repeat(c[..., None], 3, axis=2)
        elif c.ndim == 3 and c.shape[2] == 1:
            c = np.repeat(c, 3, axis=2)
        expanded.append(orient_crop(c, orientation))
    return bucket_crops(expanded, buckets, gray=True)


# The packed wire's buffer row capacity is quantized to 64ths of the padded
# batch's rows, so a bucket's buffers take few distinct shapes while the
# height padding stays off the wire.
CAP_QUANTA = 64


@dataclasses.dataclass
class PackedBatch:
    """One bucket's crops in the row-packed wire format: heights tight,
    widths edge-padded to the bucket width on the host.  The device rebuilds
    the padded [B, bh, bw] batch with a per-row clamped gather
    (``ops.preprocess.unpack_packed_page``), byte-identical to
    ``prep_page_gray``'s batch; the batch-padding rows alias the last real
    crop's rows through ``offsets``, so they cost nothing on the wire."""

    bucket_hw: tuple[int, int]
    flat: np.ndarray  # [H_cap, bw] uint8: tight crop rows + tail padding
    offsets: np.ndarray  # [B_padded] int32 ROW offsets into flat
    indices: list[int]  # original crop index per valid row
    valid: int
    sizes: np.ndarray  # [B_padded, 2] int32 valid (h, w) per row


def prep_page_packed(
    crops: Sequence[np.ndarray],
    orientation: int,
    buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
) -> list:
    """Host prep of the row-packed wire (``PackedBatch``): orient + bucket +
    gray + width pad into one height-tight buffer per bucket, in one native
    pass per bucket.  Where the native library does not load (or a crop
    needs the NumPy path), returns ``prep_page_gray``'s ``BucketedBatch``
    items instead: callers dispatch on the type."""
    from manga_ocr_tpu_torch import native

    if native.load() is None:
        return prep_page_gray(crops, orientation, buckets)
    grouped = _native_prep_groups(crops, orientation, buckets)
    if grouped is None:
        return prep_page_gray(crops, orientation, buckets)
    prepped, groups = grouped

    out = []
    for hw, idxs in sorted(groups.items(), key=lambda kv: kv[0][0] * kv[0][1]):
        bh, bw = hw
        n = len(idxs)
        bn = pad_batch_size(n)
        sizes = np.empty((bn, 2), np.int32)
        offsets = np.empty((bn,), np.int64)
        rots = np.fromiter((prepped[i][1] for i in idxs), np.int32, count=n)
        total_rows = 0
        for row, i in enumerate(idxs):
            eh, ew = prepped[i][2], prepped[i][3]
            sizes[row] = (eh, ew)
            offsets[row] = total_rows
            total_rows += eh
        if bn > n:
            sizes[n:] = sizes[n - 1]
            offsets[n:] = offsets[n - 1]  # alias the last crop's rows
        # quantized row capacity: CAP_QUANTA-ths of the padded batch rows
        full = bn * bh
        step = -(-full // CAP_QUANTA)
        h_cap = min(full, -(-total_rows // step) * step)
        # rows [0, total_rows) are all written by the native pass; only the
        # quantization tail needs deterministic bytes
        flat = np.empty((h_cap, bw), np.uint8)
        flat[total_rows:] = 0
        if not native.prep_gray_packed(
            [prepped[i][0] for i in idxs], rots, offsets[:n], flat
        ):
            return prep_page_gray(crops, orientation, buckets)
        out.append(
            PackedBatch(hw, flat, offsets.astype(np.int32), idxs, n, sizes)
        )
    return out
