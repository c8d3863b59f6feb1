"""ctypes bindings of the native host ops: the page prep (``prep.cpp``: the
gray wire's padded batches and the packed wire's row-packed buffers) and
the detection's mask ops (``contours.cpp``).

The port's copy of ``manga_ocr_tpu/native``.  Both sources are compiled on
first use with the host's C++ compiler into one library in the git-ignored
``build/manga_ocr_tpu_torch/`` directory beside the CUDA library, keyed by a
hash of the sources and flags, so an edited source is rebuilt and a stale
library never loaded.  ``load()`` returns None when no compiler or library is
available; callers then take the NumPy path (byte-identical gray batches for
the prep, which the packed wire's prep returns too; ``detect/contours.py``'s
tracer and fill for the mask ops).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from manga_ocr_tpu_torch.kernels.build import BUILD_DIR

_SRCS = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
              for name in ("prep.cpp", "contours.cpp"))
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmocr_native_{h.hexdigest()[:16]}.so")


def build() -> str | None:
    """Compile the library if it is missing; its path, or None when no C++
    compiler is found or the build fails."""
    path = _library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # built under a private name, then renamed: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_SRCS], capture_output=True, timeout=120)
        if out.returncode != 0:
            return None
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load() -> ctypes.CDLL | None:
    """The loaded library (built on first use), or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.prep_gray_batch.restype = None
        lib.prep_gray_batch.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.prep_gray_packed.restype = None
        lib.prep_gray_packed.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
        ]
        lib.trace_external_contours.restype = ctypes.c_int32
        lib.trace_external_contours.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.fill_polygon.restype = None
        lib.fill_polygon.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_uint8,
        ]
        lib.dilate_box.restype = None
        lib.dilate_box.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def prep_gray_batch(crops: list[np.ndarray], rots: np.ndarray, dst: np.ndarray) -> bool:
    """Fused orient + gray + edge-replicate pad of ``crops`` into the
    [n, bh, bw] uint8 batch ``dst`` (first ``len(crops)`` rows).

    ``rots``: int32 per-crop rotation code (0 none, 1 = 90° CW, 2 = 90° CCW),
    resolved by the caller on the real crop dims.  Crops must be contiguous
    uint8 [h, w, 3] (BGR) or [h, w]; the rotated crop must fit (bh, bw).
    Returns False when the native library is unavailable."""
    lib = load()
    if lib is None:
        return False
    n = len(crops)
    if not (dst.flags["C_CONTIGUOUS"] and dst.dtype == np.uint8 and dst.ndim == 3):
        raise ValueError("prep_gray_batch: dst must be a contiguous uint8 [n, bh, bw] array")
    if n > dst.shape[0]:
        raise ValueError(f"prep_gray_batch: {n} crops for {dst.shape[0]} rows")
    dims = np.empty((n, 2), np.int32)
    chs = np.empty((n,), np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    for i, c in enumerate(crops):
        if not (c.flags["C_CONTIGUOUS"] and c.dtype == np.uint8):
            raise ValueError("prep_gray_batch: crops must be contiguous uint8 arrays")
        dims[i] = c.shape[:2]
        chs[i] = 1 if c.ndim == 2 else c.shape[2]
        ptrs[i] = _u8ptr(c)
    rots = np.ascontiguousarray(rots, np.int32)
    lib.prep_gray_batch(
        ptrs, _i32ptr(dims), _i32ptr(chs), _i32ptr(rots), n,
        _u8ptr(dst), dst.shape[1], dst.shape[2],
    )
    return True


def prep_gray_packed(
    crops: list[np.ndarray], rots: np.ndarray, row_offsets: np.ndarray, dst: np.ndarray
) -> bool:
    """Fused orient + gray of ``crops`` into the row-packed wire buffer
    ``dst`` [H_total, bw]: crop i fills its rotated height of rows from
    ``row_offsets[i]``, each row edge-padded to bw, so heights are tight
    and the device rebuilds the padded batch with a clamped row gather
    (``ops.preprocess.unpack_packed_page``).  ``rots`` and the crops as in
    ``prep_gray_batch``.  Returns False when the native library is
    unavailable."""
    lib = load()
    if lib is None:
        return False
    n = len(crops)
    if not (dst.flags["C_CONTIGUOUS"] and dst.dtype == np.uint8 and dst.ndim == 2):
        raise ValueError("prep_gray_packed: dst must be a contiguous uint8 [rows, bw] array")
    bw = dst.shape[1]
    dims = np.empty((n, 2), np.int32)
    chs = np.empty((n,), np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    for i, c in enumerate(crops):
        if not (c.flags["C_CONTIGUOUS"] and c.dtype == np.uint8):
            raise ValueError("prep_gray_packed: crops must be contiguous uint8 arrays")
        dims[i] = c.shape[:2]
        chs[i] = 1 if c.ndim == 2 else c.shape[2]
        ptrs[i] = _u8ptr(c)
    rots = np.ascontiguousarray(rots, np.int32)
    byte_offsets = np.ascontiguousarray(row_offsets, np.int64) * bw
    if n:
        last_h = int(dims[-1, 1] if rots[-1] else dims[-1, 0])
        if int(row_offsets[-1]) + last_h > dst.shape[0]:
            raise ValueError(f"prep_gray_packed: the last crop's rows end past {dst.shape[0]}")
    lib.prep_gray_packed(
        ptrs, _i32ptr(dims), _i32ptr(chs), _i32ptr(rots),
        byte_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        _u8ptr(dst), bw,
    )
    return True


def trace_external_contours(mask: np.ndarray) -> list[np.ndarray] | None:
    """External contours of a 0/nonzero [h, w] mask as [N, 2] int32 (x, y)
    arrays; None when the library is unavailable or its buffers overflow."""
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"trace_external_contours: mask must be [h, w], got {mask.shape}")
    h, w = mask.shape
    max_pts = h * w + 16
    max_contours = 4096
    xy = np.empty((max_pts, 2), np.int32)
    sizes = np.empty((max_contours,), np.int32)
    n = lib.trace_external_contours(
        _u8ptr(mask), h, w, _i32ptr(xy), max_pts, _i32ptr(sizes), max_contours
    )
    if n < 0:
        return None  # buffer overflow: the caller falls back
    polys, off = [], 0
    for i in range(n):
        cnt = int(sizes[i])
        polys.append(xy[off : off + cnt].copy())
        off += cnt
    return polys


def fill_polygon(mask: np.ndarray, poly: np.ndarray, value: int = 255) -> bool:
    """Scanline even-odd fill of ``poly`` into the contiguous uint8 ``mask``
    in place; False when the library is unavailable."""
    lib = load()
    if lib is None:
        return False
    if not (mask.flags["C_CONTIGUOUS"] and mask.dtype == np.uint8 and mask.ndim == 2):
        raise ValueError("fill_polygon: mask must be a contiguous uint8 [h, w] array")
    pts = np.ascontiguousarray(poly, np.int32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"fill_polygon: poly must be [n, 2] points, got {pts.shape}")
    lib.fill_polygon(
        _u8ptr(mask), mask.shape[0], mask.shape[1], _i32ptr(pts), len(pts), value
    )
    return True


def dilate_box(mask: np.ndarray, radius: int) -> np.ndarray | None:
    """Box dilation of a uint8 [h, w] mask by ``radius``; None when the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 2 or radius < 0:
        raise ValueError(f"dilate_box: mask must be [h, w] and radius >= 0, got {mask.shape}, "
                         f"{radius}")
    out = np.empty_like(mask)
    lib.dilate_box(_u8ptr(mask), _u8ptr(out), mask.shape[0], mask.shape[1], radius)
    return out
