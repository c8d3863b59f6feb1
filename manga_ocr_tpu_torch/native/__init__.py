"""ctypes binding of the native host-side page prep (``prep.cpp``).

The port's copy of the gray-wire pass of ``manga_ocr_tpu/native``.  The
library is compiled on first use with the host's C++ compiler into the
git-ignored ``build/manga_ocr_tpu_torch/`` directory beside the CUDA
library, keyed by a hash of the source and flags, so an edited source is
rebuilt and a stale library never loaded.  ``load()`` returns None when no
compiler or library is available; callers then take the NumPy path, which
gives byte-identical batches.
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

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prep.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmocr_prep_{h.hexdigest()[:16]}.so")


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
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC], capture_output=True, timeout=120)
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
