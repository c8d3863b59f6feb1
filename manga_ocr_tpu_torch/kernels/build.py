"""Build and load the CUDA kernels of ``manga_ocr_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects link into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/manga_ocr_tpu_torch/`` beside the package and is
keyed by a hash of the sources and flags, so an edited source is rebuilt and
a stale library is never loaded.  Headers come only from this repository and
the CUDA toolkit; nothing is downloaded.

Nothing here runs at import time: the first ``load()`` builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "manga_ocr_tpu_torch")

# ``-Xptxas -v`` only prints each kernel's registers, shared memory and
# spills into the build's log; every build takes it, so one library serves
# every process, whoever built it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(_P)
# C entry points: (name, argtypes).  Each returns cudaGetLastError() after
# its launch (0 = cudaSuccess).
_SIGNATURES = {
    # x, x_is_bf16, ln_scale, ln_bias, do_ln, eps, q_out, sx_out, M, K, stream
    "mocr_ln_quant_rows": (_P, _I, _P, _P, _I, _F, _P, _P, _I, _I, _P),
    # a, b_t, sx, sw, bias, residual, out, M, N, K, mode, stream
    "mocr_int8_gemm": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, in strides (batch, head, row), out, out strides, out_bf16,
    # divide, B, S, H, dh, valid_len, scale, stream
    "mocr_attention": (_P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _F,
                       _P),
    # as mocr_attention, without divide
    "mocr_attention_sdpa_int8": (_P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                                 _F, _P),
    # ptrs, n_ptrs, ints, n_ints, scale, eps, tokens, lengths, stream
    "mocr_decode_loop": (_PP, _I, ctypes.POINTER(_I), _I, _F, _F, _P, _P, _P),
    # int8_w, fuse_kv, opts, rows_per_block, smem bytes, blocks (out)
    "mocr_decode_loop_blocks_per_sm": (_I, _I, _I, _I, _I, ctypes.POINTER(_I)),
    # ptrs, n_ptrs, ints, n_ints, scale, eps, int8, tokens, lengths, clusters
    # (out), stage clocks (device, or null), stream
    "mocr_decode_cluster": (_PP, _I, ctypes.POINTER(_I), _I, _F, _F, _I, _P, _P,
                            ctypes.POINTER(_I), _P, _P),
    # x, ln_scale, ln_bias, eps, y, M, K, stream
    "mocr_ln_rows_bf16": (_P, _P, _P, _F, _P, _I, _I, _P),
    # a, b, bias, residual, out, M, N, K, mode, stream
    "mocr_bf16_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # mismatches (u64, device), stream
    "mocr_check_gelu_erf_rcp": (_P, _P),
    # x, wt, bt, lns, lnb, wp, bp, B, D, V, eps, h32, hb, part_v, part_i,
    # ids, stream
    "mocr_fused_head": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P),
    # qkv, cache_k, cache_v, out, sx, mode, B, T, H, dh, step, scale, cluster,
    # width, chunk, smem, stream
    "mocr_self_attn_step": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # q, k, v, k_scale, v_scale, kv_int8, out, sx, mode, B, S, H, dh, s_valid,
    # scale, cluster, width, chunk, smem, stream
    "mocr_cross_attn_step": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                             _I, _I, _P),
    # weights, n_weights, scratch, n_scratch, x, out, n_layers, int8,
    # gelu_sigmoid, divide, B, S, D, H, I, eps, scale, stream
    "mocr_encoder_layers": (_PP, _I, _PP, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                            _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_log = ""  # nvcc's output of the library this process loaded, if known


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _key() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needs the CUDA toolkit, e.g. /usr/local/cuda)")


def build() -> str:
    """Compile the library if no library for the current sources exists;
    return its path.  The build's log (ptxas's registers, shared memory and
    spills per kernel) is kept beside the library and read into
    ``last_build_log`` when it is reused."""
    global last_build_log
    path = os.path.join(BUILD_DIR, f"libmocr_cuda_{_key()}.so")
    log_path = path + ".log"  # the build's nvcc output, kept beside it
    if os.path.exists(path):
        if os.path.exists(log_path):
            with open(log_path) as f:
                last_build_log = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library are built under private names, then the
    # library is renamed: a concurrent build never loads a half-written one
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(os.path.basename(obj))
        last_build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp,
               *(obj for obj, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        last_build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{last_build_log}")
        with open(log_path, "w") as f:
            f.write(last_build_log)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def call(device, what: str, name: str, *args, stream: bool = True) -> None:
    """Call the C entry point ``name`` with ``device`` (a ``torch.device``)
    current, PyTorch's current stream on ``device`` appended to ``args``
    (``stream=False``: nothing appended), and raise as ``check`` does,
    naming ``what``.  The C side keys its per-device state (SM counts,
    opted-in shared memory, function attributes) on the current device, so
    a tensor on ``cuda:1`` must launch with ``cuda:1`` current; a CUDA
    device that is current already is not set again (launches are
    host-bound on the step decodes)."""
    import torch

    fn = getattr(load(), name)
    if stream:
        args = (*args, stream_ptr(device))
    if device.type == "cuda" and device.index in (None, torch.cuda.current_device()):
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    check(err, what)
