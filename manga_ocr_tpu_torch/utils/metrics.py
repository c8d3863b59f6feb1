"""Stage timing, counters, traces and FLOP accounting (the port's own copy of
``manga_ocr_tpu/utils/metrics.py``).

- ``StageTimer``: per-stage wall time (``engine.ocr_page``'s ``timer``,
  the server's request stages);
- ``ThroughputCounter``: a sliding-window items/s rate (crops served);
- ``trace``: a ``torch.profiler`` trace of a block, written as one Chrome
  trace (JAX's wraps ``jax.profiler``);
- ``EventCounter``: named event counts (dispatch shapes outside the warmed
  set);
- the model's matmul FLOPs a crop and ``mfu`` against the H100's peaks (the
  benchmark's utilisation fields; JAX's are against a TPU v5e's).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Iterator


class StageTimer:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(name, self._clock() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def summary(self) -> dict:
        with self._lock:
            return {
                name: {
                    "total_s": round(self._totals[name], 6),
                    "count": self._counts[name],
                    "mean_ms": round(self._totals[name] / self._counts[name] * 1000, 3),
                }
                for name in self._totals
            }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)


class ThroughputCounter:
    """Sliding-window items/sec counter."""

    def __init__(self, window_s: float = 60.0, clock=time.time):
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        self._events: list[tuple[float, int]] = []
        self._total = 0

    def add(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._events.append((now, n))
            self._total += n
            cutoff = now - self.window_s
            while self._events and self._events[0][0] < cutoff:
                self._events.pop(0)

    @property
    def total(self) -> int:
        return self._total

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            cutoff = now - self.window_s
            items = sum(n for t, n in self._events if t >= cutoff)
            if not self._events:
                return 0.0
            # Floor the span at 1 s so a burst of events at a single instant
            # reads as items/sec, not items/epsilon.
            span = min(self.window_s, max(now - self._events[0][0], 1.0))
            return items / span


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace: ``with metrics.trace('/tmp/trace'): ...`` writes one
    Chrome trace (``trace_<pid>_<ms>.json``, readable in Perfetto or
    chrome://tracing) into ``logdir``: CPU activity, and CUDA activity
    where a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


class EventCounter:
    """Named event counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def summary(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


# ---------------------------------------------------------------------------
# Model FLOPs accounting + MFU
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM dense tensor-core peaks (published): 989 TFLOP/s bf16,
# 1,979 TOP/s int8.
H100_PEAK_BF16 = 989e12
H100_PEAK_INT8 = 1979e12


def encoder_flops_per_crop(cfg) -> float:
    """Matmul FLOPs of one encoder forward for ONE crop (2*M*N*K
    convention).  ``cfg``: EncoderConfig."""
    s, d, i = cfg.seq_len, cfg.hidden_size, cfg.intermediate_size
    p = cfg.patch_size
    patch = 2 * cfg.num_patches * (p * p * cfg.num_channels) * d
    per_layer = (
        4 * 2 * s * d * d  # q/k/v/o projections
        + 2 * 2 * s * s * d  # QK^T and AV (summed over heads: H * 2*2*s*s*dh)
        + 2 * 2 * s * d * i  # fc1 + fc2
    )
    return float(patch + cfg.num_layers * per_layer)


def decode_flops_per_crop(cfg, decode_steps: int, enc_seq_len: int) -> float:
    """Matmul FLOPs of cross-KV precompute + ``decode_steps`` greedy steps
    for ONE crop.  ``cfg``: DecoderConfig."""
    d, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    s = enc_seq_len
    cross_kv = cfg.num_layers * 2 * 2 * s * d * d  # k & v projections
    # per step, per layer: self q/k/v/o + self-attn (~T*d, T<=steps) +
    # cross q/o + cross-attn over s + mlp
    per_step_layer = (
        4 * 2 * d * d
        + 2 * 2 * decode_steps * d  # self-attn (upper bound: full cache)
        + 2 * 2 * d * d  # cross q/o
        + 2 * 2 * s * d  # cross scores + context
        + 2 * 2 * d * i  # mlp
    )
    head = 2 * d * d + 2 * d * v  # transform + vocab projection
    return float(cross_kv + decode_steps * (cfg.num_layers * per_step_layer + head))


def model_flops_per_crop(cfg, decode_steps: int) -> float:
    """Total matmul FLOPs for one crop through encode + greedy decode.
    ``cfg``: MangaOCRConfig."""
    return encoder_flops_per_crop(cfg.encoder) + decode_flops_per_crop(
        cfg.decoder, decode_steps, cfg.encoder.seq_len
    )


def mfu(crops_per_s: float, flops_per_crop: float, peak_flops: float = H100_PEAK_BF16) -> float:
    """Model FLOPs utilization: achieved model FLOP/s over hardware peak."""
    if peak_flops <= 0:
        return 0.0
    return crops_per_s * flops_per_crop / peak_flops


GLOBAL_TIMER = StageTimer()
OCR_COUNTER = ThroughputCounter()
# Dispatch shapes outside the warmed set (``engine.ocr_page``): a first call
# of a shape pays the kernel library load and the allocator's growth.
COMPILE_EVENTS = EventCounter()
