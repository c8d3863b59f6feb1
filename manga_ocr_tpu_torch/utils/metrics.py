"""Stage timing and counters of the engine and server (the port's own copy of
what it uses from ``manga_ocr_tpu/utils/metrics.py``).

- ``StageTimer``: per-stage wall time (``engine.ocr_page``'s ``timer``,
  the server's request stages);
- ``ThroughputCounter``: a sliding-window items/s rate (crops served);
- ``EventCounter``: named event counts (dispatch shapes outside the warmed
  set).
"""

from __future__ import annotations

import contextlib
import json
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


GLOBAL_TIMER = StageTimer()
OCR_COUNTER = ThroughputCounter()
# Dispatch shapes outside the warmed set (``engine.ocr_page``): a first call
# of a shape pays the kernel library load and the allocator's growth.
COMPILE_EVENTS = EventCounter()
