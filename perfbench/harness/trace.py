"""The device trace of a run's window, and what is read from it.

``Tracer`` runs ``torch.profiler`` (host and CUDA activity) over the
window, inside a ``perfbench.window`` annotation that marks its span, and
exports one Chrome trace under the run's temporary directory; ``read``
turns that file into a ``Trace``: the device's operations (kernels,
copies, fills) as intervals, the host's annotated and runtime events, and
the window.  The file is deleted once read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile

import numpy as np

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SMALL_GAP_US = 50.0


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]  # us
    dev_names: list[str]
    dev_start: np.ndarray  # us
    dev_end: np.ndarray
    host_names: list[str]
    host_start: np.ndarray
    host_end: np.ndarray

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's operations inside the window, [n, 2] us."""
        a, b = self.window
        s = np.clip(self.dev_start, a, b)
        e = np.clip(self.dev_end, a, b)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return np.zeros((0, 2))
        order = np.argsort(s)
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.concatenate([[True], s[1:] > e[:-1]])
        starts = s[new]
        ends = np.concatenate([e[np.flatnonzero(new)[1:] - 1], [e[-1]]])
        return np.stack([starts, ends], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6

    def count_host(self, name: str) -> int:
        a, b = self.window
        return sum(1 for n, s in zip(self.host_names, self.host_start)
                   if n == name and a <= s <= b)

    def device_time_s(self, pattern: str) -> float:
        """Seconds of the device operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        a, b = self.window
        total = 0.0
        for n, s, e in zip(self.dev_names, self.dev_start, self.dev_end):
            if rx.search(n):
                total += max(0.0, min(e, b) - max(s, a))
        return total * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        sums: dict = {}
        a, b = self.window
        for n, s, e in zip(self.dev_names, self.dev_start, self.dev_end):
            d = min(e, b) - max(s, a)
            if d > 0:
                sums[n] = sums.get(n, 0.0) + d
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), v * 1e-6] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the window by what the host was doing:
        each gap of at least ``SMALL_GAP_US`` goes to the host event that
        overlaps it most (the shortest, where several overlap alike); the
        shorter gaps are summed under one name."""
        a, b = self.window
        iv = self.busy_intervals()
        bounds = np.concatenate([[a], iv.reshape(-1), [b]]).reshape(-1, 2)
        gs, ge = bounds[:, 0], bounds[:, 1]
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        sums: dict = {}
        small = (ge - gs) < SMALL_GAP_US
        if small.any():
            sums[f"gaps under {SMALL_GAP_US:g} us"] = float((ge - gs)[small].sum())
        big = np.flatnonzero(~small)
        big = big[np.argsort(-(ge - gs)[big])][:2000]
        hs, he = self.host_start, self.host_end
        for j in big:
            ov = np.minimum(he, ge[j]) - np.maximum(hs, gs[j])
            cand = np.flatnonzero(ov > 0)
            if not len(cand):
                name = "no traced host event"
            else:
                best = ov[cand].max()
                tied = cand[ov[cand] >= best * 0.999]
                name = self.host_names[tied[np.argmin((he - hs)[tied])]]
            sums[name] = sums.get(name, 0.0) + float(ge[j] - gs[j])
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), v * 1e-6] for n, v in top]


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def read(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    window = None
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((name, ts, ts + dur))
        elif cat in HOST_CATS:
            if name == WINDOW and cat == "user_annotation":
                window = (ts, ts + dur)
            else:
                host.append((name, ts, ts + dur))
    if window is None:
        raise RuntimeError(f"trace {path}: no {WINDOW!r} annotation")

    def cols(rows):
        return ([r[0] for r in rows], np.array([r[1] for r in rows], dtype=np.float64),
                np.array([r[2] for r in rows], dtype=np.float64))

    return Trace(window, *cols(dev), *cols(host))


class Tracer:
    """``with Tracer(on) as t: ...`` profiles the block when ``on``; then
    ``t.trace`` holds the read trace."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Trace | None = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.on:
            yield
            return
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                yield
            if cuda:
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            self.trace = read(path)
        finally:
            os.remove(path)
