"""The latency arithmetic: percentiles over every request, an unanswered one
counted as infinite, and the microbatcher driver's clock."""

from __future__ import annotations

import math
import sys
import types

import numpy as np
import pytest

from perfbench.harness import drive, spec, traffic
from perfbench.harness.record import percentile
from perfbench.tests.conftest import ROOT


def _reader(name):
    return spec.reader(ROOT, name)


def test_percentile_by_nearest_rank():
    v = list(range(1, 21))  # 1..20
    assert percentile(v, 50) == 10 and percentile(v, 95) == 19 and percentile(v, 100) == 20
    assert percentile([5.0], 95) == 5.0
    assert math.isnan(percentile([], 95))


def test_an_unanswered_request_is_infinite():
    v = [0.1] * 19 + [math.inf]
    assert percentile(v, 95) == 0.1  # 1 of 20 beyond the 95th
    v = [0.1] * 18 + [math.inf, math.inf]
    assert percentile(v, 95) == math.inf


def test_latency_readers():
    run = types.SimpleNamespace(outcome=types.SimpleNamespace(
        latency_s=[0.010 * k for k in range(1, 101)]))
    assert _reader("crop_p95_ms")(run) == pytest.approx(950.0)
    assert _reader("crop_p50_ms")(run) == pytest.approx(500.0)
    run.outcome.latency_s = [0.01] * 90 + [math.inf] * 10
    assert _reader("crop_p95_ms")(run) == sys.float_info.max
    assert _reader("crop_p50_ms")(run) == 10.0
    run.outcome.latency_s = None
    assert _reader("crop_p95_ms")(run) is None


class _Batcher:
    """A microbatcher stand-in: answers every request 20 ms after it came,
    except the ones it drops or answers with the engine's error sentinel."""

    def __init__(self, drop, error):
        import threading
        from concurrent.futures import Future

        self.Future, self.threading = Future, threading
        self.batch_fn = lambda crops: ["x"] * len(crops)
        self.drop, self.error, self.count = drop, error, 0

    def submit(self, crop):
        fut = self.Future()
        k = self.count
        self.count += 1
        if k in self.drop:
            return fut
        text = "[ERROR: boom]" if k in self.error else self.batch_fn([crop])[0]
        self.threading.Timer(0.02, fut.set_result, (text,)).start()
        return fut


def test_microbatcher_driver_counts_from_the_scheduled_time(monkeypatch):
    monkeypatch.setattr(drive, "DRAIN_S", 0.5)
    mix = dict(spec.traffic(ROOT, "serve"), rate_per_s=50.0)
    sched = traffic.schedule(ROOT, mix, 3, 1.0)
    pool = [np.zeros((100, 80, 3), np.uint8) for _ in range(1024)]
    svc = types.SimpleNamespace(batcher=_Batcher(drop={3}, error={7}))
    out = spec.driver(ROOT, "microbatcher").drive(svc, pool, sched, mix, 1.0)
    lat = out.latency_s
    assert len(lat) == 50 and len(out.answers) == 50
    assert lat[3] == math.inf and out.answers[3] is None
    assert lat[7] == math.inf and out.answers[7].startswith("[ERROR")
    finite = [x for x in lat if math.isfinite(x)]
    assert len(finite) == 48 and min(finite) >= 0.02 and max(finite) < 0.5
    assert out.window_s >= 1.0
    assert len(out.batches) == 48 and all(len(ks) == 1 for _, _, ks in out.batches)
