"""Single-crop requests into ``serve.OcrService``'s ``MicroBatcher``, each
submitted at its scheduled time.

A request's latency runs from that time to the moment its Future
completed.  After the last send the driver waits for every answer, at most
``drive.DRAIN_S`` past the window.  The service's ``batch_fn`` is wrapped,
in the benchmark's code, with a span: the crops of each engine call, and
its start and end.
"""

from __future__ import annotations

import concurrent.futures as futures
import math
import threading
import time

from perfbench.harness import drive as shared
from perfbench.harness import system
from perfbench.harness.drive import Outcome


def warm(eng, pool: list, sched, mix: dict):
    """Capture every padded batch of every bucket the pool falls into, then
    send one full batch through the service untimed."""
    buckets = {hw for hw, _, _ in system.dispatches(pool, mix["orientation"])}
    system.warm(eng, [(hw, n) for hw in buckets for n in system.batch_sizes(mix["max_batch"])])
    svc = system.service(eng, mix)
    futures.wait([svc.batcher.submit(pool[j]) for j in range(min(len(pool), mix["max_batch"]))],
                 timeout=shared.WARM_S)
    return svc


def close(svc) -> None:
    svc.close()


def drive(svc, pool: list, sched, mix: dict, seconds: float) -> Outcome:
    batcher = svc.batcher
    inner = batcher.batch_fn
    n = len(sched.arrivals)
    # a distinct array object a request, so that a batch's crops name their requests
    views = [pool[j].view() for j in sched.requests]
    owner = {id(v): k for k, v in enumerate(views)}
    batches: list = []

    def spanned(crops):
        t0 = time.perf_counter()
        out = inner(crops)
        batches.append((t0, time.perf_counter(), [owner.get(id(c), -1) for c in crops]))
        return out

    batcher.batch_fn = spanned
    done = [math.inf] * n
    answers: list = [None] * n
    lag = [0.0] * n
    all_done = threading.Event()
    left = [n]
    lock = threading.Lock()

    def finished(k, fut):
        t = time.perf_counter()
        if not fut.cancelled() and fut.exception() is None:
            answers[k] = fut.result()
            if not str(answers[k]).startswith("[ERROR"):  # the engine's error sentinel
                done[k] = t
        with lock:
            left[0] -= 1
            if not left[0]:
                all_done.set()

    t0 = time.perf_counter()
    due = [t0 + float(a) for a in sched.arrivals]
    for k in range(n):
        wait = due[k] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lag[k] = time.perf_counter() - due[k]
        batcher.submit(views[k]).add_done_callback(lambda f, k=k: finished(k, f))
    all_done.wait(timeout=max(0.0, t0 + seconds + shared.DRAIN_S - time.perf_counter()))
    end = time.perf_counter()
    latency = [d - u for d, u in zip(done, due)]
    with lock:
        snapshot = list(answers)
    batcher.batch_fn = inner
    rel_batches = [(a - t0, b - t0, ks) for a, b, ks in batches]
    return Outcome(list(sched.requests), snapshot, end - t0, latency, rel_batches,
                   [u - t0 for u in due], lag)
