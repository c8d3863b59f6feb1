"""Host orchestration of single-crop callers (the port's own copy of
``MicroBatcher`` from ``manga_ocr_tpu/runtime/pipeline.py``).

``MicroBatcher`` keeps a per-crop calling convention: single ``submit()``
calls coalesce within a small window (default 10 ms) and run as ONE batched
call (``engine.ocr_page``), so per-crop callers get page-batch throughput.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np


class MicroBatcher:
    """Coalesce single-crop OCR calls into batched dispatches.

    ``submit(crop)`` returns a Future; a background thread drains the queue
    every ``window_ms`` (or when ``max_batch`` is reached) and runs one
    batched call for everything collected."""

    def __init__(
        self,
        batch_fn: Callable[[list[np.ndarray]], list[str]],
        window_ms: float = 10.0,
        max_batch: int = 256,
    ):
        self.batch_fn = batch_fn
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self._queue: "queue.Queue[tuple[np.ndarray, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, crop: np.ndarray) -> Future:
        fut: Future = Future()
        self._queue.put((crop, fut))
        return fut

    def ocr(self, crop: np.ndarray, timeout: float | None = 600.0) -> str:
        """The default timeout covers a first call that builds the kernels."""
        return self.submit(crop).result(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # Adaptive window: a lone request on an idle engine dispatches
            # (almost) immediately — only a sub-ms grace period to catch
            # simultaneous submitters; the full coalescing window applies
            # only under load (more work already queued).
            time.sleep(0.0005)
            if not self._queue.empty():
                end = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
            while len(batch) < self.max_batch:  # final non-blocking drain
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # Drop entries whose caller cancelled while queued (and claim the
            # rest against further cancellation) BEFORE spending device time.
            live = [(c, f) for c, f in batch if f.set_running_or_notify_cancel()]
            if not live:
                continue
            crops = [c for c, _ in live]
            futures = [f for _, f in live]
            try:
                texts = self.batch_fn(crops)
            except Exception as e:
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for fut, text in zip(futures, texts):
                # a cancelled/raced future must not poison its batchmates
                if not fut.done():
                    fut.set_result(text)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
