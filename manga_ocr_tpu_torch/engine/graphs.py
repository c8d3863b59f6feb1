"""Compile-once dispatches: one CUDA graph per (bucket, padded batch).

The counterpart of the JAX engine's AOT executable store
(``manga_ocr_tpu/utils/aot_store.py`` behind ``engine._resolve_fn``),
where each (bucket, padded batch) shape runs as ONE compiled XLA
executable.  Eager, one dispatch of ``TorchMangaOcrEngine._bucket_program``
(preprocess, the encoder's kernels, cross-K/V, kernel C) is on the order of
a hundred launches from Python through ctypes; here it is recorded once per
shape into a ``torch.cuda.CUDAGraph`` and replayed with one launch.  The
key is JAX's: the bucket and the padded batch (``max_length`` and the
params are the engine's own).

A ``Capture`` holds its static inputs ([n, bh, bw] uint8 crops and [n, 2]
int32 extents on the engine's device), the graph of the program over them,
and its static [n, 1 + L] int32 output.  The graph also recorded the
pointers of the weights the kernels read in their prepared layouts
(``ops.encoder_weights.prepared``): those are remembered under a leaf of the
engine's params, which the engine holds as long as its graphs, so they
outlive every capture.  The engine's params are not written in place (an
in-place write would make the next eager preparation replace, and free,
what a graph reads).

``run`` copies a dispatch's crops and extents into the static inputs on the
current stream, replays there, and returns a fresh copy of the output made
on that stream.  A later replay of the shape overwrites the static output,
while what an earlier dispatch returned may still be read (a coalesced
page's ``torch.cat``, a ``HostCopy``): the copy keeps each dispatch's rows
its own, as the eager program's fresh tensors are.  Stream order puts every
copy-in after the replays before it, so callers dispatch on one stream (the
engine's threads use the device's default stream).

``capture`` first runs the program eagerly on the capture stream (the
kernel library's load, the weights' preparation, the kernels' per-process
attributes and the allocator's growth, none of which stream capture
allows), then records it.  Every capture of one ``BucketGraphs`` shares one
capture stream and one graph memory pool (``torch.cuda.graph_pool_handle``):
a later graph's temporaries may take an earlier graph's temporaries' memory,
never a static input or output, which stay allocated as long as their
capture.  Capture runs with ``capture_error_mode="thread_local"``: a shape
first reached from ``ocr_pages``' lookahead thread is captured there while
the caller waits on ``HostCopy`` events.  A capture or a replay that fails
raises; nothing falls back to the eager dispatch.

The capture stream and the pool are a ``Recorder``'s, which ``graphed``
also takes: the benchmark (``manga_ocr_tpu_torch/benchmark.py``) records
its model-only call, over pixels that stay put, as one graph the same way.
"""

from __future__ import annotations

import threading
import time

import torch


class Capture:
    """One (bucket, padded batch) shape's static inputs, graph and output."""

    def __init__(self, crops: torch.Tensor, ext: torch.Tensor):
        self.crops, self.ext = crops, ext
        self.graph = None
        self.out: torch.Tensor | None = None
        self.seconds = 0.0  # host seconds of the eager pass and the capture


class Recorder:
    """One capture stream and one graph memory pool on ``device``, made at
    the first ``record``: every graph recorded through it shares them."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None
        self._pool = None

    def record(self, program, *inputs):
        """The eager pass of ``program(*inputs)`` on the capture stream, then
        its capture -> (graph, the static output the graph writes)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            program(*inputs)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            out = program(*inputs)
        current.wait_stream(self._stream)
        return graph, out


def _fresh(out):
    """A copy of a static output (a tensor, or a tuple of them) that later
    replays do not overwrite."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(*(t.clone() for t in out))


def graphed(program, recorder: Recorder):
    """``program()``, which reads only tensors that outlive it, recorded once
    through ``recorder`` -> a call that replays the graph on the current
    stream and returns a fresh copy of its output."""
    graph, out = recorder.record(program)

    def call():
        graph.replay()
        return _fresh(out)

    return call


class BucketGraphs:
    """The captures of one ``program(crops, ext) -> [n, 1 + L] int32`` (the
    engine's bucket program) on ``device``, by (bucket_hw, n), in capture
    order.  Each call is handed the program, the same at every call, which
    is not kept: the captures hold no reference to the engine, so dropping
    the engine frees its graphs and their pool at once.  ``lock`` (the
    engine's) serialises captures and replays."""

    def __init__(self, device: torch.device, lock: threading.Lock):
        self.device = device
        self._lock = lock
        self.captures: dict[tuple[tuple[int, int], int], Capture] = {}
        self._recorder = Recorder(device)

    def capture(self, program, bucket_hw: tuple[int, int], n: int) -> Capture:
        """The shape's capture, made now if it is not made yet."""
        with self._lock:
            return self._capture(program, tuple(bucket_hw), n)

    def run(self, program, crops: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
        """``program``'s [n, 1 + L] rows of ``crops`` [n, bh, bw] uint8 and
        ``ext`` [n, 2] int32: copy in, replay, copy out."""
        n, bh, bw = crops.shape
        with self._lock, torch.inference_mode():
            cap = self._capture(program, (bh, bw), n)
            cap.crops.copy_(crops)
            cap.ext.copy_(ext)
            self._replay(cap)
            return cap.out.clone()

    def _capture(self, program, bucket_hw: tuple[int, int], n: int) -> Capture:
        cap = self.captures.get((bucket_hw, n))
        if cap is not None:
            return cap
        t0 = time.perf_counter()
        with torch.inference_mode():
            ext = torch.empty((n, 2), dtype=torch.int32, device=self.device)
            ext[:, 0], ext[:, 1] = bucket_hw
            cap = Capture(torch.zeros((n, *bucket_hw), dtype=torch.uint8, device=self.device),
                          ext)
            self._record(cap, program)
        cap.seconds = time.perf_counter() - t0
        self.captures[(bucket_hw, n)] = cap
        return cap

    def _record(self, cap: Capture, program) -> None:
        """The eager pass of ``program`` on the capture stream, then its
        capture."""
        cap.graph, cap.out = self._recorder.record(program, cap.crops, cap.ext)

    def _replay(self, cap: Capture) -> None:
        """The program on ``cap``'s static inputs into its static output:
        one launch of the graph that recorded it."""
        cap.graph.replay()
