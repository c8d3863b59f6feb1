"""A short traced window of one cell, kept as a gzipped Chrome trace.

    python3 perfbench/tools/trace_dump.py --workload int8.chapter --seed 7 \
        --seconds 2 --out chapter_trace.json.gz

The cell's set-up as ``run.py`` makes it, then ``--seconds`` of its
traffic under ``torch.profiler`` (CPU and CUDA activity), written to
``--out`` for reading by hand (kernels by name and count, graph replays,
gaps).  No check and no metric: ``run.py --trace 1`` reports those.
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

from perfbench.harness import runner, spec  # noqa: E402
from perfbench.harness.trace import WINDOW  # noqa: E402
from perfbench.reference import dims as dimslib  # noqa: E402


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True, help="the .json.gz file to write")
    args = p.parse_args(argv)
    bench = spec.load(ROOT)
    w = spec.workload(bench, args.workload)
    cfg = spec.config(ROOT, bench, w["config"])
    mix = spec.traffic(ROOT, w["traffic"])
    eng, target, pool, sched, drv = runner.setup(ROOT, cfg, mix, dimslib.read(cfg), args.seed,
                                                 args.seconds, "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            outcome = drv.drive(target, pool, sched, mix, args.seconds)
        torch.cuda.synchronize()
    if hasattr(drv, "close"):
        drv.close(target)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, "rb") as f, gzip.open(args.out, "wb") as g:
            shutil.copyfileobj(f, g)
    finally:
        os.remove(path)
    print(f"items {len(outcome.answers)} window {outcome.window_s:.3f} s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
