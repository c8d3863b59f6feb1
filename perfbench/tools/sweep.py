"""The highest rate an open-loop cell sustains, found once by a sweep.

    python3 perfbench/tools/sweep.py --workload int8.serve --rates 800,1200,1600 \
        --seconds 8 --seed 5

One process: the cell's set-up, then for each rate in turn a window of the
cell's mix at that rate (Poisson arrivals, as a run sends them).  Per rate,
one JSON line: requests offered and answered, the median and 95th
percentile latency, the backlog (requests due and not yet taken into an
engine call) at a quarter of the window and at its end, and its mean over
the window's second and last quarters.  A rate is ``sustained`` where every
request is answered within half a second of the window's close and the
last quarter's mean backlog is at most 1.25 times the second quarter's:
no backlog that grows.  The cell's rate is 80% of the highest sustained
rate, rounded down to a multiple of 50, printed last as ``{"pick": rate}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

from perfbench.harness import runner, spec, traffic  # noqa: E402
from perfbench.harness.record import percentile  # noqa: E402
from perfbench.reference import dims as dimslib  # noqa: E402


def backlog(outcome, t: float) -> int:
    """Requests due by ``t`` (window-relative) and not yet in an engine call."""
    taken = sum(1 for start, _, ks in outcome.batches if start <= t for k in ks if k >= 0)
    due = sum(1 for u in outcome.scheduled if u <= t)
    return due - taken


def mean_backlog(outcome, a: float, b: float, points: int = 50) -> float:
    return sum(backlog(outcome, a + (b - a) * (k + 0.5) / points) for k in range(points)) / points


def sustained(line: dict) -> bool:
    return line["drain_s"] <= 0.5 and line["backlog_q4_mean"] <= 1.25 * line["backlog_q2_mean"]


def pick(lines: list[dict]) -> int:
    """80% of the highest sustained rate, rounded down to a multiple of 50."""
    best = max(line["rate_per_s"] for line in lines if sustained(line))
    return int(0.8 * best // 50 * 50)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests/s")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    args = p.parse_args(argv)
    bench = spec.load(args.root)
    w = spec.workload(bench, args.workload)
    cfg = spec.config(args.root, bench, w["config"])
    mix = spec.traffic(args.root, w["traffic"])
    dims = dimslib.read(cfg)
    rates = [float(r) for r in args.rates.split(",")]
    lines = []
    mix["rate_per_s"] = rates[0]
    eng, svc, pool, _, drv = runner.setup(args.root, cfg, mix, dims, args.seed, args.seconds,
                                          args.device)
    for rate in rates:
        mix["rate_per_s"] = rate
        sched = traffic.schedule(args.root, mix, args.seed, args.seconds)
        out = drv.drive(svc, pool, sched, mix, args.seconds)
        lat = out.latency_s
        in_window = sum(1 for x, u in zip(lat, out.scheduled)
                        if math.isfinite(x) and u + x <= args.seconds)
        line = {"workload": args.workload, "rate_per_s": rate, "offered": len(lat),
                "answered": sum(1 for x in lat if math.isfinite(x)),
                "answered_in_window": in_window,
                "p50_ms": percentile(lat, 50) * 1e3, "p95_ms": percentile(lat, 95) * 1e3,
                "backlog_quarter": backlog(out, args.seconds / 4),
                "backlog_end": backlog(out, args.seconds),
                "backlog_q2_mean": mean_backlog(out, args.seconds / 4, args.seconds / 2),
                "backlog_q4_mean": mean_backlog(out, 3 * args.seconds / 4, args.seconds),
                "batch_crops": sum(len(ks) for _, _, ks in out.batches) / max(1, len(out.batches)),
                "drain_s": out.window_s - args.seconds}
        line["sustained"] = sustained(line)
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    drv.close(svc)
    if any(line["sustained"] for line in lines):
        print(json.dumps({"pick": pick(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
