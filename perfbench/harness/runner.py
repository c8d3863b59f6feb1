"""One run of one cell: set-up, the measured window, the check, the result.

``main(argv, t0)`` is ``perfbench/run.py``'s body.  Set-up makes the
weights on the device from the seed, builds the program's engine in the
configuration's serving form, draws the crop pool and the schedule from the
seed (the mix's pattern), and hands both to the mix's driver, whose
``warm`` captures every shape the schedule can dispatch and runs the entry
once untimed; ``setup_s`` runs from the process's start to the first timed
item.  The window then hands the schedule to the driver, traced with
``--trace 1``.  After it: the device's memory peak, the program freed, the
check against the reference, the metrics, and the result as the last line
of standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from perfbench.harness import check, crops, spec, system, traffic, weights
from perfbench.harness.record import Record
from perfbench.harness.trace import Tracer
from perfbench.reference import dims as dimslib

FORBIDDEN = ("jax", "jaxlib", "flax", "manga_ocr_tpu")


class NoDevice(RuntimeError):
    pass


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _device_check(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def setup(root: str, cfg, mix, dims, seed: int, seconds: float, device):
    """The engine, the pool, the schedule and the driver, with the driver's
    target (the engine, or the service around it) warmed."""
    tree = weights.make(dims, seed, cfg["weights"]["std"], device)
    eng = system.engine(tree, cfg, dims, device)
    del tree
    pool = crops.draw(mix["pool"], seed)
    sched = traffic.schedule(root, mix, seed, seconds)
    drv = spec.driver(root, mix["driver"])
    target = drv.warm(eng, pool, sched, mix)
    _sync(device)
    return eng, target, pool, sched, drv


def run(args, t0: float, root: str | None = None, device: str = "cuda",
        look_for_device: bool = True, probe=None) -> tuple[dict, list[str], int]:
    """One run; returns (result line, check lines, dispatch shapes that
    compiled inside the window).  Tests run it on the CPU with
    ``look_for_device=False``.

    ``probe(tree, dims, cfg, crops, rows, orientation, device, seed)``, where
    given, returns more readings over the same sample ({name: readings}, as
    ``check.readings`` gives them: a control, a fault), and each is judged by
    the same ``check.verdict`` as the program's, under ``result["probes"]``
    with its readings.
    The benchmark's own runs give none."""
    import torch

    root = root or spec.default_root()
    bench = spec.load(root)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(root, bench, cell["config"])
    mix = spec.traffic(root, cell["traffic"])
    if look_for_device:
        _device_check(cell["chips"])
    dims = dimslib.read(cfg)

    eng, target, pool, sched, drv = setup(root, cfg, mix, dims, args.seed, args.seconds, device)
    compiles_before = system.unplanned_compiles()
    setup_s = time.time() - t0
    note(f"set-up {setup_s:.3f} s")

    tracer = Tracer(bool(args.trace))
    with tracer.window():
        outcome = drv.drive(target, pool, sched, mix, args.seconds)
    compiles = system.unplanned_compiles() - compiles_before
    note(f"window {outcome.window_s:.3f} s, {len(outcome.answers)} items")
    if outcome.send_lag_s:
        note(f"the open loop sent late by at most {max(outcome.send_lag_s) * 1e3:.3f} ms")
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if hasattr(drv, "close"):
        drv.close(target)
    del eng, target
    _free(device)

    rows = [check.parse(a, dims) for a in outcome.answers]
    lengths = [None if r is None else len(r) for r in rows]
    failed = sum(1 for a in outcome.answers if a is None)
    malformed = sum(1 for a, r in zip(outcome.answers, rows) if a is not None and r is None)
    valid = [i for i, r in enumerate(rows) if r is not None]
    picked = [valid[i] for i in check.choose([lengths[i] for i in valid],
                                             cfg["check"]["sample"], args.seed)]
    sample = ([pool[outcome.pool_index[i]] for i in picked], [rows[i] for i in picked])
    tree = weights.make(dims, args.seed, cfg["weights"]["std"], device)
    read = check.readings(tree, dims, cfg, *sample, mix["orientation"], device)
    probes = {}
    if probe is not None:
        for name, r in probe(tree, dims, cfg, *sample, mix["orientation"], device,
                             args.seed).items():
            ok, _ = check.verdict(r, failed, malformed, cfg)
            probes[name] = {"correct": ok} | r
    del tree
    _free(device)
    correct, checks = check.verdict(read, failed, malformed, cfg)

    record = Record(args.workload, cfg, mix, dims, setup_s, outcome, lengths,
                    spec.data(root, "kernels"), tracer.trace)
    metrics = {}
    for m in spec.metrics(bench, args.workload, bool(args.trace)):
        value = spec.reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(outcome.answers),
              "failed": failed + malformed, "metrics": metrics, "device": dev}
    if tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = {"device_ops": tracer.trace.top_device_ops(),
                               "idle_gaps": tracer.trace.idle_gaps()}
    if probe is not None:
        result["probes"] = probes
    result["check"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, lines, compiles


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        result, lines, compiles = run(args, t0)
    except NoDevice as e:
        note(f"no result: {e}")
        return 2
    print(json.dumps({"unplanned_compiles_in_window": compiles}), flush=True)
    note(f"unplanned compiles in the window: {compiles}")
    if compiles:
        note("a shape compiled inside the measured window: no result")
        return 3
    bad = forbidden_modules()
    if bad:
        note(f"no result: the run loaded {bad}")
        return 4
    for line in lines:
        note(line)
    print(json.dumps(result), flush=True)
    return 0
