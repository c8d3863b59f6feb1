"""The benchmark's specification, read by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix; each of those, and each metric, is a file of its own under
``perfbench/``:

- ``configs/<config>.json``: the model's sizes, its serving form, its
  stated precision, the control's precision and the limits of the check;
- ``traffic/<traffic>.json``: the mix's parameters: the ``pattern`` that
  makes its schedule and the ``driver`` that hands it to the program;
- ``patterns/<pattern>.py``: ``schedule(mix, seed, seconds) -> Schedule``;
- ``drivers/<driver>.py``: ``warm(eng, pool, sched, mix) -> target`` (set-up:
  the shapes captured, the entry run once) and ``drive(target, pool, sched,
  mix, seconds) -> Outcome`` (the window), and ``close(target)`` where the
  target holds threads;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A later cell, configuration, mix, pattern, driver or metric is a new file
and a new entry: the harness finds each by its name.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = "perfbench"


def default_root() -> str:
    """The checkout's root: the folder above ``perfbench/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(root: str, name: str) -> dict:
    return _json(os.path.join(root, BENCH_DIR, "traffic", f"{name}.json"))


def data(root: str, name: str) -> dict:
    """A data file of the harness itself (``perfbench/<name>.json``)."""
    return _json(os.path.join(root, BENCH_DIR, f"{name}.json"))


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on.  A metric without a
    ``workloads`` list belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


_MODULES: dict = {}


def module(root: str, kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, loaded once a process."""
    path = os.path.join(root, BENCH_DIR, kind, f"{name}.py")
    if path not in _MODULES:
        s = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(root: str, name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    return module(root, "metrics", name).read


def driver(root: str, name: str):
    """``perfbench/drivers/<name>.py``."""
    return module(root, "drivers", name)


def pattern(root: str, name: str):
    """``perfbench/patterns/<name>.py``."""
    return module(root, "patterns", name)
