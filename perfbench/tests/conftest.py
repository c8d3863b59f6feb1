"""Shared set-up of the benchmark's tests: the repository root on the path, and
a throwaway checkout (``tiny_root``) that holds a copy of ``perfbench/`` and
a ``BENCHMARK.json`` naming tiny cells, added by new files and entries
alone, as a later change adds them: configurations, mixes, a traffic
pattern, a driver of another entry point and a metric."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"image_size": 32, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128}
TINY_DEC = {"vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 32}

# the new per-layer metric a later change might add: answers a page
NEW_METRIC = '''"""crops: the mean crops a page handed in (a throwaway metric)."""


def read(run):
    sizes = run.outcome.page_sizes
    return sum(sizes) / len(sizes) if sizes else None
'''


# a new traffic pattern: pages of exactly ``page_crops`` crops, the pool in
# its order, the pages in an order drawn from the seed
NEW_PATTERN = '''"""Pages of ``page_crops`` crops each (a throwaway pattern)."""

from perfbench.harness import traffic


def schedule(mix, seed, seconds):
    n, size = mix["page_crops"], mix["pool"]["size"]
    pages = [list(range(a, min(a + n, size))) for a in range(0, size, n)]
    order = traffic.rng(seed, 5).permutation(len(pages))
    return traffic.Schedule(pages=[pages[k] for k in order])
'''

# a new driver of another entry point: one synchronous ``ocr_page`` a page
NEW_DRIVER = '''"""One ``engine.ocr_page`` call a page, in turn (a throwaway driver)."""

import time

from perfbench.harness import system
from perfbench.harness.drive import Outcome


def warm(eng, pool, sched, mix):
    system.warm(eng, {(hw, n) for page in sched.pages
                      for hw, n, _ in system.dispatches([pool[j] for j in page], "vertical")})
    eng.ocr_page([pool[j] for j in sched.pages[0]], orientation=1)
    return eng


def drive(eng, pool, sched, mix, seconds):
    handed, answers, sizes = [], [], []
    t0 = time.perf_counter()
    for page in sched.pages:
        answers += eng.ocr_page([pool[j] for j in page], orientation=1)
        handed += page
        sizes.append(len(page))
        if time.perf_counter() - t0 >= seconds:
            break
    return Outcome(handed, answers, time.perf_counter() - t0, page_sizes=sizes)
'''


# The tiny cells' weights and limits, set from CPU readings of the
# lookahead's 3 pages (24 of their 72 answers compared; seeds 11-22, 5,
# 2_200_000_003 and 2_147_483_659).  At std 0.02 the tiny model answers every
# crop alike, so they take larger weights.  int8, std 0.2: the program's
# widest gap at most 0.477, the control's (int4 encoder, int8 decoder) at
# least 0.942.  bf16, std 0.1: the program's at most 0.026, the fp8
# control's at least 0.057 but on one seed whose model answers every crop
# alike (0).  The mean gap: int8, the program's at most 0.00296, answers
# handed to other crops (half the sample) at least 0.032; bf16, at most
# 0.000217 against at least 0.0018.  Tiny widths separate the two weakly;
# the cells' own limits come from the card at full width.
TINY_STD = {"int8": 0.2, "bf16": 0.1}
TINY_MAX_GAP = {"int8": 0.6, "bf16": 0.045}
TINY_MAX_MEAN_GAP = {"int8": 0.01, "bf16": 0.0008}


def tiny_config(base: dict, name: str) -> dict:
    cfg = copy.deepcopy(base)
    cfg["name"] = name
    cfg["encoder"].update(TINY)
    cfg["decoder"].update(TINY_DEC)
    cfg["max_length"] = 16
    form = cfg["serving"]["encoder_kernels"]
    cfg["weights"]["std"] = TINY_STD[form]
    cfg["check"].update(max_gap=TINY_MAX_GAP[form], max_mean_gap=TINY_MAX_MEAN_GAP[form],
                        sample=24, min_tokens=40)
    return cfg


def make_tiny_root(dest: str) -> str:
    """A checkout with the repository's benchmark and tiny cells beside its own."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dest, "perfbench")
    for form in ("int8", "bf16"):
        with open(os.path.join(pb, "configs", f"mangaocr-base-{form}.json")) as f:
            cfg = tiny_config(json.load(f), f"tiny-{form}")
        with open(os.path.join(pb, "configs", f"tiny-{form}.json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": f"tiny-{form}", "source": "https://example.org/tiny",
                                 "file": f"perfbench/configs/tiny-{form}.json", "reduced": [],
                                 "why": "a throwaway configuration"})
    for mix in ("chapter", "pages", "serve"):
        with open(os.path.join(pb, "traffic", f"{mix}.json")) as f:
            t = json.load(f)
        t["pool"]["size"] = 48
        if mix == "chapter":
            t["page_crops"] = [24, 24]
        if mix == "serve":
            t["rate_per_s"] = 150
        with open(os.path.join(pb, "traffic", f"tiny-{mix}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(pb, "traffic", "tiny-chapter.json")) as f:
        t = dict(json.load(f), pattern="tiny_even_pages", driver="tiny_page_by_page",
                 page_crops=16)
    with open(os.path.join(pb, "traffic", "tiny-by-page.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(pb, "patterns", "tiny_even_pages.py"), "w") as f:
        f.write(NEW_PATTERN)
    with open(os.path.join(pb, "drivers", "tiny_page_by_page.py"), "w") as f:
        f.write(NEW_DRIVER)
    cells = {"tiny8.chapter": ("tiny-int8", "tiny-chapter"),
             "tiny8.by_page": ("tiny-int8", "tiny-by-page"),
             "tiny8.pages": ("tiny-int8", "tiny-pages"),
             "tiny8.serve": ("tiny-int8", "tiny-serve"),
             "tiny16.chapter": ("tiny-bf16", "tiny-chapter")}
    for name, (cfg, mix) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "a throwaway cell"})
    closed = ["tiny8.chapter", "tiny8.pages", "tiny16.chapter", "tiny8.by_page"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve = "int8.serve" in m["workloads"]
            m["workloads"] = m["workloads"] + (["tiny8.serve"] if serve else closed)
    with open(os.path.join(pb, "metrics", "tiny.page_crops.py"), "w") as f:
        f.write(NEW_METRIC)
    bench["per_layer"].append({"name": "tiny.page_crops", "unit": "crops", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "crops_per_s", "workloads": closed})
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("checkout")))
