"""The control of the check and the faults it must catch: the reference in
the precision one step below the configuration's, a served token altered,
and answers handed to the wrong crops must each come out as not correct,
and the program as correct, by the comparison that decides a run's
``correct`` (``tools/calibrate.py`` over ``runner.run``).

On the CPU at ``MangaOCRConfig.tiny()``; on the card (marker ``cuda``) at
the cells' own size, on three seeds for each cell, held to the limits in
the configuration files.  Run them there with
``python3 -m pytest perfbench/tests -q -m cuda``.
"""

from __future__ import annotations

import pytest

from perfbench.harness import spec
from perfbench.tests.conftest import ROOT

CPU_SEEDS = (5, 2_200_000_003)
CARD_SEEDS = (2_300_000_001, 2_300_000_002, 2_300_000_003)


def _calibrate():
    import importlib.util
    import os

    path = os.path.join(ROOT, "perfbench", "tools", "calibrate.py")
    s = importlib.util.spec_from_file_location("perfbench_calibrate", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _judged(r: dict) -> None:
    assert r["failed"] == 0 and r["compiles_in_window"] == 0, r
    assert r["correct"] and r["max_gap"] <= r["limit"], r
    for name in ("control", "altered", "swapped"):
        if name == "swapped" and not r["swapped_rows"]:
            continue  # every crop answered alike: a swap hands no crop a wrong answer
        assert not r[name]["correct"], (name, r)


@pytest.mark.parametrize("cell", ["tiny8.chapter", "tiny16.chapter"])
@pytest.mark.parametrize("seed", CPU_SEEDS)
def test_the_control_fails_and_the_program_passes_at_tiny_size(tiny_root, cell, seed):
    # a window of 0.01 s takes the lookahead's 3 pages and no more: the same
    # answers on any machine
    r = _calibrate().one(tiny_root, cell, seed, 0.01, "cpu")
    assert r["tokens"] >= 40
    _judged(r)
    assert r["altered"]["max_gap"] > 3 * r["limit"], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load(ROOT)["workloads"]])
def test_the_control_fails_and_the_program_passes_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cal = _calibrate()
    for seed in CARD_SEEDS:
        r = cal.one(ROOT, cell, seed, 3.0, "cuda")
        assert r["swapped_rows"] >= 6, r  # the cells' crops are answered apart
        _judged(r)
