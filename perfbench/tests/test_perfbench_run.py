"""Whole runs of throwaway tiny cells on the CPU, added to a copy of the
benchmark by new files and new ``BENCHMARK.json`` entries alone: the result
line, the metrics each cell reports, a new metric found by its name, and
``correct`` coming out false when the timed path is broken underneath."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from perfbench.harness import drive, runner, spec
from perfbench.tests.conftest import ROOT

SEED = 2_147_483_659  # above 2**31


def _run(root, cell, trace=0, seconds=None, seed=SEED):
    # a closed loop's 0.01 s window takes the lookahead's 3 pages, the open
    # loop's 1.5 s its 225 requests: the same answers on any machine
    if seconds is None:
        seconds = 1.5 if cell.endswith("serve") else 0.01
    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", str(trace)])
    result, lines, compiles = runner.run(args, time.time(), root=root, device="cpu",
                                         look_for_device=False)
    json.dumps(result, allow_nan=False)  # the line is strict JSON
    return result, lines, compiles


@pytest.mark.parametrize("cell,trace", [("tiny8.chapter", 0), ("tiny8.chapter", 1),
                                        ("tiny8.pages", 1), ("tiny16.chapter", 0),
                                        ("tiny8.serve", 0), ("tiny8.serve", 1),
                                        ("tiny8.by_page", 0), ("tiny8.by_page", 1)])
def test_a_throwaway_cell_runs_and_is_correct(tiny_root, cell, trace):
    result, lines, compiles = _run(tiny_root, cell, trace)
    assert compiles == 0
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check" and list(result)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    assert result["check"]["max_gap"]["value"] <= result["check"]["max_gap"]["limit"]
    assert [ln.split(":")[0] for ln in lines] == [f"check {k}" for k in result["check"]]
    bench = spec.load(tiny_root)
    wanted = {m["name"] for m in spec.metrics(bench, cell, bool(trace))}
    got = set(result["metrics"])
    assert got <= wanted
    if trace:
        assert "breakdown" in result and result["device"]["window_s"] > 0
        # no device on the CPU: the idle share is all of the window
        idle = "device_idle_pct.serve" if cell.endswith("serve") else "device_idle_pct"
        assert result["metrics"][idle]["value"] == pytest.approx(100.0)
        if cell == "tiny8.chapter":
            assert result["metrics"]["tiny.page_crops"]["value"] == 24.0
    else:
        assert got == wanted and result["metrics"]["setup_s"]["value"] > 0
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}


def _broken(monkeypatch, how):
    """Break the timed path underneath the harness, in the program."""
    from manga_ocr_tpu_torch.engine import engine as eng_mod
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    if how == "token altered":
        real = CharTokenizer.decode_batch

        def decode_batch(self, tokens, lengths=None):
            tokens = tokens.copy()
            tokens[:, 3] = (tokens[:, 3] + 17) % len(self)
            return real(self, tokens, lengths)

        monkeypatch.setattr(CharTokenizer, "decode_batch", decode_batch)
    elif how == "answer left out":
        real = eng_mod.TorchMangaOcrEngine._collect_page
        monkeypatch.setattr(eng_mod.TorchMangaOcrEngine, "_collect_page",
                            lambda self, page, timer: real(self, page, timer)[:-1])
        monkeypatch.setattr(drive, "DRAIN_S", 0.5)
        monkeypatch.setattr(drive, "WARM_S", 1.0)
    elif how == "state unchanged":
        real = mdl.ocr_forward

        def frozen(*a, **k):
            out = real(*a, **k)
            tok = out.tokens.clone()
            tok[:, 2:] = tok[:, 1:2]  # every step repeats the first
            return mdl.GreedyResult(tok, out.lengths)

        monkeypatch.setattr(mdl, "ocr_forward", frozen)
    elif how == "half the batch":
        real = eng_mod.TorchMangaOcrEngine._collect_page

        def half(self, page, timer):
            texts = real(self, page, timer)
            k = len(texts) // 2
            return texts[:len(texts) - k] + texts[:k]  # the second half: others' answers

        monkeypatch.setattr(eng_mod.TorchMangaOcrEngine, "_collect_page", half)


@pytest.mark.parametrize("cell", ["tiny8.chapter", "tiny8.serve"])
@pytest.mark.parametrize("how", ["token altered", "answer left out", "state unchanged",
                                 "half the batch"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, how):
    _broken(monkeypatch, how)
    result, _, _ = _run(tiny_root, cell)
    assert result["correct"] is False, how


def test_no_result_without_a_card(tmp_path):
    """The real cells on this CPU-only machine: exit 2, no result line."""
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "int8.chapter", "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
        | {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert "{" not in proc.stdout


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A folder with BENCHMARK.json and perfbench/ only: no program, no result."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "int8.chapter", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_no_result_once_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(runner, "run", lambda args, t0: ({"correct": True}, [], 0))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert runner.main(["--workload", "x", "--seed", "1", "--seconds", "1"], 0.0) == 4
    out = capsys.readouterr()
    assert '"correct"' not in out.out and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "manga_ocr_tpu_torch_extra", types.ModuleType("x"))
    assert runner.main(["--workload", "x", "--seed", "1", "--seconds", "1"], 0.0) == 0


def test_no_result_when_a_shape_compiles_in_the_window(monkeypatch, capsys):
    monkeypatch.setattr(runner, "run", lambda args, t0: ({"correct": True}, [], 1))
    assert runner.main(["--workload", "x", "--seed", "1", "--seconds", "1"], 0.0) == 3
    assert '"correct"' not in capsys.readouterr().out
