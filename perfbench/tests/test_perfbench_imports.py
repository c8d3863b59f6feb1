"""What the benchmark may import: nothing of JAX or the JAX package anywhere
under ``perfbench/`` (top-level names compared whole: ``manga_ocr_tpu_torch``
begins with ``manga_ocr_tpu`` and is allowed), nothing of the program in the
reference, and the program only through ``harness/system.py`` (tests aside)."""

from __future__ import annotations

import ast
import os

from perfbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "manga_ocr_tpu"}
PROGRAM = "manga_ocr_tpu_torch"


def _sources():
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_names(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_scan_compares_whole_names():
    assert PROGRAM.startswith("manga_ocr_tpu") and PROGRAM not in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(_sources())
    assert len(paths) > 20
    for path in paths:
        assert not top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = top_names(os.path.join(ref, f))
            assert PROGRAM not in names and not names & FORBIDDEN, f
            assert names <= {"__future__", "dataclasses", "numpy", "torch", "perfbench"}, f


def test_only_the_system_module_imports_the_program():
    allowed = {os.path.join(BENCH, "harness", "system.py")}
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        if PROGRAM in top_names(path):
            assert path in allowed, path


def test_the_reference_imports_only_the_reference():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(BENCH, "reference", f), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                    "perfbench"):
                assert node.module.startswith("perfbench.reference"), (f, node.module)
