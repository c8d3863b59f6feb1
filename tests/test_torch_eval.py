"""The port's CER harness (``manga_ocr_tpu_torch/eval.py``) against the JAX
package's: ``levenshtein``, ``cer``, ``load_fixtures``, ``_orient_code`` and
``evaluate`` agree, and ``python -m manga_ocr_tpu_torch.eval
tests/fixtures/eval --checkpoint tests/fixtures/tiny_random_seed0 --device
cpu`` prints the report of JAX's harness on the committed fixtures (20
crops, 22 scored strings, CER 0, exact match 1)."""

import json
import os

import numpy as np
import pytest

from manga_ocr_tpu import eval as jeval
from manga_ocr_tpu_torch import eval as teval
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TESTS = os.path.dirname(__file__)
FIXTURES = os.path.join(TESTS, "fixtures", "eval")
SEED0 = os.path.join(TESTS, "fixtures", "tiny_random_seed0")


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_levenshtein_and_cer_agree_with_jax():
    rng = np.random.default_rng(0)
    alphabet = list("ぼィぅめぜぎきうたab")
    pairs = [("kitten", "sitting"), ("", "abc"), ("abc", ""), ("", ""), ("こんにちわ", "こんにちは")]
    pairs += [("".join(rng.choice(alphabet, rng.integers(0, 12))),
               "".join(rng.choice(alphabet, rng.integers(0, 12)))) for _ in range(50)]
    for a, b in pairs:
        assert teval.levenshtein(a, b) == jeval.levenshtein(a, b)
        assert teval.cer(a, b) == jeval.cer(a, b)
    assert teval.cer("x", "") == 1.0 and teval.cer("", "") == 0.0


@pytest.mark.parametrize("with_manifest", [True, False], ids=["manifest", "no_manifest"])
def test_load_fixtures_agrees_with_jax(with_manifest):
    manifest = _manifest() if with_manifest else None
    got = teval.load_fixtures(FIXTURES, manifest)
    want = jeval.load_fixtures(FIXTURES, manifest)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "crop":
                assert g[k].dtype == np.uint8
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
    assert sum("dual_ref" in f for f in got) == 2


def test_orient_code_agrees_with_jax():
    for name in ("Vertical", "Horizontal", "Auto-Detect", "None", "other"):
        assert teval._orient_code(name) == jeval._orient_code(name)


class _FakeEngine:
    """Texts from each crop's size; the dual pass returns a fixed second text."""

    def ocr_page(self, crops, orientation):
        return [f"{c.shape[0]}x{c.shape[1]}@{orientation}" for c in crops]

    def ocr_page_dual(self, crops):
        return [(self.ocr_page([c], 0)[0], "dual") for c in crops]


def test_evaluate_agrees_with_jax():
    manifest = _manifest()
    fixtures = teval.load_fixtures(FIXTURES, manifest)
    fixtures[3]["ref"] = f"{fixtures[3]['crop'].shape[0]}x{fixtures[3]['crop'].shape[1]}@1"
    for engine in (_FakeEngine(), lambda crops: ["x" for _ in crops]):
        got = teval.evaluate(engine, fixtures)
        assert got == jeval.evaluate(engine, fixtures)
        assert got["n"] == 20 and got["n_scored"] == (22 if hasattr(engine, "ocr_page") else 20)
    assert teval.evaluate(_FakeEngine(), []) == jeval.evaluate(_FakeEngine(), [])


def test_main_on_cpu_prints_the_jax_harness_report(capsys):
    manifest = _manifest()
    engine = jeval._engine_from_manifest(FIXTURES, manifest)
    want = jeval.evaluate(engine, jeval.load_fixtures(FIXTURES, manifest))
    assert teval.main([FIXTURES, "--checkpoint", SEED0, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert (got["n"], got["n_scored"], got["mean_cer"], got["exact_match"]) == (20, 22, 0.0, 1.0)


def test_main_requires_a_checkpoint(capsys):
    with pytest.raises(SystemExit):
        teval.main([FIXTURES])
    assert "--checkpoint" in capsys.readouterr().err
