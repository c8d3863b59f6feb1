"""The port's throughput bench (``manga_ocr_tpu_torch/benchmark.py``) and the
FLOP accounting and ``trace`` of its ``utils/metrics.py`` against the JAX
package's, on the CPU:

- the four FLOP functions equal JAX's for ``base()``, ``serving()`` and a
  tiny config at 1, 32 and 300 decode steps; ``mfu`` is rate x FLOPs over
  the H100 peak;
- ``committed_lengths`` equal to JAX's; ``_scored``'s keys JAX's but
  ``vs_baseline``, with the same ``model_gflops_per_crop``;
- ``main``'s merge, phase D and failure line with the phase functions
  replaced (JAX's ``tests/test_benchmark_parent.py`` cases 3-5), and a
  phase that raises: the lines before it are printed, the exit is
  non-zero;
- one ``init_params_numpy`` tree (tiny, std 0.1) through JAX's rung-1 and
  rung-2 programs and its budget-300 program (Pallas kernels interpreted on
  the CPU) and through the port's at B=4, in f32: tokens and lengths
  IDENTICAL, every budget-300 length at most its stop;
- the phases end to end at the tiny config (their lines and keys),
  ``bench_full_path`` on a tiny engine, a missing card raising, and
  ``metrics.trace`` writing a trace.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu import benchmark as jbm
from manga_ocr_tpu.engine.engine import _cast_quantized as jax_cast_quantized
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models.config import MangaOCRConfig, with_serving_kernels
from manga_ocr_tpu.models.quantize import quantize_encoder as jax_quantize_encoder
from manga_ocr_tpu.utils import metrics as jmetrics
from manga_ocr_tpu_torch import benchmark as bm
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.models import checkpoint as tckpt
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.utils import metrics as tmetrics
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


def _tiny(positions=32):
    """The tiny config with a vocabulary kernel F takes (a multiple of 512)
    and ``positions`` decoder positions (budget 300 needs 300)."""
    cfg = MangaOCRConfig.tiny(vocab_size=512)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, max_position_embeddings=positions))


# -- the FLOP accounting ----------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 32, 300])
@pytest.mark.parametrize("which", ["base", "serving", "tiny"])
def test_flop_functions_equal_jax(which, steps):
    cfg = {"base": MangaOCRConfig.base(), "serving": MangaOCRConfig.serving(),
           "tiny": MangaOCRConfig.tiny()}[which]
    tcfg = port_config(cfg)
    assert tmetrics.encoder_flops_per_crop(tcfg.encoder) == \
        jmetrics.encoder_flops_per_crop(cfg.encoder)
    assert tmetrics.decode_flops_per_crop(tcfg.decoder, steps, tcfg.encoder.seq_len) == \
        jmetrics.decode_flops_per_crop(cfg.decoder, steps, cfg.encoder.seq_len)
    got = tmetrics.model_flops_per_crop(tcfg, steps)
    assert got == jmetrics.model_flops_per_crop(cfg, steps) and got > 0
    rate = 1234.5
    assert tmetrics.mfu(rate, got) == jmetrics.mfu(rate, got, 989e12)


def test_mfu_is_rate_times_flops_over_the_h100_peak():
    assert (tmetrics.H100_PEAK_BF16, tmetrics.H100_PEAK_INT8) == (989e12, 1979e12)
    flops = tmetrics.model_flops_per_crop(port_config(MangaOCRConfig.serving()), 32)
    assert tmetrics.mfu(5000.0, flops) == 5000.0 * flops / 989e12
    assert tmetrics.mfu(5000.0, flops, tmetrics.H100_PEAK_INT8) == 5000.0 * flops / 1979e12
    assert tmetrics.mfu(5000.0, flops, 0.0) == 0.0
    assert not hasattr(tmetrics, "V5E_PEAK_BF16")


# -- the bench's constants and lines --------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [1, 256, 384])
def test_committed_lengths_equal_jax(n, seed):
    got = bm.committed_lengths(n, seed)
    want = jbm.committed_lengths(n, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_constants_are_jax_s():
    for name in ("MAX_NEW_TOKENS", "BATCH_SIZES", "LOGNORMAL_MU", "LOGNORMAL_SIGMA",
                 "LENGTH_CLIP", "TRAINED_CKPT_ENV", "DEFAULT_BUDGET_S"):
        assert getattr(bm, name) == getattr(jbm, name), name
    for gone in ("NORTH_STAR", "H2D_FLOOR_MS", "_spawn", "_stream_child", "_cached_host_tree"):
        assert not hasattr(bm, gone), gone


def test_scored_line_keys_equal_jax_but_vs_baseline():
    got = bm._scored(4100.0, "serving B=256")
    want = jbm._scored(4100.0, "serving B=256")
    assert set(got) == set(want) - {"vs_baseline"}
    assert got["model_gflops_per_crop"] == want["model_gflops_per_crop"]
    flops = want["model_gflops_per_crop"] * 1e9
    assert got["mfu_vs_bf16_peak"] == pytest.approx(4100.0 * flops / 989e12, rel=1e-3)
    assert got["mfu_vs_int8_peak"] == pytest.approx(4100.0 * flops / 1979e12, rel=1e-3)
    assert {k: got[k] for k in ("metric", "value", "unit", "config", "headline_kind")} == \
        {k: want[k] for k in ("metric", "value", "unit", "config", "headline_kind")}
    assert bm._scored(1.0, "x", {"extra": 2})["extra"] == 2
    fail = bm._fail_line()
    assert set(fail) == set(jbm._fail_line()) - {"vs_baseline"} and fail["value"] == 0.0


# -- main, with the phases replaced ---------------------------------------------


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.fixture
def no_weights(monkeypatch):
    """``main`` without the full-size host weights."""
    monkeypatch.setattr(bm, "_base_params_host", lambda cfg=None: {"stand-in": True})


def test_main_merges_phases_and_prints_final_line(monkeypatch, capsys, no_weights):
    calls = []

    def model_only(params, device, deadline, emit):
        calls.append(("A", params, device.type))
        emit({"metric": "m", "value": 100.0, "unit": "c/s", "config": "fast"})
        emit({"metric": "m", "value": 200.0, "unit": "c/s", "config": "serving"})

    def full_path(params, device, emit):
        calls.append(("B", params, device.type))
        emit({"full_path_crops_per_s": 50.0, "stage_summary": {"h2d": {"mean_ms": 1.5}}})

    def budget300(params, device, emit):
        calls.append(("C", params, device.type))
        emit({"crops_per_s_budget300_realistic": 75.0, "budget300_mean_emitted_len": 14.1,
              "budget300_batch": 256})

    monkeypatch.setattr(bm, "run_model_only", model_only)
    monkeypatch.setattr(bm, "run_full_path", full_path)
    monkeypatch.setattr(bm, "run_budget300", budget300)
    monkeypatch.setenv("BENCH_BUDGET_S", "120")
    # phase D must not fire here even where a trained checkpoint exists
    monkeypatch.setenv(bm.TRAINED_CKPT_ENV, "/nonexistent/trained_ckpt")
    bm.main(device="cpu")
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) >= 2  # progressive lines plus the final merge
    first, final = lines[0], lines[-1]
    assert first["value"] == 100.0  # the early line was already out
    assert final["value"] == 200.0
    assert final["config"] == "serving"
    assert final["full_path_crops_per_s"] == 50.0
    assert final["full_path_stage_ms"] == {"h2d": 1.5}
    assert final["crops_per_s_budget300_realistic"] == 75.0
    assert "bench_wall_s" in final
    for line in lines:  # every line carries a score
        assert "value" in line
    stand_in = {"stand-in": True}
    assert calls == [("A", stand_in, "cpu"), ("B", stand_in, "cpu"), ("C", stand_in, "cpu")]


def test_main_runs_phase_d_when_trained_ckpt_exists(monkeypatch, capsys, tmp_path, no_weights):
    payloads = {
        "A": {"metric": "m", "value": 10.0, "unit": "c/s", "config": "fast"},
        "B": {"full_path_crops_per_s": 5.0},
        "C": {"crops_per_s_budget300_realistic": 7.5},
        "D": {"trained_eos_crops_per_s": 9.0, "trained_fixed32_crops_per_s": 11.0},
    }
    seen = {}
    monkeypatch.setattr(bm, "run_model_only",
                        lambda params, device, deadline, emit: emit(payloads["A"]))
    monkeypatch.setattr(bm, "run_full_path", lambda params, device, emit: emit(payloads["B"]))
    monkeypatch.setattr(bm, "run_budget300", lambda params, device, emit: emit(payloads["C"]))

    def trained_eos(path, device, emit):
        seen["path"] = path
        emit(payloads["D"])

    monkeypatch.setattr(bm, "run_trained_eos", trained_eos)
    monkeypatch.setenv("BENCH_BUDGET_S", "120")
    monkeypatch.setenv(bm.TRAINED_CKPT_ENV, str(tmp_path))
    bm.main(device="cpu")
    final = _json_lines(capsys.readouterr().out)[-1]
    assert final["value"] == 10.0
    assert final["trained_eos_crops_per_s"] == 9.0
    assert final["trained_fixed32_crops_per_s"] == 11.0
    assert seen["path"] == str(tmp_path)


def test_main_emits_failure_line_when_nothing_measured(monkeypatch, capsys, no_weights):
    monkeypatch.setattr(bm, "run_model_only", lambda params, device, deadline, emit: None)
    monkeypatch.setattr(bm, "run_full_path", lambda params, device, emit: None)
    monkeypatch.setattr(bm, "run_budget300", lambda params, device, emit: None)
    monkeypatch.setenv("BENCH_BUDGET_S", "30")
    monkeypatch.setenv(bm.TRAINED_CKPT_ENV, "/nonexistent/trained_ckpt")
    bm.main(device="cpu")
    final = _json_lines(capsys.readouterr().out)[-1]
    assert final["value"] == 0.0 and "error" in final
    assert final["metric"] == "bubble_crop_ocr_decodes_per_sec_per_chip"
    assert final["full_path_crops_per_s"] == 0.0


def test_a_phase_that_raises_ends_the_run_non_zero_after_the_lines_before_it():
    script = textwrap.dedent(
        """
        import manga_ocr_tpu_torch.benchmark as bm
        bm._base_params_host = lambda cfg=None: None
        def model_only(params, device, deadline, emit):
            emit({"metric": "m", "value": 10.0, "unit": "c/s", "config": "fast"})
        def full_path(params, device, emit):
            raise RuntimeError("phase B failed")
        def budget300(params, device, emit):
            print("BUDGET300 RAN", flush=True)
        bm.run_model_only, bm.run_full_path, bm.run_budget300 = model_only, full_path, budget300
        bm.main(device="cpu")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO, BENCH_BUDGET_S="60",
               **{bm.TRAINED_CKPT_ENV: "/nonexistent/trained_ckpt"})
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.returncode != 0
    assert "RuntimeError: phase B failed" in out.stderr and "Traceback" in out.stderr
    lines = out.stdout.splitlines()
    assert lines and all(json.loads(line)["value"] == 10.0 for line in lines)
    assert "BUDGET300 RAN" not in out.stdout


def test_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bm.main(), lambda: bm.run_model_only(),
                 lambda: bm.run_full_path(), lambda: bm.run_budget300(),
                 lambda: bm.bench_batch(None, None, 4)):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            call()


# -- the programs against JAX's ---------------------------------------------------


@pytest.fixture(scope="module")
def programs():
    """One std-0.1 tiny tree in the serving form (f32) in both packages, the
    pixels, and JAX's rung-1, rung-2 and budget-300 results at B=4."""
    cfg = _tiny(positions=304)
    np_params = init_params_numpy(cfg, 0, std=0.1)
    serving = with_serving_kernels(cfg, quantized=True)
    fast = dataclasses.replace(serving, decoder=dataclasses.replace(
        serving.decoder, step_kernel="xla", head_phased=False))
    f32 = jax.tree.map(jnp.asarray, np_params)
    jp = jmdl.cast_params(f32, jnp.float32)
    jp["encoder"] = jax_cast_quantized(
        jax_quantize_encoder(f32["encoder"], quantize_attn_proj=True), jnp.float32)
    px = np.random.default_rng(5).normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    stops = jbm.committed_lengths(BATCH)

    @jax.jit
    def budget300(p, x):
        enc = jmdl.encode(p, x, serving)
        return jmdl.greedy_decode(p, enc, serving, max_length=300,
                                  stop_lengths=jnp.asarray(stops))

    want = {
        "rung1": jmdl.make_jitted_ocr(fast, max_length=32, chunk_size=32)(jp, jnp.asarray(px)),
        "rung2": jmdl.make_jitted_ocr(serving, max_length=32, chunk_size=32)(jp,
                                                                             jnp.asarray(px)),
        "budget300": budget300(jp, jnp.asarray(px)),
    }
    want = {k: (np.asarray(v.tokens), np.asarray(v.lengths)) for k, v in want.items()}
    sp = bm._serving_params(np_params, "cpu", dtype=torch.float32)
    return port_config(cfg), sp, torch.from_numpy(px), stops, want


@pytest.mark.parametrize("which", ["rung1", "rung2", "budget300"])
def test_programs_return_jax_s_tokens_and_lengths(programs, which):
    tcfg, sp, px, stops, want = programs
    fast, serving = bm.rung_configs(tcfg)
    fn = {"rung1": bm.ocr_fn(fast), "rung2": bm.ocr_fn(serving),
          "budget300": bm.ocr_fn(serving, max_length=300, chunk_size=8,
                                 stop_lengths=torch.as_tensor(bm.committed_lengths(BATCH)))}[which]
    got = fn(sp, px)
    tokens, lengths = got.tokens.numpy(), got.lengths.numpy()
    np.testing.assert_array_equal(tokens, want[which][0])
    np.testing.assert_array_equal(lengths, want[which][1])
    assert len({tuple(r) for r in tokens}) > 1  # rows differ: the input matters
    if which == "budget300":
        assert tokens.shape == (BATCH, 300) and np.all(lengths <= stops)
    else:
        assert tokens.shape == (BATCH, 32)


def test_rung_configs_are_the_serving_config_and_its_step_decode():
    fast, serving = bm.rung_configs()
    assert serving == port_config(MangaOCRConfig.serving())
    assert (fast.decoder.step_kernel, fast.decoder.head_phased, fast.decoder.head_kernel,
            fast.decoder.step_mlp_kernel) == ("xla", False, "fused", "fused")
    assert dataclasses.replace(fast.decoder, step_kernel="fused_loop", head_phased=True,
                               head_kernel="xla", step_mlp_kernel="xla") == serving.decoder
    assert fast.encoder == serving.encoder


# -- the phases end to end at the tiny config -----------------------------------


def test_run_model_only_emits_improving_scored_lines():
    cfg = _tiny()
    lines = []
    bm.run_model_only(init_params_numpy(cfg, 0, std=0.1), cfg, batch_sizes=(4, 8), iters=1,
                      device="cpu", emit=lines.append)
    assert lines and all(a["value"] < b["value"] for a, b in zip(lines, lines[1:]))
    _, serving = bm.rung_configs(port_config(cfg))
    flops = tmetrics.model_flops_per_crop(serving, bm.MAX_NEW_TOKENS)
    for line in lines:
        assert line["value"] > 0 and line["headline_kind"] == "model_only"
        assert line["config"].startswith(("fused-enc+xla-decode B=", "serving(mega-kernel) B="))
        assert line["model_gflops_per_crop"] == round(flops / 1e9, 2)


def test_run_model_only_skips_past_its_deadline():
    cfg = _tiny()
    lines = []
    bm.run_model_only(init_params_numpy(cfg, 0, std=0.1), cfg, batch_sizes=(4, 8), iters=1,
                      device="cpu", deadline=0.0, emit=lines.append)
    assert [line["config"] for line in lines] == ["fused-enc+xla-decode B=4"]


def test_run_budget300_emits_its_keys():
    cfg = _tiny(positions=304)
    lines = []
    bm.run_budget300(init_params_numpy(cfg, 0, std=0.1), cfg, batch=BATCH, iters=1,
                     device="cpu", emit=lines.append)
    (line,) = lines
    assert set(line) == {"crops_per_s_budget300_realistic", "budget300_mean_emitted_len",
                         "budget300_batch"}
    assert line["crops_per_s_budget300_realistic"] > 0 and line["budget300_batch"] == BATCH
    # random weights rarely emit EOS: rows run to their stops
    assert 0 < line["budget300_mean_emitted_len"] <= round(bm.committed_lengths(BATCH).mean(), 1)


def test_run_full_path_emits_its_keys():
    cfg = _tiny()
    lines = []
    bm.run_full_path(init_params_numpy(cfg, 0, std=0.1), cfg, batch=8, iters=2, device="cpu",
                     emit=lines.append)
    (line,) = lines
    assert set(line) == {"full_path_crops_per_s", "full_path_h2d_ms", "full_path_attempts",
                         "stage_summary"}
    assert line["full_path_crops_per_s"] > 0 and line["full_path_attempts"] == 1


def test_bench_full_path_streams_ocr_page_s_texts(monkeypatch):
    cfg = port_config(_tiny())
    engine = TorchMangaOcrEngine(params_from_jax(init_params_numpy(cfg, 0, std=0.1), "cpu"), cfg,
                                 CharTokenizer.synthetic(), max_length=12, dtype=torch.float32,
                                 device="cpu", aot=True)
    streamed, pages_seen = [], []
    ocr_pages = engine.ocr_pages

    def spy(pages, *args, **kw):
        pages_seen.extend(pages)
        out = ocr_pages(pages, *args, **kw)
        streamed.extend(out)
        return out

    monkeypatch.setattr(engine, "ocr_pages", spy)
    rate, stages = bm.bench_full_path(engine, 8, iters=2)
    assert rate > 0
    assert {"host_prep", "h2d", "dispatch", "readback", "detok", "ocr_page"} <= set(stages)
    assert all(stages[k]["count"] > 0 for k in stages)
    # the warm stream (the first three of the two pages), then three rounds
    assert len(streamed) == 2 + 3 * 2 and all(len(t) == 8 for t in streamed)
    want = engine.ocr_page(pages_seen[0])
    assert all(p is pages_seen[0] for p in pages_seen)
    assert all(t == want for t in streamed)
    assert len(set(want)) > 1


def test_run_trained_eos_reads_a_checkpoint(tmp_path):
    cfg = port_config(_tiny(positions=304))
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, params_from_jax(init_params_numpy(cfg, 0, std=0.1), "cpu"), cfg)
    lines = []
    bm.run_trained_eos(path, batch=BATCH, n_heldout=2, iters=1, passes=1, device="cpu",
                       emit=lines.append)
    (line,) = lines
    assert set(line) == {"trained_eos_crops_per_s", "trained_eos_mean_len",
                         "trained_eos_median_len", "trained_fixed32_crops_per_s",
                         "trained_eos_batch", "trained_ckpt"}
    assert line["trained_eos_crops_per_s"] > 0 and line["trained_fixed32_crops_per_s"] > 0
    assert line["trained_ckpt"] == path and line["trained_eos_batch"] == BATCH


def test_trace_writes_a_chrome_trace(tmp_path):
    with tmetrics.trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(tmp_path / name) as f:
        assert json.load(f)["traceEvents"]
