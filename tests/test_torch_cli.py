"""The port's command line (``manga_ocr_tpu_torch/cli.py``), and ``serve``
and ``eval`` on an HF checkpoint directory, against the JAX package's: ``ocr``
prints JAX ``cli.main``'s lines for the same arguments (a tiny HF directory,
weights std 0.1, the int8 serving engine in f32), a missing image exits 1,
the unported option ``--no-aot`` exits 2, ``bench`` reaches
``benchmark.main`` with ``--device`` (and raises without CUDA under
``--device cuda``), ``--wire packed`` and ``--no-coalesce`` reach the
engine and print the gray wire's lines (``--wire packed --mesh-data 2``
fails with JAX's message), ``--mesh-data 2`` under ``--device
cpu`` prints the lines of one device (a 2-way virtual CPU mesh, also in
``serve``'s engine), ``--device cuda`` raises without CUDA, ``eval.main``
prints JAX's report for the directory, and ``serve.build_engine
--checkpoint`` serves the checkpoint's weights."""

import dataclasses
import glob
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from manga_ocr_tpu import cli as jcli
from manga_ocr_tpu import eval as jeval
from manga_ocr_tpu_torch import cli as tcli
from manga_ocr_tpu_torch import eval as teval
from manga_ocr_tpu_torch import serve as srv
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.models import convert as tconv
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
PATHS = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))[:6]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    cfg = dataclasses.replace(MangaOCRConfig.tiny(), max_length=12)
    path = str(tmp_path_factory.mktemp("hf_tiny"))
    tconv.save_hf_checkpoint(path, init_params(cfg, 0, "cpu", std=0.1), cfg,
                             tokenizer=CharTokenizer.synthetic())
    return path


@pytest.fixture(autouse=True)
def _xla_cache(monkeypatch, tmp_path_factory):
    # JAX's engine builder turns on its persistent compile cache
    monkeypatch.setenv("MANGA_OCR_TPU_XLA_CACHE", str(tmp_path_factory.getbasetemp() / "xla"))
    monkeypatch.delenv("MANGA_OCR_CHECKPOINT", raising=False)


def test_ocr_prints_the_jax_lines(hf_dir, capsys):
    args = ["--checkpoint", hf_dir, "--dtype", "float32", "--max-length", "12", "ocr", *PATHS]
    assert tcli.main(["--device", "cpu", *args]) == 0
    got = capsys.readouterr()
    assert jcli.main(args) == 0
    want = capsys.readouterr()
    assert got.out == want.out
    lines = got.out.splitlines()
    assert [ln.split("\t")[0] for ln in lines] == PATHS
    assert len({ln.split("\t")[1] for ln in lines}) > 1
    assert f"# {len(PATHS)} crops in " in got.err


def test_ocr_missing_image_exits_1(hf_dir, tmp_path, capsys):
    rc = tcli.main(["--checkpoint", hf_dir, "--device", "cpu", "ocr", PATHS[0],
                    str(tmp_path / "nope.png")])
    assert rc == 1
    assert "cannot read" in capsys.readouterr().err


@pytest.mark.parametrize(
    "argv", [["--no-aot", "ocr", "x.png"], []],
    ids=["no_aot", "no_command"],
)
def test_unported_options_and_subcommands_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 2
    assert "usage:" in capsys.readouterr().err


@pytest.mark.parametrize("argv, device", [(["bench"], "cuda"),
                                          (["--device", "cpu", "bench"], "cpu"),
                                          (["--device", "cuda:0", "bench"], "cuda:0")],
                         ids=["default", "cpu", "cuda0"])
def test_bench_reaches_benchmark_main_with_the_device(argv, device, monkeypatch):
    from manga_ocr_tpu_torch import benchmark

    calls = []
    monkeypatch.setattr(benchmark, "main", lambda **kw: calls.append(kw))
    assert tcli.main(argv) == 0
    assert calls == [{"device": device}]


def test_bench_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tcli.main(["--device", "cuda", "bench"])


@pytest.mark.parametrize(
    "flags, kw", [(["--wire", "packed"], {"_wire": "packed", "_coalesce": True}),
                  (["--no-coalesce"], {"_wire": "gray", "_coalesce": False})],
    ids=["wire", "no_coalesce"],
)
def test_wire_options_reach_the_engine_and_print_the_gray_lines(hf_dir, flags, kw, capsys):
    args = ["--checkpoint", hf_dir, "--device", "cpu", "--dtype", "float32", "--max-length",
            "12"]
    engine = srv.build_engine(srv.parser().parse_args([*args, *flags]))
    assert {k: getattr(engine, k) for k in kw} == kw
    assert tcli.main([*args, "ocr", *PATHS]) == 0
    want = capsys.readouterr().out
    assert tcli.main([*args, *flags, "ocr", *PATHS]) == 0
    assert capsys.readouterr().out == want


def test_packed_wire_on_a_mesh_fails_with_the_jax_message(hf_dir):
    args = ["--checkpoint", hf_dir, "--dtype", "float32", "--wire", "packed", "--mesh-data", "2"]
    with pytest.raises(ValueError) as got:
        tcli.main(["--device", "cpu", *args, "ocr", PATHS[0]])
    with pytest.raises(ValueError) as want:
        jcli.main([*args, "ocr", PATHS[0]])
    assert str(got.value) == str(want.value)
    assert "wire='packed' is single-device only" in str(got.value)


def test_mesh_data_ocr_prints_the_lines_of_one_device(hf_dir, capsys):
    args = ["--checkpoint", hf_dir, "--device", "cpu", "--dtype", "float32", "--max-length",
            "12"]
    assert tcli.main([*args, "ocr", PATHS[0]]) == 0
    want = capsys.readouterr().out
    assert tcli.main([*args, "--mesh-data", "2", "ocr", PATHS[0]]) == 0
    assert capsys.readouterr().out == want


def test_serve_build_engine_takes_the_mesh(hf_dir):
    args = srv.parser().parse_args(["--checkpoint", hf_dir, "--device", "cpu", "--dtype",
                                    "float32", "--max-length", "12", "--mesh-data", "2"])
    engine = srv.build_engine(args)
    assert engine.mesh.shape == {"data": 2, "model": 1}
    assert engine.device == torch.device("cpu") and len(engine._replicas) == 2
    if not torch.cuda.is_available():  # no card: a CUDA mesh has no device to take
        with pytest.raises(ValueError, match="needs 2 devices but only 0"):
            tcli._mesh(srv.parser().parse_args(["--mesh-data", "2"]))


def test_cuda_device_raises_without_cuda(hf_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--checkpoint", hf_dir, "ocr", PATHS[0]])


def test_eval_on_hf_dir_prints_the_jax_report(hf_dir, capsys):
    args = [FIXTURES, "--checkpoint", hf_dir, "--max-length", "12", "--dtype", "float32",
            "--serving-kernels", "off"]
    assert teval.main([*args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jeval.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert (got["n"], got["n_scored"]) == (20, 22)


def test_serve_build_engine_serves_the_checkpoint(hf_dir):
    args = srv.parser().parse_args(["--checkpoint", hf_dir, "--device", "cpu",
                                    "--dtype", "float32", "--max-length", "12", "--seed", "7"])
    engine = srv.build_engine(args)
    params, cfg = tconv.load_hf_checkpoint(hf_dir)
    assert engine.cfg.decoder.vocab_size == cfg.decoder.vocab_size == 100
    assert torch.equal(engine.params["decoder"]["tok_embed"].float(),
                       params["decoder"]["tok_embed"])
    direct = TorchMangaOcrEngine(params, cfg, CharTokenizer.synthetic(), max_length=12,
                                 dtype=torch.float32, device="cpu")
    from PIL import Image

    crops = [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in PATHS]
    want = direct.ocr_page(crops)
    assert engine.ocr_page(crops) == want
    httpd = srv.serve(engine, port=0)
    try:
        with open(PATHS[0], "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/ocr", data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["text"] == want[0]
    finally:
        httpd.shutdown()
        httpd.service.close()


def test_serve_without_checkpoint_takes_the_seed(monkeypatch):
    monkeypatch.setattr(MangaOCRConfig, "base", staticmethod(MangaOCRConfig.tiny))
    args = srv.parser().parse_args(["--device", "cpu", "--dtype", "float32", "--seed", "3"])
    engine = srv.build_engine(args)
    want = init_params(MangaOCRConfig.tiny(), 3, "cpu")
    assert torch.equal(engine.params["decoder"]["tok_embed"], want["decoder"]["tok_embed"])
