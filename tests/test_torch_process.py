"""The port's ``process`` command (``manga_ocr_tpu_torch/cli.py``) against the
JAX package's on the same pages and weights: ``tcli.main(["--device", "cpu",
...])`` and ``jcli.main(...)`` on a tiny HF checkpoint directory in f32, each
on its own copy of the page folder (``batch_save`` writes beside the pages).
Each run must exit as JAX's, print JAX's stderr lines, write the same
normalised ``project.json`` and the same typeset pixels.  Normalised fields:
the page folder's path (in ``project_dir``, the ``typeset_data`` keys and each
history entry's ``image_path``), each history entry's ``timestamp`` and the
project's ``saved_at``.  Cases: the whole page as one region, ``--detect-mode
text`` on a page of glyph columns, ``--detector`` on a full-width
``DetectorConfig()`` ``.npz`` of the port's seed-0 init with and without
``--no-split-bubbles``, ``--enhanced`` (no ``tesseract`` here: the same-model
second pass), ``--translate --provider openrouter`` against one loopback stub
that both runs share (its replies a function of each request's own prompt),
and the three ``--text-proposer craft`` messages; and the port's own run
under ``--mesh-data 2`` against its single-device run."""

import dataclasses
import glob
import http.server
import json
import os
import shutil
import threading

import numpy as np
import pytest
from PIL import Image

from manga_ocr_tpu import cli as jcli
from manga_ocr_tpu_torch import cli as tcli
from manga_ocr_tpu_torch.core.project import load_project
from manga_ocr_tpu_torch.detect import synthetic
from manga_ocr_tpu_torch.models import convert as tconv
from manga_ocr_tpu_torch.models import detector as tseg
from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models.params import init_params
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.train import render_text_crop
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    cfg = dataclasses.replace(MangaOCRConfig.tiny(), max_length=12)
    path = str(tmp_path_factory.mktemp("hf_tiny"))
    tconv.save_hf_checkpoint(path, init_params(cfg, 0, "cpu", std=0.1), cfg,
                             tokenizer=CharTokenizer.synthetic())
    return path


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Page folders: two drawn bubble pages; one wide page of four drawn
    ones side by side (the full-width U-Net's runs: its seed-0 mask covers
    the page, one region wider than ``split_extended_bubbles``' 2.5
    aspect); one page of glyph columns."""
    root = tmp_path_factory.mktemp("page_folders")
    rng = np.random.default_rng(0)
    (root / "bubbles").mkdir()
    for i in range(2):
        page, _, _ = synthetic.draw_page(rng, 160, 120)
        Image.fromarray(page[..., ::-1]).save(root / "bubbles" / f"p{i}.png")
    (root / "wide").mkdir()
    page = np.concatenate([synthetic.draw_page(rng, 160, 120)[0] for _ in range(4)], axis=1)
    Image.fromarray(page[..., ::-1]).save(root / "wide" / "w0.png")
    chars = [t for t in CharTokenizer.synthetic().id_to_token[4:] if len(t) == 1]
    page = np.full((220, 260, 3), 255, np.uint8)
    for col in range(3):
        text = "".join(rng.choice(chars, size=5))
        page[30 + 20 * col:160 + 20 * col, 30 + 80 * col:62 + 80 * col] = render_text_crop(
            text, rng, 64, hw=(130, 32))
    (root / "glyphs").mkdir()
    Image.fromarray(page[..., ::-1]).save(root / "glyphs" / "g0.png")
    return root


@pytest.fixture(scope="module")
def det_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("det") / "unet.npz")
    tseg.save_params(tseg.init_params(tseg.DetectorConfig(), 0, "cpu"), path)
    return path


def stub_reply(prompt: str) -> str:
    """The stub translator's reply: a function of the prompt's own text."""
    text = next((ln[len("Text: "):] for ln in prompt.splitlines() if ln.startswith("Text: ")),
                None)
    return f"EN<{text}>"


class _Stub(http.server.BaseHTTPRequestHandler):
    bodies = []
    disable_nagle_algorithm = True  # headers and body are two writes

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).bodies.append(body)
        prompt = json.loads(body)["messages"][-1]["content"]
        out = json.dumps({"choices": [{"message": {"content": stub_reply(prompt)}}],
                          "usage": {"prompt_tokens": 3, "completion_tokens": 2}}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def stub():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path_factory):
    # JAX's engine builder turns on its persistent compile cache
    monkeypatch.setenv("MANGA_OCR_TPU_XLA_CACHE", str(tmp_path_factory.getbasetemp() / "xla"))
    monkeypatch.delenv("MANGA_OCR_CHECKPOINT", raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")


def _settings(tmp_path, tree) -> str:
    path = tmp_path / "settings.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _run_both(tmp_path, capsys, hf_dir, template, args):
    """Both packages' ``process`` on fresh copies of ``template``; per package
    its exit code, stderr lines (paths normalised), normalised project and
    typeset pages."""
    out = {}
    for name, main, prefix in (("torch", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        folder = tmp_path / f"{name}_pages"
        shutil.copytree(template, folder)
        out_dir = tmp_path / f"{name}_out"
        _Stub.bodies = []
        rc = main([*prefix, "--checkpoint", hf_dir, "--dtype", "float32", "--max-length", "12",
                   "process", str(folder), "--out", str(out_dir), *args])
        err = capsys.readouterr().err.replace(str(folder), "<pages>").replace(str(out_dir),
                                                                           "<out>")
        res = {"rc": rc, "err": [ln for ln in err.splitlines() if not ln.startswith("WARNING")],
               "requests": sorted(_Stub.bodies)}
        if rc == 0:
            proj = out_dir / "project.json"
            res["loaded"] = load_project(str(proj))
            text = proj.read_text(encoding="utf-8").replace(json.dumps(str(folder))[1:-1],
                                                            "<pages>")
            payload = json.loads(text)
            assert payload.pop("saved_at") > 0
            for entry in payload["history_entries"]:
                assert entry.pop("timestamp") > 0
            res["project"] = payload
            res["typeset"] = {os.path.basename(p): np.asarray(Image.open(p))
                              for p in sorted(glob.glob(str(folder / "*_typeset.png")))}
        out[name] = res
    return out["torch"], out["jax"]


def _same(got, want):
    assert got["rc"] == want["rc"]
    assert got["err"] == want["err"]
    assert got["requests"] == want["requests"]
    if got["rc"] == 0:
        assert got["project"] == want["project"]
        assert list(got["typeset"]) == list(want["typeset"])
        for name, img in got["typeset"].items():
            assert img.shape == want["typeset"][name].shape
            np.testing.assert_array_equal(img, want["typeset"][name])


CASES = {
    "whole_page": ("bubbles", []),
    "text_mode": ("glyphs", ["--detect-mode", "text"]),
    "detector": ("wide", ["--detector", "<npz>"]),
    "detector_no_split": ("wide", ["--detector", "<npz>", "--no-split-bubbles"]),
    "enhanced": ("bubbles", ["--enhanced"]),
    "translate": ("bubbles", ["--translate", "--provider", "openrouter", "--settings", "<stub>"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_process_writes_the_jax_project_and_pages(case, tmp_path, capsys, hf_dir, folders,
                                                  det_npz, stub):
    template, args = CASES[case]
    stub_settings = {"apis": {"openrouter": {"keys": ["stub"]}},
                     "translate": {"openrouter": {"url": stub}}}
    subs = {"<npz>": det_npz, "<stub>": _settings(tmp_path, stub_settings)}
    args = [subs.get(a, a) for a in args]
    got, want = _run_both(tmp_path, capsys, hf_dir, folders / template, args)
    _same(got, want)
    assert got["rc"] == 0
    pages = sorted(os.listdir(folders / template))
    areas = {k: v["areas"] for k, v in got["project"]["typeset_data"].items()}
    assert sorted(areas) == [f"<pages>/{p}" for p in pages] and all(areas.values())
    assert sorted(got["typeset"]) == [p.replace(".png", "_typeset.png") for p in pages]
    assert got["err"][-1] == f"project: <out>/project.json; typeset pages: {len(pages)}"
    assert got["loaded"].history_counter == sum(len(a) for a in areas.values())
    texts = [a["original_text"] for a in sum(areas.values(), [])]
    assert any(texts)
    if case == "text_mode":
        assert len(texts) >= 2
    if case.startswith("detector"):  # one region, halved by the split rule
        assert len(texts) == (1 if case.endswith("no_split") else 2)
    if case == "translate":
        assert len(got["requests"]) == len(texts)
        for area in sum(areas.values(), []):
            assert area["text"] == stub_reply(f"Text: {area['original_text']}")
    else:
        assert got["requests"] == []


CRAFT_CASES = {
    "unconfigured": ({}, "craft", 1,
                     "--text-proposer craft needs tpu.latin_craft_checkpoint in settings"),
    "missing": ({"tpu": {"latin_craft_checkpoint": "<missing>"}}, "craft", 1,
                "--text-proposer craft: tpu.latin_craft_checkpoint is set but the file does "
                "not exist: <missing>"),
    "auto_missing": ({"tpu": {"latin_craft_checkpoint": "<missing>"}}, "auto", 0,
                     "note: tpu.latin_craft_checkpoint not found (<missing>); falling back to "
                     "the morphological text proposer"),
}


@pytest.mark.parametrize("case", list(CRAFT_CASES))
def test_craft_proposer_messages_as_jax(case, tmp_path, capsys, hf_dir, folders):
    tree, proposer, rc, message = CRAFT_CASES[case]
    missing = str(tmp_path / "no_such" / "craft_mlt_25k.pth")
    tree = json.loads(json.dumps(tree).replace("<missing>", missing))
    args = ["--detect-mode", "text", "--text-proposer", proposer,
            "--settings", _settings(tmp_path, tree)]
    got, want = _run_both(tmp_path, capsys, hf_dir, folders / "glyphs", args)
    _same(got, want)
    assert got["rc"] == rc
    assert message.replace("<missing>", missing) in got["err"]


def test_mesh_data_writes_the_single_device_project(tmp_path, capsys, hf_dir, folders,
                                                    det_npz):
    """``--mesh-data 2`` (a 2-way virtual CPU mesh under ``--device cpu``)
    shards the OCR engine's buckets and hands the detector the mesh: the
    same project and typeset pages as one device."""
    runs = []
    for top in ([], ["--mesh-data", "2"]):
        folder = tmp_path / f"pages{len(runs)}"
        shutil.copytree(folders / "bubbles", folder)
        out_dir = tmp_path / f"out{len(runs)}"
        assert tcli.main(["--device", "cpu", *top, "--checkpoint", hf_dir, "--dtype", "float32",
                          "--max-length", "12", "process", str(folder), "--out", str(out_dir),
                          "--detector", det_npz]) == 0
        capsys.readouterr()
        payload = json.loads((out_dir / "project.json").read_text(encoding="utf-8")
                             .replace(json.dumps(str(folder))[1:-1], "<pages>"))
        payload.pop("saved_at")
        for entry in payload["history_entries"]:
            entry.pop("timestamp")
        pages = [np.asarray(Image.open(p)) for p in sorted(glob.glob(str(folder / "*_typeset.png")))]
        runs.append((payload, pages))
    (want, want_pages), (got, got_pages) = runs
    assert got == want and any(a["original_text"] for v in got["typeset_data"].values()
                               for a in v["areas"])
    assert len(got_pages) == len(want_pages) == 2
    for a, b in zip(got_pages, want_pages):
        np.testing.assert_array_equal(a, b)
