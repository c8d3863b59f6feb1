"""The port stands alone: no module of ``manga_ocr_tpu_torch/``, no
``chip_smoke.py`` and no card test imports ``jax`` or anything of the JAX
package (an AST scan, and a subprocess that imports the engine, the server
and ``chip_smoke`` and then reads ``sys.modules``); and the port's own
copies of the shared modules agree with the JAX package's: the config
(fields, defaults, constructors), the tokenizer (encodes and decodes) and
``prep_page_gray`` (byte-identical batches on the fixture crops, for each
orientation, by the native pass and by NumPy)."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from manga_ocr_tpu.models import config as jcfg
from manga_ocr_tpu.models import tokenizer as jtok
from manga_ocr_tpu.parallel import batching as jbatch
from manga_ocr_tpu_torch import native
from manga_ocr_tpu_torch.models import config as tcfg
from manga_ocr_tpu_torch.models import tokenizer as ttok
from manga_ocr_tpu_torch.parallel import batching as tbatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "manga_ocr_tpu")


def _standalone_files():
    files = sorted(glob.glob(os.path.join(REPO, "manga_ocr_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py"),
                    os.path.join(REPO, "tests", "test_torch_cuda.py")]


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _standalone_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_engine_server_and_chip_smoke_import_neither():
    script = textwrap.dedent(
        """
        import sys
        import manga_ocr_tpu_torch.engine, manga_ocr_tpu_torch.serve, chip_smoke
        from manga_ocr_tpu_torch.parallel import batching
        from manga_ocr_tpu_torch.models import decoder, model
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "manga_ocr_tpu"))
        print("LOADED", bad)
        """
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize("name", ["EncoderConfig", "DecoderConfig", "MangaOCRConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, name))}
    assert list(jf) == list(tf)
    for n, f in jf.items():
        assert tf[n].type == f.type, n
        assert tf[n].default == f.default, n


def test_config_constructors_match_jax():
    def same(t, j):
        assert type(t).__module__.startswith("manga_ocr_tpu_torch")
        assert dataclasses.asdict(t) == dataclasses.asdict(j)

    same(tcfg.MangaOCRConfig.base(), jcfg.MangaOCRConfig.base())
    same(tcfg.MangaOCRConfig.tiny(), jcfg.MangaOCRConfig.tiny())
    same(tcfg.MangaOCRConfig.tiny(512), jcfg.MangaOCRConfig.tiny(512))
    for quantized in (True, False):
        same(tcfg.MangaOCRConfig.serving(quantized), jcfg.MangaOCRConfig.serving(quantized))
        same(tcfg.with_serving_kernels(tcfg.MangaOCRConfig.tiny(), quantized),
             jcfg.with_serving_kernels(jcfg.MangaOCRConfig.tiny(), quantized))
    hf = {"encoder": {"image_size": 224, "num_hidden_layers": 12},
          "decoder": {"vocab_size": 6144, "num_hidden_layers": 2, "num_attention_heads": 8,
                      "max_position_embeddings": 300, "eos_token_id": 3},
          "decoder_start_token_id": 2}
    same(tcfg.MangaOCRConfig.from_hf_config(hf), jcfg.MangaOCRConfig.from_hf_config(hf))
    for c in (tcfg.MangaOCRConfig.base(), tcfg.MangaOCRConfig.tiny()):
        j = jcfg.MangaOCRConfig.base() if c.encoder.num_layers == 12 else jcfg.MangaOCRConfig.tiny()
        assert (c.encoder.seq_len, c.encoder.head_dim, c.decoder.head_dim) == (
            j.encoder.seq_len, j.encoder.head_dim, j.decoder.head_dim)


def test_tokenizer_encodes_and_decodes_as_jax():
    extra = "漫画読"
    t, j = ttok.CharTokenizer.synthetic(extra), jtok.CharTokenizer.synthetic(extra)
    assert t.id_to_token == j.id_to_token
    for text in ("こんにちは、世界！", "ＡＢＣ　１２３…", " ｶﾞｷﾞ ﾊﾟ ", "漫画 を 読む", "[SEP]x\ty"):
        assert t.encode(text) == j.encode(text)
        assert t.encode(text, add_special=False) == j.encode(text, add_special=False)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, len(j) + 3, size=(6, 20)).astype(np.int32)
    lengths = rng.integers(1, 21, size=(6,)).astype(np.int32)
    assert t.decode_batch(tokens, lengths) == j.decode_batch(tokens, lengths)
    assert t.decode_batch(tokens) == j.decode_batch(tokens)
    for s in ("ｱｲｳ abc 123", "…・・..", "ﾊﾟﾝ"):
        assert ttok.post_process(s) == jtok.post_process(s)


def _fixture_crops():
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "eval", "*.png")))
    crops = [np.asarray(Image.open(p).convert("RGB"))[..., ::-1].copy() for p in paths]
    # and the shapes the fixtures lack: gray 2D and [h, w, 1], oversized
    rng = np.random.default_rng(1)
    crops += [rng.integers(0, 256, (50, 90), dtype=np.uint8),
              rng.integers(0, 256, (70, 30, 1), dtype=np.uint8),
              rng.integers(0, 256, (1300, 200, 3), dtype=np.uint8)]
    return crops


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("orientation", [0, 1, 2], ids=["auto", "vertical", "horizontal"])
def test_prep_page_gray_byte_identical_to_jax(orientation, path):
    crops = _fixture_crops()
    want = jbatch.prep_page_gray(crops, orientation)
    if path == "native":
        assert native.load() is not None, "the native prep library did not build"
        got = tbatch.prep_page_gray(crops, orientation)
    else:
        got = tbatch._prep_page_gray_numpy(crops, orientation, tbatch.DEFAULT_BUCKETS)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.bucket_hw, g.indices, g.valid) == (w.bucket_hw, w.indices, w.valid)
        assert g.crops.dtype == w.crops.dtype == np.uint8
        np.testing.assert_array_equal(g.crops, w.crops)
        np.testing.assert_array_equal(g.sizes, w.sizes)
    texts = [[f"{b.bucket_hw}:{r}" for r in range(b.valid)] for b in got]
    assert tbatch.scatter_results(got, texts) == jbatch.scatter_results(want, texts)


def test_batch_schedule_and_buckets_match_jax():
    assert tbatch.DEFAULT_BUCKETS == jbatch.DEFAULT_BUCKETS
    assert tbatch.BATCH_SCHEDULE == jbatch.BATCH_SCHEDULE
    for n in (0, 1, 8, 9, 300, 600, 1500):
        assert tbatch.pad_batch_size(n) == jbatch.pad_batch_size(n)
