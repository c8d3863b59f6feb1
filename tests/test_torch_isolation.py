"""The port stands alone: no module of ``manga_ocr_tpu_torch/``, no
``scripts/torch_*.py``, no ``chip_smoke.py`` and no card test imports ``jax``, ``optax`` or anything of
the JAX package (an AST scan, and a subprocess that imports the engine, the
server, the command line with its ``process`` modules, ``MangaOcr``, the HF
converter, the trainer and ``chip_smoke`` and then reads ``sys.modules``); and the port's own
copies of the shared modules agree with the JAX package's: the config
(fields, defaults, constructors), the tokenizer (encodes and decodes) and
``prep_page_gray`` (byte-identical batches on the fixture crops, for each
orientation, by the native pass and by NumPy) and ``core/files.py``
(decoded fixture images, natural sort, folder listing) and the trainer's
synthetic glyphs and crops (``pattern_glyph``, ``render_text_crop``); and
the detection's copies: ``core/geometry.py``, ``mask_to_polygons`` in each
tier (cv2, the native tracer, NumPy), ``fill_polygon`` (cv2, NumPy),
``dilate`` (cv2, native, NumPy), the adaptive threshold, the classical
bubble finder, ``detect/postprocess.py``, ``detect/craft_boxes.py`` and
``TypesetArea``'s payloads; and the detector and recognizer families'
copies: ``models/onnx_lite.py`` (the bytes it writes and what it reads),
YOLO's host decode (``_grid_anchors``, ``_nms``, ``postprocess``,
``combined_bubble_mask``) and the CRNN's ``ctc_greedy``; and the erase ->
compose -> save stage's copies, ``models/convert_lama.py``,
``typeset/render.py``, ``core/project.py``, ``runtime/export.py`` and
``typeset/cleanup.py``'s erasing functions, held to JAX's code statement for
statement (docstrings aside, the package's name mapped; ``erase_area``'s one
deliberate difference, its logged fall-through, named); and the application
layers' copies under the ``process`` command, ``core/settings.py``,
``utils/http.py``, ``utils/rate_limit.py``, ``translate/``,
``engine/ai_ocr.py`` and ``core/review.py``, held the same way, with
``engine/registry.py`` held to JAX's code but for its named differences
(``_latin_preprocess``, the Latin factory, the ``device`` parameter); and
data-parallel serving's copies: ``pad_batch_to_multiple`` (statement for
statement and on the same arrays) and ``make_global_mesh``'s per-process
block check (the same rows or the same error on the same fake devices); and
the packed wire's copies: ``CAP_QUANTA``, ``PackedBatch``'s fields and
``prep_page_packed`` (statement for statement), and the packed entry of
``native/prep.cpp`` (its code, comments aside)."""

import ast
import dataclasses
import glob
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from manga_ocr_tpu import train as jtrain
from manga_ocr_tpu.core import files as jfiles
from manga_ocr_tpu.models import config as jcfg
from manga_ocr_tpu.models import tokenizer as jtok
from manga_ocr_tpu.parallel import batching as jbatch
from manga_ocr_tpu_torch import native
from manga_ocr_tpu_torch import train as ttrain
from manga_ocr_tpu_torch.core import files as tfiles
from manga_ocr_tpu_torch.models import config as tcfg
from manga_ocr_tpu_torch.models import tokenizer as ttok
from manga_ocr_tpu_torch.parallel import batching as tbatch
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "manga_ocr_tpu", "optax")


def _standalone_files():
    files = sorted(glob.glob(os.path.join(REPO, "manga_ocr_tpu_torch", "**", "*.py"),
                             recursive=True))
    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))
    return files + scripts + [os.path.join(REPO, "chip_smoke.py"),
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
        import manga_ocr_tpu_torch.eval, manga_ocr_tpu_torch.models.checkpoint
        import manga_ocr_tpu_torch.compat, manga_ocr_tpu_torch.cli
        import manga_ocr_tpu_torch.models.convert, manga_ocr_tpu_torch.models.safetensors_io
        import manga_ocr_tpu_torch.train, manga_ocr_tpu_torch.benchmark
        from manga_ocr_tpu_torch.core import files
        from manga_ocr_tpu_torch.ops import image, preprocess
        from manga_ocr_tpu_torch.parallel import batching, mesh, multihost
        from manga_ocr_tpu_torch.models import decoder, model
        from manga_ocr_tpu_torch.models import detector
        from manga_ocr_tpu_torch.detect import (contours, craft_boxes, detector, postprocess,
                                                synthetic, text_detect)
        from manga_ocr_tpu_torch.runtime import pipeline
        from manga_ocr_tpu_torch.typeset import area, cleanup
        from manga_ocr_tpu_torch.core import geometry
        from manga_ocr_tpu_torch.models import (convert_latin, convert_onnx, convert_yolo, craft,
                                                crnn, onnx_lite, yolo_seg)
        from manga_ocr_tpu_torch.engine import latin
        from manga_ocr_tpu_torch.models import convert_lama, inpaint
        from manga_ocr_tpu_torch.typeset import render
        from manga_ocr_tpu_torch.core import project
        from manga_ocr_tpu_torch.runtime import export
        from manga_ocr_tpu_torch.core import review, settings
        from manga_ocr_tpu_torch.engine import ai_ocr, registry
        from manga_ocr_tpu_torch.translate import prompts, providers, service, styles
        from manga_ocr_tpu_torch.utils import http, rate_limit
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "manga_ocr_tpu", "optax"))
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


def test_safe_open_image_decodes_as_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "eval", "*.png")))
    assert len(paths) == 20
    for p in paths:
        got, want = tfiles.safe_open_image(p), jfiles.safe_open_image(p)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    missing = os.path.join(REPO, "tests", "fixtures", "no_such_image.png")
    assert tfiles.safe_open_image(missing) is None and jfiles.safe_open_image(missing) is None


def test_natural_sort_and_list_images_as_jax(tmp_path):
    names = ["page10.png", "page2.PNG", "Page1.jpg", "notes.txt", "a.webp", "scan.tiff",
             "x.pdf", "page2b.png", "10.bmp", "9.gif"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert sorted(names, key=tfiles.natural_sort_key) == sorted(names, key=jfiles.natural_sort_key)
    assert tfiles.list_images(str(tmp_path)) == jfiles.list_images(str(tmp_path))
    assert tfiles.list_images(str(tmp_path / "missing")) == []
    assert tfiles.IMAGE_EXTENSIONS == jfiles.IMAGE_EXTENSIONS
    key = tfiles.pdf_page_key("a/b.pdf", 3)
    assert key == jfiles.pdf_page_key("a/b.pdf", 3)
    assert tfiles.parse_pdf_page_key(key) == jfiles.parse_pdf_page_key(key) == ("a/b.pdf", 3)


@pytest.mark.parametrize("size", [4, 5, 12, 16])
def test_pattern_glyphs_as_jax(size):
    chars = "あいう漫画読ABCz0" + "".join(chr(c) for c in range(0x4E00, 0x4E40))
    for ch in chars:
        got, want = ttrain.pattern_glyph(ch, size), jtrain.pattern_glyph(ch, size)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [None, (58, 40), (30, 90), (224, 224)], ids=str)
def test_render_text_crop_as_jax(hw):
    for seed, text in enumerate(["あ", "いうえお", "漫画を読む" * 4, ""]):
        got = ttrain.render_text_crop(text, np.random.default_rng(seed), 64, hw=hw)
        want = jtrain.render_text_crop(text, np.random.default_rng(seed), 64, hw=hw)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -- the detection's copies -------------------------------------------------------

from manga_ocr_tpu import native as jnative  # noqa: E402
from manga_ocr_tpu.core import geometry as jgeo  # noqa: E402
from manga_ocr_tpu.detect import contours as jcont  # noqa: E402
from manga_ocr_tpu.detect import craft_boxes as jcraft  # noqa: E402
from manga_ocr_tpu.detect import postprocess as jpost  # noqa: E402
from manga_ocr_tpu.typeset import area as jarea  # noqa: E402
from manga_ocr_tpu.typeset import cleanup as jclean  # noqa: E402
from manga_ocr_tpu_torch.core import geometry as tgeo  # noqa: E402
from manga_ocr_tpu_torch.detect import contours as tcont  # noqa: E402
from manga_ocr_tpu_torch.detect import craft_boxes as tcraft  # noqa: E402
from manga_ocr_tpu_torch.detect import postprocess as tpost  # noqa: E402
from manga_ocr_tpu_torch.typeset import area as tarea  # noqa: E402
from manga_ocr_tpu_torch.typeset import cleanup as tclean  # noqa: E402


def _blobs(seed, h=70, w=90, speck=True):
    """A 0/255 mask of a few filled ellipses, a corner block and (``speck``)
    a one-pixel component."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), np.uint8)
    for _ in range(4):
        cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
        ry, rx = rng.integers(2, 14), rng.integers(2, 18)
        mask[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 255
    if speck:
        mask[rng.integers(0, h), rng.integers(0, w)] = 255
    mask[h - 6:, :7] = 255  # touching two borders
    return mask


@pytest.fixture()
def tier(request, monkeypatch):
    """Force one tier of the mask ops in both packages."""
    if request.param != "cv2":
        for mod in (jcont, tcont, jclean, tclean):
            monkeypatch.setattr(mod, "HAS_CV2", False)
    if request.param == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "trace_external_contours", lambda mask: None)
            monkeypatch.setattr(mod, "dilate_box", lambda mask, radius: None)
    return request.param


TIERS = ["cv2", "native", "numpy"]
tnative = native


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_mask_to_polygons_as_jax(tier):
    for seed in range(4):
        mask = _blobs(seed)
        before = tcont.TIER_COUNTS[tier]
        for min_area in (0.0, 30.0):
            got = tcont.mask_to_polygons(mask, min_area=min_area)
            want = jcont.mask_to_polygons(mask, min_area=min_area)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(g, w)
        assert tcont.TIER_COUNTS[tier] == before + 2


def test_native_tier_against_cv2():
    """As the JAX package's native tests hold its library: the tracer finds
    cv2's components with cv2's bounding boxes (cv2 compresses straight
    runs, the tracer keeps every border pixel, and drops components of one
    or two pixels), the fill is cv2's within a boundary pixel, the dilation
    is cv2's exactly."""
    cv2 = pytest.importorskip("cv2")
    assert native.load() is not None, "the native library did not build"

    def rects(polys):
        return sorted(tuple(tgeo.polygon_bounding_rect(p).to_dict().values()) for p in polys)

    for seed in range(4):
        mask = _blobs(seed, speck=False)
        ref, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        assert rects(native.trace_external_contours(mask)) == rects(
            c.reshape(-1, 2) for c in ref)
        k = cv2.getStructuringElement(cv2.MORPH_RECT, (2 * seed + 3, 2 * seed + 3))
        np.testing.assert_array_equal(native.dilate_box(mask, seed + 1), cv2.dilate(mask, k))
    poly = np.array([[5, 5], [45, 10], [40, 35], [10, 30]], np.int32)
    got, ref = np.zeros((40, 50), np.uint8), np.zeros((40, 50), np.uint8)
    assert native.fill_polygon(got, poly)
    cv2.drawContours(ref, [poly.reshape(-1, 1, 2)], -1, 255, -1)
    assert np.mean(got != ref) < 0.03
    assert native.trace_external_contours(np.zeros((10, 10), np.uint8)) == []
    assert len(native.trace_external_contours(np.full((10, 10), 255, np.uint8))) == 1


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_fill_polygon_and_dilate_as_jax(tier):
    rng = np.random.default_rng(9)
    polys = [np.array([[5, 5], [40, 8], [35, 30], [8, 25]], np.int32),
             np.array([[-5, 10], [70, -3], [60, 50]], np.int32),
             rng.integers(0, 60, (9, 2)).astype(np.int32)]
    for poly in polys:
        got, want = np.zeros((45, 60), np.uint8), np.zeros((45, 60), np.uint8)
        tcont.fill_polygon(got, poly, 200)
        jcont.fill_polygon(want, poly, 200)  # without cv2: JAX's NumPy loop
        np.testing.assert_array_equal(got, want)
        assert got.any()
    for radius in (1, 2, 6):
        mask = _blobs(radius)
        np.testing.assert_array_equal(tclean.dilate(mask, radius), jclean.dilate(mask, radius))
    poly = polys[0]
    bubble = _blobs(3, 45, 60)
    for pad in (0, 2):
        np.testing.assert_array_equal(
            tclean.build_cleanup_mask((45, 60, 3), poly, bubble, pad),
            jclean.build_cleanup_mask((45, 60, 3), poly, bubble, pad))


@pytest.mark.parametrize("tier", ["cv2", "numpy"], indirect=True)
def test_threshold_and_classical_finder_as_jax(tier):
    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (80, 100), dtype=np.uint8)
    for block, c in ((41, 5.0), (25, 15), (7, 0)):
        np.testing.assert_array_equal(tcont.adaptive_threshold_mean_inv(gray, block, c),
                                      jcont.adaptive_threshold_mean_inv(gray, block, c))
    img = np.full((120, 120, 3), 200, np.uint8)
    yy, xx = np.mgrid[0:120, 0:120]
    d = ((yy - 60) / 30.0) ** 2 + ((xx - 60) / 30.0) ** 2
    img[d <= 1.2] = 0
    img[d <= 1.0] = 255
    for rect in ((48, 50, 24, 20), (0, 0, 10, 10), (100, 100, 30, 30)):
        got = tcont.find_speech_bubble_mask_contour(img, tgeo.Rect(*rect))
        want = jcont.find_speech_bubble_mask_contour(img, jgeo.Rect(*rect))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    poly = np.array([[5, 5], [40, 8], [35, 30], [8, 25]], np.int32)
    for x, y in ((20, 15), (1, 1), (39, 9), (20.5, 29.0)):
        assert tcont._point_in_polygon(x, y, poly) == jcont._point_in_polygon(x, y, poly)


def test_geometry_as_jax():
    pairs = [((3, 4, 10, 6), (12, 9, 5, 5)), ((0, 0, 1, 1), (50, 60, 2, 3)),
             ((-4, 5, 30, 2), (0, 0, 8, 8))]
    for a, b in pairs:
        ta, tb, ja, jb = tgeo.Rect(*a), tgeo.Rect(*b), jgeo.Rect(*a), jgeo.Rect(*b)
        assert (ta.left, ta.top, ta.right, ta.bottom, ta.area, ta.center()) == (
            ja.left, ja.top, ja.right, ja.bottom, ja.area, ja.center())
        assert ta.intersects(tb) == ja.intersects(jb)
        assert ta.united(tb).to_dict() == ja.united(jb).to_dict()
        assert ta.adjusted(-2, 1, 3, -1).to_dict() == ja.adjusted(-2, 1, 3, -1).to_dict()
        assert ta.clamped(20, 10).to_dict() == ja.clamped(20, 10).to_dict()
        assert tgeo.rect_distance(ta, tb) == jgeo.rect_distance(ja, jb)
        assert tgeo.Rect.from_dict(ta.to_dict()) == ta
        np.testing.assert_array_equal(tgeo.polygon_from_rect(ta), jgeo.polygon_from_rect(ja))
    assert tgeo.axis_overlap_ratio(0, 10, 5, 20) == jgeo.axis_overlap_ratio(0, 10, 5, 20)
    poly = np.array([[5, -3], [40, 8], [35, 90]], np.int32)
    assert tgeo.polygon_bounding_rect(poly).to_dict() == jgeo.polygon_bounding_rect(poly).to_dict()
    np.testing.assert_array_equal(tgeo.clamp_polygon(poly, 30, 50),
                                  jgeo.clamp_polygon(poly, 30, 50))
    assert tgeo.polygon_to_list(poly) == jgeo.polygon_to_list(poly)
    pts = [[1, 2], ["3.6", 4], [5], [None, 1]]
    np.testing.assert_array_equal(tgeo.list_to_polygon(pts), jgeo.list_to_polygon(pts))
    for v in ("7.5", None, "x", float("nan"), 3, "-2.5"):
        assert tgeo.coerce_int(v, -1) == jgeo.coerce_int(v, -1)
    for v in ("7.5", None, "x", float("nan"), float("inf"), 3):
        assert tgeo.coerce_float(v, -1.0) == jgeo.coerce_float(v, -1.0)
    assert tgeo.Rect.from_dict({"x": "2", "w": -3}) == tgeo.Rect(2, 0, 0, 0)


def test_postprocess_as_jax():
    rng = np.random.default_rng(4)
    texts = ["hello world", "", "!!!", "ok", "ａｂｃ", "aaaaa", "~~~", "x", "数字 12", "?!",
             "#", "line two", "...."]
    items = []
    for i, t in enumerate(texts):
        x, y = int(rng.integers(0, 400)), int(rng.integers(0, 400))
        w, h = int(rng.integers(2, 160)), int(rng.integers(2, 60))
        items.append((t, jgeo.polygon_from_rect(jgeo.Rect(x, y, w, h))))
    items.append(("whole page", jgeo.polygon_from_rect(jgeo.Rect(0, 0, 499, 499))))
    for advanced in (False, True):
        got = tpost.filter_detection_noise(items, (500, 500), advanced)
        want = jpost.filter_detection_noise(items, (500, 500), advanced)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    boxes = [(t or "t", p) for t, p in items] + [("none", None)]
    for strict in (False, True):
        got = tpost.merge_text_boxes_to_blocks(boxes, (500, 500), strict)
        want = jpost.merge_text_boxes_to_blocks(boxes, (500, 500), strict)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tpost.clean_detected_text("  a \n b ") == jpost.clean_detected_text("  a \n b ")
    assert tpost.combine_texts(["a ", "", " b"]) == jpost.combine_texts(["a ", "", " b"])


def test_craft_boxes_as_jax():
    rng = np.random.default_rng(6)
    region = rng.random((40, 60)).astype(np.float32) ** 3
    affinity = rng.random((40, 60)).astype(np.float32) ** 4
    binary = region > 0.5
    gl, gn = tcraft.label_components(binary)
    wl, wn = jcraft.label_components(binary)
    assert gn == wn > 1
    np.testing.assert_array_equal(gl, wl)
    for kw in ({}, {"text_threshold": 0.5, "low_text": 0.2, "min_area": 2}):
        got = tcraft.extract_boxes(region, affinity, **kw)
        assert got == jcraft.extract_boxes(region, affinity, **kw)
    boxes = [(40, 40, 100, 24), (150, 42, 110, 22), (200, 250, 90, 24), (0, 44, 20, 10)]
    assert tcraft.group_lines(boxes) == jcraft.group_lines(boxes)
    assert tcraft.group_lines(boxes, overlap=0.9) == jcraft.group_lines(boxes, overlap=0.9)


def test_typeset_area_payloads_as_jax():
    rect = (10, 20, 30, 40)
    kw = dict(text="t", polygon=np.array([[1, 2], [3, 4], [5, 9]], np.int32),
              orientation="vertical", effect="wavy", effect_intensity=3.0,
              bubble_outline_width=0.0, margins={"top": 1, "left": "2"},
              overrides={"use_inpaint": False}, font={"family": "X", "size": "14"},
              color="bad", gradient_colors=["#000000"])
    got = tarea.TypesetArea(rect=tgeo.Rect(*rect), **kw)
    want = jarea.TypesetArea(rect=jgeo.Rect(*rect), **kw)
    assert got.to_payload() == want.to_payload()
    payload = want.to_payload()
    assert tarea.TypesetArea.from_payload(payload).to_payload() == \
        jarea.TypesetArea.from_payload(payload).to_payload()
    for odd in (None, {}, {"rect": {"x": "5"}, "polygon": [], "cleanup_rect": {"w": 3}}):
        assert tarea.TypesetArea.from_payload(odd).to_payload() == \
            jarea.TypesetArea.from_payload(odd).to_payload()
    assert [f.name for f in dataclasses.fields(tarea.TypesetArea)] == \
        [f.name for f in dataclasses.fields(jarea.TypesetArea)]


def test_native_mask_ops_refuse_bad_shapes():
    """Shapes are checked before a pointer reaches the library."""
    assert native.load() is not None
    with pytest.raises(ValueError, match="mask"):
        native.trace_external_contours(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="poly"):
        native.fill_polygon(np.zeros((4, 4), np.uint8), np.arange(6, dtype=np.int32))
    with pytest.raises(ValueError, match="mask"):
        native.fill_polygon(np.zeros((4, 4), np.int32), np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="radius"):
        native.dilate_box(np.zeros((4, 4), np.uint8), -1)


# -- the detector and recognizer families' copies -----------------------------------

from manga_ocr_tpu.models import crnn as jcrnn  # noqa: E402
from manga_ocr_tpu.models import onnx_lite as jol  # noqa: E402
from manga_ocr_tpu.models import yolo_seg as jys  # noqa: E402
from manga_ocr_tpu_torch.models import crnn as tcrnn  # noqa: E402
from manga_ocr_tpu_torch.models import onnx_lite as tol  # noqa: E402
from manga_ocr_tpu_torch.models import yolo_seg as tys  # noqa: E402


def _onnx_graph(ol):
    """A graph with every attribute and tensor kind the reader knows: ints,
    floats, strings, int and float lists, a tensor; f32, f16, int64 and int32
    initializers; negative values; inputs with and without shapes."""
    g = ol.Graph()
    rng = np.random.default_rng(0)
    g.initializers = {"w": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
                      "h": rng.normal(size=(5,)).astype(np.float16),
                      "shape": np.asarray([0, -1, 256], np.int64),
                      "i32": np.asarray([-7, 3], np.int32)}
    t = ol.Tensor("k", np.asarray([[1.5, -2.0]], np.float32))
    g.nodes = [ol.Node("Conv", "c", ["x", "w"], ["y"], {"pads": [1, 0, 1, 2], "group": 1}),
               ol.Node("LeakyRelu", "l", ["y"], ["z"], {"alpha": 0.125}),
               ol.Node("Resize", "r", ["z", "", "", "shape"], ["u"],
                       {"mode": b"nearest", "axis": -1, "scales": [1.0, 2.5]}),
               ol.Node("Constant", "k", [], ["kk"], {"value": t}),
               ol.Node("Concat", "", ["u", "kk"], ["out"], {"axis": -3})]
    g.inputs = [ol.ValueInfo("x", [1, 3, 16, 16]), ol.ValueInfo("w", [4, 3, 3, 3]),
                ol.ValueInfo("free", [])]
    g.outputs = [ol.ValueInfo("out", [1, 0, 16, 16])]
    return g


def _same_graph(a, b):
    assert [(n.op_type, n.name, n.inputs, n.outputs) for n in a.nodes] == [
        (n.op_type, n.name, n.inputs, n.outputs) for n in b.nodes]
    for na, nb in zip(a.nodes, b.nodes):
        assert list(na.attrs) == list(nb.attrs)
        for k in na.attrs:
            va, vb = na.attrs[k].value, nb.attrs[k].value
            if hasattr(va, "array"):
                assert va.name == vb.name
                np.testing.assert_array_equal(va.array, vb.array)
            else:
                assert va == vb, k
    assert list(a.initializers) == list(b.initializers)
    for k, v in a.initializers.items():
        assert v.dtype == b.initializers[k].dtype
        np.testing.assert_array_equal(v, b.initializers[k])
    assert [(v.name, v.shape) for v in a.inputs + a.outputs] == [
        (v.name, v.shape) for v in b.inputs + b.outputs]


def test_onnx_lite_reads_and_writes_as_jax(tmp_path):
    tpath, jpath = str(tmp_path / "t.onnx"), str(tmp_path / "j.onnx")
    tol.save_model(_onnx_graph(tol), tpath)
    jol.save_model(_onnx_graph(jol), jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        data = f.read()
        assert data == g.read()  # the same bytes
    t, j = tol.load_model(data), jol.load_model(data)
    _same_graph(t, j)
    assert tol.load_model(tpath).nodes[2].attrs["axis"].value == -1
    for name in ("DT_FLOAT", "DT_FLOAT16", "DT_INT64", "DT_INT32"):
        assert getattr(tol, name) == getattr(jol, name)
    # the wire helpers, on the values JAX's own tests pin
    for v in (0, 1, 127, 128, 300, 2**40, (-1) & ((1 << 64) - 1)):
        a, b = bytearray(), bytearray()
        tol._write_varint(a, v)
        jol._write_varint(b, v)
        assert a == b and tol._read_varint(bytes(a), 0) == jol._read_varint(bytes(b), 0)


def _yolo_case(seed):
    cfg_t = tys.YoloSegConfig(input_size=64, num_masks=8, reg_max=4)
    cfg_j = jys.YoloSegConfig(input_size=64, num_masks=8, reg_max=4)
    rng = np.random.default_rng(seed)
    n = (64 // 8) ** 2 + (64 // 16) ** 2 + (64 // 32) ** 2
    preds = rng.normal(0.0, 2.0, (n, 4 * 4 + 1 + 8)).astype(np.float32)
    preds[:, 16] -= 1.5  # a share of the anchors below conf_threshold
    protos = rng.normal(0.0, 1.0, (16, 16, 8)).astype(np.float32)
    return cfg_t, cfg_j, preds, protos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yolo_host_decode_as_jax(seed):
    for size in (64, 640):
        for got, want in zip(tys._grid_anchors(size), jys._grid_anchors(size)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(seed + 10)
    xy = rng.uniform(0, 50, (40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (40, 2)).astype(np.float32)], 1)
    scores = rng.random(40).astype(np.float32)
    for thr in (0.1, 0.5, 0.7):
        assert tys._nms(boxes, scores, thr) == jys._nms(boxes, scores, thr)
    cfg_t, cfg_j, preds, protos = _yolo_case(seed)
    for out_hw in ((64, 64), (97, 53)):
        got = tys.postprocess(preds, protos, cfg_t, *out_hw)
        want = jys.postprocess(preds, protos, cfg_j, *out_hw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["box"], w["box"])
            assert g["score"] == w["score"]
            np.testing.assert_array_equal(g["mask"], w["mask"])
        np.testing.assert_array_equal(tys.combined_bubble_mask(got, *out_hw),
                                      jys.combined_bubble_mask(want, *out_hw))
    preds[:, 16] = -20.0
    assert tys.postprocess(preds, protos, cfg_t, 64, 64) == jys.postprocess(
        preds, protos, cfg_j, 64, 64) == []


def test_ctc_greedy_as_jax():
    rng = np.random.default_rng(4)
    for k, blank in ((5, 0), (13, 0), (13, 3)):
        logits = rng.normal(size=(6, 20, k)).astype(np.float32)
        logits[:, ::3, blank] += 3.0  # blanks between repeats
        for lengths in (None, np.array([20, 19, 7, 1, 0, 3])):
            assert tcrnn.ctc_greedy(logits, lengths, blank) == jcrnn.ctc_greedy(logits, lengths,
                                                                                 blank)


def _module(path):
    """A module's AST with docstrings dropped and the JAX package's name
    mapped to the port's."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(re.sub(r"\bmanga_ocr_tpu\b", "manga_ocr_tpu_torch", f.read()), path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _code(path, names=None):
    """A module's (or some of its functions') statements as AST dumps, with
    docstrings dropped and the JAX package's name mapped to the port's."""
    nodes = [n for n in _module(path).body if names is None or getattr(n, "name", None) in names]
    return [ast.dump(n) for n in nodes]


COPIES = ["models/convert_lama.py", "typeset/render.py", "core/project.py",
          "runtime/export.py", "core/settings.py", "utils/http.py", "utils/rate_limit.py",
          "translate/prompts.py", "translate/providers.py", "translate/service.py",
          "translate/styles.py", "engine/ai_ocr.py", "core/review.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_stage_copies_are_the_jax_code(rel):
    want = _code(os.path.join(REPO, "manga_ocr_tpu", rel))
    got = _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel))
    assert len(got) == len(want) > 3
    assert got == want


def test_cleanup_erasing_half_is_the_jax_code_but_the_logged_fall_through():
    names = {"build_cleanup_mask", "dilate", "get_background_color", "auto_text_color",
             "inpaint", "erase_area_for_settings"}
    rel = os.path.join("typeset", "cleanup.py")
    want = _code(os.path.join(REPO, "manga_ocr_tpu", rel), names)
    got = _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel), names)
    assert len(got) == len(want) == len(names) and got == want
    jerase = _code(os.path.join(REPO, "manga_ocr_tpu", rel), {"erase_area"})[0]
    terase = _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel), {"erase_area"})[0]
    assert jerase != terase
    # the one difference: the except clause binds the exception and logs it
    silent = ("ExceptHandler(type=Name(id='Exception', ctx=Load()), "
              "body=[Pass()])")
    assert silent in jerase and silent not in terase and "attr='warning'" in terase


def test_translate_package_init_is_the_jax_code():
    rel = os.path.join("translate", "__init__.py")
    want = _code(os.path.join(REPO, "manga_ocr_tpu", rel))
    got = _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel))
    assert len(got) == len(want) == 1 and got == want


def _drop_device(fn: ast.FunctionDef) -> ast.FunctionDef:
    """``fn`` without its ``device`` parameter (and its default)."""
    names = [a.arg for a in fn.args.args]
    if "device" in names:
        i = names.index("device")
        n_plain = len(fn.args.args) - len(fn.args.defaults)
        fn.args.args.pop(i)
        if i >= n_plain:
            fn.args.defaults.pop(i - n_plain)
    return fn


def test_registry_is_the_jax_code_but_the_device_and_the_latin_path():
    """``engine/registry.py`` is JAX's statement for statement but for three
    named places: ``_latin_preprocess`` (the port's ``ocr_preprocess`` on a
    device), ``make_default_registry``'s Latin factory (``TorchLatinEngine``
    on that device), and the ``device`` parameter of ``EngineRegistry``
    (checked at construction, passed to ``_latin_preprocess``) and
    ``make_default_registry`` (passed to both)."""
    rel = os.path.join("engine", "registry.py")
    jmod = _module(os.path.join(REPO, "manga_ocr_tpu", rel))
    tmod = _module(os.path.join(REPO, "manga_ocr_tpu_torch", rel))
    jnodes = {getattr(n, "name", ast.dump(n)): n for n in jmod.body}
    tnodes = {getattr(n, "name", ast.dump(n)): n for n in tmod.body}
    assert list(tnodes) == list(jnodes) and len(jnodes) > 8
    special = {"_latin_preprocess", "make_default_registry", "EngineRegistry"}
    for name in jnodes.keys() - special:
        assert ast.dump(tnodes[name]) == ast.dump(jnodes[name]), name

    # EngineRegistry: every method as JAX's; __init__ adds the device and its
    # check before JAX's statements; perform_ocr passes self.device on
    jcls, tcls = jnodes["EngineRegistry"], tnodes["EngineRegistry"]
    jm = {m.name: m for m in jcls.body}
    tm = {m.name: m for m in tcls.body}
    assert list(tm) == list(jm)
    for name in jm.keys() - {"__init__", "perform_ocr"}:
        assert ast.dump(tm[name]) == ast.dump(jm[name]), name
    tinit = _drop_device(tm["__init__"])
    n_device = len(tinit.body) - len(jm["__init__"].body)
    assert n_device == 3 and "device" in ast.dump(ast.Module(tinit.body[:n_device], []))
    tinit.body = tinit.body[n_device:]
    assert ast.dump(tinit) == ast.dump(jm["__init__"])
    latin_call = "Call(func=Name(id='_latin_preprocess', ctx=Load()), args=["
    tperf = ast.dump(tm["perform_ocr"])
    device_arg = ", Attribute(value=Name(id='self', ctx=Load()), attr='device', ctx=Load())"
    assert tperf.count(device_arg) == 1 and latin_call in tperf
    assert tperf.replace(device_arg, "") == ast.dump(jm["perform_ocr"])

    # make_default_registry: JAX's but for the device parameter, the
    # registry built on it, and the Latin factory's body
    jmk, tmk = jnodes["make_default_registry"], _drop_device(tnodes["make_default_registry"])
    jlatin = next(n for n in ast.walk(jmk) if isinstance(n, ast.FunctionDef) and n.name == "_latin")
    tlatin = next(n for n in ast.walk(tmk) if isinstance(n, ast.FunctionDef) and n.name == "_latin")
    factory = ast.dump(tlatin)
    assert "attr='from_checkpoints'" in factory and "TorchLatinEngine" in factory
    assert "keyword(arg='device', value=Name(id='device', ctx=Load()))" in factory
    tlatin.body = jlatin.body
    dump = ast.dump(tmk)
    built = "Call(func=Name(id='EngineRegistry', ctx=Load()), args=[Name(id='device', ctx=Load())]"
    assert dump.count(built) == 1
    assert dump.replace(built, "Call(func=Name(id='EngineRegistry', ctx=Load()), args=[]") == \
        ast.dump(jmk)


# -- data-parallel serving's copies -------------------------------------------------------

from manga_ocr_tpu.parallel import mesh as jmesh  # noqa: E402
from manga_ocr_tpu.parallel import multihost as jmh  # noqa: E402
from manga_ocr_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from manga_ocr_tpu_torch.parallel import multihost as tmh  # noqa: E402


def test_pad_batch_to_multiple_is_the_jax_code():
    rel = os.path.join("parallel", "mesh.py")
    want = _code(os.path.join(REPO, "manga_ocr_tpu", rel), {"pad_batch_to_multiple"})
    assert _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel), {"pad_batch_to_multiple"}) == \
        want and len(want) == 1
    rng = np.random.default_rng(0)
    for shape, m, dtype in (((3, 2), 4, np.uint8), ((8, 5, 5, 3), 8, np.uint8),
                            ((9, 4), 8, np.float32), ((1,), 3, np.int32), ((0, 2), 2, np.uint8)):
        arr = (rng.random(shape) * 200).astype(dtype)
        got, want = tmesh.pad_batch_to_multiple(arr, m), jmesh.pad_batch_to_multiple(arr, m)
        assert got.dtype == want.dtype and (got is arr) == (want is arr)
        np.testing.assert_array_equal(got, want)


class _Dev:
    def __init__(self, pid, i):
        self.process_index, self.i = pid, i


@pytest.mark.parametrize("blocks, n_model", [
    ((4, 4), 2), ((4, 2), 3), ((4, 2), 4), ((3, 3), 3), ((2, 2, 2), 1), ((1,), 1), ((4, 4), 0),
    ((2, 4), 2)], ids=str)
def test_global_mesh_block_check_as_jax(blocks, n_model):
    """make_global_mesh's per-process blocks on the same fake devices: the
    same rows, or the same ValueError."""
    devs = [_Dev(pid, i) for pid, n in enumerate(blocks) for i in range(n)]
    out = []
    for mh in (jmh, tmh):
        try:
            mesh = mh.make_global_mesh(n_model=n_model, devices=devs)
            out.append((dict(mesh.shape), [[id(d) for d in row] for row in mesh.devices]))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


# -- the packed wire's copies ---------------------------------------------------------------


def test_packed_wire_prep_is_the_jax_code():
    assert tbatch.CAP_QUANTA == jbatch.CAP_QUANTA == 64
    assert [(f.name, f.type) for f in dataclasses.fields(tbatch.PackedBatch)] == \
        [(f.name, f.type) for f in dataclasses.fields(jbatch.PackedBatch)]
    rel = os.path.join("parallel", "batching.py")
    names = {"prep_page_packed", "PackedBatch"}
    want = _code(os.path.join(REPO, "manga_ocr_tpu", rel), names)
    assert _code(os.path.join(REPO, "manga_ocr_tpu_torch", rel), names) == want
    assert len(want) == 2


def _cpp_code(path: str, start: str) -> str:
    """The C++ source from ``start`` on, comments and blank runs dropped."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    src = re.sub(r"/\*.*?\*/", "", re.sub(r"//[^\n]*", "", src[src.index(start):]), flags=re.S)
    return " ".join(src.split())


def test_native_packed_entry_is_the_jax_code():
    rel = os.path.join("native", "prep.cpp")
    want = _cpp_code(os.path.join(REPO, "manga_ocr_tpu", rel), "void prep_gray_packed(")
    got = _cpp_code(os.path.join(REPO, "manga_ocr_tpu_torch", rel), "void prep_gray_packed(")
    assert got == want and "prep_gray_row(" in want
