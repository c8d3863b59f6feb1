"""The port's erase -> compose -> save stage against the JAX package's on the
same pages: ``typeset/cleanup.py``'s erasing half (``get_background_color``
and ``auto_text_color`` in each tier, ``erase_area`` with cv2's inpaint, the
NumPy fill and the background box, ``erase_area_for_settings`` with its
overrides and inpainter key) byte for byte; ``erase_area`` through each
package's ``LamaInpainter`` on the same weights (known pixels exact, hole
pixels within one level); the inpainter's fall-through (logged by the port,
silent in JAX, the same bytes); ``typeset/render.py``'s ``draw_single_area``
and ``render_page`` byte for byte on the cases of ``tests/test_typeset.py``
(horizontal, vertical, rotated, bubble, gradient, effects, with cleanup);
``core/project.py``'s files loaded across packages both ways, undo/redo,
legacy migration and the autosaver; ``runtime/export.py``'s ``batch_save``,
``save_single`` and ``export_pdf`` writing the same files as JAX's."""

import json
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manga_ocr_tpu.core import project as jproj
from manga_ocr_tpu.core.geometry import Rect as JRect
from manga_ocr_tpu.core.geometry import polygon_from_rect as jpoly
from manga_ocr_tpu.models import inpaint as jip
from manga_ocr_tpu.runtime import export as jexp
from manga_ocr_tpu.typeset import cleanup as jcl
from manga_ocr_tpu.typeset import render as jren
from manga_ocr_tpu.typeset.area import TypesetArea as JArea
from manga_ocr_tpu_torch.core import project as tproj
from manga_ocr_tpu_torch.core.geometry import Rect as TRect
from manga_ocr_tpu_torch.core.geometry import polygon_from_rect as tpoly
from manga_ocr_tpu_torch.models import inpaint as tip
from manga_ocr_tpu_torch.runtime import export as texp
from manga_ocr_tpu_torch.typeset import cleanup as tcl
from manga_ocr_tpu_torch.typeset import render as tren
from manga_ocr_tpu_torch.typeset.area import TypesetArea as TArea
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _page(h=200, w=200, color=(230, 230, 230)):
    page = np.zeros((h, w, 3), np.uint8)
    page[:] = color
    return page


def _text_page(seed=0, h=200, w=200):
    """A light page with dark strokes and some noise."""
    rng = np.random.default_rng(seed)
    page = _page(h, w, (245, 240, 235))
    page += rng.integers(0, 8, page.shape, dtype=np.uint8)
    page[90:110, 50:150] = (10, 10, 10)
    page[60:65, 40:160] = (30, 40, 50)
    return page


@pytest.fixture(params=["cv2", "numpy"])
def tier(request, monkeypatch):
    """cleanup's tier in both packages: cv2, or the NumPy paths (Otsu by the
    median, the neighbourhood fill; the dilation stays on cv2's or the
    native box)."""
    if request.param == "numpy":
        monkeypatch.setattr(jcl, "HAS_CV2", False)
        monkeypatch.setattr(tcl, "HAS_CV2", False)
    elif not tcl.HAS_CV2:
        pytest.skip("OpenCV is not installed")
    return request.param


@pytest.mark.parametrize("rect", [(30, 30, 120, 60), (0, 0, 200, 200), (190, 190, 40, 40),
                                  (300, 300, 5, 5)], ids=str)
def test_background_and_text_color_as_jax(tier, rect):
    page = _text_page(1)
    got = tcl.get_background_color(page, TRect(*rect))
    assert got == jcl.get_background_color(page, JRect(*rect))
    assert all(isinstance(c, int) for c in got)
    dark = _page(color=(20, 20, 20))
    for p in (page, dark):
        assert tcl.auto_text_color(p, TRect(*rect)) == jcl.auto_text_color(p, JRect(*rect))


ERASE_CASES = {
    "inpaint": dict(),
    "box": dict(use_inpaint=False, use_background_box=True),
    "neither": dict(use_inpaint=False, use_background_box=False),
    "padding5": dict(inpaint_padding=5),
    "bubble": dict(bubble=True),
    "empty_mask": dict(bubble="empty"),
}


@pytest.mark.parametrize("case", list(ERASE_CASES))
def test_erase_area_as_jax(tier, case):
    kw = dict(ERASE_CASES[case])
    page = _text_page(2)
    r = (45, 85, 110, 30)
    bubble = kw.pop("bubble", None)
    mask = None
    if bubble is not None:
        mask = np.zeros(page.shape[:2], np.uint8)
        if bubble is True:
            mask[80:120, 40:120] = 255
    want = jcl.erase_area(page, jpoly(JRect(*r)), JRect(*r), bubble_mask=mask, **kw)
    got = tcl.erase_area(page, tpoly(TRect(*r)), TRect(*r), bubble_mask=mask, **kw)
    assert got.dtype == np.uint8 and got.shape == page.shape
    np.testing.assert_array_equal(got, want)
    if case == "inpaint":
        assert got[100, 100].mean() > 200 and (got[:50] == page[:50]).all()


class _Fill:
    """A deterministic stand-in inpainter: the hole filled with one value."""

    def __init__(self, value=128):
        self.value = value
        self.calls = 0

    def __call__(self, image, mask):
        self.calls += 1
        out = image.copy()
        out[mask > 0] = self.value
        return out


class _Broken:
    def __call__(self, image, mask):
        raise ValueError("weights missing")


def test_erase_area_inpainter_tier_and_logged_fall_through(tier, caplog):
    page = _text_page(3)
    r = (45, 85, 110, 30)
    args = lambda R, poly: (page, poly(R(*r)), R(*r))  # noqa: E731
    fill_j, fill_t = _Fill(), _Fill()
    want = jcl.erase_area(*args(JRect, jpoly), inpainter=fill_j)
    got = tcl.erase_area(*args(TRect, tpoly), inpainter=fill_t)
    np.testing.assert_array_equal(got, want)
    assert fill_j.calls == fill_t.calls == 1 and (got[100, 100] == 128).all()
    classical = tcl.erase_area(*args(TRect, tpoly))
    with caplog.at_level(logging.WARNING, logger=tcl.__name__):
        got = tcl.erase_area(*args(TRect, tpoly), inpainter=_Broken())
    want = jcl.erase_area(*args(JRect, jpoly), inpainter=_Broken())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, classical)
    msgs = [rec.getMessage() for rec in caplog.records if rec.name == tcl.__name__]
    assert len(msgs) == 1 and "ValueError" in msgs[0] and "weights missing" in msgs[0]


def test_erase_area_for_settings_as_jax(tier):
    page = _text_page(4)
    r = (45, 85, 110, 30)
    poly_r = (40, 80, 120, 40)
    for overrides, settings in [
        ({}, {}),
        ({}, {"inpaint_model_key": "big_lama", "inpaint_padding": 4}),
        ({"use_inpaint": False}, {"inpaint_model_key": "big_lama"}),
        ({"use_inpaint": False, "use_background_box": False}, {}),
        ({}, {"use_inpaint": False, "use_background_box": True}),
        ({}, {"inpaint_model_key": "anime_inpaint"}),  # no such inpainter: classical
    ]:
        outs = []
        for Area, R, poly, cl in ((JArea, JRect, jpoly, jcl), (TArea, TRect, tpoly, tcl)):
            area = Area(rect=R(*r), text="x", polygon=poly(R(*poly_r)), overrides=dict(overrides))
            outs.append(cl.erase_area_for_settings(page, area, settings,
                                                   inpainters={"big_lama": _Fill(77)}))
        np.testing.assert_array_equal(outs[1], outs[0])


def test_erase_area_through_each_lama_inpainter():
    """Both packages' inpainters on the same numpy weights (the JAX converter
    test's tiny config): known pixels exact, hole pixels within one level on
    at most 0.5% of them."""
    tcfg = tip.InpaintConfig(base_channels=8, num_blocks=2, downsamples=2, global_ratio=0.5,
                             max_features=64)
    jcfg = jip.InpaintConfig(base_channels=8, num_blocks=2, downsamples=2, global_ratio=0.5,
                             max_features=64)
    tree = tip.init_params_numpy(tcfg, 3)
    page = _text_page(5, 90, 130)
    r = (20, 30, 70, 30)
    want = jcl.erase_area(page, jpoly(JRect(*r)), JRect(*r),
                          inpainter=jip.LamaInpainter(jax.tree.map(jnp.asarray, tree), jcfg))
    got = tcl.erase_area(page, tpoly(TRect(*r)), TRect(*r),
                         inpainter=tip.LamaInpainter(tip.params_from_jax(tree), tcfg,
                                                     device="cpu"))
    hole = tcl.build_cleanup_mask(page.shape, tpoly(TRect(*r))) > 0
    np.testing.assert_array_equal(got[~hole], page[~hole])
    np.testing.assert_array_equal(got[~hole], want[~hole])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))[hole]
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005


# -- render -------------------------------------------------------------------------

RENDER_CASES = {
    "horizontal": dict(rect=(20, 20, 160, 80), text="HELLO WORLD", color="#000000"),
    "vertical": dict(rect=(60, 10, 80, 180), text="こんにちは", orientation="vertical"),
    "rotated_bubble": dict(rect=(40, 40, 120, 100), text="Hi", bubble_enabled=True,
                           bubble_fill="#ffffff", rotation=15.0),
    "gradient": dict(rect=(10, 10, 180, 80), text="GRADIENT", gradient_enabled=True,
                     gradient_colors=["#ff0000", "#0000ff"], gradient_angle=0.0),
    "curved": dict(rect=(10, 60, 180, 80), text="WAVY TEXT", effect="curved",
                   effect_intensity=6.0),
    "wavy": dict(rect=(10, 60, 180, 80), text="WAVY TEXT", effect="wavy", effect_intensity=6.0),
    "jagged": dict(rect=(10, 60, 180, 80), text="WAVY TEXT", effect="jagged",
                   effect_intensity=6.0),
    "outline_left": dict(rect=(10, 10, 180, 120), text="a long line that has to wrap twice",
                         text_outline=True, text_outline_color="#ff00ff", alignment="left",
                         line_spacing=1.3, char_spacing=1.0,
                         margins={"top": 4, "right": 6, "bottom": 2, "left": 8}),
    "vertical_outline": dict(rect=(30, 20, 60, 150), text="縦書きの\nテキスト",
                             orientation="vertical", text_outline=True,
                             font={"family": "Arial", "size": 30}),
}


def _areas(case):
    kw = dict(RENDER_CASES[case])
    r = kw.pop("rect")
    return JArea(rect=JRect(*r), **kw), TArea(rect=TRect(*r), **kw)


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_draw_single_area_as_jax(case):
    ja, ta = _areas(case)
    page = _page()
    want = jren.draw_single_area(page, ja, do_cleanup=False)
    got = tren.draw_single_area(page, ta, do_cleanup=False)
    assert got.dtype == np.uint8 and got.shape == page.shape
    np.testing.assert_array_equal(got, want)
    assert (got != page).any()


def test_render_page_with_cleanup_as_jax(tier):
    page = _text_page(6, 300, 300)
    rects = [(40, 80, 120, 40), (150, 200, 120, 60), (10, 10, 100, 50)]
    texts = ["one", "two", "three"]
    jareas = [JArea(rect=JRect(*r), text=t, polygon=jpoly(JRect(*r))) for r, t in zip(rects, texts)]
    tareas = [TArea(rect=TRect(*r), text=t, polygon=tpoly(TRect(*r))) for r, t in zip(rects, texts)]
    tareas[1].overrides["use_inpaint"] = jareas[1].overrides["use_inpaint"] = False
    masks = [None, None, np.full(page.shape[:2], 255, np.uint8)]
    want = jren.render_page(page, jareas, masks)
    got = tren.render_page(page, tareas, masks)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tren.render_page(page, tareas), jren.render_page(page, jareas))


def test_render_keeps_its_own_font_caches(tmp_path):
    """The port's font directory list and caches are its own."""
    assert tren._FONT_DIRS is not jren._FONT_DIRS
    assert os.path.normpath(tren._FONT_DIRS[0]).endswith(os.path.join("manga_ocr_tpu_torch",
                                                                      "fonts"))
    before = list(jren._FONT_DIRS)
    tren.register_font_dir(str(tmp_path))
    try:
        assert tren._FONT_DIRS[0] == str(tmp_path) and jren._FONT_DIRS == before
        assert tren.load_font({"family": "dejavusans", "size": 13}) is not None
        assert ("dejavusans", 13) in tren._FONT_CACHE
    finally:
        tren._FONT_DIRS.remove(str(tmp_path))
        tren._FONT_PATH_CACHE.clear()
    assert tren._effect_offset("curved", 0.5, 10, 0) == jren._effect_offset("curved", 0.5, 10, 0)


# -- projects -----------------------------------------------------------------------


def _project(mod, Area, R, poly, root):
    proj = mod.Project(project_dir=str(root), current_image_path="a.png", current_pdf_page=0)
    a = Area(rect=R(10, 20, 100, 50), text="Hello", polygon=poly(R(10, 20, 100, 50)),
             orientation="vertical", rotation=12.5, overrides={"use_inpaint": False})
    proj.add_area("a.png", a)
    proj.add_area("a.png", Area(rect=R(0, 0, 10, 10), text="t", bubble_enabled=True,
                                bubble_outline_width=0.0))
    proj.add_area("b.png", Area(rect=R(5, 5, 30, 30), text="二"), push_undo=False)
    proj.register_history_entry("a.png", a, "こんにちは", "Hello")
    proj.settings = {"inpaint_model_key": "big_lama", "inpaint_padding": 3}
    proj.scenes = {"s1": {"pages": ["a.png"]}}
    proj.scene_order = ["s1"]
    proj.current_scene_name = "s1"
    return proj


def _payload(proj):
    p = proj.to_payload()
    p.pop("saved_at")
    for e in p["history_entries"]:
        e.pop("timestamp")
    return json.loads(json.dumps(p))


def test_project_files_load_across_packages(tmp_path):
    jp = _project(jproj, JArea, JRect, jpoly, tmp_path)
    tp = _project(tproj, TArea, TRect, tpoly, tmp_path)
    assert _payload(tp) == _payload(jp)
    for save, load, src in ((jproj.save_project, tproj.load_project, jp),
                            (tproj.save_project, jproj.load_project, tp)):
        path = str(tmp_path / f"{save.__module__}.json")
        save(src, path)
        assert not os.path.exists(path + ".tmp")
        back = load(path)
        assert _payload(back) == _payload(src)
        assert type(back).__module__ == load.__module__
        assert back.images["a.png"].areas[0].rotation == 12.5
        assert back.images["a.png"].areas[1].bubble_outline_width == 0.0
    # undo / redo across a load, the same in both packages
    for mod, src in ((jproj, jp), (tproj, tp)):
        path = str(tmp_path / "p.json")
        mod.save_project(src, path)
        st = mod.load_project(path).image_state("a.png")
        assert [a.text for a in st.areas] == ["Hello", "t"]
        assert st.undo() and [a.text for a in st.areas] == ["Hello"]
        assert st.undo() and st.areas == [] and not st.undo()
        assert st.redo() and st.redo() and [a.text for a in st.areas] == ["Hello", "t"]
        assert not st.redo()


def test_project_migration_and_tolerance_as_jax():
    legacy = {"schema_version": 1, "areas_by_image": {"x.png": [
        {"rect": {"x": 1, "y": 2, "w": 3, "h": 4}, "text": "old"}]}, "current_pdf_page": 0}
    for data in (legacy, {"current_pdf_page": None}, {}, "not a dict",
                 {"schema_version": 2, "typeset_data": {"y.png": {"areas": [{"text": "n"}]}}}):
        j = jproj.Project.from_payload(json.loads(json.dumps(data)))
        t = tproj.Project.from_payload(json.loads(json.dumps(data)))
        assert _payload(t) == _payload(j)
    assert tproj.migrate_legacy(dict(legacy)) == jproj.migrate_legacy(dict(legacy))
    assert tproj.Project.from_payload(legacy).current_pdf_page == 0


def test_autosaver_writes_the_project(tmp_path):
    proj = _project(tproj, TArea, TRect, tpoly, tmp_path)
    path = str(tmp_path / "auto.json")
    saver = tproj.AutoSaver(lambda: proj, path, interval_ms=1)
    assert saver.interval_s == 5.0  # the floor
    saver.interval_s = 0.01
    saver.start()
    try:
        for _ in range(500):
            if os.path.exists(path):
                break
            saver._stop.wait(0.01)
    finally:
        saver.stop()
    assert _payload(jproj.load_project(path)) == _payload(proj)


# -- export -------------------------------------------------------------------------


def _write_pages(root, n=3):
    from PIL import Image

    root.mkdir()
    paths = []
    for i in range(n):
        p = str(root / f"page{i + 1}.png")
        Image.fromarray(_text_page(10 + i, 120, 150)[..., ::-1]).save(p)
        paths.append(p)
    return paths


def _export_project(mod, Area, R, poly, paths):
    proj = mod.Project()
    for i, p in enumerate(paths[:-1]):  # the last page has no area
        r = R(20 + 5 * i, 30, 100, 50)
        proj.add_area(p, Area(rect=r, text=f"page {i}", polygon=poly(r)), push_undo=False)
    proj.image_state(paths[-1])
    return proj


def _strip_dates(pdf: bytes) -> bytes:
    return re.sub(rb"/(CreationDate|ModDate) \([^)]*\)", b"", pdf)


def test_export_writes_the_files_jax_writes(tmp_path):
    jpaths = _write_pages(tmp_path / "j")
    tpaths = _write_pages(tmp_path / "t")
    jp = _export_project(jproj, JArea, JRect, jpoly, jpaths)
    tp = _export_project(tproj, TArea, TRect, tpoly, tpaths)
    calls = []
    jw = jexp.batch_save(jp)
    tw = texp.batch_save(tp, progress=lambda i, n, p: calls.append((i, n, p)))
    names = sorted(os.path.basename(w) for w in tw)
    assert names == sorted(os.path.basename(w) for w in jw) == ["page1_typeset.png",
                                                                "page2_typeset.png"]
    assert calls == [(1, 2, tpaths[0]), (2, 2, tpaths[1])]
    for a, b in zip(sorted(tw), sorted(jw)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for fmt in ("JPG", "WEBP"):
        out_t = texp.save_single(tpaths[0], tp, fmt=fmt, quality=80)
        out_j = jexp.save_single(jpaths[0], jp, fmt=fmt, quality=80)
        assert out_t == texp.typeset_output_path(tpaths[0], fmt)
        assert os.path.basename(out_t) == os.path.basename(out_j) == f"page1_typeset.{fmt.lower()}"
        with open(out_t, "rb") as fa, open(out_j, "rb") as fb:
            assert fa.read() == fb.read()
    pdf_t, pdf_j = str(tmp_path / "t" / "book.pdf"), str(tmp_path / "j" / "book.pdf")
    assert texp.export_pdf(tp, pdf_t) == pdf_t
    jexp.export_pdf(jp, pdf_j)
    with open(pdf_t, "rb") as fa, open(pdf_j, "rb") as fb:
        a, b = fa.read(), fb.read()
    assert a.startswith(b"%PDF-") and _strip_dates(a) == _strip_dates(b)
    with pytest.raises(ValueError):
        texp.export_pdf(tproj.Project(), str(tmp_path / "x.pdf"))
    with pytest.raises(FileNotFoundError):
        texp.save_single(str(tmp_path / "missing.png"), tp)
