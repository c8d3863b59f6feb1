"""The port's ``PagePipeline`` (``process_jobs``, ``process_pages``),
``create_typeset_area`` and ``apply_safe_mode`` against the JAX package's
with stub OCR, dual-pass and translate callables: every scenario of the JAX
package's runtime tests run through both packages, the ``JobResult``s
compared field by field (the areas by their project payload), including
the ``[ERROR`` pass-through, pre-detected text, the batch translator, the
enhanced dual pass, safe mode, and ``process_pages``' look-ahead and its
cancellation on error."""

import threading
import time

import numpy as np
import pytest

from manga_ocr_tpu.core import geometry as jgeo
from manga_ocr_tpu.runtime import pipeline as jpipe
from manga_ocr_tpu_torch.core import geometry as tgeo
from manga_ocr_tpu_torch.runtime import pipeline as tpipe
from manga_ocr_tpu_torch.typeset.area import TypesetArea
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SETTINGS = [
    {"use_inpaint": False},
    {"safe_mode": True, "orientation_mode": "vertical", "text_effect": "wavy",
     "effect_intensity": 7, "create_bubble": True, "text_outline": True, "outline_width": 3,
     "outline_color": "#112233", "outline_style": "glow", "alignment": "left",
     "line_spacing": 1.4, "char_spacing": 90, "margins": {"top": 1, "right": 2, "bottom": 3,
                                                          "left": 4},
     "translation_style": "casual", "use_background_box": False,
     "font": {"family": "Noto", "size": 20, "bold": True}, "text_color": "#ff0000"},
    {"enhanced_pipeline": True, "color": "#00ff00"},
]


def _jobs(pkg, geo, settings, pre=(None, None, None)):
    return [pkg.OcrJob(image_path="page.png", rect=geo.Rect(10 * i, 3, 50, 40),
                       polygon=geo.polygon_from_rect(geo.Rect(10 * i, 3, 50, 40)),
                       cropped_image=np.full((40, 50, 3), 200 + i, np.uint8),
                       settings=dict(settings), pre_text=p)
            for i, p in enumerate(pre)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.original_text, g.translated_text, g.error) == (
            w.original_text, w.translated_text, w.error)
        assert (g.area is None) == (w.area is None)
        if g.area is not None:
            assert isinstance(g.area, TypesetArea)
            assert g.area.to_payload() == w.area.to_payload()
        assert g.job.pre_text == w.job.pre_text and g.job.image_path == w.job.image_path


def _ocr(crops):
    return ["[ERROR: boom]" if c[0, 0, 0] == 201 else f"vagina text{int(c[0, 0, 0])}"
            for c in crops]


def _dual(crops, settings=None):
    return [("longer raw penis", f"short{len(settings or {})}")] * len(crops)


def _translate(text, settings):
    return f"EN[{text}|{settings.get('is_enhanced', False)}|" \
           f"{sorted(settings.get('ocr_results', {}))}]"


def _translate_batch(texts, settings):
    return [None if "text2" in t else f"B[{t}]" for t in texts]


SCENARIOS = {
    "ocr only": dict(),
    "translate": dict(translate=_translate),
    "batch translate": dict(translate=_translate, translate_batch=_translate_batch),
    "dual pass": dict(translate=_translate, dual_pass=_dual),
}


@pytest.mark.parametrize("settings", SETTINGS, ids=["plain", "typeset keys", "enhanced"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("pre", [(None, None, None), ("given", None, "x")], ids=["ocr", "pre"])
def test_process_jobs_matches_jax(scenario, settings, pre):
    kw = SCENARIOS[scenario]
    calls = {"jax": [], "port": []}

    def ocr(tag):
        return lambda crops: (calls[tag].append(len(crops)), _ocr(crops))[1]

    got_pipe = tpipe.PagePipeline(ocr("port"), **kw)
    want_pipe = jpipe.PagePipeline(ocr("jax"), **kw)
    seen = {"jax": [], "port": []}
    for enhanced in (None, False, True):
        got = got_pipe.process_jobs(_jobs(tpipe, tgeo, settings, pre), enhanced=enhanced,
                                    on_result=lambda r: seen["port"].append(r.original_text))
        want = jpipe.PagePipeline.process_jobs(
            want_pipe, _jobs(jpipe, jgeo, settings, pre), enhanced=enhanced,
            on_result=lambda r: seen["jax"].append(r.original_text))
        _same(got, want)
    assert calls["port"] == calls["jax"]
    assert seen["port"] == seen["jax"]
    got_pipe.close()
    want_pipe.close()


def test_error_sentinels_pass_through_untranslated():
    sent = []
    pipe = tpipe.PagePipeline(_ocr, translate=lambda t, s: (sent.append(t), f"T({t})")[1])
    results = pipe.process_jobs(_jobs(tpipe, tgeo, {}))
    pipe.close()
    assert results[1].error == "[ERROR: boom]" and results[1].area is None
    assert results[1].translated_text == "[ERROR: boom]"
    assert "[ERROR: boom]" not in sent and len(sent) == 2


@pytest.mark.parametrize("text", ["", "Vagina and PENIS", "plain"])
@pytest.mark.parametrize("on", [None, {}, {"safe_mode": False}, {"safe_mode": True}])
def test_apply_safe_mode_matches_jax(text, on):
    assert tpipe.apply_safe_mode(text, on) == jpipe.apply_safe_mode(text, on)


@pytest.mark.parametrize("settings", SETTINGS + [{}], ids=["plain", "typeset keys",
                                                           "enhanced", "none"])
def test_create_typeset_area_matches_jax(settings):
    tjob = _jobs(tpipe, tgeo, settings)[0]
    jjob = _jobs(jpipe, jgeo, settings)[0]
    for override in (None, {"alignment": "right"}):
        got = tpipe.create_typeset_area(tjob, "translated", "original", override)
        want = jpipe.create_typeset_area(jjob, "translated", "original", override)
        assert got.to_payload() == want.to_payload()
        assert got.overrides == want.overrides


def _detect(geo):
    def detect(page):
        h, w = page.shape[:2]
        return [{"polygon": geo.polygon_from_rect(geo.Rect(0, 0, w // 2, h // 2)), "text": None},
                {"polygon": np.array([[w // 2, 2], [w - 3, h // 3], [w // 2 + 4, h - 5]],
                                     np.int32), "text": "pre"},
                {"polygon": geo.polygon_from_rect(geo.Rect(1, 1, 1, 9)), "text": None}]
    return detect


def test_process_pages_matches_jax():
    pages = [(f"p{i}.png", np.random.default_rng(i).integers(0, 256, (40 + 10 * i, 60, 3),
                                                             dtype=np.uint8))
             for i in range(5)]
    ocr = lambda crops: [f"t{c.shape[0]}x{c.shape[1]}:{int(c.sum())}" for c in crops]  # noqa: E731
    order = {"jax": [], "port": []}
    got = tpipe.PagePipeline(ocr, translate=lambda t, s: t.upper()).process_pages(
        pages, _detect(tgeo), settings={"safe_mode": True},
        on_page=lambda p, r: order["port"].append(p))
    want = jpipe.PagePipeline(ocr, translate=lambda t, s: t.upper()).process_pages(
        pages, _detect(jgeo), settings={"safe_mode": True},
        on_page=lambda p, r: order["jax"].append(p))
    assert list(got) == list(want) == [p for p, _ in pages]
    assert order["port"] == order["jax"] == [p for p, _ in pages]
    for path in got:
        assert len(got[path]) == 2  # the 1-pixel-wide detection is dropped
        _same(got[path], want[path])
        np.testing.assert_array_equal(got[path][1].job.cropped_image,
                                      want[path][1].job.cropped_image)
        assert got[path][1].original_text == "pre"  # pre-detected text skips OCR


def test_process_pages_looks_ahead_and_cancels_on_error():
    """Page 0's OCR runs while the next two pages prepare; a page whose
    detection fails raises, and the pages queued behind it are cancelled,
    not run."""
    gate = threading.Event()
    prepared = []

    def detect(page):
        idx = int(page[0, 0, 0])
        prepared.append(idx)
        if idx == 1:
            raise RuntimeError("detector failed on page 1")
        if idx >= 2:
            assert gate.wait(5)
        return [{"polygon": tgeo.polygon_from_rect(tgeo.Rect(0, 0, 8, 8)), "text": None}]

    def ocr(crops):
        deadline = time.monotonic() + 5
        while len(prepared) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        return ["x"] * len(crops)

    pages = [(f"p{i}", np.full((16, 16, 3), i, np.uint8)) for i in range(12)]
    pipe = tpipe.PagePipeline(ocr)
    with pytest.raises(RuntimeError, match="page 1"):
        pipe.process_pages(pages, detect)
    in_flight = list(prepared)
    gate.set()
    pipe.close()
    assert {0, 1, 2} <= set(in_flight)  # two pages ahead while page 0's OCR ran
    time.sleep(0.2)
    # a worker freed by page 1 may have started page 3; pages 4-11 were cancelled
    assert set(prepared) <= {0, 1, 2, 3}
