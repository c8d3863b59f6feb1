"""Text-mode detection (``manga_ocr_tpu_torch/detect/text_detect.py``) against
the JAX package's: the cases of ``tests/test_text_detect.py`` through both
packages on the same page, with a stub ``ocr_page`` and a stub CRAFT engine
-- proposals (each contour tier), refinement, the one batched OCR call,
noise filtering and block merging (plain and advanced), the error
sentinels, and the CRAFT proposer's line grouping."""

import numpy as np
import pytest
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

cv2 = pytest.importorskip("cv2")

from manga_ocr_tpu import native as jnative  # noqa: E402
from manga_ocr_tpu.core.geometry import polygon_from_rect as jpoly  # noqa: E402
from manga_ocr_tpu.core.geometry import Rect as JRect  # noqa: E402
from manga_ocr_tpu.detect import contours as jcont  # noqa: E402
from manga_ocr_tpu.detect import text_detect as jtd  # noqa: E402
from manga_ocr_tpu.typeset import cleanup as jclean  # noqa: E402
from manga_ocr_tpu_torch import native as tnative  # noqa: E402
from manga_ocr_tpu_torch.core.geometry import Rect, polygon_bounding_rect  # noqa: E402
from manga_ocr_tpu_torch.core.geometry import polygon_from_rect as tpoly  # noqa: E402
from manga_ocr_tpu_torch.detect import contours as tcont  # noqa: E402
from manga_ocr_tpu_torch.detect import text_detect as ttd  # noqa: E402
from manga_ocr_tpu_torch.typeset import cleanup as tclean  # noqa: E402


@pytest.fixture(scope="module")
def page():
    page = np.full((300, 400, 3), 245, np.uint8)
    cv2.putText(page, "HELLO WORLD", (40, 60), cv2.FONT_HERSHEY_SIMPLEX, 1.2, (10, 10, 10), 3)
    cv2.putText(page, "SECOND LINE", (40, 100), cv2.FONT_HERSHEY_SIMPLEX, 1.2, (10, 10, 10), 3)
    cv2.putText(page, "FAR AWAY", (200, 270), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (10, 10, 10), 3)
    return page


@pytest.fixture()
def tier(request, monkeypatch):
    """Force one tier of contours and dilation in both packages."""
    if request.param == "cv2":
        return "cv2"
    for mod in (jcont, tcont, jclean, tclean):
        monkeypatch.setattr(mod, "HAS_CV2", False)
    if request.param == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "trace_external_contours", lambda mask: None)
            monkeypatch.setattr(mod, "dilate_box", lambda mask, radius: None)
    return request.param


def _same_polys(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _same_items(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    _same_polys([p for _, p in got], [p for _, p in want])


@pytest.mark.parametrize("tier", ["cv2", "native", "numpy"], indirect=True)
def test_proposals_match_jax(page, tier):
    got, want = ttd.propose_text_regions(page), jtd.propose_text_regions(page)
    _same_polys(got, want)
    assert len(got) >= 2
    rects = [polygon_bounding_rect(p) for p in got]
    assert any(r.top < 70 and r.bottom > 30 and r.left < 100 for r in rects)
    for radius, area in ((3, 20), (9, 200)):
        _same_polys(ttd.propose_text_regions(page, radius, area),
                    jtd.propose_text_regions(page, radius, area))


def test_refine_matches_jax(page):
    for x, y, w, h in ((20, 20, 360, 100), (190, 230, 200, 60), (0, 0, 3, 3), (300, 150, 50, 40)):
        got = ttd.refine_polygon_with_image(page, tpoly(Rect(x, y, w, h)))
        want = jtd.refine_polygon_with_image(page, jpoly(JRect(x, y, w, h)))
        np.testing.assert_array_equal(got, want)
    r = polygon_bounding_rect(ttd.refine_polygon_with_image(page, tpoly(Rect(20, 20, 360, 100))))
    assert r.area < 360 * 100  # actually tightened


@pytest.mark.parametrize("tier", ["cv2", "native"], indirect=True)
@pytest.mark.parametrize("advanced", [False, True])
@pytest.mark.parametrize("merge", [True, False])
def test_detect_text_regions_matches_jax(page, tier, advanced, merge):
    calls = {"jax": [], "port": []}

    def ocr(tag):
        def ocr_page(crops):
            calls[tag].append([c.shape for c in crops])
            return [f"text region {i}" for i in range(len(crops))]
        return ocr_page

    got = ttd.detect_text_regions(page, ocr("port"), advanced=advanced, merge=merge)
    want = jtd.detect_text_regions(page, ocr("jax"), advanced=advanced, merge=merge)
    assert len(calls["port"]) == 1  # every proposal read in one batched call
    assert calls["port"] == calls["jax"] and len(calls["port"][0]) >= 2
    _same_items(got, want)
    assert 1 <= len(got) <= len(calls["port"][0])


def test_error_sentinels_filtered(page):
    for texts in (lambda n: ["[ERROR: x]"] * n, lambda n: ["", "!!", "ok text"] * n):
        got = ttd.detect_text_regions(page, lambda crops: texts(len(crops))[:len(crops)])
        want = jtd.detect_text_regions(page, lambda crops: texts(len(crops))[:len(crops)])
        _same_items(got, want)
    assert ttd.detect_text_regions(page, lambda crops: ["[ERROR: x]"] * len(crops)) == []


class _StubLatin:
    """detect_boxes stand-in: returns fixed word boxes in image coords."""

    def __init__(self, boxes):
        self.boxes = boxes
        self.seen = []

    def detect_boxes(self, rgb):
        self.seen.append(rgb.shape)
        return list(self.boxes)


BOXES = [[(40, 40, 100, 24), (150, 42, 110, 22), (200, 250, 90, 24)],
         [(40, 40, 320, 60)],
         [(390, 290, 40, 40), (0, 0, 1, 5), (10, 100, 30, 12), (50, 101, 30, 12)]]


@pytest.mark.parametrize("boxes", BOXES, ids=["two lines", "one box", "edges"])
def test_craft_proposer_matches_jax(page, boxes):
    tstub, jstub = _StubLatin(boxes), _StubLatin(boxes)
    _same_polys(ttd.craft_proposer(tstub)(page), jtd.craft_proposer(jstub)(page))
    assert tstub.seen == jstub.seen == [page.shape]
    got = ttd.detect_text_regions(page, lambda crops: ["hello"] * len(crops),
                                  proposer=ttd.craft_proposer(tstub))
    want = jtd.detect_text_regions(page, lambda crops: ["hello"] * len(crops),
                                   proposer=jtd.craft_proposer(jstub))
    _same_items(got, want)


def test_craft_proposer_groups_lines(page):
    polys = ttd.craft_proposer(_StubLatin(BOXES[0]))(page)
    assert len(polys) == 2
    rects = sorted((polygon_bounding_rect(p) for p in polys), key=lambda r: r.top)
    assert rects[0].left == 40 and rects[0].right >= 259
    assert rects[0].top == 40 and rects[0].bottom >= 63
    assert rects[1].top == 250
