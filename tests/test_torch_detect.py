"""The port's ``BubbleDetector`` and its helpers against the JAX package's, on
the same numpy-made weights (``params_from_jax``) and pages: masks,
``detect_pages`` (with and without the over-wide split, with progress),
``detect_bubbles``, ``find_bubble_mask`` (DL component and the classical
fallback), ``crops_from_detections``, ``split_extended_bubbles``,
``detector_from_settings`` and ``from_checkpoint``, each contour tier (cv2,
the native tracer, NumPy) forced alike in both packages; and the port's
refusals (a mesh of another device type, a CUDA device without CUDA; an
``.onnx`` path ignores a mesh with JAX's note)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu import native as jnative
from manga_ocr_tpu.core.geometry import Rect as JRect
from manga_ocr_tpu.detect import contours as jcont
from manga_ocr_tpu.detect import detector as jdetect
from manga_ocr_tpu.detect import postprocess as jpost
from manga_ocr_tpu.models import detector as jseg
from manga_ocr_tpu_torch import native as tnative
from manga_ocr_tpu_torch.core.geometry import Rect, polygon_bounding_rect, polygon_from_rect
from manga_ocr_tpu_torch.detect import contours as tcont
from manga_ocr_tpu_torch.detect import detector as tdetect
from manga_ocr_tpu_torch.detect import postprocess as tpost
from manga_ocr_tpu_torch.detect import synthetic
from manga_ocr_tpu_torch.models import detector as tseg
from manga_ocr_tpu_torch.parallel.mesh import make_mesh
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TIERS = ["cv2", "native", "numpy"]
MASK_EPS = 1e-4  # a pixel this close to the threshold may flip between packages


@pytest.fixture()
def tier(request, monkeypatch):
    """Force one contour tier in both packages."""
    name = request.param
    if name == "cv2":
        pytest.importorskip("cv2")
        assert jcont.HAS_CV2 and tcont.HAS_CV2
        return name
    for mod in (jcont, tcont):
        monkeypatch.setattr(mod, "HAS_CV2", False)
    if name == "native":
        assert jnative.load() is not None and tnative.load() is not None
    else:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "trace_external_contours", lambda mask: None)
    return name


def _pages():
    """Bubble pages (the closed loop's drawer) at two shapes, and one random
    page."""
    rng = np.random.default_rng(11)
    pages = [synthetic.draw_page(rng, 96, 128)[0] for _ in range(3)]
    pages += [synthetic.draw_page(rng, 120, 90)[0] for _ in range(2)]
    pages.insert(2, np.random.default_rng(12).integers(0, 256, (96, 128, 3), dtype=np.uint8))
    return pages


@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's detector on the same random weights (the head's
    bias set so that the masks hold both values)."""
    cfg = tseg.DetectorConfig(input_size=64, base_channels=4, depth=2)
    jcfg = jseg.DetectorConfig(input_size=64, base_channels=4, depth=2)
    tree = tseg.init_params_numpy(cfg, 4)
    pages = _pages()
    # centre the head's logits on these pages: masks of both values
    prob = tseg.segment_probs(tseg.params_from_jax(tree), np.stack(pages[:3])[..., ::-1].copy(),
                              cfg, 96, 128).numpy()
    median = float(np.median(prob))
    tree["head"]["bias"][:] = -np.log(median / (1.0 - median))
    jdet = jdetect.BubbleDetector(jax.tree.map(jnp.asarray, tree), jcfg, min_area=20.0)
    tdet = tdetect.BubbleDetector(tseg.params_from_jax(tree), cfg, min_area=20.0, device="cpu")
    jm = jdet.detect_bubble_masks(pages)
    tm = tdet.detect_bubble_masks(pages)
    return jdet, tdet, tree, pages, jm, tm


@pytest.fixture()
def jax_masks(pair, monkeypatch):
    """The port's detector reading JAX's masks: what follows the device
    dispatch (contours, post-processing, crops) compared exactly, whatever
    a pixel at the threshold did."""
    jdet, tdet = pair[0], pair[1]
    monkeypatch.setattr(tdet, "detect_bubble_masks", jdet.detect_bubble_masks)


def test_masks_match_jax(pair):
    """Masks equal except where the probability lies within MASK_EPS of the
    threshold; where they are equal, detect_pages end to end too."""
    jdet, tdet, tree, pages, jm, tm = pair
    cfg = tdet.cfg
    for page, j, t in zip(pages, jm, tm):
        assert t.dtype == np.uint8 and t.shape == page.shape[:2]
        prob = tseg.segment_probs(tdet._net, np.ascontiguousarray(page[None, ..., ::-1]), cfg,
                                  *page.shape[:2])[0].numpy()
        near = np.abs(prob - cfg.threshold) <= MASK_EPS
        print(f"page {page.shape[:2]}: {int(near.sum())} pixels within {MASK_EPS} of the "
              f"threshold, {int((t != j).sum())} differ")
        np.testing.assert_array_equal(t[~near], j[~near])
    shares = [float((t > 0).mean()) for t in tm]
    assert all(0.0 < s < 1.0 for s in shares), shares
    for page, j, t in zip(pages, jm, tm):
        if np.array_equal(t, j):
            got, want = tdet.detect_pages([page]), jdet.detect_pages([page])
            assert len(got[0]) == len(want[0])
            for g, w in zip(got[0], want[0]):
                np.testing.assert_array_equal(g["polygon"], w["polygon"])


def test_masks_dispatched_in_groups_of_dispatch_pages(pair, monkeypatch):
    """A chapter of one page shape goes to the device DISPATCH_PAGES pages a
    dispatch, each shape apart, and every page gets its own mask back: the
    mask of dispatching it alone, except within MASK_EPS of the threshold
    (the batch size changes the CPU's summation order)."""
    tdet, pages = pair[1], pair[3]
    chapter = [pages[i % 4] for i in range(2 * tdetect.DISPATCH_PAGES + 1)] + pages[4:]
    sizes = []
    segment = tseg.segment_pages

    def recording(net, rgb, cfg, h, w):
        sizes.append((len(rgb), h, w))
        return segment(net, rgb, cfg, h, w)

    monkeypatch.setattr(tseg, "segment_pages", recording)
    got = tdet.detect_bubble_masks(chapter)
    n = tdetect.DISPATCH_PAGES
    assert sizes[:3] == [(n, 96, 128), (n, 96, 128), (1, 96, 128)]
    assert sizes[3:] == [(2, 120, 90)]
    monkeypatch.undo()
    for page, mask in zip(chapter, got):
        prob = tseg.segment_probs(tdet._net, np.ascontiguousarray(page[None, ..., ::-1]),
                                  tdet.cfg, *page.shape[:2])[0].numpy()
        far = np.abs(prob - tdet.cfg.threshold) > MASK_EPS
        alone = tdet.detect_bubble_masks([page])[0]
        np.testing.assert_array_equal(mask[far], alone[far])


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("split_extended", [True, False])
def test_detect_pages_matches_jax(pair, tier, split_extended, jax_masks):
    jdet, tdet, tree, pages, jm, tm = pair
    jprog, tprog = [], []
    want = jdet.detect_pages(pages, split_extended=split_extended,
                             progress=lambda i, n: jprog.append((i, n)))
    before = dict(tcont.TIER_COUNTS)
    got = tdet.detect_pages(pages, split_extended=split_extended,
                            progress=lambda i, n: tprog.append((i, n)))
    assert tcont.TIER_COUNTS[tier] - before[tier] == len(pages)
    assert tprog == jprog == [(i + 1, len(pages)) for i in range(len(pages))]
    assert len(got) == len(want) == len(pages)
    assert sum(len(d) for d in got) >= len(pages), "too few detections to compare"
    for g_page, w_page in zip(got, want):
        assert len(g_page) == len(w_page)
        for g, w in zip(g_page, w_page):
            assert g["text"] == w["text"]
            np.testing.assert_array_equal(np.asarray(g["polygon"]), np.asarray(w["polygon"]))


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_detect_bubbles_and_crops_match_jax(pair, tier, jax_masks):
    jdet, tdet, tree, pages, jm, tm = pair
    for page in pages[:3]:
        want = jdet.detect_bubbles(page)
        got = tdet.detect_bubbles(page)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["polygon"], w["polygon"])
        tri = {"polygon": np.array([[10, 10], [60, 12], [14, 70]], np.int32), "text": "t"}
        wc, wj = jdetect.crops_from_detections(page, want + [tri])
        gc, gj = tdetect.crops_from_detections(page, got + [tri])
        assert len(gc) == len(wc) == len(gj) == len(wj)
        for a, b in zip(gc, wc):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(gj, wj):
            assert (a["rect"].x, a["rect"].y, a["rect"].w, a["rect"].h) == (
                b["rect"].x, b["rect"].y, b["rect"].w, b["rect"].h)
            assert a["text"] == b["text"]
            np.testing.assert_array_equal(a["polygon"], b["polygon"])
        # outside the polygon whited out, inside kept
        crop = gc[-1]
        assert crop[-2, -2].tolist() == [255, 255, 255]
        np.testing.assert_array_equal(crop[3, 3], page[13, 13])


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_find_bubble_mask_matches_jax(pair, tier, jax_masks):
    jdet, tdet, tree, pages, jm, tm = pair
    page = pages[0]
    poly = tdet.detect_bubbles(page)[0]["polygon"]
    r = polygon_bounding_rect(poly)
    cx, cy = r.center()
    rects = [(cx - 3, cy - 3, 6, 6), (0, 0, 4, 4), (40, 30, 30, 20)]
    for x, y, w, h in rects:
        got = tdet.find_bubble_mask(page, Rect(x, y, w, h))
        want = jdet.find_bubble_mask(page, JRect(x, y, w, h))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    # no weights: the classical finder alone, on a drawn bubble
    img = np.full((120, 120, 3), 200, np.uint8)
    yy, xx = np.mgrid[0:120, 0:120]
    d = ((yy - 60) / 30.0) ** 2 + ((xx - 60) / 30.0) ** 2
    img[d <= 1.2] = 0
    img[d <= 1.0] = 255
    img[58:62, 50:70] = 0
    classical = [tdetect.BubbleDetector(None, device="cpu"), jdetect.BubbleDetector(None)]
    for rect in ((48, 50, 24, 20), (0, 0, 10, 10)):
        got = classical[0].find_bubble_mask(img, Rect(*rect))
        want = classical[1].find_bubble_mask(img, JRect(*rect))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert classical[0].detect_bubble_mask(img) is None
    assert classical[0].detect_bubbles(img) == []
    with pytest.raises(RuntimeError, match="no weights"):
        classical[0].detect_bubble_masks([img])


def test_split_extended_bubbles_matches_jax():
    dets = [{"polygon": polygon_from_rect(Rect(0, 0, 300, 50)), "text": "x"},
            {"polygon": polygon_from_rect(Rect(0, 0, 40, 200)), "text": "y"},
            {"polygon": polygon_from_rect(Rect(0, 0, 100, 100)), "text": "z"},
            {"polygon": polygon_from_rect(Rect(10, 20, 301, 40)), "text": None},
            {"polygon": polygon_from_rect(Rect(5, 7, 33, 151)), "text": "w"},
            {"polygon": np.array([[3, 3], [90, 5], [40, 20]], np.int32), "text": None}]
    for threshold in (2.5, 4.0):
        got = tpost.split_extended_bubbles(dets, split_threshold=threshold)
        want = jpost.split_extended_bubbles(dets, split_threshold=threshold)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["text"] == w["text"]
            np.testing.assert_array_equal(g["polygon"], w["polygon"])


def test_detector_from_settings_matches_jax():
    models = {("onnx", "a.onnx"): "A", "b.npz": "B", ("x", "c"): None}
    for settings in ({}, {"use_dl_detector": False, "dl_model_file": "b.npz"},
                     {"use_dl_detector": True, "dl_provider": "onnx", "dl_model_file": "a.onnx"},
                     {"use_dl_detector": True, "dl_provider": "other", "dl_model_file": "b.npz"},
                     {"use_dl_detector": True, "dl_provider": "x", "dl_model_file": "c"},
                     {"use_dl_detector": True, "dl_model_file": "missing"}):
        assert tdetect.detector_from_settings(settings, models) == \
            jdetect.detector_from_settings(settings, models)


def test_from_checkpoint_matches_jax(pair, tmp_path):
    jdet, tdet, tree, pages, jm, tm = pair
    path = str(tmp_path / "det.npz")
    jseg.save_params(jax.tree.map(jnp.asarray, tree), path)
    loaded = tdetect.BubbleDetector.from_checkpoint(path, tdet.cfg, min_area=20.0, device="cpu")
    for got, want in zip(loaded.detect_bubble_masks(pages), tm):
        np.testing.assert_array_equal(got, want)  # the same weights, the same package
    # the weights live on the detector's device once, as f32, apart from the caller's
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in loaded._net.parameters())
    assert not any(p.requires_grad for p in loaded._net.parameters())


def test_refusals(pair, tmp_path, capsys):
    jdet, tdet, tree, pages, jm, tm = pair
    params = tseg.params_from_jax(tree)
    cuda_mesh = make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="mesh"):  # a CUDA mesh under device="cpu"
        tdetect.BubbleDetector(params, tdet.cfg, mesh=cuda_mesh, device="cpu")
    with pytest.raises(FileNotFoundError):  # .onnx ignores the mesh (a note), then opens
        tdetect.BubbleDetector.from_checkpoint(str(tmp_path / "bubbles.onnx"), mesh=cuda_mesh,
                                               device="cpu")
    assert "mesh ignored for .onnx" in capsys.readouterr().err
    path = str(tmp_path / "det.npz")
    tseg.save_params(params, path)
    with pytest.raises(ValueError, match="mesh"):
        tdetect.BubbleDetector.from_checkpoint(path, tdet.cfg, mesh=cuda_mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdetect.BubbleDetector(params, tdet.cfg)  # the default device is "cuda"
