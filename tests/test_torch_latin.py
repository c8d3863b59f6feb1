"""The port's Latin OCR stack (``models/craft.py``, ``models/crnn.py``,
``models/convert_latin.py``, ``engine/latin.py``) against the JAX package's
at the JAX tests' tiny configs (CRAFT ``vgg_channels=(4, 8, 16, 32, 32,
64)``, head 8; CRNN 13 classes, output 32, hidden 16), on the same numpy
weights (``params_from_jax``): ``craft_forward`` within ``CRAFT_ATOL``,
``crnn_forward`` within ``CRNN_ATOL`` (at widths whose valid columns end
short of the bucket: both directions run over the padded width),
``_lstm_scan``'s two directions within ``LSTM_ATOL``; the converters bit for
bit on one state dict of twins with the public parameter names (and
through ``load_torch_checkpoint`` files), the converted weights against the
twins' own forwards; ``TorchLatinEngine``'s boxes and strings equal to
``TpuLatinEngine``'s (``detect_boxes_batch`` over three buckets and a
downscaled page, ``recognize_lines``, ``readtext``, ``perform_ocr``,
``from_checkpoints`` on ``.pth`` files and on a ``train_latin`` checkpoint
directory), with the score pixels and logit gaps that lie within
the tolerance of a threshold counted, printed and required to be none (the
inputs are fixed, so one that comes to lie there fails loudly); and text mode
(``detect_text_regions`` on ``craft_proposer(engine)``) against JAX's.
Twins are built on the meta device and filled from explicit
``torch.Generator``s; torch's global RNG is never drawn."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_latin_ocr as jtwin  # noqa: E402  (the JAX tests' CRAFT and CRNN twins)
from manga_ocr_tpu.detect import text_detect as jtd
from manga_ocr_tpu.engine import latin as jlatin
from manga_ocr_tpu.models import convert_latin as jconv
from manga_ocr_tpu.models import craft as jcraft
from manga_ocr_tpu.models import crnn as jcrnn
from manga_ocr_tpu_torch import train_latin as ttl
from manga_ocr_tpu_torch.detect import text_detect as ttd
from manga_ocr_tpu_torch.engine import latin as tlatin
from manga_ocr_tpu_torch.models import convert_latin as tconv
from manga_ocr_tpu_torch.models import craft as tcraft
from manga_ocr_tpu_torch.models import crnn as tcrnn
from manga_ocr_tpu_torch.parallel.mesh import make_mesh
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JCRAFT, JCRNN = jtwin.CRAFT_CFG, jtwin.CRNN_CFG
TCRAFT = tcraft.CraftConfig(vgg_channels=(4, 8, 16, 32, 32, 64), head_channels=8)
TCRNN = tcrnn.CrnnConfig(num_classes=13, output_channel=32, hidden_size=16)
CHARSET = "0123456789ab"  # 12 characters + blank = 13 classes
BUCKETS = dict(det_buckets=(32, 64, 128), rec_width_buckets=(32, 64))
# f32 on both sides, summation order only: ~20 convolutions (CRAFT), 7 convs
# and two BiLSTMs (CRNN; cuDNN's or ATen's LSTM against lax.scan)
CRAFT_ATOL = 1e-5
CRNN_ATOL = 1e-5
LSTM_ATOL = 1e-6
# with the maps and logits held within those bounds, only a score map pixel
# within SCORE_TOL of a threshold, or a column whose top two logits lie
# within LOGIT_TOL, can part the packages' boxes or strings
SCORE_TOL = CRAFT_ATOL
LOGIT_TOL = 2 * CRNN_ATOL


def _craft_tree():
    """The port's numpy init with its kernels at He-normal's gain (sqrt(6) on
    the +-1/sqrt(fan) uniform draws: at JAX's own init the maps collapse to a
    constant through ~20 ReLU layers) and the region head's bias raised, so
    the maps cross every threshold on the test pages."""
    tree = tcraft.init_craft_params_numpy(TCRAFT, 0)
    for leaf in jax.tree.leaves(tree):
        if leaf.ndim == 4:
            leaf *= np.float32(np.sqrt(6.0))
    tree["conv_cls"][4]["bias"][0] += np.float32(0.6)
    return tree


def _crnn_tree():
    return tcrnn.init_crnn_params_numpy(TCRNN, 0)


def _pages():
    """Light pages with dark bars (glyph-like ink), in each detection bucket
    and one oversized (downscaled into the largest)."""
    rng = np.random.default_rng(5)
    pages = []
    for h, w in ((24, 30), (30, 18), (50, 60), (90, 70), (150, 100)):
        page = np.full((h, w, 3), 240, np.uint8)
        for _ in range(max(2, h * w // 300)):
            y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
            page[y:y + int(rng.integers(3, 6)), x:x + int(rng.integers(4, 16))] = 15
        pages.append(page)
    return pages


@pytest.fixture(scope="module")
def engines():
    ctree, rtree = _craft_tree(), _crnn_tree()
    j = jlatin.TpuLatinEngine(craft_params=jax.tree.map(jnp.asarray, ctree),
                              crnn_params=jax.tree.map(jnp.asarray, rtree), charset=CHARSET,
                              craft_cfg=JCRAFT, crnn_cfg=JCRNN, **BUCKETS)
    t = tlatin.TorchLatinEngine(tcraft.params_from_jax(ctree), tcrnn.params_from_jax(rtree),
                                charset=CHARSET, craft_cfg=TCRAFT, crnn_cfg=TCRNN, device="cpu",
                                **BUCKETS)
    return j, t


# -- the models -----------------------------------------------------------------------


def test_configs_match_jax():
    for t, j in ((tcraft.CraftConfig(), jcraft.CraftConfig()), (TCRAFT, JCRAFT),
                 (tcrnn.CrnnConfig(), jcrnn.CrnnConfig()), (TCRNN, JCRNN)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TCRNN.stage_channels == JCRNN.stage_channels
    assert tlatin.DEFAULT_CHARSET == jlatin.DEFAULT_CHARSET
    assert (tlatin._DET_BUCKETS, tlatin._REC_WIDTH_BUCKETS) == (jlatin._DET_BUCKETS,
                                                               jlatin._REC_WIDTH_BUCKETS)


@pytest.mark.parametrize("name", ["craft", "crnn"])
def test_trees_match_jax_init(name):
    tmod, jshape = {
        "craft": (tcraft, lambda: jcraft.init_craft_params(JCRAFT, jax.random.PRNGKey(0))),
        "crnn": (tcrnn, lambda: jcrnn.init_crnn_params(JCRNN, jax.random.PRNGKey(0)))}[name]
    tree = _craft_tree() if name == "craft" else _crnn_tree()
    want = jax.eval_shape(jshape)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    for a, b in zip(jax.tree.leaves(tmod.params_to_jax(tmod.params_from_jax(tree))),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(32, 48), (64, 64)], ids=str)
def test_craft_forward_matches_jax(hw):
    tree = _craft_tree()
    pages = np.random.default_rng(hw[1]).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    x = np.asarray(jcraft.normalize_images(jnp.asarray(pages)))
    np.testing.assert_allclose(
        tcraft.normalize_images(torch.from_numpy(pages)).numpy(), x, rtol=0, atol=1e-6)
    want = np.asarray(jax.jit(jcraft.craft_forward)(jax.tree.map(jnp.asarray, tree),
                                                    jnp.asarray(x)))
    got = tcraft.craft_forward(tcraft.params_from_jax(tree),
                               torch.from_numpy(x.copy()).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 2, hw[0] // 2, hw[1] // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=CRAFT_ATOL)
    region, affinity = tcraft.detect_maps(tcraft.params_from_jax(tree), pages)
    np.testing.assert_allclose(region.numpy(), want[..., 0], rtol=0, atol=CRAFT_ATOL)
    np.testing.assert_allclose(affinity.numpy(), want[..., 1], rtol=0, atol=CRAFT_ATOL)


@pytest.mark.parametrize("size", [(12, 10), (7, 8), (3, 4)], ids=str)
def test_upsample_is_jax_gather(size):
    """``F.interpolate(bilinear, align_corners=False)`` against JAX's gather
    formulation, up (whole and fractional ratios) and down."""
    x = np.random.default_rng(0).normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = np.asarray(jcraft._upsample_to(jnp.asarray(x), size))
    got = tcraft._upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("width", [44, 64], ids=str)
def test_crnn_forward_matches_jax(width):
    tree = _crnn_tree()
    x = np.random.default_rng(width).normal(size=(3, 32, width, 1)).astype(np.float32)
    x[0, :, width // 2:] = -1.0  # a short line padded with white, as the engine pads
    want = np.asarray(jax.jit(jcrnn.crnn_forward)(jax.tree.map(jnp.asarray, tree),
                                                  jnp.asarray(x)))
    got = tcrnn.crnn_forward(tcrnn.params_from_jax(tree), torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == want.shape == (3, width // 4 - 1, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CRNN_ATOL)
    net = tcrnn.Crnn(tcrnn.params_from_jax(tree))
    np.testing.assert_array_equal(
        tcrnn.crnn_forward(net, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), got.numpy())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_lstm_scan_matches_jax(reverse):
    rng = np.random.default_rng(2)
    p = {"w_ih": rng.uniform(-0.4, 0.4, (6, 20)).astype(np.float32),
         "w_hh": rng.uniform(-0.4, 0.4, (5, 20)).astype(np.float32),
         "bias": rng.uniform(-0.4, 0.4, (20,)).astype(np.float32)}
    x = rng.normal(size=(3, 9, 6)).astype(np.float32)
    want = np.asarray(jcrnn._lstm_scan(jax.tree.map(jnp.asarray, p), jnp.asarray(x), reverse))
    tp = {"w_ih": torch.from_numpy(p["w_ih"].T.copy()), "w_hh": torch.from_numpy(p["w_hh"].T.copy()),
          "bias": torch.from_numpy(p["bias"])}
    state = torch.random.get_rng_state()
    got = tcrnn._lstm_scan(tp, torch.from_numpy(x), reverse)
    assert torch.equal(state, torch.random.get_rng_state())  # meta-built: no default init drawn
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LSTM_ATOL)
    # the backward direction depends on the columns after t: it sees the padding
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = tcrnn._lstm_scan(tp, torch.from_numpy(x2), reverse).numpy()
    assert (np.abs(moved[:, 0] - got.numpy()[:, 0]).max() > 1e-4) == reverse


def test_ctc_greedy_matches_jax():
    logits = np.random.default_rng(3).normal(size=(4, 12, 5)).astype(np.float32)
    for lengths in (None, np.array([12, 5, 1, 0])):
        assert tcrnn.ctc_greedy(logits, lengths) == jcrnn.ctc_greedy(logits, lengths)
        assert tcrnn.ctc_greedy(logits, lengths, 2) == jcrnn.ctc_greedy(logits, lengths, 2)


# -- the converters ----------------------------------------------------------------------


def _materialize(module, seed):
    g = torch.Generator().manual_seed(seed)
    module = module.to_empty(device="cpu")
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith("num_batches_tracked"):
                t.zero_()
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=g)
            else:
                bn = name.rsplit(".", 1)[0] in {n for n, m in module.named_modules()
                                                if isinstance(m, torch.nn.BatchNorm2d)}
                if bn and name.endswith(".weight"):
                    t.uniform_(0.5, 1.5, generator=g)
                else:
                    t.uniform_(-0.3, 0.3, generator=g)
    return module.eval()


@pytest.fixture(scope="module")
def twins():
    state = torch.random.get_rng_state()
    with torch.device("meta"):
        craft, crnn = jtwin.TorchCraft(JCRAFT), jtwin.TorchCrnn(JCRNN)
    twins = _materialize(craft, 0), _materialize(crnn, 1)
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG untouched
    return twins


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_converters_bit_for_bit(twins, tmp_path):
    craft, crnn = twins
    for twin, tfn, jfn in ((craft, tconv.convert_craft_state_dict, jconv.convert_craft_state_dict),
                           (crnn, tconv.convert_crnn_state_dict, jconv.convert_crnn_state_dict)):
        sd = twin.state_dict()
        _same_tree(tfn(sd), jfn(sd))
        _same_tree(tfn({f"module.{k}": v.numpy() for k, v in sd.items()}), jfn(sd))
        path = str(tmp_path / "w.pth")
        torch.save({"state_dict": sd}, path)
        _same_tree(tfn(tconv.load_torch_checkpoint(path)), jfn(jconv.load_torch_checkpoint(path)))
    assert tconv.BN_EPS == jconv.BN_EPS == 1e-5
    assert tconv.CRAFT_VGG_SLICES == jconv.CRAFT_VGG_SLICES


def test_converted_weights_match_the_twins(twins):
    """The converted weights against the twins' own forwards.  The CRAFT
    twin's ReLUs run out of place here: upstream's ``ReLU(inplace=True)``
    at the head of slices 2-4 rewrites the previous slice's output, so its
    skips s1-s3 reach the decoder after the ReLU, where the JAX package's
    ``craft_forward`` (and so the port's) takes them before it."""
    craft, crnn = twins
    x = np.random.default_rng(0).normal(size=(2, 3, 32, 48)).astype(np.float32)
    relus = [m for m in craft.modules() if isinstance(m, torch.nn.ReLU)]
    for m in relus:
        m.inplace = False
    try:
        with torch.no_grad():
            want = craft(torch.from_numpy(x)).numpy()
    finally:
        for m in relus:
            m.inplace = True
    got = tcraft.craft_forward(tcraft.params_from_jax(tconv.convert_craft_state_dict(
        craft.state_dict())), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CRAFT_ATOL)
    x = np.random.default_rng(1).normal(size=(3, 1, 32, 44)).astype(np.float32)
    with torch.no_grad():
        want = crnn(torch.from_numpy(x)).numpy()
    got = tcrnn.crnn_forward(tcrnn.params_from_jax(tconv.convert_crnn_state_dict(
        crnn.state_dict())), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# -- the engine ----------------------------------------------------------------------------


def _near_scores(engine, images):
    """Score-map pixels within SCORE_TOL of a threshold on JAX's maps (the
    part of each map that ``_boxes_from_maps`` reads)."""
    cfg = engine.craft_cfg
    n = 0
    for img in images:
        rgb, side, h, w, _ = engine._prep_for_detection(np.asarray(img))
        padded = np.zeros((1, side, side, 3), np.uint8)
        padded[0, :h, :w] = rgb
        region, affinity = (np.asarray(m[0])[: (h + 1) // 2, : (w + 1) // 2]
                            for m in engine._craft(engine.craft_params, padded))
        n += int((np.abs(region - cfg.low_text) <= SCORE_TOL).sum()
                 + (np.abs(region - cfg.text_threshold) <= SCORE_TOL).sum()
                 + (np.abs(affinity - cfg.link_threshold) <= SCORE_TOL).sum())
    return n


def test_detect_boxes_batch_matches_jax(engines):
    j, t = engines
    pages = _pages()
    rgb = [p[..., ::-1].copy() for p in pages]
    got, want = t.detect_boxes_batch(rgb), j.detect_boxes_batch(rgb)
    near = _near_scores(j, rgb)
    print(f"boxes per page {[len(b) for b in want]}; {near} score pixels within {SCORE_TOL} "
          f"of a threshold")
    assert sum(len(b) for b in want) >= 4
    assert near == 0  # the inputs are fixed: a score this close to a threshold fails loudly
    assert got == want
    assert [t.detect_boxes(r) for r in rgb] == got  # bucketed == one image at a time


def test_detect_boxes_batch_splits_buckets(engines, monkeypatch):
    """A bucket's pages go to CRAFT in dispatches of at most DISPATCH_PAGES
    pages and DISPATCH_PIXELS pixels (at least one page each), and the boxes
    do not depend on the split."""
    _, t = engines
    rgb = [p[..., ::-1].copy() for p in _pages()] * 3  # buckets 32: 6 pages, 64: 3, 128: 6
    whole = t.detect_boxes_batch(rgb)
    sizes = []
    maps = t.detect_maps
    monkeypatch.setattr(t, "detect_maps", lambda batch: sizes.append(batch.shape[:2]) or maps(batch))
    monkeypatch.setattr(tlatin, "DISPATCH_PIXELS", 2 * 32 * 32)
    assert t.detect_boxes_batch(rgb) == whole
    assert sizes == [(2, 32)] * 3 + [(1, 64)] * 3 + [(1, 128)] * 6
    sizes.clear()
    monkeypatch.setattr(tlatin, "DISPATCH_PIXELS", 128 * 128)
    assert t.detect_boxes_batch(rgb) == whole
    assert sizes == [(4, 32), (2, 32), (3, 64)] + [(1, 128)] * 6


def _crops():
    rng = np.random.default_rng(6)
    crops = []
    for h, w in ((12, 30), (20, 100), (32, 200), (9, 9), (0, 5), (16, 40)):
        crop = np.full((h, w), 235, np.uint8)
        for _ in range(w // 6):
            x = int(rng.integers(0, max(1, w - 3)))
            crop[h // 4: 3 * h // 4, x:x + 3] = int(rng.integers(0, 80))
        crops.append(crop)
    return crops


def _near_logits(engine, crops):
    """Valid columns whose top two JAX logits lie within LOGIT_TOL."""
    n = 0
    ih = engine.crnn_cfg.input_height
    for crop in crops:
        if 0 in crop.shape:
            continue
        nw = max(8, int(round(crop.shape[1] * ih / crop.shape[0])))
        bucket = jlatin._round_up(nw, engine.rec_width_buckets)
        nw = min(nw, bucket)
        batch = np.zeros((1, ih, bucket, 1), np.float32)
        batch[0, :, :nw, 0] = jlatin._resize_gray(crop, (ih, nw))
        logits = np.asarray(engine._crnn(engine.crnn_params, jnp.asarray((batch / 255.0 - 0.5)
                                                                         / 0.5)))[0]
        top = np.sort(logits[: max(nw // 4 - 1, 1)], -1)
        n += int((top[:, -1] - top[:, -2] <= LOGIT_TOL).sum())
    return n


def test_recognize_lines_matches_jax(engines):
    j, t = engines
    crops = _crops()
    got, want = t.recognize_lines(crops), j.recognize_lines(crops)
    near = _near_logits(j, crops)
    print(f"strings {want}; {near} columns with a top-two logit gap within {LOGIT_TOL}")
    assert len(got) == len(crops) and got[4] == ""
    assert near == 0
    assert got == want
    assert t.recognize_lines([]) == []


def test_readtext_and_perform_ocr_match_jax(engines):
    j, t = engines
    pages = _pages()
    near = _near_scores(j, [p[..., ::-1].copy() for p in pages])
    assert near == 0
    for page in pages:
        assert t.readtext(page) == j.readtext(page)
        assert t.perform_ocr(page) == j.perform_ocr(page)
        assert not t.perform_ocr(page[..., 0]).startswith("[ERROR")  # gray accepted
    bad = t.perform_ocr(np.zeros((4, 4, 5), np.uint8))
    assert bad.startswith("[ERROR") and j.perform_ocr(np.zeros((4, 4, 5), np.uint8)).startswith(
        "[ERROR")


def test_text_mode_on_the_engine_matches_jax(engines):
    j, t = engines
    page = np.full((100, 120, 3), 240, np.uint8)  # two rows of glyph-like bars
    for y in (10, 80):
        for x in range(8, 60, 7):
            page[y:y + 6, x:x + 4] = 15
    seen = {}

    def reader(name):
        def ocr_page(crops):
            seen[name] = [c.shape for c in crops]
            return [f"LINE {i} OF TEXT" for i in range(len(crops))]
        return ocr_page

    got = ttd.detect_text_regions(page, reader("t"), proposer=ttd.craft_proposer(t))
    want = jtd.detect_text_regions(page, reader("j"), proposer=jtd.craft_proposer(j))
    near = _near_scores(j, [page[..., ::-1].copy()])
    print(f"text mode: {len(seen.get('j', []))} proposals, {len(want)} regions; {near} score "
          f"pixels near a threshold")
    assert near == 0
    assert seen.get("t") and seen.get("t") == seen.get("j")
    assert [x for x, _ in got] == [x for x, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_from_checkpoints_and_refusals(twins, tmp_path):
    craft, crnn = twins
    torch.save(craft.state_dict(), tmp_path / "craft.pth")
    torch.save(crnn.state_dict(), tmp_path / "crnn.pth")
    kw = dict(craft_cfg=JCRAFT, **BUCKETS)
    j = jlatin.TpuLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"),
                                               str(tmp_path / "crnn.pth"), charset=CHARSET, **kw)
    t = tlatin.TorchLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"),
                                                 str(tmp_path / "crnn.pth"), charset=CHARSET,
                                                 device="cpu", **dict(kw, craft_cfg=TCRAFT))
    assert dataclasses.asdict(t.crnn_cfg) == dataclasses.asdict(j.crnn_cfg)
    _same_tree(tcraft.params_to_jax(t.craft_params), j.craft_params)
    _same_tree(tcrnn.params_to_jax(t.crnn_params), j.crnn_params)
    page = _pages()[2]
    assert isinstance(t.perform_ocr(page), str) and not t.perform_ocr(page).startswith("[ERROR")
    with pytest.raises(ValueError, match="charset"):
        tlatin.TorchLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"),
                                                 str(tmp_path / "crnn.pth"), device="cpu")
    # a CRNN checkpoint directory (train_latin.save_crnn_checkpoint): the
    # manifest's config and charset, an explicit charset over it, JAX's tree
    crnn_dir = str(tmp_path / "crnn_dir")
    ttl.save_crnn_checkpoint(crnn_dir, t.crnn_params, t.crnn_cfg, CHARSET)
    kw_dir = dict(kw, craft_cfg=TCRAFT)
    d = tlatin.TorchLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"), crnn_dir,
                                                 device="cpu", **kw_dir)
    jd = jlatin.TpuLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"), crnn_dir, **kw)
    assert d.charset == jd.charset == CHARSET
    assert dataclasses.asdict(d.crnn_cfg) == dataclasses.asdict(jd.crnn_cfg)
    _same_tree(tcrnn.params_to_jax(d.crnn_params), jd.crnn_params)
    _same_tree(tcrnn.params_to_jax(d.crnn_params), j.crnn_params)
    other = "abcdefghijkl"
    assert tlatin.TorchLatinEngine.from_checkpoints(
        str(tmp_path / "craft.pth"), crnn_dir, charset=other, device="cpu", **kw_dir
    ).charset == other
    with pytest.raises(ValueError, match="charset"):
        tlatin.TorchLatinEngine.from_checkpoints(str(tmp_path / "craft.pth"), crnn_dir,
                                                 charset="abc", device="cpu", **kw_dir)
    assert d.perform_ocr(page) == t.perform_ocr(page)
    with pytest.raises(ValueError, match="mesh"):  # a CUDA mesh under device="cpu"
        tlatin.TorchLatinEngine(mesh=make_mesh(2, devices=[torch.device("cuda", 0)] * 2),
                                device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        tlatin.TorchLatinEngine(charset="abc", crnn_cfg=TCRNN, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlatin.TorchLatinEngine()  # the default device is "cuda"


def test_random_init_is_the_ports_numpy_init():
    state = torch.random.get_rng_state()
    t = tlatin.TorchLatinEngine(craft_cfg=TCRAFT, crnn_cfg=TCRNN, charset=CHARSET, device="cpu",
                                **BUCKETS)
    _same_tree(tcraft.params_to_jax(t.craft_params), tcraft.init_craft_params_numpy(TCRAFT, 0))
    _same_tree(tcrnn.params_to_jax(t.crnn_params), tcrnn.init_crnn_params_numpy(TCRNN, 0))
    assert isinstance(t.perform_ocr(_pages()[0]), str)
    assert torch.equal(state, torch.random.get_rng_state())
