"""The port's YOLOv8-seg (``models/yolo_seg.py``, ``models/convert_yolo.py``)
against the JAX package's at the JAX tests' tiny config (input 64, widths
4..64, 8 masks): ``forward`` and ``infer`` on the same numpy weights
(``params_from_jax``) within ``PRED_ATOL``; ``postprocess`` on a planted
instance (the same host NumPy: equal); ``YoloBubbleDetector`` end to end,
its instances and masks equal, with the scores, overlaps and mask values
that lie within the tolerance of a threshold counted, printed and required
to be none; the converter bit for
bit on one state dict of a twin with the ultralytics parameter names (also
through ``convert_yolo_file`` and the ``model.model.`` prefix), and the
converted weights against the twin's own forward; ``.npz`` files across
packages both ways.  The twin is built on the meta device and filled from
an explicit ``torch.Generator``: torch's global RNG is never drawn."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_convert_yolo as jtwin  # noqa: E402  (the JAX tests' ultralytics twin)
from manga_ocr_tpu.models import convert_yolo as jconv
from manga_ocr_tpu.models import yolo_seg as jys
from manga_ocr_tpu_torch.models import convert_yolo as tconv
from manga_ocr_tpu_torch.models import detector as tseg
from manga_ocr_tpu_torch.models import yolo_seg as tys
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JCFG = jtwin.CFG  # input 64, width (4, 8, 16, 32, 64), depth 1s, 8 masks, reg_max 4
TCFG = tys.YoloSegConfig(input_size=64, width=(4, 8, 16, 32, 64), depth=(1, 1, 1, 1),
                         num_masks=8, reg_max=4)
# f32 on both sides through ~60 convolutions: summation order only
PRED_ATOL = 1e-4
NEAR = 1e-4  # a score, IoU or mask probability this close to its threshold may flip
# a box is the DFL expectation times the stride (up to 32) scaled to the page:
# PRED_ATOL on the logits moves it by at most ~stride * PRED_ATOL
BOX_ATOL = 32 * PRED_ATOL


def _tree(seed=0):
    """He-normal weights plus random biases (a swapped axis shows)."""
    tree = tys.init_params_numpy(TCFG, seed)
    rng = np.random.default_rng(seed + 100)
    for leaf in jax.tree.leaves(tree):
        if leaf.ndim == 1:
            leaf += rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def jinfer():
    return jax.jit(lambda p, x: jys.infer(p, x, JCFG))


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(tys.YoloSegConfig()) == dataclasses.asdict(jys.YoloSegConfig())
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)


def test_tree_matches_jax_init(tree):
    want = jax.eval_shape(lambda: jys.init_params(JCFG, jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    back = tys.params_to_jax(tys.params_from_jax(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_forward_matches_jax(tree):
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    jp, jq = jax.jit(lambda p, x: jys.forward(p, x, JCFG))(jax.tree.map(jnp.asarray, tree),
                                                          jnp.asarray(x))
    tp, tq = tys.forward(tys.params_from_jax(tree), torch.from_numpy(x).permute(0, 3, 1, 2),
                         TCFG)
    n_cells = 8 * 8 + 4 * 4 + 2 * 2
    assert tuple(tp.shape) == jp.shape == (2, n_cells, 4 * 4 + 1 + 8)
    assert tuple(tq.shape) == jq.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=PRED_ATOL)
    # a transposed kernel still runs: only asymmetric weights catch it
    bad = tys.params_from_jax(tree)
    bad["c2f2"]["m"][0]["cv1"]["kernel"] = bad["c2f2"]["m"][0]["cv1"]["kernel"].transpose(2, 3)
    wrong, _ = tys.forward(bad, torch.from_numpy(x).permute(0, 3, 1, 2), TCFG)
    assert np.abs(wrong.numpy() - np.asarray(jp)).max() > 10 * PRED_ATOL


def test_infer_matches_jax(tree, jinfer):
    pages = np.random.default_rng(1).integers(0, 256, (2, 100, 80, 3), dtype=np.uint8)
    jp, jq = jinfer(jax.tree.map(jnp.asarray, tree), jnp.asarray(pages))
    tp, tq = tys.infer(tys.params_from_jax(tree), pages, TCFG)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=PRED_ATOL)


def _planted():
    """The JAX test's planted instance: one confident P3 cell at (32, 32)."""
    anchors, _ = jys._grid_anchors(JCFG.input_size)
    no = 4 * JCFG.reg_max + JCFG.num_classes + JCFG.num_masks
    preds = np.full((len(anchors), no), -10.0, np.float32)
    idx = int(np.argmin(np.abs(anchors[:, 0] - 32) + np.abs(anchors[:, 1] - 32)))
    box_logits = np.full((4, JCFG.reg_max), -10.0, np.float32)
    box_logits[:, 1] = 10.0
    preds[idx, : 4 * JCFG.reg_max] = box_logits.ravel()
    preds[idx, 4 * JCFG.reg_max] = 8.0
    preds[idx, 4 * JCFG.reg_max + JCFG.num_classes:] = 5.0
    return preds, np.full((16, 16, JCFG.num_masks), 0.5, np.float32)


def _same_instances(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["box"], w["box"])
        assert g["score"] == w["score"]
        np.testing.assert_array_equal(g["mask"], w["mask"])


def test_postprocess_planted_instance_matches_jax():
    preds, protos = _planted()
    got = tys.postprocess(preds, protos, TCFG, 64, 64)
    _same_instances(got, jys.postprocess(preds, protos, JCFG, 64, 64))
    assert len(got) == 1 and got[0]["mask"][32, 32] and not got[0]["mask"][5, 60]
    _same_instances(tys.postprocess(preds, protos, TCFG, 90, 70),
                    jys.postprocess(preds, protos, JCFG, 90, 70))
    np.testing.assert_array_equal(tys.combined_bubble_mask(got, 64, 64),
                                  jys.combined_bubble_mask(got, 64, 64))


def _near_counts(preds, protos, cfg):
    """On JAX's outputs, where the two packages may part: the scores within
    NEAR of ``conf_threshold``, and among the candidates that pass it the
    pairwise IoUs within NEAR of ``iou_threshold`` and the mask
    probabilities within NEAR of ``mask_threshold``."""
    rm, nc = cfg.reg_max, cfg.num_classes
    scores = 1.0 / (1.0 + np.exp(-preds[:, 4 * rm: 4 * rm + nc].max(-1)))
    cand = scores >= cfg.conf_threshold
    anchors, strides = jys._grid_anchors(cfg.input_size)
    logits = preds[cand, : 4 * rm].reshape(-1, 4, rm)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    dist = (e / e.sum(-1, keepdims=True) * np.arange(rm)).sum(-1) * strides[cand, None]
    boxes = np.concatenate([anchors[cand] - dist[:, :2], anchors[cand] + dist[:, 2:]], -1)
    lo, hi = np.maximum(boxes[:, None, :2], boxes[None, :, :2]), np.minimum(boxes[:, None, 2:],
                                                                          boxes[None, :, 2:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    area = (boxes[:, 2:] - boxes[:, :2]).prod(-1)
    iou = inter / np.maximum(area[:, None] + area[None] - inter, 1e-9)
    near_iou = int(np.triu(np.abs(iou - cfg.iou_threshold) <= NEAR, 1).sum())
    m = 1.0 / (1.0 + np.exp(-(protos.reshape(-1, protos.shape[-1]) @ preds[cand, 4 * rm + nc:].T)))
    return {"candidates": int(cand.sum()),
            "scores": int((np.abs(scores - cfg.conf_threshold) <= NEAR).sum()),
            "ious": near_iou, "mask": int((np.abs(m - cfg.mask_threshold) <= NEAR).sum())}


@pytest.mark.parametrize("cls_bias,coeff_bias", [(0.0, 0.0), (-1.21, 1.0)],
                         ids=["random heads", "lowered cls bias"])
def test_detector_end_to_end_matches_jax(tree, cls_bias, coeff_bias, jinfer):
    """``YoloBubbleDetector`` on a page as drawn (all 84 anchors pass) and
    with the cls bias lowered and the mask coefficients' raised (16
    candidates, partial masks): each side's instances from its
    own ``infer`` agree (count, boxes within BOX_ATOL, scores within
    PRED_ATOL, masks exactly) and the OR-ed masks are equal.  The page is
    fixed, so a score, IoU or mask probability within NEAR of its threshold
    fails the test rather than excusing a difference."""
    tree = jax.tree.map(np.copy, tree)
    for branch in tree["heads"]["cls"]:
        branch["out"]["bias"] += np.float32(cls_bias)
    for branch in tree["heads"]["coeff"]:
        branch["out"]["bias"] += np.float32(coeff_bias)
    page = np.random.default_rng(2).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    tdet = tys.YoloBubbleDetector(tys.params_from_jax(tree), TCFG, device="cpu")
    jdet = jys.YoloBubbleDetector(jax.tree.map(jnp.asarray, tree), JCFG)
    got, want = tdet.detect_bubble_mask(page), jdet.detect_bubble_mask(page)
    jp, jq = (np.asarray(a[0]) for a in jinfer(jdet.params, jnp.asarray(page[None, ..., ::-1])))
    tp, tq = (a[0].numpy() for a in tys.infer(tdet.params, page[None, ..., ::-1].copy(), TCFG))
    near = _near_counts(jp, jq, JCFG)
    tinst, jinst = tys.postprocess(tp, tq, TCFG, 90, 70), jys.postprocess(jp, jq, JCFG, 90, 70)
    print(f"cls bias {cls_bias}, coeff bias {coeff_bias}: within {NEAR} of a threshold {near}; "
          f"{len(jinst)} instances, mask pixels {[int(i['mask'].sum()) for i in jinst]}; "
          f"{int((got != want).sum())} of {got.size} pixels differ, {int((want > 0).sum())} set")
    assert got.shape == (90, 70) and got.dtype == np.uint8 and near["candidates"]
    assert near["scores"] == near["ious"] == near["mask"] == 0
    assert len(tinst) == len(jinst)
    for g, w in zip(tinst, jinst):
        np.testing.assert_allclose(g["box"], w["box"], rtol=0, atol=BOX_ATOL)
        assert abs(g["score"] - w["score"]) <= PRED_ATOL
        np.testing.assert_array_equal(g["mask"], w["mask"])
    assert any(0 < i["mask"].sum() < i["mask"].size for i in jinst)
    np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tys.YoloBubbleDetector(tys.params_from_jax(tree), TCFG)  # the default is "cuda"


# -- the converter --------------------------------------------------------------------


def _materialize(module, seed):
    """A twin built on the meta device, its weights and BN statistics drawn
    from an explicit generator (never torch's global RNG)."""
    g = torch.Generator().manual_seed(seed)
    module = module.to_empty(device="cpu")
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith("num_batches_tracked"):
                t.zero_()
            elif name.endswith(("running_var", "bn.weight")):
                t.uniform_(0.5, 1.5, generator=g)
            else:
                t.normal_(0.0, 0.1, generator=g)
    return module.eval()


@pytest.fixture(scope="module")
def twin():
    state = torch.random.get_rng_state()
    with torch.device("meta"):
        twin = jtwin.TwinYolo(JCFG)
    twin = _materialize(twin, 0)
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG untouched
    return twin


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_converter_bit_for_bit(twin, tmp_path):
    want = jconv.convert_yolo_torch(twin, JCFG)
    _same_tree(tconv.convert_yolo_torch(twin, TCFG), want)
    sd = twin.state_dict()
    _same_tree(tconv.convert_yolo_state_dict({k: v.numpy() for k, v in sd.items()}, TCFG), want)
    # an ultralytics full checkpoint's names, and a saved file of them
    nested = {f"model.{k}": v for k, v in sd.items()}
    _same_tree(tconv.convert_yolo_torch(nested, TCFG), want)
    path = str(tmp_path / "yolo.pt")
    torch.save(nested, path)
    _same_tree(tconv.convert_yolo_file(path, TCFG), jconv.convert_yolo_file(path, JCFG))
    assert tconv.BN_EPS == jconv.BN_EPS == 1e-3


def test_converted_weights_match_the_twin(twin):
    params = tys.params_from_jax(tconv.convert_yolo_torch(twin, TCFG))
    x = np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want_p, want_q = twin(torch.from_numpy(x))
    got_p, got_q = tys.forward(params, torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(got_p.numpy(), want_p.numpy(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got_q.numpy(), want_q.permute(0, 2, 3, 1).numpy(), rtol=1e-3,
                               atol=2e-3)


def test_npz_across_packages(tree, tmp_path, monkeypatch):
    tpath, jpath, cpath = (str(tmp_path / n) for n in ("t.npz", "j.npz", "c.npz"))
    # JAX's load_params fills its PRNGKey(0) init as a template: its shapes
    # are all it reads (eager, that init takes ~25 s on one core)
    init = jys.init_params
    monkeypatch.setattr(jys, "init_params",
                        lambda cfg, key, dtype=jnp.float32: jax.eval_shape(
                            lambda: init(cfg, key, dtype)))
    tys.save_params(tys.params_from_jax(tree), tpath)
    _same_tree(jax.tree.map(np.asarray, jys.load_params(tpath, JCFG)), tree)
    jys.save_params(jax.tree.map(jnp.asarray, tree), jpath)
    _same_tree(tys.params_to_jax(tys.load_params(jpath, TCFG)), tree)
    # a converted tree through the shared writer
    tseg.save_npz(tree, cpath)
    _same_tree(tys.params_to_jax(tys.load_params(cpath, TCFG)), tree)
    with pytest.raises(ValueError, match="shape"):
        tys.load_params(tpath, tys.YoloSegConfig(input_size=64, width=(8, 8, 16, 32, 64),
                                                 depth=(1, 1, 1, 1), num_masks=8, reg_max=4))
