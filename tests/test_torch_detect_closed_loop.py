"""The JAX package's detection closed loop (``tests/test_detect_closed_loop.py``)
in PyTorch: train the bubble segmenter from scratch on synthetic pages with
known bubble geometry, then run held-out pages at another size through the
port's batched detection path (``BubbleDetector.detect_pages``: device
dispatch → mask → host contour trace → polygon post-processing) and hold
JAX's bounds: the exact bubble count on every page, rasterized-polygon IoU
>= 0.6 per page and >= 0.75 on average.

Both loops start from the same weights: JAX's ``init_params`` at the loop's
config and ``PRNGKey(0)``, committed as
``tests/fixtures/detector_closed_loop_init.npz`` (checked here against a
fresh JAX init) and read by the port's ``load_params``.  The pages are the
same bytes (``synthetic.draw_page`` against the JAX test's drawer).  The
trainer's first steps are held to JAX's jitted ``optax.adam`` step on that
init and those batches, loss and every leaf after each step."""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu.models import detector as jseg
from manga_ocr_tpu_torch.detect import contours as cont
from manga_ocr_tpu_torch.detect import synthetic
from manga_ocr_tpu_torch.detect.detector import BubbleDetector
from manga_ocr_tpu_torch.models import detector as seg
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_detect_closed_loop as jloop  # noqa: E402

INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "detector_closed_loop_init.npz")


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a > 0, b > 0).sum()
    union = np.logical_or(a > 0, b > 0).sum()
    return inter / union if union else 1.0


def test_config_and_pages_are_jax_loops():
    cfg = synthetic.CLOSED_LOOP_CFG
    assert (cfg.input_size, cfg.base_channels, cfg.depth) == (jloop.S, 8, 2)
    assert synthetic.CLOSED_LOOP_PAGE_HW == (jloop.PAGE_H, jloop.PAGE_W)
    for h, w in ((64, 64), (96, 128), (1700, 1200)):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            got, want = synthetic.draw_page(a, h, w), jloop._draw_page(b, h, w)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]


def test_init_fixture_is_jax_prngkey0_init():
    jcfg = jseg.DetectorConfig(input_size=64, base_channels=8, depth=2)
    want = jax.tree.map(np.asarray, jseg.init_params(jcfg, jax.random.PRNGKey(0)))
    got = seg.params_to_jax(seg.load_params(INIT, synthetic.CLOSED_LOOP_CFG))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# Three steps: at the fourth a channel of the mid block that was dead so far
# (zero gradient in both packages) comes alive on a ~1e-6 gradient, and
# Adam's normalized first step carries summation noise there to ~lr.  Over
# the first three the worst leaf gap read 9.2e-6 and the worst loss gap
# 5.2e-6 relative, on 1 and on 4 threads.
PARITY_STEPS = 3
LOSS_RTOL = 3e-5
LEAF_ATOL = 3e-5  # 1% of one step's largest move (lr = 3e-3)


def test_train_steps_match_jax_optax_adam():
    """``train_steps``' first PARITY_STEPS steps against the JAX closed
    loop's own step (its BCE under ``jax.value_and_grad`` and
    ``optax.adam(3e-3)``, jitted) from the same init on the same batches:
    each step's loss within LOSS_RTOL and every leaf after each step within
    LEAF_ATOL."""
    import optax

    cfg = synthetic.CLOSED_LOOP_CFG
    jcfg = jseg.DetectorConfig(input_size=64, base_channels=8, depth=2)
    params = jax.tree.map(jnp.asarray, seg.params_to_jax(seg.load_params(INIT, cfg)))
    opt = optax.adam(synthetic.TRAIN_LR)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, imgs, masks):
        def loss_fn(p):
            prob = jseg.forward(p, imgs, jcfg)
            eps = 1e-6
            bce = -(masks * jnp.log(prob + eps) + (1 - masks) * jnp.log(1 - prob + eps))
            return bce.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(synthetic.TRAIN_SEED)
    want_losses, want_trees = [], []
    for _ in range(PARITY_STEPS):
        pages, masks = [], []
        for _ in range(synthetic.TRAIN_BATCH):
            bgr, gt, _ = jloop._draw_page(rng, jloop.S, jloop.S)
            pages.append(bgr[..., ::-1] / 255.0)
            masks.append(gt / 255.0)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(np.stack(pages), jnp.float32),
                                       jnp.asarray(np.stack(masks), jnp.float32))
        want_losses.append(float(loss))
        want_trees.append(jax.tree.map(np.asarray, params))

    worst = 0.0
    net = seg.UNet(seg.load_params(INIT, cfg), cfg)
    with contextlib.closing(synthetic.train_steps(net)) as steps:
        for k, loss in zip(range(PARITY_STEPS), steps):
            np.testing.assert_allclose(loss, want_losses[k], rtol=LOSS_RTOL)
            got = seg.params_to_jax(net)
            assert jax.tree.structure(got) == jax.tree.structure(want_trees[k])
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_trees[k])):
                np.testing.assert_allclose(a, b, rtol=0, atol=LEAF_ATOL)
                worst = max(worst, float(np.abs(a - b).max()))
    print(f"losses {want_losses}; worst leaf gap {worst:.3e}")


@pytest.fixture(scope="module")
def trained_detector():
    """The loop's 150 steps trained on one CPU thread.  How well they carry
    over to 96x128 pages swings with the f32 summation order, which the
    thread count sets: the same run read mean IoU 0.82, 0.86, 0.70, 0.86,
    0.85, 0.65 on 1, 2, 3, 4, 6, 8 threads (every count exact).  One thread
    pins one trajectory, whatever the machine's core count."""
    cfg = synthetic.CLOSED_LOOP_CFG
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net, losses = synthetic.train_segmenter(seg.load_params(INIT, cfg), cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(losses) == 150 and all(np.isfinite(losses))
    assert losses[-1] < 0.15, f"detector failed to train (loss {losses[-1]:.3f})"
    return BubbleDetector(net, cfg, min_area=80.0, device="cpu")


def test_detect_pages_closed_loop_iou(trained_detector):
    """Held-out pages at a NON-training size through the batched production
    path: per-page rasterized-polygon IoU >= 0.6 vs ground truth, and the
    bubble count matches exactly on every page."""
    rng = np.random.default_rng(42)
    pages, gts, counts = [], [], []
    while len(pages) < 6:
        bgr, gt, n = synthetic.draw_page(rng, *synthetic.CLOSED_LOOP_PAGE_HW)
        if n == 0:
            continue
        pages.append(bgr)
        gts.append(gt)
        counts.append(n)

    results = trained_detector.detect_pages(pages)
    assert len(results) == len(pages)
    ious = []
    for dets, gt, n in zip(results, gts, counts):
        assert len(dets) == n, f"expected {n} bubbles, detected {len(dets)}"
        pred = np.zeros_like(gt)
        for det in dets:
            assert det["text"] is None  # AutoDetector schema
            cont.fill_polygon(pred, np.asarray(det["polygon"]), 255)
        ious.append(_iou(pred, gt))
    print("IoU per page", [round(float(i), 4) for i in ious])
    assert min(ious) >= 0.6, f"per-page IoU too low: {ious}"
    assert float(np.mean(ious)) >= 0.75, f"mean IoU too low: {ious}"


def test_detect_single_page_matches_batched(trained_detector):
    """detect_bubbles (single page) and detect_pages (batched) agree."""
    rng = np.random.default_rng(7)
    bgr, gt, n = synthetic.draw_page(rng, *synthetic.CLOSED_LOOP_PAGE_HW)
    single = trained_detector.detect_bubbles(bgr)
    batched = trained_detector.detect_pages([bgr], split_extended=False)[0]
    assert len(single) == len(batched)
    for a, b in zip(single, batched):
        np.testing.assert_array_equal(np.asarray(a["polygon"]), np.asarray(b["polygon"]))
