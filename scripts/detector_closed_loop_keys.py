"""The detection closed loop from several initial weights, in both packages.

``tests/test_detect_closed_loop.py`` trains the JAX bubble segmenter from
``init_params(cfg, PRNGKey(0))`` for 150 Adam steps and holds held-out
96x128 pages to exact bubble counts, IoU >= 0.6 a page and >= 0.75 on
average; ``tests/test_torch_detect_closed_loop.py`` holds the port's trainer
to the same bounds from the same init.  This script runs that recipe from
``PRNGKey(k)`` for each ``--keys`` entry: the JAX loop as the JAX test runs
it (jitted ``optax.adam``), and the port's ``train_segmenter`` from the same
init on ``--threads`` CPU threads, each served through its own package's
``BubbleDetector.detect_pages``.  It prints one line per key and package:
the last loss, the counts against the drawn ones, the IoU per page and
their mean, and whether the test's bounds hold.  CPU only:

    JAX_PLATFORMS=cpu python scripts/detector_closed_loop_keys.py --keys 0 1 2 3
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def held_out_pages(draw_page, hw):
    """The closed-loop test's six held-out pages (``default_rng(42)``)."""
    rng = np.random.default_rng(42)
    pages, gts, counts = [], [], []
    while len(pages) < 6:
        bgr, gt, n = draw_page(rng, *hw)
        if n:
            pages.append(bgr)
            gts.append(gt)
            counts.append(n)
    return pages, gts, counts


def score(results, gts, counts, fill_polygon) -> dict:
    ious, got = [], []
    for dets, gt in zip(results, gts):
        pred = np.zeros_like(gt)
        for d in dets:
            fill_polygon(pred, np.asarray(d["polygon"]), 255)
        union = np.logical_or(pred > 0, gt > 0).sum()
        ious.append(float(np.logical_and(pred > 0, gt > 0).sum() / union) if union else 1.0)
        got.append(len(dets))
    ok = got == counts and min(ious) >= 0.6 and float(np.mean(ious)) >= 0.75
    return {"counts": got, "drawn": counts, "iou": [round(v, 4) for v in ious],
            "mean": round(float(np.mean(ious)), 4), "bounds_hold": ok}


def jax_loop(init, cfg, pages_fn):
    import jax
    import jax.numpy as jnp
    import optax

    from manga_ocr_tpu.detect import contours as jcont
    from manga_ocr_tpu.detect.detector import BubbleDetector
    from manga_ocr_tpu.models import detector as jseg
    from manga_ocr_tpu_torch.detect import synthetic

    params = init
    opt = optax.adam(synthetic.TRAIN_LR)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, imgs, masks):
        def loss_fn(p):
            prob = jseg.forward(p, imgs, cfg)
            eps = 1e-6
            bce = -(masks * jnp.log(prob + eps) + (1 - masks) * jnp.log(1 - prob + eps))
            return bce.mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(synthetic.TRAIN_SEED)
    s = cfg.input_size
    for _ in range(synthetic.TRAIN_STEPS):
        pages, masks = [], []
        for _ in range(synthetic.TRAIN_BATCH):
            bgr, gt, _ = synthetic.draw_page(rng, s, s)
            pages.append(bgr[..., ::-1] / 255.0)
            masks.append(gt / 255.0)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(np.stack(pages), jnp.float32),
                                       jnp.asarray(np.stack(masks), jnp.float32))
    pages, gts, counts = pages_fn()
    results = BubbleDetector(params, cfg, min_area=80.0).detect_pages(pages)
    return float(loss), score(results, gts, counts, jcont.fill_polygon)


def port_loop(init_np, threads: int, pages_fn):
    import torch

    from manga_ocr_tpu_torch.detect import contours as tcont
    from manga_ocr_tpu_torch.detect import synthetic
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector
    from manga_ocr_tpu_torch.models import detector as seg

    cfg = synthetic.CLOSED_LOOP_CFG
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        net, losses = synthetic.train_segmenter(seg.params_from_jax(init_np), cfg, device="cpu")
    finally:
        torch.set_num_threads(saved)
    pages, gts, counts = pages_fn()
    results = BubbleDetector(net, cfg, min_area=80.0, device="cpu").detect_pages(pages)
    return losses[-1], score(results, gts, counts, tcont.fill_polygon)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--threads", type=int, default=1, help="the port trainer's CPU threads")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from manga_ocr_tpu.models import detector as jseg
    from manga_ocr_tpu_torch.detect import synthetic

    cfg = jseg.DetectorConfig(input_size=64, base_channels=8, depth=2)
    pages_fn = lambda: held_out_pages(synthetic.draw_page, synthetic.CLOSED_LOOP_PAGE_HW)  # noqa: E731
    for key in args.keys:
        init = jseg.init_params(cfg, jax.random.PRNGKey(key))
        init_np = jax.tree.map(np.asarray, init)
        loss, res = jax_loop(init, cfg, pages_fn)
        print(f"PRNGKey({key}) jax: loss {loss:.4f} {res}", flush=True)
        loss, res = port_loop(init_np, args.threads, pages_fn)
        print(f"PRNGKey({key}) port ({args.threads} thread(s)): loss {loss:.4f} {res}",
              flush=True)


if __name__ == "__main__":
    main()
