"""Synthetic bubble pages and the segmenter's closed-loop trainer.

The bubble segmenter has no trained checkpoint in the repository, so the
detection path proves that it *detects* the way the JAX package's closed
loop does (``tests/test_detect_closed_loop.py``): train the U-Net from
scratch on pages with known bubble geometry (``draw_page``, the same bytes
as that test's page drawer for the same generator), then run held-out pages
through ``BubbleDetector.detect_pages`` and score them against the ground
truth.  NumPy only for the pages; the trainer is plain PyTorch in f32 with
TF32 off.  ``tests/fixtures/detector_closed_loop_init.npz`` holds that
test's initial weights (the JAX package's ``init_params`` at its config and
``PRNGKey(0)``), which both the port's closed-loop test and ``chip_smoke.py``
train from: how well 150 steps at 64×64 carry over to 96×128 pages depends
on the initial weights (see PERF.md).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from manga_ocr_tpu_torch.models import detector as seg

# The JAX closed loop's segmenter: trained at 64×64, served at 96×128.
CLOSED_LOOP_CFG = seg.DetectorConfig(input_size=64, base_channels=8, depth=2)
CLOSED_LOOP_PAGE_HW = (96, 128)


def draw_page(rng: np.random.Generator, h: int, w: int):
    """Textured page + 1-3 elliptical white bubbles with dark outlines and
    text-like marks inside AND outside (distractors).  Returns (page_bgr
    uint8, gt_mask 0/255, n_bubbles)."""
    page = rng.integers(110, 190, size=(h, w), dtype=np.int64)
    gt = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    # text-like distractor strokes on the raw background
    for _ in range(4):
        y = int(rng.integers(0, h - 2))
        x = int(rng.integers(0, w - 10))
        page[y : y + 2, x : x + 10] = int(rng.integers(0, 60))
    n = int(rng.integers(1, 4))
    placed = 0
    for _ in range(n):
        ry = int(rng.integers(h // 8, h // 5))
        rx = int(rng.integers(w // 8, min(w // 5, 2 * ry)))  # aspect < 2.5
        cy = int(rng.integers(ry + 2, h - ry - 2))
        cx = int(rng.integers(rx + 2, w - rx - 2))
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        if (gt[d <= 1.3] > 0).any():
            continue  # keep bubbles disjoint so the count is unambiguous
        page[d <= 1.15] = 30  # dark outline ring
        page[d <= 1.0] = 245  # bubble interior
        gt[d <= 1.0] = 255
        # "text" inside the bubble
        for _ in range(2):
            ty = int(np.clip(cy + rng.integers(-ry // 2, ry // 2), 1, h - 3))
            page[ty : ty + 1, cx - rx // 2 : cx + rx // 2] = 20
        placed += 1
    bgr = np.repeat(page.astype(np.uint8)[..., None], 3, axis=-1)
    return bgr, gt, placed


# The JAX closed loop's recipe: Adam at TRAIN_LR on TRAIN_BATCH fresh pages a
# step for TRAIN_STEPS steps, drawn from np.random.default_rng(TRAIN_SEED).
TRAIN_STEPS = 150
TRAIN_BATCH = 8
TRAIN_LR = 3e-3
TRAIN_SEED = 1


def train_steps(net: seg.UNet) -> Iterator[float]:
    """Train ``net`` in place by the JAX closed loop's recipe, yielding each
    step's loss after its update (one host read a step).  The convolutions
    are the only products; cuDNN runs them in f32 with TF32 off and
    deterministic algorithms: the trained net's IoU at another page size
    swings with the summation order (see the port's closed-loop test)."""
    device = net.head.weight.device
    s = net.cfg.input_size
    opt = torch.optim.Adam(net.parameters(), lr=TRAIN_LR)
    rng = np.random.default_rng(TRAIN_SEED)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for _ in range(TRAIN_STEPS):
            pages, masks = [], []
            for _ in range(TRAIN_BATCH):
                bgr, gt, _ = draw_page(rng, s, s)
                pages.append(bgr[..., ::-1] / 255.0)  # RGB float in [0,1]
                masks.append(gt / 255.0)
            x = torch.from_numpy(np.stack(pages).astype(np.float32)).to(device)
            t = torch.from_numpy(np.stack(masks).astype(np.float32)).to(device)
            prob = net(x.permute(0, 3, 1, 2))
            eps = 1e-6  # the JAX closed loop's binary cross-entropy
            loss = -(t * torch.log(prob + eps) + (1 - t) * torch.log(1 - prob + eps)).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            yield loss.item()


def train_segmenter(params: dict, cfg: seg.DetectorConfig,
                    device="cuda") -> tuple[seg.UNet, list[float]]:
    """A U-Net on ``device`` from ``params`` (the port's tree), trained by
    ``train_steps``; and the loss of every step."""
    net = seg.UNet(params, cfg).to(device)
    return net, list(train_steps(net))
