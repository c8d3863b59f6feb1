"""Closed loop at full width on one CUDA card: train ``MangaOCRConfig.base()``
from scratch on rendered glyph crops, read held-out crops through the
serving engine, and time the model with trained weights at budget 300
(kernel C's EOS exit live) against fixed-32.  Imports torch, numpy and
``manga_ocr_tpu_torch`` only.

Phases (the port of ``scripts/closed_loop_fullsize.py``):
  1. Data: kana-only texts of 1-18 characters (``tok.id_to_token[4:150]``,
     one character each, so that the decoded text compares char-exact),
     each drawn by ``train.render_text_crop`` at h in [176, 224], w in
     [104, 160] and pasted on a (224, 160) canvas, the valid region
     preprocessed by ``model_preprocess`` on the card.  A producer keeps
     rendering into a pool (from ``pool_min`` to ``pool_max`` crops) while
     the batches sample it with replacement; ``train.Prefetcher`` builds
     the next batch while the step runs.
  2. Training, f32: AdamW on the warmup-cosine schedule
     (``train.make_optimizer``, warmup min(1500, steps // 8)) after a clip
     of the gradients' global norm to 1.0 with optax's arithmetic
     (``clip_by_global_norm``).  The loss is logged every 100 steps; the
     loop ends when it falls below 0.01 after step 400.  A partial
     checkpoint every 5000 steps.
  3. Held-out read: ``--eval-n`` crops (seed 9999) through the int8 serving
     engine and the ``serving_kernels=False`` bf16 control, both at
     ``max_length`` 300: exact match and CER of each, their agreement.
  4. Model-only rate: the held-out crops tiled to ``--tp-batch``,
     preprocessed once on the card, ``models.model.ocr_forward`` timed at
     budget 300 and 32 (best of 3 passes of 12 calls, the lengths read back
     at the end of each pass).

Usage: python3 scripts/torch_closed_loop_fullsize.py [--steps N] [--batch B]
    [--peak-lr LR] [--eval-n N] [--tp-batch B] [--ckpt DIR] [--device DEV]
The trained checkpoint goes to ``--ckpt`` (default ``mocr_torch_fullsize_ckpt``
under the temporary directory) and is reused when it exists (delete it to
retrain).  The last line printed is a JSON summary.  ``run`` is the same
loop for a given config and sizes (the tests run it at the tiny config).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from manga_ocr_tpu_torch import train as tr  # noqa: E402
from manga_ocr_tpu_torch.engine.engine import TorchMangaOcrEngine  # noqa: E402
from manga_ocr_tpu_torch.eval import cer  # noqa: E402
from manga_ocr_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from manga_ocr_tpu_torch.models import model as mdl  # noqa: E402
from manga_ocr_tpu_torch.models.config import MangaOCRConfig  # noqa: E402
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer  # noqa: E402
from manga_ocr_tpu_torch.ops import preprocess as pp  # noqa: E402

CKPT = os.path.join(tempfile.gettempdir(), "mocr_torch_fullsize_ckpt")
CANVAS = (224, 160)  # the train canvas: every crop pasted at its top left
SEQ = 24  # CLS + <= 18 characters + SEP + slack
BUDGET = 300  # the reference's max_length
RENDER_CHUNK = 32  # crops the render process sends at once


def say(m: str) -> None:
    print(m, flush=True)


def _chars(tok: CharTokenizer) -> list[str]:
    # kana only: tokenizer.post_process is the identity on kana, so the
    # engine's text compares char-exact against the sampled text
    return [t for t in tok.id_to_token[4:150] if len(t) == 1]


def _sample_text(rng, chars) -> str:
    n = int(rng.integers(1, 19))
    return "".join(rng.choice(chars) for _ in range(n))


def _render(text: str, rng) -> np.ndarray:
    h = int(rng.integers(176, CANVAS[0] + 1))
    w = int(rng.integers(104, CANVAS[1] + 1))
    return tr.render_text_crop(text, rng, 224, hw=(h, w))


def _produce(tok: CharTokenizer, chars: list, seed: int, pool_max: int, out, stop) -> None:
    """The render process: (gray crop, ids) pairs from the seeded stream, in
    chunks of RENDER_CHUNK, until ``stop`` is set or ``pool_max`` are sent;
    then None (or the error's text)."""
    prng = np.random.default_rng(seed)
    sent = 0
    try:
        while not stop.is_set() and sent < pool_max:
            chunk = []
            for _ in range(min(RENDER_CHUNK, pool_max - sent)):
                text = _sample_text(prng, chars)
                chunk.append((np.ascontiguousarray(_render(text, prng)[..., 0]),
                              tok.encode(text)[:SEQ]))
            out.put(chunk)
            sent += len(chunk)
        out.put(None)
    except BaseException as e:  # the parent raises it
        out.put(f"{type(e).__name__}: {e}")


class RenderPool:
    """Crops and token ids rendered by a producer into a growing pool, up to
    ``pool_max``; the constructor returns once ``pool_min`` are in.  The
    rendering runs in a process of its own (``_produce``, seeded ``seed``):
    as a thread it would hold the interpreter lock between the training
    loop's operator calls, each of which then waits for it.  A thread here
    (``self.thread``) moves its chunks into the pool.  A crop is kept as its
    one gray channel (``render_text_crop`` repeats it three times).
    ``close`` stops the process and the thread and waits for both."""

    def __init__(self, tok: CharTokenizer, chars: list, seed: int, pool_min: int,
                 pool_max: int):
        ctx = multiprocessing.get_context("spawn")
        self._pool: list = []
        self._lock = threading.Lock()
        self._stop = ctx.Event()
        self._error: list = []
        self._queue = ctx.Queue()
        self.process = ctx.Process(target=_produce, name="render-pool", daemon=True,
                                   args=(tok, chars, seed, pool_max, self._queue, self._stop))
        self.process.start()

        def receive():
            while True:
                try:
                    item = self._queue.get(timeout=0.5)
                except queue.Empty:
                    if not self.process.is_alive():
                        self._error.append(f"exit code {self.process.exitcode}")
                        return
                    continue
                if item is None:
                    return
                if isinstance(item, str):
                    self._error.append(item)
                    return
                with self._lock:
                    self._pool.extend(item)

        self.thread = threading.Thread(target=receive, name="render-pool-receiver", daemon=True)
        self.thread.start()
        while len(self._pool) < min(pool_min, pool_max):
            self._raise()
            time.sleep(0.05)

    def _raise(self) -> None:
        if self._error:
            raise RuntimeError(f"render pool: the producer failed: {self._error[0]}")

    def __len__(self) -> int:
        return len(self._pool)

    def sample(self, rng, n: int) -> list:
        """``n`` (crop, ids) pairs drawn with replacement."""
        self._raise()
        with self._lock:
            return [self._pool[j] for j in rng.integers(0, len(self._pool), n)]

    def close(self) -> None:
        self._stop.set()
        self.thread.join()  # drains the queue up to the producer's last word
        self.process.join()
        self._queue.close()


class BatchSource:
    """``TrainBatch``es on ``device``: ``batch`` pool samples on the canvas,
    the valid regions preprocessed as the serving engine does (f32
    pixels), tokens padded to SEQ with their loss mask.  ``close`` stops
    the pool's producer."""

    def __init__(self, cfg: MangaOCRConfig, tok: CharTokenizer, batch: int, seed: int,
                 device, pool_min: int = 4000, pool_max: int = 250_000):
        self._cfg, self._batch, self._device = cfg, batch, torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.pool = RenderPool(tok, _chars(tok), seed + 1, pool_min, pool_max)
        say(f"  data pool warmed: {len(self.pool)} samples (producer keeps filling)")

    def __iter__(self):
        return self

    def __next__(self) -> tr.TrainBatch:
        b, pad = self._batch, self._cfg.decoder.pad_token_id
        arr = np.zeros((b, *CANVAS, 3), np.uint8)
        sizes = np.zeros((b, 2), np.int32)
        tokens = np.full((b, SEQ), pad, np.int32)
        mask = np.zeros((b, SEQ), np.float32)
        for i, (crop, ids) in enumerate(self.pool.sample(self._rng, b)):
            arr[i, : crop.shape[0], : crop.shape[1]] = crop[..., None]
            sizes[i] = crop.shape
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1.0
        host = [torch.from_numpy(a) for a in (arr, sizes, tokens, mask)]
        if self._device.type == "cuda":
            host = [t.pin_memory() for t in host]
        arr_d, sizes_d, tokens_d, mask_d = (t.to(self._device, non_blocking=True) for t in host)
        px = pp.model_preprocess(arr_d, sizes_d, self._cfg.encoder.image_size).float()
        return tr.TrainBatch(px, tokens_d, mask_d)

    def close(self) -> None:
        self.pool.close()


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on ``grads`` in place: the
    global norm sqrt(sum of every leaf's sum of squares); at or above
    ``max_norm`` each gradient becomes (g / norm) * max_norm, below it is
    left as it is (dividing and multiplying by 1.0 is exact).  No host
    sync; returns the norm."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(g_norm, max_norm)))
    return g_norm


def make_optimizer(peak_lr: float, steps: int):
    """AdamW on the closed loop's schedule: warmup min(1500, steps // 8),
    cosine decay over ``steps``."""
    return tr.make_optimizer(lr=tr.make_lr_schedule(
        peak_lr=peak_lr, warmup_steps=min(1500, steps // 8), decay_steps=steps))


def make_train_step(cfg: MangaOCRConfig, max_norm: float = 1.0):
    """``train.make_train_step`` without a mesh, with the gradients clipped
    (``clip_by_global_norm``) between the backward and the optimizer's step:
    optax.chain(clip_by_global_norm(max_norm), adamw(schedule)).  The
    parameters are updated in place; the loss stays a device tensor."""

    def step(params, opt_state: tr.OptState, batch: tr.TrainBatch):
        opt_state.optimizer.zero_grad(set_to_none=True)
        loss = tr.loss_fn(params, batch, cfg)
        loss.backward()
        grads = [p.grad for _, p in tr._leaves(params) if p.grad is not None]
        clip_by_global_norm(grads, max_norm)
        opt_state.optimizer.step()
        if opt_state.scheduler is not None:
            opt_state.scheduler.step()
        return params, opt_state, loss.detach()

    return step


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def train(cfg: MangaOCRConfig, tok: CharTokenizer, steps: int, batch: int,
          peak_lr: float = 2e-4, device="cuda", ckpt_dir: str = CKPT, pool_min: int = 4000,
          pool_max: int = 250_000):
    """Train ``cfg`` from the port's seed-0 init -> (params detached on
    ``device``, info): ``final_loss``, ``steps`` (the step the loss fell
    below 0.01 after step 400, else ``steps``), ``train_s``, steps/s, and
    the seconds the loop waited on the host for its next batch and their
    share of the loop.  Partial checkpoints go to ``ckpt_dir + "_partial"``
    every 5000 steps."""
    device = tr._device(device)
    params, opt_state = tr.init_train_state(cfg, make_optimizer(peak_lr, steps), 0, device)
    step = make_train_step(cfg)
    source = BatchSource(cfg, tok, batch, 0, device, pool_min, pool_max)
    it = tr.Prefetcher(source)
    t0 = time.perf_counter()
    wait = 0.0
    lv, done_step, ran = float("nan"), steps, 0
    try:
        for i in range(steps):
            tw = time.perf_counter()
            b = next(it)
            wait += time.perf_counter() - tw
            params, opt_state, loss = step(params, opt_state, b)
            ran = i + 1
            if i % 100 == 0 or i == steps - 1:
                lv = float(loss)
                say(f"  step {i:5d}  loss {lv:.4f}  ({time.perf_counter() - t0:.0f}s, "
                    f"pool {len(source.pool)})")
                if lv < 0.01 and i > 400:
                    done_step = i
                    break
            if i and i % 5000 == 0:
                # a partial directory, so that a rerun does not take it for a
                # finished checkpoint
                ckpt.save_checkpoint(ckpt_dir + "_partial", params, cfg)
    finally:
        it.close()
        source.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    info = {"final_loss": lv, "steps": done_step, "train_s": round(dt, 1),
            "steps_per_s": round(ran / dt, 3), "host_wait_s": round(wait, 1),
            "host_share": round(wait / dt, 4), "pool": len(source.pool)}
    return _detached(params), info


def heldout(tok: CharTokenizer, n: int, seed: int = 9999):
    rng = np.random.default_rng(seed)
    chars = _chars(tok)
    refs, crops = [], []
    for _ in range(n):
        refs.append(_sample_text(rng, chars))
        crops.append(_render(refs[-1], rng))
    return refs, crops


def score(got: list[str], refs: list[str]) -> tuple[float, float]:
    exact = sum(g == r for g, r in zip(got, refs)) / len(refs)
    mean_cer = float(np.mean([cer(g, r) for g, r in zip(got, refs)]))
    return exact, mean_cer


def read_heldout(params, cfg: MangaOCRConfig, tok: CharTokenizer, refs: list, crops: list,
                 device="cuda", max_length: int = BUDGET) -> tuple[dict, TorchMangaOcrEngine]:
    """The held-out crops through the int8 serving engine and the
    ``serving_kernels=False`` bf16 control -> (scores, the serving engine)."""
    say(f"eval: serving engine (int8, kernels A, B, C), max_length={max_length}")
    eng = TorchMangaOcrEngine(params, cfg, tok, max_length=max_length, dtype=torch.bfloat16,
                              device=device)
    t0 = time.perf_counter()
    got = eng.ocr_page(crops, orientation=pp.ORIENT_NONE)
    t_fused = time.perf_counter() - t0
    exact_f, cer_f = score(got, refs)
    say(f"  int8 serving: exact {exact_f:.3f}  CER {cer_f:.4f}  ({t_fused:.1f}s, first call)")
    for r, g in list(zip(refs, got))[:5]:
        say(f"    ref={r!r}\n    got={g!r}")
    say("eval: bf16 control (serving_kernels=False)")
    eng_x = TorchMangaOcrEngine(params, cfg, tok, max_length=max_length, dtype=torch.bfloat16,
                                device=device, serving_kernels=False)
    got_x = eng_x.ocr_page(crops, orientation=pp.ORIENT_NONE)
    exact_x, cer_x = score(got_x, refs)
    say(f"  bf16 control: exact {exact_x:.3f}  CER {cer_x:.4f}")
    # int8 quantization may flip a character the model is unsure of: the
    # agreement is reported, not required
    agree = sum(a == b for a, b in zip(got, got_x)) / len(got)
    say(f"  int8-vs-bf16 text agreement: {agree:.3f}")
    return {"exact_fused_int8": round(exact_f, 4), "cer_fused_int8": round(cer_f, 5),
            "exact_xla_bf16": round(exact_x, 4), "cer_xla_bf16": round(cer_x, 5),
            "fused_vs_xla_agree": round(agree, 4)}, eng


def throughput_model_only(engine: TorchMangaOcrEngine, crops: list, max_length: int,
                          iters: int = 12, passes: int = 3) -> tuple[float, np.ndarray]:
    """crops/s of ``ocr_forward`` on the engine's params and config over
    ``crops`` preprocessed once on its device: one warm call, then the best
    of ``passes`` passes of ``iters`` calls, each pass's lengths read back
    at its end; and the lengths of the warm call."""
    b = len(crops)
    mh = max(c.shape[0] for c in crops)
    mw = max(c.shape[1] for c in crops)
    arr = np.zeros((b, mh, mw, 3), np.uint8)
    sizes = np.zeros((b, 2), np.int32)
    for i, c in enumerate(crops):
        arr[i, : c.shape[0], : c.shape[1]] = c
        sizes[i] = c.shape[:2]
    dev = engine.device
    with torch.inference_mode():
        px = pp.model_preprocess(torch.from_numpy(arr).to(dev), torch.from_numpy(sizes).to(dev),
                                 engine.cfg.encoder.image_size).to(engine.dtype)

        def run():
            return mdl.ocr_forward(engine.params, px, engine.cfg, max_length=max_length)

        lengths = run().lengths.cpu().numpy()
        best = float("inf")
        for _ in range(passes):
            t0 = time.perf_counter()
            outs = [run() for _ in range(iters)]
            for o in outs:
                o.lengths.cpu()
            best = min(best, (time.perf_counter() - t0) / iters)
    return b / best, lengths


def run(cfg: MangaOCRConfig, tok: CharTokenizer, steps: int, batch: int, peak_lr: float = 2e-4,
        eval_n: int = 64, tp_batch: int = 256, ckpt_dir: str = CKPT, device="cuda",
        max_length: int = BUDGET, iters: int = 12, passes: int = 3,
        pool_min: int = 4000) -> dict:
    """The closed loop: train ``cfg`` into ``ckpt_dir`` (or reuse it where it
    exists), read ``eval_n`` held-out crops, time ``ocr_forward`` on
    ``tp_batch`` crops at budget ``max_length`` and min(32, ``max_length``)
    (``iters`` calls a pass, best of ``passes``) -> the summary, also printed
    as JSON."""
    device = tr._device(device)
    say(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    if os.path.exists(ckpt_dir):
        say(f"reusing checkpoint {ckpt_dir}")
        params, cfg = ckpt.load_checkpoint(ckpt_dir, torch.float32, device)
        train_info = {"reused": True}
    else:
        say(f"training from scratch: steps<={steps} batch={batch}")
        params, train_info = train(cfg, tok, steps, batch, peak_lr, device, ckpt_dir, pool_min)
        ckpt.save_checkpoint(ckpt_dir, params, cfg)
        say(f"trained: {train_info}")

    refs, crops = heldout(tok, eval_n)
    scores, eng = read_heldout(params, cfg, tok, refs, crops, device, max_length)

    say(f"throughput: trained weights, budget {max_length} with the EOS exit (serving "
        f"engine's params and config)")
    tp_crops = (crops * -(-tp_batch // len(crops)))[:tp_batch]
    short = min(32, max_length)
    rate_full, lengths = throughput_model_only(eng, tp_crops, max_length, iters, passes)
    say(f"  budget-{max_length} trained: {rate_full:.1f} crops/s  lengths med "
        f"{np.median(lengths):.0f} p95 {np.percentile(lengths, 95):.0f} max {lengths.max()}")
    rate_short, _ = throughput_model_only(eng, tp_crops, short, iters, passes)
    say(f"  budget-{short} same weights: {rate_short:.1f} crops/s")

    summary = {
        "train": train_info,
        **scores,
        "crops_per_s_budget300_trained": round(rate_full, 1),
        "crops_per_s_budget32": round(rate_short, 1),
        "len_median": float(np.median(lengths)),
        "eval_n": eval_n,
    }
    say(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="torch_closed_loop_fullsize")
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--peak-lr", type=float, default=2e-4)
    ap.add_argument("--eval-n", type=int, default=64)
    ap.add_argument("--tp-batch", type=int, default=256)
    ap.add_argument("--ckpt", default=CKPT, help="checkpoint directory (reused when present)")
    ap.add_argument("--device", default="cuda", help="'cuda' raises where CUDA is unavailable")
    args = ap.parse_args(argv)
    return run(MangaOCRConfig.base(), CharTokenizer.synthetic(), args.steps, args.batch,
               args.peak_lr, args.eval_n, args.tp_batch, args.ckpt, args.device)


if __name__ == "__main__":
    main()
