"""Training and fine-tuning of the manga-ocr model (counterpart of
``manga_ocr_tpu/train.py``): teacher-forced cross-entropy, AdamW on a
warmup-cosine schedule, synthetic or directory data, resumable train state
and an HF-format export.

The step is plain PyTorch with autograd, as the JAX step is plain XLA: the
loss runs the encoder and ``decoder.forward_full`` under a config whose
encoder names no kernel (``attn_kernel``/``mlp_kernel`` "xla"; the kernels
have no backward), in float32 on both devices.  The optimizer is
``torch.optim.AdamW`` set up as ``optax.adamw`` is: one group holding every
leaf, betas 0.9/0.999, eps 1e-8 outside the square root, weight decay on
every leaf (biases, LN and embeddings included), and the learning rate of
step n equal to ``schedule(n)`` (so the warmup's first step, at lr 0,
changes no weight).  The train-state files are the JAX package's
(``save_train_state``), so either package resumes the other's run.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from manga_ocr_tpu_torch.models import checkpoint as ckpt
from manga_ocr_tpu_torch.models import decoder as dec
from manga_ocr_tpu_torch.models import model as mdl
from manga_ocr_tpu_torch.models import params as mparams
from manga_ocr_tpu_torch.models.config import MangaOCRConfig


class TrainBatch(NamedTuple):
    pixel_values: torch.Tensor  # [B, H, W, C] float32
    tokens: torch.Tensor  # [B, T] int32, BOS ... EOS PAD*
    loss_mask: torch.Tensor  # [B, T] float32, 1 where the *label* at t counts


def _check_trainable(cfg: MangaOCRConfig) -> None:
    """Training runs the plain encoder: a config that names one of its
    kernels (which have no backward) is refused, not quietly run plain."""
    enc = cfg.encoder
    for flag in ("attn_kernel", "mlp_kernel"):
        if getattr(enc, flag) != "xla":
            raise ValueError(
                f"training needs encoder.{flag}='xla', got {getattr(enc, flag)!r}: "
                f"the encoder kernels have no backward"
            )


def loss_fn(params: dict, batch: TrainBatch, cfg: MangaOCRConfig) -> torch.Tensor:
    """Teacher-forcing cross-entropy over next-token prediction (a scalar
    tensor on the batch's device)."""
    _check_trainable(cfg)
    enc_out = mdl.encode(params, batch.pixel_values, cfg, use_kernels=False)
    inputs = batch.tokens[:, :-1]
    labels = batch.tokens[:, 1:].long()
    mask = batch.loss_mask[:, 1:].float()
    logits = dec.forward_full(params["decoder"], inputs, enc_out, cfg.decoder)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def make_lr_schedule(
    peak_lr: float = 1e-4,
    warmup_steps: int = 500,
    decay_steps: int = 20_000,
    end_lr_ratio: float = 0.1,
) -> Callable[[int], float]:
    """Linear warmup from 0 to ``peak_lr``, then cosine decay to
    ``peak_lr * end_lr_ratio`` at ``decay_steps`` (which counts the warmup):
    ``optax.warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    decay_steps, peak_lr * end_lr_ratio)``, step by step in float32 as
    optax computes it (the cosine rounded once from double)."""
    f32 = np.float32
    end = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    cos_steps = f32(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"make_lr_schedule: decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax's linear_schedule (none when warmup_steps <= 0)
            frac = f32(1) - f32(min(max(step, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(0.0 - peak_lr) * frac + f32(peak_lr))
        count = min(f32(step - warmup_steps), cos_steps)
        arg = f32(math.pi) * count / cos_steps
        decay = f32(0.5) * (f32(1) + f32(math.cos(float(arg))))
        return float(f32(peak_lr) * (f32(1 - alpha) * decay + f32(alpha)))

    return schedule


class OptState(NamedTuple):
    """The torch optimizer over the tree's leaves (in ``_leaves`` order) and,
    under a schedule, its ``LambdaLR`` (base lr 1.0, so lr = schedule(step))."""

    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR | None


def make_optimizer(lr: float | Callable[[int], float] = 1e-4,
                   weight_decay: float = 0.01) -> Callable[[dict], OptState]:
    """``optax.adamw(lr, weight_decay=weight_decay)`` (0.01, this module's
    setting; optax's own default is 1e-4, and ``optax.adam`` is 0.0):
    returns ``init(params) -> OptState``, which builds the optimizer state
    over a parameter tree."""

    def init(params: dict) -> OptState:
        leaves = [t for _, t in _leaves(params)]
        opt = torch.optim.AdamW(leaves, lr=1.0 if callable(lr) else lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lr) if callable(lr) else None
        return OptState(opt, sched)

    return init


def _leaves(tree, prefix: str = "") -> list:
    """(path, tensor) of every floating leaf, paths as the checkpoint's
    ``_flatten`` writes them."""
    if isinstance(tree, dict):
        return [pt for k, v in tree.items() for pt in _leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)] if tree.is_floating_point() else []


def make_train_step(cfg: MangaOCRConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: zero
    the gradients, the loss, backward, the optimizer step and the schedule's
    step; the parameters are updated in place and the loss stays a device
    tensor (no host sync)."""

    def step(params, opt_state: OptState, batch: TrainBatch):
        opt_state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        opt_state.optimizer.step()
        if opt_state.scheduler is not None:
            opt_state.scheduler.step()
        return params, opt_state, loss.detach()

    return step


def _as_trainable(tree, device) -> dict:
    """A copy of ``tree`` on ``device`` whose floating leaves require grad
    (the caller's tensors are never updated)."""
    if isinstance(tree, dict):
        return {k: _as_trainable(v, device) for k, v in tree.items()}
    t = tree.detach().to(device, copy=True)
    return t.requires_grad_(True) if t.is_floating_point() else t


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: device='cuda' but CUDA is unavailable (pass --device cpu)")
    return device


def init_train_state(
    cfg: MangaOCRConfig,
    optimizer: Callable[[dict], OptState],
    seed: int = 0,
    device="cuda",
    init_params: dict | None = None,
):
    """(params, opt_state) on ``device``, float32: random weights from the
    port's numpy init (``models.params.init_params``, ``seed``, std 0.02),
    or a copy of ``init_params`` (e.g. a converted HF checkpoint, to
    fine-tune)."""
    device = _device(device)
    if init_params is None:
        init_params = mparams.init_params(cfg, seed, "cpu")
    params = _as_trainable(mdl.cast_params(init_params, torch.float32), device)
    return params, optimizer(params)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


def pattern_glyph(ch: str, size: int = 12) -> np.ndarray:
    """A deterministic, per-character-DISTINCT glyph: a 4x4 binary pattern
    hashed from the codepoint, scaled to ``size`` (uint8, 0=ink/255=paper).
    (PIL's default bitmap font draws every non-Latin character as the same
    box, which would leave the synthetic crops without their labels.)"""
    bits = (ord(ch) * 2654435761) & 0xFFFF
    g = np.array([(bits >> i) & 1 for i in range(16)], np.uint8).reshape(4, 4)
    g[0, 0] = 1  # anchor cell: no glyph is empty
    cell = max(1, size // 4)
    return 255 - np.kron(g, np.ones((cell, cell), np.uint8)) * 255


def render_text_crop(
    text: str, rng, image_size: int, font=None, hw: tuple[int, int] | None = None
) -> np.ndarray:
    """A bubble-like training crop: white ellipse on page tone, the text drawn
    vertically as ``pattern_glyph``s; [h, w, 3] uint8.  ``hw``: optional
    (height, width) for non-square crops."""
    h, w = hw if hw is not None else (image_size, image_size)
    img = np.full((h, w), int(rng.integers(140, 220)), np.uint8)
    # white bubble interior with a 2px border of page tone
    img[2 : h - 2, 2 : w - 2] = 255
    gs = max(4, min(12, (h - 8) // max(len(text), 1) - 2, w - 8))
    y = 4
    for ch in text:
        gl = pattern_glyph(ch, gs)
        if y + gl.shape[0] > h - 2:
            break
        x = max(2, (w - gl.shape[1]) // 2)
        gw = min(gl.shape[1], max(0, w - 2 - x))  # clip BOTH sides alike
        img[y : y + gl.shape[0], x : x + gw] = gl[:, :gw]
        y += gl.shape[0] + 2
    return np.repeat(img[..., None], 3, axis=2)


def _batch(pixels, tokens, mask) -> TrainBatch:
    return TrainBatch(torch.from_numpy(pixels), torch.from_numpy(tokens), torch.from_numpy(mask))


def synthetic_dataset(cfg: MangaOCRConfig, tokenizer, batch_size: int, seq_len: int,
                      seed: int = 0):
    """Infinite generator of CPU ``TrainBatch``es of rendered crops of random
    character runs from the tokenizer's vocab (ids below the model's vocab
    size): smoke training and overfit tests; ``directory_dataset`` for real
    data."""
    rng = np.random.default_rng(seed)
    img = cfg.encoder.image_size
    chars = [t for t in tokenizer.id_to_token[4 : cfg.decoder.vocab_size] if len(t) == 1]

    while True:
        pixels = np.zeros((batch_size, img, img, 3), np.float32)
        tokens = np.full((batch_size, seq_len), cfg.decoder.pad_token_id, np.int32)
        mask = np.zeros((batch_size, seq_len), np.float32)
        for i in range(batch_size):
            n = int(rng.integers(1, max(2, seq_len - 2)))
            text = "".join(rng.choice(chars) for _ in range(n))
            crop = render_text_crop(text, rng, img)
            pixels[i] = (crop.astype(np.float32) / 255.0 - 0.5) / 0.5
            ids = tokenizer.encode(text)[:seq_len]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1.0
        yield _batch(pixels, tokens, mask)


def directory_dataset(path: str, cfg: MangaOCRConfig, tokenizer, batch_size: int, seq_len: int,
                      seed: int = 0):
    """Infinite generator of CPU ``TrainBatch``es drawn from a directory of
    (crop.png, crop.txt) pairs, the eval fixtures' format."""
    from PIL import Image

    from manga_ocr_tpu_torch.eval import load_fixtures

    fixtures = load_fixtures(path)
    if not fixtures:
        raise ValueError(f"no (image, txt) pairs under {path}")
    rng = np.random.default_rng(seed)
    img = cfg.encoder.image_size

    while True:
        idxs = rng.integers(0, len(fixtures), size=batch_size)
        pixels = np.zeros((batch_size, img, img, 3), np.float32)
        tokens = np.full((batch_size, seq_len), cfg.decoder.pad_token_id, np.int32)
        mask = np.zeros((batch_size, seq_len), np.float32)
        for row, i in enumerate(idxs):
            fx = fixtures[int(i)]
            crop, text = fx["crop"], fx["ref"]
            gray = np.asarray(Image.fromarray(crop[..., ::-1]).convert("L").resize((img, img)))
            rgbish = np.repeat(gray[..., None], 3, axis=-1)
            pixels[row] = (rgbish.astype(np.float32) / 255.0 - 0.5) / 0.5
            ids = [
                t if t < cfg.decoder.vocab_size else cfg.decoder.unk_token_id
                for t in tokenizer.encode(text)
            ][:seq_len]
            tokens[row, : len(ids)] = ids
            mask[row, : len(ids)] = 1.0
        yield _batch(pixels, tokens, mask)


class Prefetcher:
    """One-batch host prefetch: the next batch builds on a worker thread
    while the current step runs on the device."""

    def __init__(self, iterator):
        self._it = iterator
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def pump():
            while not self._stop.is_set():
                try:
                    item = next(self._it)
                except StopIteration:
                    item = None
                except Exception as e:  # handed to the consumer, which raises it
                    item = e
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if item is None or isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker and wait for it, so the source iterator is no
        longer running (another ``Prefetcher`` may take it up)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()


# ---------------------------------------------------------------------------
# Train-state checkpointing + loop
# ---------------------------------------------------------------------------

# optax.adamw's state, as the JAX package's checkpoint flattens it: (adam
# (count, mu, nu), decayed-weights (no state), schedule (count) or none).
_ADAM_COUNT, _MU, _NU, _SCHEDULE_COUNT = "/0/0", "/0/1/", "/0/2/", "/2/0"


def save_train_state(path: str, params: dict, opt_state: OptState, step: int,
                     cfg: MangaOCRConfig) -> None:
    """Checkpoint params + optimizer state + step in the JAX package's files:
    the params' ``weights.npz`` and ``manifest.json``, ``opt_state.npz`` under
    optax's keys and ``train_state.json``."""
    ckpt.save_checkpoint(path, params, cfg)
    opt = opt_state.optimizer
    flat = {}
    count = 0
    for name, p in _leaves(params):
        st = opt.state.get(p, {})
        if st:
            count = int(st["step"])
        for prefix, key in ((_MU, "exp_avg"), (_NU, "exp_avg_sq")):
            m = st.get(key)
            flat[prefix + name] = ckpt._to_numpy(m) if m is not None else np.zeros(p.shape, np.float32)
    flat[_ADAM_COUNT] = np.asarray(count, np.int32)
    if opt_state.scheduler is not None:
        flat[_SCHEDULE_COUNT] = np.asarray(opt_state.scheduler.last_epoch, np.int32)
    np.savez(os.path.join(path, "opt_state.npz"), **flat)
    with open(os.path.join(path, "train_state.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def load_train_state(path: str, optimizer: Callable[[dict], OptState], device="cuda"):
    """Restore float32 (params, opt_state, step, cfg) on ``device`` from
    ``save_train_state``'s files (the JAX package's too); a key the file
    lacks keeps the fresh state's value, as the JAX loader does."""
    device = _device(device)
    params, cfg = ckpt.load_checkpoint(path, torch.float32, device)
    params = _as_trainable(params, device)
    opt_state = optimizer(params)
    opt = opt_state.optimizer
    with np.load(os.path.join(path, "opt_state.npz")) as data:
        count = int(data[_ADAM_COUNT]) if _ADAM_COUNT in data.files else 0
        if count:
            for name, p in _leaves(params):
                moments = {}
                for prefix, key in ((_MU, "exp_avg"), (_NU, "exp_avg_sq")):
                    arr = data[prefix + name] if prefix + name in data.files else np.zeros(p.shape)
                    moments[key] = torch.from_numpy(np.asarray(arr, np.float32)).to(p.device, p.dtype)
                opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32), **moments}
        sched_count = int(data[_SCHEDULE_COUNT]) if _SCHEDULE_COUNT in data.files else 0
    if opt_state.scheduler is not None:  # where LambdaLR stands after sched_count steps
        opt_state.scheduler.last_epoch = sched_count
        opt.param_groups[0]["lr"] = opt_state.scheduler.lr_lambdas[0](sched_count)
    with open(os.path.join(path, "train_state.json")) as f:
        step = json.load(f)["step"]
    return params, opt_state, step, cfg


def _to_device(batch: TrainBatch, device: torch.device) -> TrainBatch:
    return TrainBatch(*(t.to(device, non_blocking=True) for t in batch))


def _pinned(batches, device: torch.device):
    """Batches in page-locked memory where they go to the card, so their copy
    does not wait on the steps before it."""
    for batch in batches:
        yield TrainBatch(*(t.pin_memory() for t in batch)) if device.type == "cuda" else batch


def train(
    cfg: MangaOCRConfig,
    dataset,
    steps: int,
    peak_lr: float = 1e-4,
    warmup_steps: int = 100,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    resume: bool = False,
    log_every: int = 50,
    seed: int = 0,
    init_params: dict | None = None,
    device="cuda",
):
    """The training loop: schedule, prefetch, periodic resumable checkpoints.

    Returns (params, losses), ``losses`` read every ``log_every`` steps and
    at the last.  ``dataset`` is any ``TrainBatch`` iterator
    (``synthetic_dataset`` / ``directory_dataset``).  ``init_params``:
    fine-tune from these weights instead of random init (ignored when
    resuming from a saved train state, which carries its own params)."""
    device = _device(device)
    schedule = make_lr_schedule(peak_lr, warmup_steps, max(steps, warmup_steps + 1))
    optimizer = make_optimizer(schedule)
    start = 0
    if resume and checkpoint_dir and os.path.exists(
        os.path.join(checkpoint_dir, "train_state.json")
    ):
        params, opt_state, start, cfg = load_train_state(checkpoint_dir, optimizer, device=device)
    else:
        params, opt_state = init_train_state(cfg, optimizer, seed, device,
                                             init_params=init_params)
    step_fn = make_train_step(cfg)
    losses = []
    it = Prefetcher(_pinned(iter(dataset), device))
    try:
        for i in range(start, steps):
            batch = _to_device(next(it), device)
            params, opt_state, loss = step_fn(params, opt_state, batch)
            if (i + 1) % log_every == 0 or i + 1 == steps:
                losses.append(float(loss))
            if checkpoint_dir and ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
                save_train_state(checkpoint_dir, params, opt_state, i + 1, cfg)
    finally:
        it.close()
    return params, losses


def main(argv=None) -> int:
    """Command-line training: ``python -m manga_ocr_tpu_torch.train``.

    Synthetic data by default (smoke and overfit runs); ``--data DIR`` of
    (crop.png, crop.txt) pairs for real fine-tuning.  Runs on ``--device``
    (``cuda`` by default, which raises where CUDA is unavailable).  The JAX
    command line's ``--mesh-data``/``--mesh-model`` are not ported: the
    command line rejects them."""
    import argparse

    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    p = argparse.ArgumentParser(prog="manga-ocr-tpu-torch-train")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--data", default="", help="dir of (crop.png, crop.txt) pairs; default: synthetic")
    p.add_argument("--config", default="base", choices=("base", "tiny"))
    p.add_argument("--init-checkpoint", default="", help="HF checkpoint dir to fine-tune from")
    p.add_argument("--checkpoint-dir", default="", help="where to write resumable train state")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    p.add_argument(
        "--export-hf",
        default="",
        help="after training, write the final weights as an HF-format "
        "checkpoint dir (model.safetensors + config.json + vocab.txt), which "
        "load_hf_checkpoint, the CLI/serve --checkpoint flag and MangaOcr read",
    )
    args = p.parse_args(argv)
    device = _device(args.device)

    cfg = MangaOCRConfig.base() if args.config == "base" else MangaOCRConfig.tiny()
    tok = CharTokenizer.synthetic()
    init_params = None
    if args.init_checkpoint:
        from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint

        init_params, cfg = load_hf_checkpoint(args.init_checkpoint)
        vocab = os.path.join(args.init_checkpoint, "vocab.txt")
        if os.path.exists(vocab):
            tok = CharTokenizer.from_vocab_file(vocab)
    if args.data:
        dataset = directory_dataset(args.data, cfg, tok, args.batch_size, args.seq_len,
                                    seed=args.seed)
    else:
        dataset = synthetic_dataset(cfg, tok, args.batch_size, args.seq_len, seed=args.seed)
    trained_params, losses = train(
        cfg,
        dataset,
        steps=args.steps,
        peak_lr=args.lr,
        warmup_steps=args.warmup_steps,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        seed=args.seed,
        init_params=init_params,
        device=device,
    )
    for i, loss in enumerate(losses):
        print(f"log[{i}] loss={loss:.4f}")
    if args.export_hf:
        from manga_ocr_tpu_torch.models.convert import save_hf_checkpoint

        save_hf_checkpoint(args.export_hf, trained_params, cfg, tokenizer=tok)
        print(f"exported HF-format checkpoint to {args.export_hf}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
