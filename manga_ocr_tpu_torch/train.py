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

On a (data, model) mesh (``mesh=``; ``--mesh-data``/``--mesh-model``) the
parameters are ``parallel.mesh.shard_params``' rows of column trees, every
replica and every shard a leaf of its own, and the step runs each data
row's slice of the batch through the plain forward on its model columns
(``parallel.tensor``).  The loss stays the JAX package's over the global batch: the loss
mask's sum is reduced first (no gradient), each row contributes its
masked negative log-likelihood divided by it, and the gradients of every
copy of a leaf are summed (in f32, in row and column order; across ranks
by ``parallel.multihost.all_reduce_sum``) and handed to every copy, so
that each replica takes the same AdamW step and stays bit-equal.  The
train-state files hold the full arrays: saving puts the first row's
shards together, loading under a mesh shards them.
"""

from __future__ import annotations

import functools
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
from manga_ocr_tpu_torch.ops.common import tree_device
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from manga_ocr_tpu_torch.parallel import multihost as mh
from manga_ocr_tpu_torch.parallel import tensor


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


def loss_fn(params, batch: TrainBatch, cfg: MangaOCRConfig) -> torch.Tensor:
    """Teacher-forcing cross-entropy over next-token prediction (a scalar
    tensor on the batch's device).  ``params``: a tree, or a list of a data
    row's model columns."""
    _check_trainable(cfg)
    return _row_loss(params, batch, cfg, batch.loss_mask[:, 1:].float().sum().clamp_min(1.0))


def _masked_nll(logits: torch.Tensor, batch: TrainBatch) -> torch.Tensor:
    """sum(nll * mask) of next-token logits [B, T-1, V] against the batch's
    labels and loss mask."""
    labels = batch.tokens[:, 1:].long()
    mask = batch.loss_mask[:, 1:].float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return (nll * mask).sum()


def _row_loss(params, batch: TrainBatch, cfg: MangaOCRConfig,
              denom: torch.Tensor) -> torch.Tensor:
    """One data row's share of the global loss: its masked negative
    log-likelihood through the plain forward (on its model columns where
    ``params`` is a list of them), divided by the global mask sum
    ``denom``."""
    enc_out = mdl.encode(params, batch.pixel_values, cfg, use_kernels=False)
    logits = dec.forward_full(mdl.subtree(params, "decoder"), batch.tokens[:, :-1], enc_out,
                              cfg.decoder)
    return _masked_nll(logits, batch) / denom


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

    def init(params) -> OptState:
        leaves = [t for _, t in _any_leaves(params)]
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


def _local(params: list) -> list:
    """A mesh layout's rows of this process (lists of column trees)."""
    return [cols for cols in params if cols is not None]


def _any_leaves(params) -> list:
    """``_leaves`` of a tree, or of every column tree of a mesh layout's
    local rows (row by row, column by column)."""
    if isinstance(params, dict):
        return _leaves(params)
    return [pt for cols in _local(params) for tree in cols for pt in _leaves(tree)]


def _grad_groups(params: list, n_model: int) -> list:
    """The copies of each parameter in a mesh layout: a split leaf's slice of
    one column in every local row; a replicated leaf in every local row and
    every column.  In tree order, rows and columns in order."""
    specs = meshlib.flat_specs()
    rows = [[dict(_leaves(tree)) for tree in cols] for cols in _local(params)]
    groups = []
    for name in rows[0][0]:
        if meshlib.model_dim(specs[name]) is None or n_model == 1:
            groups.append([r[c][name] for r in rows for c in range(n_model)])
        else:
            groups.extend([r[c][name] for r in rows] for c in range(n_model))
    return groups


def _reduce_grads(params: list, mesh: meshlib.Mesh) -> None:
    """Give every copy of each parameter the sum of all its copies'
    gradients (f32, in ``_grad_groups``' order on the first copy's device,
    then over the ranks where the mesh spans several), so that every replica
    steps alike.  A parameter none of whose copies has a gradient keeps
    None."""
    groups = _grad_groups(params, mesh.shape[meshlib.MODEL_AXIS])
    sums = []
    for group in groups:
        acc = None
        for p in group:
            if p.grad is not None:
                g = p.grad.to(group[0].device)
                acc = g if acc is None else acc + g
        sums.append(acc)
    if mh.spans_processes(mesh):
        live = [s for s in sums if s is not None]
        flat = mh.all_reduce_sum(torch.cat([s.reshape(-1).to(live[0].device) for s in live]))
        parts = iter(torch.split(flat, [s.numel() for s in live]))
        sums = [None if s is None else next(parts).view_as(s).to(s.device) for s in sums]
    for group, total in zip(groups, sums):
        for p in group:
            p.grad = None if total is None else total.to(p.device)


def make_train_step(cfg: MangaOCRConfig, mesh: meshlib.Mesh | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: zero
    the gradients, the loss, backward, the optimizer step and the schedule's
    step; the parameters are updated in place and the loss stays a device
    tensor (no host sync).

    With ``mesh`` the parameters are ``parallel.mesh.shard_params``' rows and
    ``batch`` holds this process's rows of the global batch (all of it in
    one process), split evenly over its local data rows: every row's
    forward is launched, then the backward of all, the gradients reduced
    (``_reduce_grads``) and every copy stepped; the loss is the global
    batch's (summed over the rows and the ranks) on the first row's
    device.  Without one, the params are one tree and the batch its only
    row: the same step with nothing to reduce."""
    _check_trainable(cfg)
    if mesh is not None:
        tensor.check_heads(cfg, mesh.shape[meshlib.MODEL_AXIS])
    spans = mesh is not None and mh.spans_processes(mesh)

    def step(params, opt_state: OptState, batch: TrainBatch):
        rows = [params] if mesh is None else _local(params)
        n = batch.tokens.shape[0]
        if n % len(rows):
            raise ValueError(f"train step: a batch of {n} rows does not split over "
                             f"{len(rows)} data rows")
        per = n // len(rows)
        count = batch.loss_mask[:, 1:].float().sum()
        if spans:
            count = mh.all_reduce_sum(count)
        denom = count.clamp_min(1.0)
        opt_state.optimizer.zero_grad(set_to_none=True)
        losses = []
        for k, row in enumerate(rows):
            dev = tree_device(row if mesh is None else row[0])
            part = TrainBatch(*(t[k * per:(k + 1) * per].to(dev, non_blocking=True)
                                for t in batch))
            losses.append(_row_loss(row, part, cfg, denom.to(dev)))
        torch.autograd.backward(losses)
        if mesh is not None:
            _reduce_grads(params, mesh)
        opt_state.optimizer.step()
        if opt_state.scheduler is not None:
            opt_state.scheduler.step()
        loss = functools.reduce(lambda a, b: a + b.to(a.device), [l.detach() for l in losses])
        return params, opt_state, mh.all_reduce_sum(loss) if spans else loss

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


def _check_mesh(mesh: meshlib.Mesh, device: torch.device) -> None:
    """A mesh's devices of this process must be of ``device``'s type, so
    that a CUDA request never trains on the CPU (nor the reverse)."""
    kinds = sorted({meshlib.device_of(mesh.devices[i, j]).type
                    for i in meshlib.local_rows(mesh) for j in range(mesh.devices.shape[1])})
    if kinds != [device.type]:
        raise ValueError(f"train: mesh devices of type {kinds} do not match device={str(device)!r}")


def _trainable_grid(params: list) -> list:
    """``shard_params``' fresh rows with every floating leaf requiring grad."""
    for _, t in _any_leaves(params):
        t.requires_grad_(True)
    return params


def init_train_state(
    cfg: MangaOCRConfig,
    optimizer: Callable[[dict], OptState],
    seed: int = 0,
    device="cuda",
    init_params: dict | None = None,
    mesh: meshlib.Mesh | None = None,
):
    """(params, opt_state) on ``device``, float32: random weights from the
    port's numpy init (``models.params.init_params``, ``seed``, std 0.02),
    or a copy of ``init_params`` (e.g. a converted HF checkpoint, to
    fine-tune).  With ``mesh`` (whose devices must be of ``device``'s type)
    the params are placed on it by ``parallel.mesh.shard_params``."""
    device = _device(device)
    if init_params is None:
        init_params = mparams.init_params(cfg, seed, "cpu")
    if mesh is None:
        params = _as_trainable(mdl.cast_params(init_params, torch.float32), device)
    else:
        _check_mesh(mesh, device)
        params = _trainable_grid(meshlib.shard_params(
            mdl.cast_params(init_params, torch.float32), mesh))
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


def save_train_state(path: str, params, opt_state: OptState, step: int,
                     cfg: MangaOCRConfig) -> None:
    """Checkpoint params + optimizer state + step in the JAX package's files:
    the params' ``weights.npz`` and ``manifest.json``, ``opt_state.npz`` under
    optax's keys and ``train_state.json``.  A mesh layout (``shard_params``'
    rows) is saved as its first local row's shards put together, the AdamW
    moments as the params are."""
    opt = opt_state.optimizer

    def moment(key):  # a leaf's moment, zeros before its first step
        return lambda p: opt.state[p][key] if opt.state.get(p) else torch.zeros_like(p)

    if isinstance(params, dict):
        full = params
        moments = {key: {name: moment(key)(p) for name, p in _leaves(params)}
                   for key in ("exp_avg", "exp_avg_sq")}
    else:
        cols = _local(params)[0]
        full = meshlib.unshard_params(cols)
        moments = {key: dict(_leaves(meshlib.unshard_params(cols, get=moment(key))))
                   for key in ("exp_avg", "exp_avg_sq")}
    ckpt.save_checkpoint(path, full, cfg)
    steps = [int(st["step"]) for st in opt.state.values() if "step" in st]
    count = steps[0] if steps else 0
    flat = {}
    for name, _ in _leaves(full):
        for prefix, key in ((_MU, "exp_avg"), (_NU, "exp_avg_sq")):
            flat[prefix + name] = ckpt._to_numpy(moments[key][name])
    flat[_ADAM_COUNT] = np.asarray(count, np.int32)
    if opt_state.scheduler is not None:
        flat[_SCHEDULE_COUNT] = np.asarray(opt_state.scheduler.last_epoch, np.int32)
    np.savez(os.path.join(path, "opt_state.npz"), **flat)
    with open(os.path.join(path, "train_state.json"), "w") as f:
        json.dump({"step": int(step)}, f)


def _placements(params, mesh: meshlib.Mesh | None) -> list:
    """(path, leaf, piece) of every trainable leaf: ``piece(full)`` is the
    part of the full array that the leaf holds (the leaf's slice under its
    spec on a mesh)."""
    if mesh is None:
        return [(name, p, lambda a: a) for name, p in _leaves(params)]
    specs, n_model = meshlib.flat_specs(), mesh.shape[meshlib.MODEL_AXIS]
    return [(name, p, functools.partial(meshlib.shard_leaf, spec=specs[name], n_model=n_model,
                                        column=c, name=name))
            for cols in _local(params) for c, tree in enumerate(cols) for name, p in _leaves(tree)]


def _shard_opt_state(opt_state: OptState, params, data, count: int,
                     mesh: meshlib.Mesh | None) -> None:
    """Restore the AdamW moments of ``opt_state.npz`` (full arrays under
    optax's keys) onto ``params``' leaves: each leaf's moments take its part
    of the full arrays, a tensor of its own on its device (so a mesh's
    moments take the params' shardings); a key the file lacks is zeros."""
    opt = opt_state.optimizer
    for name, p, piece in _placements(params, mesh):
        moments = {}
        for prefix, key in ((_MU, "exp_avg"), (_NU, "exp_avg_sq")):
            if prefix + name in data.files:
                full = torch.from_numpy(np.asarray(data[prefix + name], np.float32))
                m = torch.empty_like(p, memory_format=torch.contiguous_format)
                m.copy_(piece(full))
            else:
                m = torch.zeros_like(p, memory_format=torch.contiguous_format)
            moments[key] = m
        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32), **moments}


def load_train_state(path: str, optimizer: Callable[[dict], OptState], device="cuda",
                     mesh: meshlib.Mesh | None = None):
    """Restore float32 (params, opt_state, step, cfg) on ``device`` from
    ``save_train_state``'s files (the JAX package's too); a key the file
    lacks keeps the fresh state's value, as the JAX loader does.  With
    ``mesh`` the params are sharded onto it and the AdamW moments with them
    (``_shard_opt_state``)."""
    device = _device(device)
    if mesh is None:
        params, cfg = ckpt.load_checkpoint(path, torch.float32, device)
        params = _as_trainable(params, device)
    else:
        _check_mesh(mesh, device)
        full, cfg = ckpt.load_checkpoint(path, torch.float32, "cpu")
        params = _trainable_grid(meshlib.shard_params(full, mesh))
    opt_state = optimizer(params)
    opt = opt_state.optimizer
    with np.load(os.path.join(path, "opt_state.npz")) as data:
        count = int(data[_ADAM_COUNT]) if _ADAM_COUNT in data.files else 0
        if count:
            _shard_opt_state(opt_state, params, data, count, mesh)
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
    mesh: meshlib.Mesh | None = None,
):
    """The training loop: schedule, prefetch, periodic resumable checkpoints.

    Returns (params, losses), ``losses`` read every ``log_every`` steps and
    at the last.  ``dataset`` is any ``TrainBatch`` iterator
    (``synthetic_dataset`` / ``directory_dataset``).  ``init_params``:
    fine-tune from these weights instead of random init (ignored when
    resuming from a saved train state, which carries its own params).
    ``mesh``: train on it (devices of ``device``'s type; the params returned
    are ``shard_params``' rows); on a global mesh each rank's ``dataset``
    yields its rows of the global batch, and the rank holding data row 0
    writes the checkpoints."""
    device = _device(device)
    if mesh is not None:
        _check_mesh(mesh, device)
    schedule = make_lr_schedule(peak_lr, warmup_steps, max(steps, warmup_steps + 1))
    optimizer = make_optimizer(schedule)
    start = 0
    if resume and checkpoint_dir and os.path.exists(
        os.path.join(checkpoint_dir, "train_state.json")
    ):
        params, opt_state, start, cfg = load_train_state(checkpoint_dir, optimizer,
                                                         device=device, mesh=mesh)
    else:
        params, opt_state = init_train_state(cfg, optimizer, seed, device,
                                             init_params=init_params, mesh=mesh)
    step_fn = make_train_step(cfg, mesh)
    writes = mesh is None or 0 in meshlib.local_rows(mesh)
    losses = []
    it = Prefetcher(_pinned(iter(dataset), device))
    try:
        for i in range(start, steps):
            batch = next(it)  # a mesh step sends each row its slice
            if mesh is None:
                batch = _to_device(batch, device)
            params, opt_state, loss = step_fn(params, opt_state, batch)
            if (i + 1) % log_every == 0 or i + 1 == steps:
                losses.append(float(loss))
            if checkpoint_dir and writes and (
                    (i + 1) % checkpoint_every == 0 or i + 1 == steps):
                save_train_state(checkpoint_dir, params, opt_state, i + 1, cfg)
    finally:
        it.close()
    return params, losses


def _mesh(n_data: int, n_model: int, device: torch.device) -> meshlib.Mesh | None:
    """The command line's mesh: none without ``--mesh-data`` or a model axis
    above 1 (as the JAX command line); on CUDA every visible card (data size
    defaults to their count over ``n_model``; ``make_mesh`` raises with too
    few); on the CPU a virtual mesh of ``n_data`` (default 1) x ``n_model``
    CPU devices."""
    if not (n_data or n_model > 1):
        return None
    if device.type == "cpu":
        return meshlib.make_mesh(n_data or 1, n_model, devices=[device] * ((n_data or 1) * n_model))
    return meshlib.make_mesh(n_data or None, n_model)


def main(argv=None) -> int:
    """Command-line training: ``python -m manga_ocr_tpu_torch.train``.

    Synthetic data by default (smoke and overfit runs); ``--data DIR`` of
    (crop.png, crop.txt) pairs for real fine-tuning.  Runs on ``--device``
    (``cuda`` by default, which raises where CUDA is unavailable).
    ``--mesh-data N`` shards the batch over N data rows; ``--mesh-model M``
    splits the params over M model columns (tensor parallelism) and implies
    a mesh (of every visible card over M, or of one data row under
    ``--device cpu``).  Under ``--device cpu`` the mesh is virtual: N x M
    CPU devices."""
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
    p.add_argument("--mesh-data", type=int, default=0, help="data-parallel mesh size (0 = no mesh)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel (model axis) size; above 1 implies a mesh")
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
    mesh = _mesh(args.mesh_data, args.mesh_model, device)

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
        mesh=mesh,
    )
    for i, loss in enumerate(losses):
        print(f"log[{i}] loss={loss:.4f}")
    if mesh is not None:
        trained_params = meshlib.unshard_params(_local(trained_params)[0])
    if args.export_hf:
        from manga_ocr_tpu_torch.models.convert import save_hf_checkpoint

        save_hf_checkpoint(args.export_hf, trained_params, cfg, tokenizer=tok)
        print(f"exported HF-format checkpoint to {args.export_hf}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
