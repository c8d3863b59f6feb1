"""CTC training for the Latin recognizer on PyTorch (counterpart of
``manga_ocr_tpu/train_latin.py``): the CTC step over the CRNN's per-column
logits, a synthetic line dataset of per-character-distinct pattern glyphs,
a directory dataset of (line.png, line.txt) pairs, and the native
checkpoint directory that ``TorchLatinEngine.from_checkpoints`` and the
registry's ``"Latin (TPU)"`` factory read (``tpu.latin_crnn_checkpoint``).

The step is plain PyTorch with autograd, as the JAX step is plain XLA:
``models/crnn.crnn_forward(..., grad=True)`` (convolutions and cuDNN's or
ATen's LSTM over the tree's own tensors) and ``ctc_loss``, the port's own
recurrence of ``optax.ctc_loss`` (not ``F.ctc_loss``, which differs on rows
that cannot be aligned), in float32 with TF32 off on both devices
(``fp32_products`` around forward, backward and update).  The optimizer is
``train.make_optimizer`` with ``optax.adamw``'s default decay of 1e-4.

The checkpoint files are the JAX package's: ``crnn.npz`` keyed by the flat
paths of JAX's tree (``params_to_jax``) and ``manifest.json`` with the
config and the training charset, so either package reads the other's
directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from manga_ocr_tpu_torch import train as trainlib
from manga_ocr_tpu_torch.models import checkpoint as ckpt
from manga_ocr_tpu_torch.models import crnn as crnn_mod
from manga_ocr_tpu_torch.models.crnn import CrnnConfig
from manga_ocr_tpu_torch.models.detector import fp32_products

MANIFEST = "manifest.json"
WEIGHTS = "crnn.npz"
LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log(0)
ADAMW_DECAY = 1e-4  # optax.adamw's default weight decay


def _ctc_frames(width: int) -> int:
    """CTC time steps the CRNN emits for an input of ``width`` columns
    (W/4 - 1 at the production conv geometry, engine/latin.py)."""
    return width // 4 - 1


def _check_ctc_frames(width: int, max_chars: int) -> None:
    """CTC cannot align more labels than frames; e.g. --width 32
    --max-chars 16 gives 7 frames for up-to-16 labels."""
    frames = _ctc_frames(width)
    if frames < max_chars:
        raise ValueError(
            f"width {width} yields only {frames} CTC frames (< max_chars "
            f"{max_chars}); use width >= {(max_chars + 1) * 4}"
        )


class CtcBatch(NamedTuple):
    images: torch.Tensor  # [B, 1, H, W] normalized gray (JAX's is [B, H, W, 1])
    labels: torch.Tensor  # [B, N] int32 class ids (1-based; 0 = blank)
    label_paddings: torch.Tensor  # [B, N] float32, 1.0 where padded


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with JAX's gradient, ``g * exp(x - out)`` for each
    input (``jax.numpy.logaddexp``'s jvp), where torch's own backward takes
    ``g / (1 + exp(other - x))``.  The two agree to rounding on aligned rows;
    near the ``LOG_EPSILON`` floor (|x| ~ 1e5, an f32 ulp ~8e-3) JAX's
    differs by up to ~1%, and a row that cannot be aligned lives there."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC loss [B] with ``optax.ctc_loss``'s semantics, every
    frame valid (JAX's step passes zero logit paddings): log-softmax over
    the classes, blank 0, label lengths from ``label_paddings``
    (right-padded), and ``LOG_EPSILON`` in place of log(0), so a row that
    cannot be aligned (more frames needed than given) costs a large finite
    value and carries a gradient, where ``F.ctc_loss`` gives inf.  The forward recurrence is
    optax's, op for op, its log-add-exp's gradient JAX's (``_LogAddExp``):
    blank (phi) and label (emit) log-alphas over the frames."""
    b = logits.shape[0]
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    # repeat[b, k] == 1.0 when label k equals label k + 1
    repeat = torch.nn.functional.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    logprobs_phi = logprobs[:, :, :1].transpose(0, 1)  # blank 0: [T, B, 1]
    logprobs_emit = torch.gather(
        logprobs, 2, labels.long()[:, None, :].expand(-1, logprobs.shape[1], -1)
    ).transpose(0, 1)  # [T, B, N]

    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=torch.float32, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, dtype=torch.float32, device=logits.device)

    def update_phi(phi, added):  # phi[:, 1:] plus ``added`` in log space
        return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], added)], dim=-1)

    eps_repeat, eps_other = LOG_EPSILON * repeat, LOG_EPSILON * (1.0 - repeat)
    for lp_emit, lp_phi in zip(logprobs_emit, logprobs_phi):
        # emit-to-phi epsilon transition, except where the next label repeats
        prev_phi = update_phi(phi, emit + eps_repeat)
        # phi-to-emit and emit self-loop
        next_emit = _LogAddExp.apply(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # phi self-loop; emit-to-phi blank only where the next label repeats
        phi = update_phi(prev_phi + lp_phi, emit + lp_phi + eps_other)
        emit = next_emit
    # the last epsilon transition
    phi = update_phi(phi, emit)
    return -torch.gather(phi, 1, labellens[:, None])[:, 0]


def ctc_loss_fn(params: dict, batch: CtcBatch) -> torch.Tensor:
    """The batch mean of ``ctc_loss`` over the CRNN's logits (a scalar
    tensor with a graph to the tree's leaves)."""
    logits = crnn_mod.crnn_forward(params, batch.images, grad=True)
    return ctc_loss(logits, batch.labels, batch.label_paddings).mean()


def make_ctc_train_step():
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    batch moved to the params' device, zero the gradients, the loss,
    backward and the optimizer step, all with TF32 off; the params are
    updated in place and the loss stays a device tensor (no host sync).
    The optimizer travels in ``opt_state`` (``train.make_optimizer``), so
    the step takes none, where JAX's closes over its optax transform."""

    def step(params, opt_state: trainlib.OptState, batch: CtcBatch):
        device = params["head"]["bias"].device
        batch = CtcBatch(*(t.to(device, non_blocking=True) for t in batch))
        with fp32_products():
            opt_state.optimizer.zero_grad(set_to_none=True)
            loss = ctc_loss_fn(params, batch)
            loss.backward()
            opt_state.optimizer.step()
        if opt_state.scheduler is not None:
            opt_state.scheduler.step()
        return params, opt_state, loss.detach()

    return step


def init_ctc_train_state(cfg: CrnnConfig, optimizer, seed: int = 0, device="cuda",
                         init_params: dict | None = None):
    """(params, opt_state) on ``device`` (``"cuda"`` raises where CUDA is
    unavailable): the port's numpy init of ``seed`` (``crnn.init_crnn_params``;
    JAX draws from a PRNG key, so the weights differ), or a trainable copy
    of ``init_params`` (the port's tree) to fine-tune."""
    device = trainlib._device(device)
    if init_params is None:
        init_params = crnn_mod.init_crnn_params(cfg, seed, "cpu")
    params = trainlib._as_trainable(init_params, device)
    return params, optimizer(params)


# ---------------------------------------------------------------------------
# Synthetic horizontal-line dataset
# ---------------------------------------------------------------------------


def render_line(
    text: str, charset: str, height: int, width: int, rng
) -> tuple[np.ndarray, int]:
    """Render ``text`` horizontally as per-character-distinct pattern glyphs
    on paper tone -- (gray uint8 [height, width], chars actually drawn).
    The drawn count matters: labels must cover exactly what the image
    shows, or CTC fits phantom tail characters."""
    img = np.full((height, width), 255, np.uint8)
    gs = max(4, min(height - 4, (width - 4) // max(len(text), 1) - 2))
    x = 2
    y = max(0, (height - gs) // 2)
    drawn = 0
    for ch in text:
        gl = trainlib.pattern_glyph(ch, gs)
        if x + gl.shape[1] > width - 2:
            break
        img[y : y + gl.shape[0], x : x + gl.shape[1]] = gl
        x += gl.shape[1] + 2
        drawn += 1
    return img, drawn


def _batch(images, labels, paddings) -> CtcBatch:
    return CtcBatch(torch.from_numpy(images), torch.from_numpy(labels),
                    torch.from_numpy(paddings))


def synthetic_line_dataset(
    cfg: CrnnConfig,
    charset: str,
    batch_size: int,
    width: int,
    max_chars: int,
    seed: int = 0,
):
    """Infinite generator of CPU ``CtcBatch``es of rendered charset lines
    (label ids are 1-based -- 0 is the CTC blank); JAX's batches for the
    same seed, images in [B, 1, H, W]."""
    rng = np.random.default_rng(seed)
    h = cfg.input_height
    _check_ctc_frames(width, max_chars)

    while True:
        images = np.zeros((batch_size, 1, h, width), np.float32)
        labels = np.zeros((batch_size, max_chars), np.int32)
        paddings = np.ones((batch_size, max_chars), np.float32)
        for i in range(batch_size):
            n = int(rng.integers(1, max_chars + 1))
            idxs = rng.integers(0, len(charset), size=n)
            text = "".join(charset[k] for k in idxs)
            img, drawn = render_line(text, charset, h, width, rng)
            images[i, 0] = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
            labels[i, :drawn] = idxs[:drawn] + 1
            paddings[i, :drawn] = 0.0
        yield _batch(images, labels, paddings)


def directory_line_dataset(
    data_dir: str,
    cfg: CrnnConfig,
    charset: str,
    batch_size: int,
    width: int,
    max_chars: int,
    seed: int = 0,
):
    """Infinite generator of CPU ``CtcBatch``es over ``(name.png, name.txt)``
    line pairs.

    Images are resized to ``cfg.input_height`` keeping aspect (the engine's
    serving-side rule, ``engine/latin.py recognize_lines``), left-aligned
    into the fixed training width; labels use 1-based charset ids.  Pairs
    whose text contains characters outside ``charset`` or exceeds
    ``max_chars`` are skipped with a printed line (once each)."""
    from PIL import Image

    from manga_ocr_tpu_torch.engine.latin import _resize_gray

    _check_ctc_frames(width, max_chars)
    idx = {c: i + 1 for i, c in enumerate(charset)}
    items: list[tuple[np.ndarray, list[int]]] = []
    for name in sorted(os.listdir(data_dir)):
        if not name.endswith(".txt"):
            continue
        stem = name[:-4]
        img_path = None
        for ext in (".png", ".jpg", ".jpeg", ".bmp"):
            cand = os.path.join(data_dir, stem + ext)
            if os.path.exists(cand):
                img_path = cand
                break
        if img_path is None:
            continue
        with open(os.path.join(data_dir, name), encoding="utf-8") as f:
            text = f.read().strip("\n")
        if not text or len(text) > max_chars or any(c not in idx for c in text):
            print(f"train_latin: skipping {stem} (empty/too long/out-of-charset)")
            continue
        if len(text) > _ctc_frames(width):
            # CTC needs >= one frame per label
            print(
                f"train_latin: skipping {stem} ({len(text)} labels > "
                f"{_ctc_frames(width)} CTC frames at --width {width})"
            )
            continue
        gray = np.asarray(Image.open(img_path).convert("L"), np.uint8)
        h, w = gray.shape
        nw = min(width, max(8, int(round(w * cfg.input_height / max(h, 1)))))
        items.append((_resize_gray(gray, (cfg.input_height, nw)), [idx[c] for c in text]))
    if not items:
        raise ValueError(f"no usable (img, txt) line pairs in {data_dir}")

    def _gen():
        rng = np.random.default_rng(seed)
        hh = cfg.input_height
        while True:
            picks = rng.integers(0, len(items), size=batch_size)
            # Pad value -1.0 = the serving distribution: recognize_lines
            # zero-pads the uint8 batch BEFORE normalizing, so the tail a
            # fine-tuned model sees at inference is (0/255-0.5)/0.5 = -1.0
            # (black), not 0.0 (mid-gray).
            images = np.full((batch_size, 1, hh, width), -1.0, np.float32)
            labels = np.zeros((batch_size, max_chars), np.int32)
            paddings = np.ones((batch_size, max_chars), np.float32)
            for row, k in enumerate(picks):
                gray, ids = items[int(k)]
                images[row, 0, :, : gray.shape[1]] = (
                    gray.astype(np.float32) / 255.0 - 0.5
                ) / 0.5
                labels[row, : len(ids)] = ids
                paddings[row, : len(ids)] = 0.0
            yield _batch(images, labels, paddings)

    return _gen()


# ---------------------------------------------------------------------------
# Native checkpoint store (loadable by TorchLatinEngine / the registry)
# ---------------------------------------------------------------------------


def save_crnn_checkpoint(
    path: str, params, cfg: CrnnConfig, charset: str
) -> None:
    """Write the recognizer as a native checkpoint dir: flat ``crnn.npz`` of
    JAX's tree (``params``: the port's tree or a ``Crnn``) + a JSON manifest
    carrying the config and the training charset (so serving never has to
    guess the label mapping)."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, WEIGHTS), **ckpt._flatten(crnn_mod.params_to_jax(params)))
    manifest = {"format": 1, "charset": charset, **dataclasses.asdict(cfg)}
    with open(os.path.join(path, MANIFEST), "w", encoding="utf-8") as f:
        json.dump(manifest, f, ensure_ascii=False, indent=2)


def load_crnn_checkpoint(path: str, device="cuda") -> tuple[dict, CrnnConfig, str]:
    """Inverse of :func:`save_crnn_checkpoint` (either package's directory)
    -> (the port's tree on ``device``, cfg, charset); ``"cuda"`` raises
    where CUDA is unavailable."""
    device = trainlib._device(device)
    with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    charset = manifest.pop("charset")
    manifest.pop("format", None)
    cfg = CrnnConfig(**manifest)
    tree: dict = {}
    with np.load(os.path.join(path, WEIGHTS)) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return crnn_mod.params_from_jax(ckpt._relistify(tree), device), cfg, charset


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """Fine-tune / train the Latin recognizer:
    ``python -m manga_ocr_tpu_torch.train_latin``.

    Synthetic pattern-glyph lines by default; ``--data DIR`` of
    (line.png, line.txt) pairs for real data.  ``--init`` seeds from a
    converted EasyOCR ``.pth`` or a native checkpoint dir; ``--out`` writes
    the native dir the registry loads via ``tpu.latin_crnn_checkpoint``.
    Runs on ``--device`` (``cuda`` by default, which raises where CUDA is
    unavailable)."""
    import argparse

    from manga_ocr_tpu_torch.engine.latin import DEFAULT_CHARSET

    p = argparse.ArgumentParser(prog="manga-ocr-tpu-torch-train-latin")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--width", type=int, default=128, help="training line width (px)")
    p.add_argument("--max-chars", type=int, default=16)
    p.add_argument("--charset", default=DEFAULT_CHARSET)
    p.add_argument("--data", default="", help="dir of (line.png, line.txt) pairs; default: synthetic")
    p.add_argument("--init", default="", help="EasyOCR .pth or native checkpoint dir to fine-tune from")
    p.add_argument("--out", default="", help="native checkpoint dir to write")
    p.add_argument("--save-every", type=int, default=0, help="also save every N steps (0 = end only)")
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--output-channel", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    args = p.parse_args(argv)

    try:
        _check_ctc_frames(args.width, args.max_chars)
    except ValueError as e:
        p.error(str(e))
    device = trainlib._device(args.device)

    charset = args.charset
    if args.init and os.path.isdir(args.init):
        params, cfg, charset = load_crnn_checkpoint(args.init, "cpu")
        # The checkpoint manifest is authoritative for architecture +
        # charset; an explicitly-passed conflicting flag would otherwise be
        # silently ignored -- fail loudly instead.
        conflicts = [
            (flag, passed, got)
            for flag, passed, got in (
                ("--charset", args.charset, charset),
                ("--hidden-size", args.hidden_size, cfg.hidden_size),
                ("--output-channel", args.output_channel, cfg.output_channel),
            )
            if passed != p.get_default(flag.lstrip("-").replace("-", "_"))
            and passed != got
        ]
        if conflicts:
            p.error(
                "; ".join(
                    f"{flag}={passed!r} conflicts with the --init checkpoint "
                    f"manifest ({got!r}); drop the flag (the manifest is "
                    "authoritative) or train from scratch"
                    for flag, passed, got in conflicts
                )
            )
    elif args.init:  # torch .pth
        from manga_ocr_tpu_torch.models import convert_latin as cl

        tree = cl.convert_crnn_state_dict(cl.load_torch_checkpoint(args.init))
        num_classes = tree["head"]["bias"].shape[0]
        if len(charset) + 1 != num_classes:
            print(
                f"--init has {num_classes} classes; --charset must have "
                f"{num_classes - 1} characters"
            )
            return 1
        cfg = CrnnConfig(
            num_classes=num_classes,
            output_channel=args.output_channel,
            hidden_size=args.hidden_size,
        )
        params = crnn_mod.params_from_jax(tree)
    else:
        cfg = CrnnConfig(
            num_classes=len(charset) + 1,
            output_channel=args.output_channel,
            hidden_size=args.hidden_size,
        )
        params = None

    optimizer = trainlib.make_optimizer(args.lr, weight_decay=ADAMW_DECAY)
    params, opt_state = init_ctc_train_state(cfg, optimizer, args.seed, device,
                                             init_params=params)
    step = make_ctc_train_step()

    if args.data:
        dataset = directory_line_dataset(
            args.data, cfg, charset, args.batch_size, args.width,
            args.max_chars, seed=args.seed,
        )
    else:
        dataset = synthetic_line_dataset(
            cfg, charset, args.batch_size, args.width, args.max_chars,
            seed=args.seed,
        )

    loss = float("nan")
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, next(dataset))
        if args.log_every and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {i}: ctc_loss={float(loss):.4f}", flush=True)
        if args.out and args.save_every and i and i % args.save_every == 0:
            save_crnn_checkpoint(args.out, params, cfg, charset)
    if args.out:
        save_crnn_checkpoint(args.out, params, cfg, charset)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
