"""Numerics of the port's Latin recognizer training on one CUDA card
(``manga_ocr_tpu_torch.train_latin``; imports nothing of JAX).

    python3 scripts/torch_latin_numerics.py grads
        One step of the full-width CRNN (96 classes, output 512, hidden 256;
        numpy seed-0 weights, one B=32 width-128 synthetic batch): each
        gradient leaf's gap to the host's f64 gradient over its max |g|, for
        the host in f32 (oneDNN and native convolutions), the card in f32
        (cuDNN, and without cuDNN), the card with TF32 on and the card in
        f64.  The network runs in the given type; the CTC recurrence in f32.
    python3 scripts/torch_latin_numerics.py escape [RUNS [CAP [FORM [BATCH [LR]]]]]
        The closed loop of tests/test_latin_closed_loop.py on the card from
        tests/fixtures/latin_closed_loop_init (JAX's PRNGKey(0) init), RUNS
        times (default 3): the step at which the loss first falls below
        0.05 after step 100 (or the loss at step CAP, default 2000, the JAX
        test's), and the loss every 100 steps.  FORM: "f32" (the default:
        train_latin as it stands), "det" (cuDNN's and torch's deterministic
        algorithms), "nocudnn" (cuDNN off: ATen's convolutions and LSTM) or
        "f64" (the network's parameters and images in f64; the CTC
        recurrence in f32).  BATCH (default 32) and LR (default 1e-3) are
        the test's batch size and Adam learning rate.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from manga_ocr_tpu_torch import train as trainlib  # noqa: E402
from manga_ocr_tpu_torch import train_latin as tl  # noqa: E402
from manga_ocr_tpu_torch.engine.latin import DEFAULT_CHARSET  # noqa: E402
from manga_ocr_tpu_torch.models import crnn  # noqa: E402
from manga_ocr_tpu_torch.models.detector import fp32_products  # noqa: E402


def grads() -> None:
    cfg = crnn.CrnnConfig(num_classes=len(DEFAULT_CHARSET) + 1)
    tree = crnn.init_crnn_params(cfg, 0, "cpu")
    batch = next(tl.synthetic_line_dataset(cfg, DEFAULT_CHARSET, 32, 128, 16, seed=0))

    def run(dev, dtype=torch.float32, tf32=False, ctx=contextlib.nullcontext()):
        params = trainlib._as_trainable(_cast(tree, dtype), dev)
        with ctx, (contextlib.nullcontext() if tf32 else fp32_products()):
            logits = crnn.crnn_forward(params, batch.images.to(dev, dtype), grad=True)
            loss = tl.ctc_loss(logits.float(), batch.labels.to(dev),
                               batch.label_paddings.to(dev)).mean()
            loss.backward()
        return loss.item(), {n: t.grad.double().cpu() for n, t in trainlib._leaves(params)}

    runs = {"host f32": run("cpu"),
            "host native": run("cpu", ctx=torch.backends.mkldnn.flags(enabled=False))}
    ref = run("cpu", torch.float64)
    if torch.cuda.is_available():
        runs["card f32"] = run("cuda")
        runs["card no cuDNN"] = run("cuda", ctx=torch.backends.cudnn.flags(enabled=False))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        runs["card TF32"] = run("cuda", tf32=True)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        runs["card f64"] = run("cuda", torch.float64)
    print(f"loss: host f64 {ref[0]!r}, " + ", ".join(f"{k} {v[0]!r}" for k, v in runs.items()))
    print("gap to the host's f64 gradient / max |g|")
    print("leaf".ljust(24) + "".join(k.rjust(15) for k in runs))
    for leaf, g in ref[1].items():
        m = g.abs().max().item()
        print(leaf.ljust(24) + "".join(f"{(r[1][leaf] - g).abs().max().item() / m:15.2e}"
                                       for r in runs.values()))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def escape(runs: int, cap: int, form: str, batch: int, lr: float) -> None:
    init, cfg, charset = tl.load_crnn_checkpoint(
        os.path.join(ROOT, "tests", "fixtures", "latin_closed_loop_init"), "cuda")
    dtype = torch.float64 if form == "f64" else torch.float32
    init = _cast(init, dtype)
    step = tl.make_ctc_train_step()
    if form == "det":
        torch.backends.cudnn.deterministic = True
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
    ctx = torch.backends.cudnn.flags(enabled=False) if form == "nocudnn" else contextlib.nullcontext()

    for r in range(runs):
        params, opt_state = tl.init_ctc_train_state(
            cfg, trainlib.make_optimizer(lr, weight_decay=0.0), device="cuda",
            init_params=init)
        data = tl.synthetic_line_dataset(cfg, charset, batch, 96, 6, seed=0)
        t0, trace = time.perf_counter(), []
        with ctx:
            for i in range(cap):
                b = next(data)
                params, opt_state, loss = step(params, opt_state,
                                               tl.CtcBatch(b.images.to(dtype), *b[1:]))
                loss = loss.item()
                if i % 100 == 0:
                    trace.append(round(loss, 4))
                if i > 100 and loss < 0.05:
                    break
        print(f"{form} B={batch} lr={lr} run {r + 1}: {i + 1} steps, loss {loss:.4f}, "
              f"{time.perf_counter() - t0:.1f} s; every 100: {trace}", flush=True)


def main() -> int:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if torch.cuda.is_available():
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    if sys.argv[1:2] == ["grads"]:
        grads()
    elif sys.argv[1:2] == ["escape"] and torch.cuda.is_available():
        args = sys.argv[2:7]
        escape(int(args[0]) if args else 3, int(args[1]) if args[1:] else 2000,
               args[2] if args[2:] else "f32", int(args[3]) if args[3:] else 32,
               float(args[4]) if args[4:] else 1e-3)
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
