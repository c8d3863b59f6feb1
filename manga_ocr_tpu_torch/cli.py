"""Command line of the port (counterpart of ``manga_ocr_tpu/cli.py``).

Usage:
    python -m manga_ocr_tpu_torch.cli --checkpoint DIR ocr IMAGE [IMAGE...]

``ocr`` reads each image as one crop, runs them all through one
``TorchMangaOcrEngine.ocr_page`` and prints ``path<TAB>text`` per crop.  The
JAX command line's ``process`` and ``bench`` subcommands, and its
``--wire``, ``--no-coalesce``, ``--mesh-data`` and ``--no-aot`` options, are
not ported: the command line rejects them.  The port has ``process``'s
detect → crop → OCR path (``detect.detector.BubbleDetector`` and
``runtime.pipeline.PagePipeline``); the subcommand still needs the project
and settings files (``core/project.py``, ``core/settings.py``), the export
(``runtime/export.py``), the translators (``translate/``) and the engine
registry (``engine/registry.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _build_engine(args):
    """A ``TorchMangaOcrEngine`` from ``args``: the HF checkpoint directory
    ``args.checkpoint`` (else ``$MANGA_OCR_CHECKPOINT``) loaded in f32, or
    random weights from ``args.seed`` (0 where ``args`` has none) at
    ``MangaOCRConfig.base()`` width with a warning; ``args.max_length``,
    ``args.dtype``, ``args.serving_kernels`` and ``args.device``."""
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig
    from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    ckpt = args.checkpoint or os.environ.get("MANGA_OCR_CHECKPOINT", "")
    if ckpt and os.path.isdir(ckpt):
        # Always load f32: the engine casts to the compute dtype itself and
        # takes its int8 quantization scales from the original weights.
        params, cfg = load_hf_checkpoint(ckpt)
        vocab_path = os.path.join(ckpt, "vocab.txt")
        tok = (
            CharTokenizer.from_vocab_file(vocab_path)
            if os.path.exists(vocab_path)
            else CharTokenizer.synthetic()
        )
    else:
        print(
            "warning: no checkpoint dir (pass --checkpoint or set "
            "MANGA_OCR_CHECKPOINT); using random weights — output will be "
            "garbage but the pipeline runs.",
            file=sys.stderr,
        )
        cfg = MangaOCRConfig.base()
        params = init_params(cfg, getattr(args, "seed", 0), "cpu")
        tok = CharTokenizer.synthetic()
    flag = args.serving_kernels
    return TorchMangaOcrEngine(
        params, cfg, tok, max_length=args.max_length, device=args.device,
        dtype=torch.float32 if args.dtype == "float32" else torch.bfloat16,
        serving_kernels=None if flag == "auto" else flag == "on",
    )


def cmd_ocr(args) -> int:
    from manga_ocr_tpu_torch.core import files as fio

    engine = _build_engine(args)
    crops = []
    for path in args.images:
        img = fio.safe_open_image(path)
        if img is None:
            print(f"error: cannot read {path}", file=sys.stderr)
            return 1
        crops.append(img)
    t0 = time.time()
    texts = engine.ocr_page(crops)
    dt = time.time() - t0
    for path, text in zip(args.images, texts):
        print(f"{path}\t{text}")
    print(f"# {len(crops)} crops in {dt:.2f}s", file=sys.stderr)
    return 0


def add_engine_options(p: argparse.ArgumentParser) -> None:
    """The engine's options, shared with ``serve.py``."""
    p.add_argument("--checkpoint", default="", help="HF checkpoint dir for the OCR model")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is unavailable")
    p.add_argument("--max-length", type=int, default=300)
    p.add_argument(
        "--dtype", default="bfloat16", choices=("bfloat16", "float32"),
        help="compute dtype (the CUDA kernels take bfloat16; float32 for CPU runs "
        "and reproducible evaluation)",
    )
    p.add_argument(
        "--serving-kernels", default="auto", choices=("auto", "on", "off"),
        help="int8 serving kernels: auto (engine default), on, or off (exact "
        "reference math)",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="manga-ocr-tpu-torch")
    add_engine_options(p)
    sub = p.add_subparsers(dest="cmd", required=True)
    p_ocr = sub.add_parser("ocr", help="OCR one or more crop images")
    p_ocr.add_argument("images", nargs="+")
    p_ocr.set_defaults(fn=cmd_ocr)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
