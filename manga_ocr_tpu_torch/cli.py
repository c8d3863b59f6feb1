"""Command line of the port (counterpart of ``manga_ocr_tpu/cli.py``).

Usage:
    python -m manga_ocr_tpu_torch.cli --checkpoint DIR ocr IMAGE [IMAGE...]
    python -m manga_ocr_tpu_torch.cli process FOLDER --out DIR
    python -m manga_ocr_tpu_torch.cli bench                       # throughput (JSON)

``ocr`` reads each image as one crop, runs them all through one
``TorchMangaOcrEngine.ocr_page`` and prints ``path<TAB>text`` per crop.
``process`` is the full pipeline over a folder of pages: load → detect
(``--detector`` U-Net or YOLOv8-seg weights, ``--detect-mode text``, or
the whole page as one region) → crop → batched OCR (``--enhanced``: the dual
pass) → optional translation (``--translate``, over HTTP) → typeset areas →
``project.json`` in ``--out`` and ``<page>_typeset.<fmt>`` beside each page.
Its flags, messages and outputs are the JAX command's; ``--device`` (default
``cuda``, which raises where CUDA is unavailable) places the OCR engine, the
detectors and the CRAFT proposer; ``--mesh-data N`` shards the OCR engine's
and the U-Net detector's batches over N devices (the visible CUDA devices,
or, under ``--device cpu``, an N-way virtual CPU mesh); ``--wire
{gray,packed}`` picks the engine's host -> device crop format and
``--no-coalesce`` sends and reads back a multi-bucket page bucket by bucket
(``TorchMangaOcrEngine``'s ``wire`` and ``coalesce``).  ``bench`` runs
``manga_ocr_tpu_torch.benchmark.main`` on ``--device`` (the other engine
options do not apply to it).  Like JAX's, the command line has no ``--no-aot``: ``ocr`` and ``process`` dispatch
eagerly, and only ``serve.py`` turns the engine's CUDA graphs on.
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
    ``args.dtype``, ``args.serving_kernels``, ``args.device``,
    ``args.mesh_data`` (``_mesh``), ``args.wire``, ``args.no_coalesce`` and
    ``args.no_aot`` (CUDA graphs on where ``args`` has it and it is False:
    ``serve.py``'s default, as JAX's ``cli._build_engine`` passes ``aot``)."""
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
        serving_kernels=None if flag == "auto" else flag == "on", mesh=_mesh(args),
        wire=getattr(args, "wire", "gray"), coalesce=not getattr(args, "no_coalesce", False),
        aot=not getattr(args, "no_aot", True),
    )


def _mesh(args):
    """The data-parallel mesh of ``args.mesh_data`` devices (None for 0 or
    1): every visible CUDA device (``make_mesh`` raises where fewer are
    visible), or, under a CPU ``args.device``, that many virtual CPU
    devices."""
    import torch

    n_data = int(getattr(args, "mesh_data", 0) or 0)
    if n_data <= 1:
        return None
    from manga_ocr_tpu_torch.parallel import mesh as meshlib

    device = torch.device(args.device)
    return meshlib.make_mesh(n_data, devices=[device] * n_data if device.type == "cpu" else None)


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


def cmd_process(args) -> int:
    """The full pipeline (JAX ``cli.cmd_process``) on ``args.device``."""
    from manga_ocr_tpu_torch.core import files as fio
    from manga_ocr_tpu_torch.core.geometry import Rect
    from manga_ocr_tpu_torch.core.project import Project, save_project
    from manga_ocr_tpu_torch.core.settings import Settings
    from manga_ocr_tpu_torch.detect import contours as cont
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector, crops_from_detections
    from manga_ocr_tpu_torch.runtime import export as ex
    from manga_ocr_tpu_torch.runtime.pipeline import OcrJob, PagePipeline
    from manga_ocr_tpu_torch.translate.service import TranslationService

    settings = Settings(args.settings) if args.settings else Settings()
    engine = _build_engine(args)

    detector = None
    det_ckpt = args.detector or settings.get("tpu.detector_checkpoint")
    if det_ckpt and os.path.exists(det_ckpt):
        if args.detector_type == "yolo":
            from manga_ocr_tpu_torch.models import yolo_seg

            cfg_y = yolo_seg.YoloSegConfig()
            yolo = yolo_seg.YoloBubbleDetector(
                yolo_seg.load_params(det_ckpt, cfg_y), cfg_y, device=args.device
            )

            class _YoloAdapter:
                def detect_bubbles(self, page):
                    mask = yolo.detect_bubble_mask(page)
                    return [
                        {"polygon": p, "text": None}
                        for p in cont.mask_to_polygons(mask, min_area=200)
                    ]

            detector = _YoloAdapter()
        else:
            # the OCR engine's data-parallel mesh: page batches shard too
            detector = BubbleDetector.from_checkpoint(det_ckpt, device=args.device,
                                                      mesh=engine.mesh)

    translate = None
    if args.translate:
        svc = TranslationService(settings)
        translate = lambda text, s: svc.translate_with_ai(
            text, provider=args.provider, target_lang=args.target_lang
        )

    # Enhanced dual-pass fidelity (reference workers.py:398-402): the second
    # pass goes to Tesseract(jpn) on the preprocessed crop when the binary
    # is installed; same-model-on-binarized is only the fallback.
    import functools as _ft

    from manga_ocr_tpu_torch.engine.registry import TesseractEngine

    try:
        second = TesseractEngine()
    except RuntimeError:
        second = None
    dual = _ft.partial(engine.ocr_page_dual, second_engine=second)
    pipe = PagePipeline(engine.ocr_page, translate=translate, dual_pass=dual)
    project = Project(project_dir=args.folder)

    pages = fio.list_images(args.folder)
    if not pages:
        print(f"no images found in {args.folder}", file=sys.stderr)
        return 1
    # one snapshot for the whole run (the settings do not change here)
    settings_dict = settings.as_dict()

    # Text-mode detection (reference AutoDetector mode "Text",
    # workers.py:470-474): proposals recognized in ONE batched dispatch,
    # detections carry their text so the pipeline's pre-text skip applies.
    text_proposer = None
    if args.detect_mode == "text" and args.text_proposer in ("auto", "craft"):
        from manga_ocr_tpu_torch.detect import text_detect as td

        craft_ckpt = settings.get("tpu.latin_craft_checkpoint") or ""
        if craft_ckpt and os.path.exists(craft_ckpt):
            from manga_ocr_tpu_torch.engine.latin import TorchLatinEngine
            from manga_ocr_tpu_torch.models import convert_latin as cl
            from manga_ocr_tpu_torch.models import craft

            latin = TorchLatinEngine(
                craft_params=craft.params_from_jax(
                    cl.convert_craft_state_dict(cl.load_torch_checkpoint(craft_ckpt))
                ),
                device=args.device,
            )
            text_proposer = td.craft_proposer(latin)
        elif args.text_proposer == "craft":
            # "not configured" and "configured but missing" get their own
            # messages
            if craft_ckpt:
                print(
                    f"--text-proposer craft: tpu.latin_craft_checkpoint is "
                    f"set but the file does not exist: {craft_ckpt}",
                    file=sys.stderr,
                )
            else:
                print(
                    "--text-proposer craft needs tpu.latin_craft_checkpoint "
                    "in settings",
                    file=sys.stderr,
                )
            return 1
        elif craft_ckpt:
            # auto mode with a configured-but-missing path: say so
            print(
                f"note: tpu.latin_craft_checkpoint not found ({craft_ckpt}); "
                "falling back to the morphological text proposer",
                file=sys.stderr,
            )

    for path in pages:
        page = fio.safe_open_image(path)
        if page is None:
            continue
        if args.detect_mode == "text":
            from manga_ocr_tpu_torch.detect import text_detect as td

            items = td.detect_text_regions(
                page, engine.ocr_page, proposer=text_proposer
            )
            detections = [{"polygon": poly, "text": text} for text, poly in items]
        elif detector is not None:
            detections = detector.detect_bubbles(page)
            # auto_split_bubbles is a per-job UI-checkbox key in the
            # reference (get_current_settings, main_window.py:4946), not a
            # settings.json key — the CLI flag is the checkbox analog
            if settings_dict.get("auto_split_bubbles", not args.no_split_bubbles):
                from manga_ocr_tpu_torch.detect import postprocess as _post

                detections = _post.split_extended_bubbles(detections)
        else:
            # no detector weights: the whole page as one region
            h, w = page.shape[:2]
            from manga_ocr_tpu_torch.core.geometry import polygon_from_rect

            detections = [{"polygon": polygon_from_rect(Rect(0, 0, w, h)), "text": None}]
        crops, metas = crops_from_detections(page, detections)
        jobs = [
            OcrJob(path, m["rect"], m["polygon"], crop, settings_dict, m["text"])
            for crop, m in zip(crops, metas)
        ]
        results = pipe.process_jobs(jobs, enhanced=args.enhanced or None)
        for r in results:
            if r.area is not None:
                project.add_area(path, r.area, push_undo=False)
                project.register_history_entry(
                    path, r.area, r.original_text, r.translated_text
                )
        print(f"{path}: {len(results)} regions", file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)
    proj_path = os.path.join(args.out, "project.json")
    save_project(project, proj_path)
    written = ex.batch_save(project, fmt=args.format)
    print(f"project: {proj_path}; typeset pages: {len(written)}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from manga_ocr_tpu_torch import benchmark

    benchmark.main(device=args.device)
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
    p.add_argument(
        "--wire", default="gray", choices=("gray", "packed"),
        help="host->device crop format: padded gray batches (default) or "
        "height-tight row-packed buffers (one device only)",
    )
    p.add_argument(
        "--no-coalesce", action="store_true",
        help="send and read back a multi-bucket page bucket by bucket instead of "
        "in one transfer each way (a measurement aid)",
    )
    p.add_argument(
        "--mesh-data", type=int, default=0,
        help="shard crop batches over N devices (data-parallel serving; 0/1 = one "
        "device; under --device cpu an N-way virtual CPU mesh)",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="manga-ocr-tpu-torch")
    add_engine_options(p)
    sub = p.add_subparsers(dest="cmd", required=True)
    p_ocr = sub.add_parser("ocr", help="OCR one or more crop images")
    p_ocr.add_argument("images", nargs="+")
    p_ocr.set_defaults(fn=cmd_ocr)

    p_proc = sub.add_parser("process", help="full detect→OCR→translate→typeset pipeline")
    p_proc.add_argument("folder")
    p_proc.add_argument("--out", required=True)
    p_proc.add_argument("--detector", default="", help="bubble segmenter .npz")
    p_proc.add_argument(
        "--detector-type", default="unet", choices=("unet", "yolo"),
        help="segmentation family for --detector weights",
    )
    p_proc.add_argument("--settings", default="", help="settings.json path")
    p_proc.add_argument("--translate", action="store_true")
    p_proc.add_argument("--provider", default="gemini")
    p_proc.add_argument("--target-lang", default="English")
    p_proc.add_argument("--enhanced", action="store_true", help="dual-pass OCR")
    p_proc.add_argument(
        "--no-split-bubbles",
        action="store_true",
        help="disable the reference's auto_split_bubbles rule (UI checkbox "
        "analog, main_window.py:4946)",
    )
    p_proc.add_argument(
        "--detect-mode",
        default="bubble",
        choices=("bubble", "text"),
        help="detection sweep mode (the reference AutoDetector's "
        "Bubble/Text switch, workers.py:448-482): bubble = segmenter mask "
        "-> polygons; text = region proposals recognized in one batched "
        "dispatch",
    )
    p_proc.add_argument(
        "--text-proposer",
        default="auto",
        choices=("auto", "morph", "craft"),
        help="text-mode proposal source: morphological pass (reference "
        "behavior) or the CRAFT detector (needs "
        "tpu.latin_craft_checkpoint); auto = craft when configured",
    )
    p_proc.add_argument("--format", default="PNG")
    p_proc.set_defaults(fn=cmd_process)

    p_bench = sub.add_parser("bench", help="throughput benchmark on this card")
    p_bench.set_defaults(fn=cmd_bench)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
