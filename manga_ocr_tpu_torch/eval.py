"""Accuracy evaluation harness (counterpart of ``manga_ocr_tpu/eval.py``):
character error rate and exact match of the engine's texts against fixture
transcriptions.

Fixture format (a directory):
    fixtures/
      000.png       -- the crop
      000.txt       -- the reference engine's output for that crop (UTF-8)
      018.dual.txt  -- for a dual-pass fixture, the second pass's output
      manifest.json -- optional: each crop's kind and orientation, and the
                       engine the expected outputs came from
Run:  python -m manga_ocr_tpu_torch.eval fixtures/ --checkpoint DIR [--device cpu]

``DIR`` is an HF checkpoint directory (``config.json`` and
``model.safetensors`` or ``pytorch_model.bin``, ``models/convert.py``) or a
checkpoint of ``models/checkpoint.py`` (either package's).
Where the manifest names the ``tiny-random`` engine, the engine takes the
manifest's ``max_length``, ``dtype`` and ``serving_kernels``; otherwise
``--max-length``, ``--dtype`` and ``--serving-kernels``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os


def levenshtein(a: str, b: str) -> int:
    """Edit distance by the two-row dynamic programme."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def cer(hypothesis: str, reference: str) -> float:
    """Character error rate (edit distance / reference length)."""
    if not reference:
        return 0.0 if not hypothesis else 1.0
    return levenshtein(hypothesis, reference) / len(reference)


def load_fixtures(path: str, manifest: dict | None = None) -> list[dict]:
    """Fixture dicts: {name, crop, ref, orientation, kind, dual_ref?}.

    ``manifest["items"]`` records each crop's kind and orientation;
    directories without a manifest default every crop to Vertical."""
    from manga_ocr_tpu_torch.core.files import safe_open_image

    meta = {}
    if manifest:
        meta = {it["name"]: it for it in manifest.get("items", [])}
    out = []
    for name in sorted(os.listdir(path)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            continue
        stem = os.path.splitext(name)[0]
        txt = os.path.join(path, f"{stem}.txt")
        if not os.path.exists(txt):
            continue
        img = safe_open_image(os.path.join(path, name))
        if img is None:
            continue
        with open(txt, encoding="utf-8") as f:
            ref = f.read().strip()
        item = {
            "name": stem,
            "crop": img,
            "ref": ref,
            "kind": meta.get(stem, {}).get("kind", "plain"),
            "orientation": meta.get(stem, {}).get("orientation", "Vertical"),
        }
        dual = os.path.join(path, f"{stem}.dual.txt")
        if os.path.exists(dual):
            with open(dual, encoding="utf-8") as f:
                item["dual_ref"] = f.read().strip()
        out.append(item)
    return out


def _orient_code(name: str) -> int:
    from manga_ocr_tpu_torch.ops import preprocess as pp

    return {
        "Vertical": pp.ORIENT_VERTICAL,
        "Horizontal": pp.ORIENT_HORIZONTAL,
        "Auto-Detect": pp.ORIENT_AUTO,
        "None": pp.ORIENT_NONE,
    }.get(name, pp.ORIENT_VERTICAL)


def evaluate(engine, fixtures: list) -> dict:
    """``engine``: a batched OCR engine (``ocr_page`` / ``ocr_page_dual``)
    or a bare ``ocr_page`` callable; ``fixtures``: ``load_fixtures`` dicts.
    Crops go batched per orientation, as served; dual-pass fixtures go
    through ``ocr_page_dual`` and both passes are scored."""
    if not fixtures:
        return {"n": 0, "mean_cer": 0.0, "exact_match": 0.0}
    if not hasattr(engine, "ocr_page"):  # a bare callable

        class _Wrap:
            def __init__(self, fn):
                self.ocr_page = fn

        engine = _Wrap(engine)

    hyps: dict[int, str] = {}
    dual_hyps: dict[int, str] = {}
    dual_idx = [i for i, f in enumerate(fixtures) if "dual_ref" in f]
    if dual_idx and hasattr(engine, "ocr_page_dual"):
        pairs = engine.ocr_page_dual([fixtures[i]["crop"] for i in dual_idx])
        for i, (raw, second) in zip(dual_idx, pairs):
            hyps[i] = raw
            dual_hyps[i] = second
    rest = [i for i in range(len(fixtures)) if i not in hyps]
    # probe the signature up front: catching TypeError around the call would
    # also swallow one raised inside OCR
    try:
        takes_orient = len(inspect.signature(engine.ocr_page).parameters) >= 2
    except (TypeError, ValueError):
        takes_orient = True
    for orientation in sorted({fixtures[i]["orientation"] for i in rest}):
        idxs = [i for i in rest if fixtures[i]["orientation"] == orientation]
        crops = [fixtures[i]["crop"] for i in idxs]
        if takes_orient:
            out = engine.ocr_page(crops, _orient_code(orientation))
        else:
            out = engine.ocr_page(crops)
        hyps.update(dict(zip(idxs, out)))

    cers, exact, per_item = [], 0, []
    for i, f in enumerate(fixtures):
        hyp = hyps[i]
        c = cer(hyp, f["ref"])
        cers.append(c)
        exact += hyp == f["ref"]
        row = {
            "name": f["name"],
            "kind": f["kind"],
            "orientation": f["orientation"],
            "cer": round(c, 4),
            "ref": f["ref"],
            "hyp": hyp,
        }
        if i in dual_hyps:
            c2 = cer(dual_hyps[i], f["dual_ref"])
            cers.append(c2)
            exact += dual_hyps[i] == f["dual_ref"]
            row["dual_cer"] = round(c2, 4)
            row["dual_ref"] = f["dual_ref"]
            row["dual_hyp"] = dual_hyps[i]
        per_item.append(row)
    n_scored = len(cers)
    return {
        "n": len(fixtures),
        "n_scored": n_scored,
        "mean_cer": round(sum(cers) / n_scored, 4),
        "exact_match": round(exact / n_scored, 4),
        "items": per_item,
    }


def build_engine(checkpoint: str, device, max_length: int, dtype: str, serving_kernels: str):
    """A ``TorchMangaOcrEngine`` on ``device`` from a checkpoint directory:
    an HF checkpoint (``config.json``, ``models/convert.py``) or the npz
    store of ``models/checkpoint.py``; its ``vocab.txt`` if present, else the
    synthetic vocab.  ``dtype`` is "float32" or "bfloat16";
    ``serving_kernels`` "on", "off" or "auto"."""
    import torch

    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.checkpoint import load_checkpoint
    from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    # f32 weights: the engine casts to the compute dtype itself and takes its
    # int8 scales from the original weights
    if os.path.exists(os.path.join(checkpoint, "config.json")):
        params, cfg = load_hf_checkpoint(checkpoint, torch.float32)
    else:
        params, cfg = load_checkpoint(checkpoint, torch.float32, device)
    vocab = os.path.join(checkpoint, "vocab.txt")
    tok = (CharTokenizer.from_vocab_file(vocab) if os.path.exists(vocab)
           else CharTokenizer.synthetic())
    return TorchMangaOcrEngine(
        params, cfg, tok,
        max_length=max_length,
        dtype=torch.float32 if dtype == "float32" else torch.bfloat16,
        device=device,
        serving_kernels=None if serving_kernels == "auto" else serving_kernels == "on",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m manga_ocr_tpu_torch.eval")
    p.add_argument("fixtures")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory: an HF checkpoint (config.json) or the "
                   "models/checkpoint.py format")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-length", type=int, default=300)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="compute dtype (float32 for reproducible evaluation)")
    p.add_argument("--serving-kernels", default="auto", choices=("auto", "on", "off"),
                   help="the serving configuration's kernels, or 'off' for the exact "
                   "reference math")
    args = p.parse_args(argv)

    manifest = None
    manifest_path = os.path.join(args.fixtures, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    if manifest is not None and manifest.get("engine") == "tiny-random":
        # the engine the fixtures' expected outputs came from
        engine = build_engine(
            args.checkpoint, args.device,
            int(manifest.get("max_length", 12)),
            manifest.get("dtype", "float32"),
            "on" if manifest.get("serving_kernels", False) else "off",
        )
    else:
        engine = build_engine(args.checkpoint, args.device, args.max_length, args.dtype,
                              args.serving_kernels)
    report = evaluate(engine, load_fixtures(args.fixtures, manifest))
    print(json.dumps(report, ensure_ascii=False, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
