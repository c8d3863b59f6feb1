"""Native checkpoint store (counterpart of ``manga_ocr_tpu/models/checkpoint.py``,
in the same files, so a checkpoint saved by either package loads in the
other).

A checkpoint is a directory: ``weights.npz`` with one array per leaf of the
parameter tree under its ``/``-joined path (list items by their index), and
``manifest.json`` with the model config (``format``, ``encoder``,
``decoder``, ``max_length``).  The port's trees are the JAX package's
layout with torch tensors as leaves (``models/params.py``); bf16 leaves are
saved as f32 (NumPy has no bf16), which loses nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from manga_ocr_tpu_torch.models.config import DecoderConfig, EncoderConfig, MangaOCRConfig
from manga_ocr_tpu_torch.models.params import _to_tensor

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = _to_numpy(tree)
    return out


def save_checkpoint(path: str, params: dict, cfg: MangaOCRConfig) -> None:
    """Write ``params`` (torch tensors or arrays) and ``cfg`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, WEIGHTS), **_flatten(params))
    manifest = {
        "format": 1,
        "encoder": dataclasses.asdict(cfg.encoder),
        "decoder": dataclasses.asdict(cfg.decoder),
        "max_length": cfg.max_length,
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_checkpoint(
    path: str, dtype: torch.dtype = torch.float32, device="cuda"
) -> tuple[dict, MangaOCRConfig]:
    """The tree under ``path`` as torch tensors on ``device`` (floating
    leaves in ``dtype``, integer leaves as saved) and its config.  ``device``
    is explicit: ``"cuda"`` raises when CUDA is unavailable."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_checkpoint: device='cuda' but CUDA is unavailable")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    cfg = MangaOCRConfig(
        encoder=EncoderConfig(**manifest["encoder"]),
        decoder=DecoderConfig(**manifest["decoder"]),
        max_length=manifest.get("max_length", 300),
    )
    tree: dict = {}
    with np.load(os.path.join(path, WEIGHTS)) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            t = _to_tensor(data[key], device)
            node[parts[-1]] = t.to(dtype) if t.is_floating_point() else t
    return _relistify(tree), cfg


def _relistify(node):
    """Rebuild list nodes that ``_flatten`` encoded as numeric path segments
    (``{"0": ..., "1": ...}`` back to a list, in numeric order)."""
    if not isinstance(node, dict):
        return node
    out = {k: _relistify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if idx == [str(i) for i in range(len(idx))]:
            return [out[k] for k in idx]
    return out
