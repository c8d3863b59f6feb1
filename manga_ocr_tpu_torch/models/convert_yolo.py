"""Ultralytics YOLOv8-seg checkpoint -> the JAX package's parameter tree
(BN folded; the port's own copy of ``manga_ocr_tpu/models/convert_yolo.py``:
one state dict gives both packages identical arrays).

The reference runs its second bubble-detector family through the
ultralytics torch black box (``_run_yolov8_inference``,
``main_window.py:6817-6841``, model files registered at ``:515-516``).  This
converter maps a YOLOv8-seg state dict (the ``model.model`` Sequential's
parameter names, e.g. ``model.0.conv.weight``) onto the structure of
``models/yolo_seg.py``:

- every ``Conv`` module (conv + BatchNorm + SiLU) folds its BatchNorm into
  the conv kernel and a bias: w' = w * g/sqrt(v+eps), b' = b - m*g/sqrt(v+eps),
  eps 1e-3 (ultralytics' BatchNorm2d),
- torch OIHW conv kernels -> HWIO,
- the Proto upsample ``ConvTranspose2d`` kernel [I, O, kh, kw] -> [kh, kw, I, O],
- head branch finals are plain convs (bias kept, no BN).

The result is numpy in the JAX layout; ``yolo_seg.params_from_jax`` puts it
on a device in the port's.  Parity: ``tests/test_torch_yolo.py``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from manga_ocr_tpu_torch.models.yolo_seg import YoloSegConfig

BN_EPS = 1e-3  # ultralytics Conv uses BatchNorm2d(eps=0.001)


def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """Fold ``{prefix}.conv`` + ``{prefix}.bn`` into kernel [kh,kw,I,O] + bias."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)  # [O, I, kh, kw]
    g = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
    scale = g / np.sqrt(var + BN_EPS)
    kernel = (w * scale[:, None, None, None]).transpose(2, 3, 1, 0)
    bias = b - mean * scale
    return {"kernel": np.ascontiguousarray(kernel), "bias": bias}


def _plain_conv(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    return {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }


def _c2f(sd, prefix: str, n: int) -> dict:
    return {
        "cv1": _fold_bn(sd, f"{prefix}.cv1"),
        "m": [
            {
                "cv1": _fold_bn(sd, f"{prefix}.m.{i}.cv1"),
                "cv2": _fold_bn(sd, f"{prefix}.m.{i}.cv2"),
            }
            for i in range(n)
        ],
        "cv2": _fold_bn(sd, f"{prefix}.cv2"),
    }


def _branch(sd, prefix: str) -> dict:
    """One decoupled-head branch: Conv, Conv, plain 1x1 conv."""
    return {
        "c1": _fold_bn(sd, f"{prefix}.0"),
        "c2": _fold_bn(sd, f"{prefix}.1"),
        "out": _plain_conv(sd, f"{prefix}.2"),
    }


def convert_yolo_state_dict(
    sd: Mapping[str, np.ndarray], cfg: YoloSegConfig
) -> dict:
    """State dict (numpy values, ultralytics ``model.N...`` names) -> pytree
    matching ``yolo_seg.init_params``."""
    d = cfg.depth
    head = "model.22"
    up_w = np.asarray(sd[f"{head}.proto.upsample.weight"], np.float32)  # [I,O,2,2]
    params = {
        "stem": _fold_bn(sd, "model.0"),
        "down1": _fold_bn(sd, "model.1"),
        "c2f1": _c2f(sd, "model.2", d[0]),
        "down2": _fold_bn(sd, "model.3"),
        "c2f2": _c2f(sd, "model.4", d[1]),
        "down3": _fold_bn(sd, "model.5"),
        "c2f3": _c2f(sd, "model.6", d[2]),
        "down4": _fold_bn(sd, "model.7"),
        "c2f4": _c2f(sd, "model.8", d[3]),
        "sppf": {
            "cv1": _fold_bn(sd, "model.9.cv1"),
            "cv2": _fold_bn(sd, "model.9.cv2"),
        },
        "n_td4": _c2f(sd, "model.12", d[0]),
        "n_td3": _c2f(sd, "model.15", d[0]),
        "n_bu3": _fold_bn(sd, "model.16"),
        "n_bu4": _c2f(sd, "model.18", d[0]),
        "n_bu4c": _fold_bn(sd, "model.19"),
        "n_bu5": _c2f(sd, "model.21", d[0]),
        "proto": {
            "cv1": _fold_bn(sd, f"{head}.proto.cv1"),
            "up": {
                "kernel": np.ascontiguousarray(up_w.transpose(2, 3, 0, 1)),
                "bias": np.asarray(sd[f"{head}.proto.upsample.bias"], np.float32),
            },
            "cv2": _fold_bn(sd, f"{head}.proto.cv2"),
            "cv3": _fold_bn(sd, f"{head}.proto.cv3"),
        },
        "heads": {
            "box": [_branch(sd, f"{head}.cv2.{i}") for i in range(3)],
            "cls": [_branch(sd, f"{head}.cv3.{i}") for i in range(3)],
            "coeff": [_branch(sd, f"{head}.cv4.{i}") for i in range(3)],
        },
    }
    return params


def convert_yolo_torch(module_or_sd, cfg: YoloSegConfig) -> dict:
    """Accept a torch module (ultralytics ``model.model`` root or a
    DetectionModel) or a state dict of tensors."""
    if hasattr(module_or_sd, "state_dict"):
        sd = module_or_sd.state_dict()
    else:
        sd = module_or_sd
    sd = {k: _to_numpy(v) for k, v in sd.items()}
    # ultralytics full checkpoints nest under "model.model.N..."
    if any(k.startswith("model.model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return convert_yolo_state_dict(sd, cfg)


def _to_numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def convert_yolo_file(path: str, cfg: YoloSegConfig) -> dict:
    """Load an ultralytics ``.pt`` checkpoint file and convert.

    ultralytics ``.pt`` files are torch pickles holding {"model": Module};
    loading requires torch (installed) but NOT the ultralytics package when
    ``weights_only``-style raw state dicts are used.  Full ultralytics
    pickles need their class definitions; exporting a state dict first
    (``torch.save(yolo.model.state_dict(), ...)``) is the supported path.
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        return convert_yolo_torch(obj["model"], cfg)
    if isinstance(obj, dict):
        return convert_yolo_torch(obj, cfg)
    return convert_yolo_torch(obj, cfg)
