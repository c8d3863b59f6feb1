"""Torch checkpoints (CRAFT detector, VGG-BiLSTM-CTC recognizer) -> the JAX
package's parameter trees (the port's own copy of
``manga_ocr_tpu/models/convert_latin.py``: one state dict gives both
packages identical arrays; ``models.craft.params_from_jax`` and
``models.crnn.params_from_jax`` put them on a device in the port's layouts).

The reference consumes these models through the EasyOCR pip black box
(``main_window.py:9805-9810``); EasyOCR ships the public CRAFT weights
(``craft_mlt_25k``-style) and per-language recognizer checkpoints (e.g.
``english_g2``).  This module maps those torch state dicts onto the
structures of ``models/craft.py`` / ``models/crnn.py``:

- every conv+BatchNorm pair folds into kernel+bias
  (w' = w*g/sqrt(v+eps), b' = (b-m)*g/sqrt(v+eps) + beta; BN eps 1e-5 here --
  torchvision/CRAFT default, unlike ultralytics' 1e-3),
- torch OIHW conv kernels -> HWIO; linear [O, I] -> [I, O],
- torch LSTM gates stay in (i, f, g, o) row order; ``bias_ih + bias_hh``
  sum into one bias; ``*_reverse`` params map to the ``bwd`` direction,
- CRAFT's basenet children are named by their ORIGINAL torchvision
  ``vgg16_bn.features`` indices (the public wrapper adds modules with
  ``str(index)``), so keys look like ``basenet.slice1.0.weight``; the
  index table below mirrors the upstream slicing at (12, 19, 29, 39).
  Each slice ends at a BatchNorm (the skip tensors are pre-ReLU) and vgg's
  conv5_3 is never used.

Parity: ``tests/test_torch_latin.py`` converts twins with these parameter
names in both packages and holds the trees equal bit for bit.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

BN_EPS = 1e-5

# vgg16_bn.features conv indices per CRAFT basenet slice (BN = conv idx + 1)
CRAFT_VGG_SLICES = {
    "slice1": (0, 3, 7, 10),
    "slice2": (14, 17),
    "slice3": (20, 24, 27),
    "slice4": (30, 34, 37),
}


def _np(v) -> np.ndarray:
    # works for both numpy arrays and torch tensors without importing torch
    return np.asarray(getattr(v, "detach", lambda: v)().cpu() if hasattr(v, "cpu") else v, np.float32)


def _fold_conv_bn(sd: Mapping, conv: str, bn: str) -> dict:
    w = _np(sd[f"{conv}.weight"])  # [O, I, kh, kw]
    conv_bias = _np(sd[f"{conv}.bias"]) if f"{conv}.bias" in sd else 0.0
    g = _np(sd[f"{bn}.weight"])
    beta = _np(sd[f"{bn}.bias"])
    mean = _np(sd[f"{bn}.running_mean"])
    var = _np(sd[f"{bn}.running_var"])
    scale = g / np.sqrt(var + BN_EPS)
    kernel = (w * scale[:, None, None, None]).transpose(2, 3, 1, 0)
    bias = (conv_bias - mean) * scale + beta
    return {"kernel": np.ascontiguousarray(kernel), "bias": np.asarray(bias, np.float32)}


def _plain_conv(sd: Mapping, prefix: str) -> dict:
    w = _np(sd[f"{prefix}.weight"])
    out = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    else:
        out["bias"] = np.zeros(w.shape[0], np.float32)
    return out


def _linear(sd: Mapping, prefix: str) -> dict:
    return {
        "kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


# ---------------------------------------------------------------------------
# CRAFT
# ---------------------------------------------------------------------------


def convert_craft_state_dict(sd: Mapping) -> dict:
    """CRAFT torch state dict → ``models/craft.py`` param pytree."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    params: dict = {}
    for slice_name, conv_idxs in CRAFT_VGG_SLICES.items():
        params[slice_name] = [
            _fold_conv_bn(
                sd,
                f"basenet.{slice_name}.{i}",
                f"basenet.{slice_name}.{i + 1}",
            )
            for i in conv_idxs
        ]
    # slice5: Sequential(MaxPool, Conv(dilated), Conv 1x1) — plain convs
    params["slice5"] = [
        _plain_conv(sd, "basenet.slice5.1"),
        _plain_conv(sd, "basenet.slice5.2"),
    ]
    # decoder double_convs: Sequential(Conv, BN, ReLU, Conv, BN, ReLU)
    for i in range(1, 5):
        p = f"upconv{i}.conv"
        params[f"upconv{i}"] = {
            "conv1": _fold_conv_bn(sd, f"{p}.0", f"{p}.1"),
            "conv2": _fold_conv_bn(sd, f"{p}.3", f"{p}.4"),
        }
    # head: Sequential(Conv, ReLU)*4 + Conv → conv indices 0, 2, 4, 6, 8
    params["conv_cls"] = [_plain_conv(sd, f"conv_cls.{i}") for i in (0, 2, 4, 6, 8)]
    return params


# ---------------------------------------------------------------------------
# Recognizer (None-VGG-BiLSTM-CTC)
# ---------------------------------------------------------------------------

# FeatureExtraction.ConvNet Sequential indices of the 7 convs; the two
# bias-free convs carry a BatchNorm at idx+1
_CRNN_CONVS = ((0, None), (3, None), (6, None), (8, None), (11, 12), (14, 15), (18, None))


def _lstm_dir(sd: Mapping, prefix: str, reverse: bool) -> dict:
    sfx = "_reverse" if reverse else ""
    w_ih = _np(sd[f"{prefix}.weight_ih_l0{sfx}"])  # [4H, I]
    w_hh = _np(sd[f"{prefix}.weight_hh_l0{sfx}"])  # [4H, H]
    bias = _np(sd[f"{prefix}.bias_ih_l0{sfx}"]) + _np(sd[f"{prefix}.bias_hh_l0{sfx}"])
    return {
        "w_ih": np.ascontiguousarray(w_ih.T),
        "w_hh": np.ascontiguousarray(w_hh.T),
        "bias": bias,
    }


def convert_crnn_state_dict(sd: Mapping) -> dict:
    """deep-text-recognition-benchmark (EasyOCR recognition) state dict →
    ``models/crnn.py`` param pytree."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    features = {}
    for n, (ci, bi) in enumerate(_CRNN_CONVS):
        prefix = f"FeatureExtraction.ConvNet.{ci}"
        if bi is None:
            features[f"conv{n}"] = _plain_conv(sd, prefix)
        else:
            features[f"conv{n}"] = _fold_conv_bn(
                sd, prefix, f"FeatureExtraction.ConvNet.{bi}"
            )
    params = {"features": features}
    for n in range(2):
        p = f"SequenceModeling.{n}"
        params[f"rnn{n}"] = {
            "fwd": _lstm_dir(sd, f"{p}.rnn", reverse=False),
            "bwd": _lstm_dir(sd, f"{p}.rnn", reverse=True),
            "linear": _linear(sd, f"{p}.linear"),
        }
    params["head"] = _linear(sd, "Prediction")
    return params


def load_torch_checkpoint(path: str) -> Mapping:
    """Load a ``.pth`` state dict without executing pickled code beyond
    torch's own loader (weights_only)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj
