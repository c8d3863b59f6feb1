"""LaMa (FFC-ResNet generator) torch checkpoint -> the JAX package's
parameter tree (BN folded; the port's own copy of
``manga_ocr_tpu/models/convert_lama.py``: one state dict gives both
packages identical arrays).

Converts the published LaMa inpainting generator's state dict (the
``saicinpainting`` ``FFCResNetGenerator`` -- what lama-cleaner runs for the
reference at ``main_window.py:3590-3667``) into the folded-BN layout of
``models/inpaint.py``:

- every BatchNorm (eps 1e-5) folds into the preceding conv; FFC applies BN
  to the SUM of its two path convs, so the scale folds into BOTH kernels and
  the bias lands on one of them (l2l / l2g),
- torch OIHW -> HWIO; ConvTranspose2d [I,O,kh,kw] -> spatially flipped
  [kh,kw,I,O] (the JAX package consumes it as an input-dilated conv),
- module indices follow the generator's nn.Sequential layout, computed from
  the config (downsamples / num_blocks).

The result is numpy in the JAX layout; ``inpaint.params_from_jax`` puts it
on a device in the port's (OIHW, the transposed convs flipped back).
Parity: ``tests/test_torch_inpaint.py``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np

from manga_ocr_tpu_torch.models.inpaint import InpaintConfig

BN_EPS = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _bn(sd, pfx):
    g = _np(sd[f"{pfx}.weight"]).astype(np.float32)
    b = _np(sd[f"{pfx}.bias"]).astype(np.float32)
    m = _np(sd[f"{pfx}.running_mean"]).astype(np.float32)
    v = _np(sd[f"{pfx}.running_var"]).astype(np.float32)
    s = g / np.sqrt(v + BN_EPS)
    return s, b - m * s


def _conv_w(sd, name, scale=None):
    w = _np(sd[name]).astype(np.float32)  # [O, I, kh, kw]
    if scale is not None:
        w = w * scale[:, None, None, None]
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO


def _folded_conv(sd, conv_name, bn_pfx):
    s, b = _bn(sd, bn_pfx)
    return {"kernel": _conv_w(sd, conv_name, s), "bias": b}


def _ffc_unit(sd, pfx) -> dict:
    """FFC_BN_ACT with both local and global paths (the resnet blocks)."""
    sl, bl = _bn(sd, f"{pfx}.bn_l")
    sg, bg = _bn(sd, f"{pfx}.bn_g")
    g2g = f"{pfx}.ffc.convg2g"
    return {
        # bn_l applies to convl2l(xl) + convg2l(xg): scale on both, bias once
        "l2l": {"kernel": _conv_w(sd, f"{pfx}.ffc.convl2l.weight", sl), "bias": bl},
        "g2l": {
            "kernel": _conv_w(sd, f"{pfx}.ffc.convg2l.weight", sl),
            "bias": np.zeros_like(bl),
        },
        # bn_g applies to convl2g(xl) + spectral(xg)
        "l2g": {"kernel": _conv_w(sd, f"{pfx}.ffc.convl2g.weight", sg), "bias": bg},
        "g2g": {
            "conv1": _folded_conv(sd, f"{g2g}.conv1.0.weight", f"{g2g}.conv1.1"),
            "fu": _folded_conv(sd, f"{g2g}.fu.conv_layer.weight", f"{g2g}.fu.bn"),
            "conv2": {
                "kernel": _conv_w(sd, f"{g2g}.conv2.weight", sg),
                "bias": np.zeros((sg.shape[0],), np.float32),
            },
        },
    }


def _normalize_keys(sd: Mapping[str, np.ndarray]) -> dict:
    """Strip any wrapper prefix so keys start with ``model.<idx>.``
    (training checkpoints use ``generator.model...``; TorchScript exports may
    nest differently)."""
    pat = re.compile(r"(?:^|\.)(model\.\d+\..+)$")
    out = {}
    for k, v in sd.items():
        mt = pat.search(k)
        if mt:
            out[mt.group(1)] = v
    return out if out else dict(sd)


def convert_lama_state_dict(sd: Mapping[str, np.ndarray], cfg: InpaintConfig) -> dict:
    sd = _normalize_keys(sd)
    nd, nb = cfg.downsamples, cfg.num_blocks

    # stem: [0]=ReflectionPad, [1]=FFC_BN_ACT(ratio 0,0) == plain conv+bn_l
    params: dict = {
        "stem": _folded_conv(sd, "model.1.ffc.convl2l.weight", "model.1.bn_l")
    }

    down = []
    for i in range(nd):
        pfx = f"model.{2 + i}"
        if i == nd - 1:  # ratio_gout > 0: split output
            sl, bl = _bn(sd, f"{pfx}.bn_l")
            sg, bg = _bn(sd, f"{pfx}.bn_g")
            down.append(
                {
                    "l2l": {
                        "kernel": _conv_w(sd, f"{pfx}.ffc.convl2l.weight", sl),
                        "bias": bl,
                    },
                    "l2g": {
                        "kernel": _conv_w(sd, f"{pfx}.ffc.convl2g.weight", sg),
                        "bias": bg,
                    },
                }
            )
        else:
            down.append(
                {"l2l": _folded_conv(sd, f"{pfx}.ffc.convl2l.weight", f"{pfx}.bn_l")}
            )
    params["down"] = down

    params["blocks"] = [
        {
            "conv1": _ffc_unit(sd, f"model.{2 + nd + j}.conv1"),
            "conv2": _ffc_unit(sd, f"model.{2 + nd + j}.conv2"),
        }
        for j in range(nb)
    ]

    # upsamples: [2+nd+nb]=ConcatTuple, then (ConvT, BN, ReLU) triples
    ups = []
    base = 3 + nd + nb
    for u in range(nd):
        ct = f"model.{base + 3 * u}"
        s, b = _bn(sd, f"model.{base + 3 * u + 1}")
        w = _np(sd[f"{ct}.weight"]).astype(np.float32)  # [I, O, kh, kw]
        cb = _np(sd[f"{ct}.bias"]).astype(np.float32)
        w = w * s[None, :, None, None]
        kernel = np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
        ups.append({"kernel": kernel, "bias": cb * s + b})
    params["up"] = ups

    # head: [base+3nd]=ReflectionPad, [base+3nd+1]=Conv2d(bias), [..]=Sigmoid
    hc = f"model.{base + 3 * nd + 1}"
    params["head"] = {
        "kernel": _conv_w(sd, f"{hc}.weight"),
        "bias": _np(sd[f"{hc}.bias"]).astype(np.float32),
    }
    return params


def convert_lama_torch(module_or_sd, cfg: InpaintConfig) -> dict:
    sd = (
        module_or_sd.state_dict()
        if hasattr(module_or_sd, "state_dict")
        else module_or_sd
    )
    return convert_lama_state_dict({k: _np(v) for k, v in sd.items()}, cfg)


def convert_lama_file(path: str, cfg: InpaintConfig) -> dict:
    """Load a LaMa checkpoint (training ckpt dict, raw state dict, or
    TorchScript archive) and convert."""
    import torch

    try:
        obj = torch.jit.load(path, map_location="cpu")
        return convert_lama_torch(obj, cfg)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        sd = obj.get("state_dict", obj)
        return convert_lama_state_dict({k: _np(v) for k, v in sd.items()}, cfg)
    return convert_lama_torch(obj, cfg)
