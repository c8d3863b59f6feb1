"""CRAFT text detector on PyTorch (counterpart of
``manga_ocr_tpu/models/craft.py``).

The reference's Latin OCR path delegates text detection to the EasyOCR pip
black box (engine dispatch at ``main_window.py:9805-9810``), whose
detector is the public CRAFT model (Character Region Awareness For Text
detection): a VGG16-BN backbone with U-Net-style skip connections producing
two score maps -- per-pixel character *region* and character-*link*
(affinity) -- at half input resolution.  The detection half of the Latin
engine (``engine/latin.py``) runs it batched over padded page buckets; it
is plain PyTorch on the device (f32 with TF32 off), as the JAX graph has no
Pallas kernel.

Architecture (channel-scalable; defaults = the published CRAFT shapes so
real ``craft_mlt_25k``-style checkpoints convert via
``models/convert_latin.py``):

- backbone: VGG16-BN feature slices.  The public CRAFT basenet splits
  torchvision's ``vgg16_bn.features`` at indices (12, 19, 29, 39) -- each
  slice therefore ends at a BatchNorm and the following slice *starts* with
  the ReLU, so the skip tensors the decoder consumes are PRE-activation.
- slice5 ("fc6/fc7"): MaxPool(3, stride 1, pad 1) -> dilated 3x3 conv
  (dilation 6, pad 6) to 2x channels -> 1x1 conv.
- decoder: four ``double_conv`` blocks (1x1 conv + BN + ReLU, 3x3 conv +
  BN + ReLU), each consuming concat(upsampled previous, skip), with
  bilinear (half-pixel, align_corners=False) upsampling to the skip's
  resolution: torch's ``F.interpolate``, which the JAX package's gather
  formulation reproduces.
- head ``conv_cls``: 3x3/3x3/3x3/1x1/1x1 convs -> 2 channels (region score,
  affinity score), raw (no sigmoid).

Parameters keep the JAX package's tree (BN folded into kernel + bias) with
OIHW kernels; ``params_from_jax``/``params_to_jax`` cross to its HWIO layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from manga_ocr_tpu_torch.models.detector import fp32_products

# ImageNet RGB normalization the public CRAFT applies (normalizeMeanVariance)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class CraftConfig:
    """Channel-scalable CRAFT.  Defaults are the published model's shapes.

    ``vgg_channels``: output channels of vgg stages 1..5 plus the slice5
    ("fc") width -- (64, 128, 256, 512, 512, 1024) in the real model.
    Decoder widths derive from the same tuple exactly as upstream:
    upconv_i mid/out channels halve from stage-5 width down to
    ``head_channels``.
    """

    vgg_channels: tuple = (64, 128, 256, 512, 512, 1024)
    head_channels: int = 32  # conv_cls working width (32 in the real model)
    # detection thresholds (the public defaults)
    text_threshold: float = 0.7
    link_threshold: float = 0.4
    low_text: float = 0.4


def _conv(x, p, dilation=1):
    """3x3/1x1 conv with torch's symmetric padding."""
    w = p["kernel"]
    return F.conv2d(x, w, p["bias"], 1, dilation * (w.shape[-1] // 2),
                    dilation)


def _upsample_to(x, hw):
    """Bilinear, torch's align_corners=False: source position
    max(0, (i+0.5)*in/out - 0.5), the upper tap clamped to the last row."""
    return F.interpolate(x, size=tuple(int(v) for v in hw), mode="bilinear", align_corners=False)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B,H,W,3] -> CRAFT's normalized float input [B,H,W,3]."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _double_conv(x, p):
    """1x1 conv + (folded) BN + ReLU, 3x3 conv + (folded) BN + ReLU."""
    return torch.relu(_conv(torch.relu(_conv(x, p["conv1"])), p["conv2"]))


def craft_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Normalized images [B,3,H,W] (H, W multiples of 16) ->
    [B, 2, H/2, W/2] raw (region, affinity) score maps."""
    relu = torch.relu
    # --- backbone slices (outputs are PRE-ReLU; see module docstring) ---
    h = relu(_conv(x, params["slice1"][0]))
    h = relu(_conv(h, params["slice1"][1]))
    h = F.max_pool2d(h, 2, 2)
    h = relu(_conv(h, params["slice1"][2]))
    s1 = _conv(h, params["slice1"][3])  # [B, c2, H/2, W/2] pre-relu

    h = F.max_pool2d(relu(s1), 2, 2)
    h = relu(_conv(h, params["slice2"][0]))
    s2 = _conv(h, params["slice2"][1])  # [B, c3, H/4, W/4] pre-relu

    h = relu(_conv(relu(s2), params["slice3"][0]))
    h = F.max_pool2d(h, 2, 2)
    h = relu(_conv(h, params["slice3"][1]))
    s3 = _conv(h, params["slice3"][2])  # [B, c4, H/8, W/8] pre-relu

    h = relu(_conv(relu(s3), params["slice4"][0]))
    h = F.max_pool2d(h, 2, 2)
    h = relu(_conv(h, params["slice4"][1]))
    s4 = _conv(h, params["slice4"][2])  # [B, c5, H/16, W/16] pre-relu

    h = F.max_pool2d(s4, 3, 1, 1)
    h = _conv(h, params["slice5"][0], dilation=6)
    s5 = _conv(h, params["slice5"][1])  # [B, fc, H/16, W/16]

    # --- U decoder ---
    y = _double_conv(torch.cat([s5, s4], 1), params["upconv1"])
    y = _double_conv(torch.cat([_upsample_to(y, s3.shape[2:]), s3], 1), params["upconv2"])
    y = _double_conv(torch.cat([_upsample_to(y, s2.shape[2:]), s2], 1), params["upconv3"])
    y = _double_conv(torch.cat([_upsample_to(y, s1.shape[2:]), s1], 1), params["upconv4"])

    # --- classification head ---
    for p in params["conv_cls"][:4]:
        y = relu(_conv(y, p))
    return _conv(y, params["conv_cls"][4])  # [B, 2, H/2, W/2], raw


def detect_maps(params: dict, images_u8) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 RGB [B,H,W,3] -> (region, affinity) f32 maps [B,H/2,W/2] on the
    parameters' device, f32 products with TF32 off."""
    device = params["conv_cls"][0]["kernel"].device
    if isinstance(images_u8, np.ndarray):
        images_u8 = np.ascontiguousarray(images_u8)  # torch takes no negative strides
    pages = torch.as_tensor(images_u8).to(device)
    with fp32_products(), torch.no_grad():
        x = normalize_images(pages).permute(0, 3, 1, 2).contiguous()
        maps = craft_forward(params, x)
    return maps[:, 0], maps[:, 1]


# ---------------------------------------------------------------------------
# Parameters (random; real weights come from models/convert_latin.py)
# ---------------------------------------------------------------------------


def _tree(cfg: CraftConfig, conv) -> dict:
    """The JAX package's tree with ``conv(k, cin, cout)`` at each conv, in its
    order."""
    c1, c2, c3, c4, c5, fc = cfg.vgg_channels
    hc = cfg.head_channels
    params = {
        # slice layouts mirror craft_forward (conv channels per vgg16_bn)
        "slice1": [conv(3, 3, c1), conv(3, c1, c1), conv(3, c1, c2), conv(3, c2, c2)],
        "slice2": [conv(3, c2, c3), conv(3, c3, c3)],
        "slice3": [conv(3, c3, c3), conv(3, c3, c4), conv(3, c4, c4)],
        "slice4": [conv(3, c4, c4), conv(3, c4, c5), conv(3, c5, c5)],
        "slice5": [conv(3, c5, fc), conv(1, fc, fc)],
    }
    # decoder widths derive exactly like upstream: upconv1 mid = c5,
    # out = c5/2, then each block halves down to the head width
    o1 = max(c5 // 2, 1)
    o2 = max(o1 // 2, 1)
    o3 = max(o2 // 2, 1)
    for name, cin, mid, out in (
        ("upconv1", fc + c5, c5, o1),
        ("upconv2", o1 + c4, o1, o2),
        ("upconv3", o2 + c3, o2, o3),
        ("upconv4", o3 + c2, o3, hc),
    ):
        params[name] = {"conv1": conv(1, cin, mid), "conv2": conv(3, mid, out)}
    hc2 = max(hc // 2, 1)
    params["conv_cls"] = [conv(3, hc, hc), conv(3, hc, hc), conv(3, hc, hc2), conv(1, hc2, hc2),
                          conv(1, hc2, 2)]
    return params


def init_craft_params_numpy(cfg: CraftConfig, seed: int = 0) -> dict:
    """Random weights in the JAX package's layout (HWIO, numpy f32): kernel
    and bias uniform in +-1/sqrt(fan_in), as JAX's ``init_craft_params``
    draws them, from ``np.random.default_rng(seed)`` in tree order."""
    rng = np.random.default_rng(seed)

    def conv(k, cin, cout):
        scale = 1.0 / np.sqrt(k * k * cin)
        return {"kernel": rng.uniform(-scale, scale, (k, k, cin, cout)).astype(np.float32),
                "bias": rng.uniform(-scale, scale, (cout,)).astype(np.float32)}

    return _tree(cfg, conv)


def _map_convs(tree, fn):
    if isinstance(tree, dict):
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            return fn(tree)
        return {k: _map_convs(v, fn) for k, v in tree.items()}
    return [_map_convs(v, fn) for v in tree]


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's tree (numpy or JAX arrays, HWIO) -> the port's
    (tensors on ``device``, OIHW)."""
    return _map_convs(tree, lambda p: {
        "kernel": torch.from_numpy(np.array(p["kernel"], np.float32)).permute(3, 2, 0, 1)
        .contiguous().to(device),
        "bias": torch.from_numpy(np.array(p["bias"], np.float32)).to(device)})


def params_to_jax(tree) -> dict:
    """The port's tree -> the JAX package's layout as numpy f32."""
    return _map_convs(tree, lambda p: {
        "kernel": np.ascontiguousarray(p["kernel"].detach().permute(2, 3, 1, 0)
                                       .cpu().numpy()),
        "bias": p["bias"].detach().cpu().numpy()})


def init_craft_params(cfg: CraftConfig, seed: int = 0, device="cpu") -> dict:
    """``init_craft_params_numpy`` as the port's tree on ``device``."""
    return params_from_jax(init_craft_params_numpy(cfg, seed), device)
