"""Speech-bubble segmentation model (U-Net) on PyTorch (counterpart of
``manga_ocr_tpu/models/detector.py``).

The reference runs a third-party ONNX U-Net-style bubble segmenter
(``_run_onnx_inference``, ``main_window.py:6776-6815``): RGB resized to the
model input (512×512 fallback), /255 float32, output squeezed to a [H, W]
probability map, resized back to page size, thresholded at 0.5 into a 0/255
uint8 mask.  ``segment_pages`` is that graph batched over pages on the
device: the triangle-filter resize of ``ops/image.py`` (the JAX package's
antialiased ``jax.image.resize(..., "linear")``), the U-Net (3×3 convs with
ReLU, 2×2 max-pools, ×2 nearest upsampling, skip concatenations, a 1×1
head and a sigmoid), the resize back and the threshold.  It is plain
PyTorch on the device (``F.conv2d`` where JAX has ``conv_general_dilated``);
the JAX graph has no Pallas kernel.  Its f32 products run with TF32 off
whatever the process set (``fp32_products``).

Parameters keep the JAX package's tree (``{"down": [...], "mid", "up":
[...], "head"}`` of ``{"c1", "c2"}`` blocks of ``{"kernel", "bias"}``), with
kernels in PyTorch's OIHW layout; the JAX package's HWIO layout exists only
at the edges: ``params_from_jax`` and the flat ``.npz`` files that
``save_params`` / ``load_params`` share with the JAX package.  Weights are
random from a numpy seed (``init_params``) or loaded from such a file; the
third-party weights are not redistributable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manga_ocr_tpu_torch.ops.image import resize_bilinear


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    input_size: int = 512
    base_channels: int = 32
    depth: int = 4  # number of down/up levels
    threshold: float = 0.5


# -- TF32 off around the f32 products ------------------------------------------

_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def fp32_products():
    """Hold cuDNN's and cuBLAS's TF32 off for f32 convolutions and matmuls
    inside the block, and restore the process's flags after the last of
    any concurrent blocks ends (cuDNN's flag is on by default)."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


# -- the U-Net ------------------------------------------------------------------


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """JAX's ``SAME`` at stride 1: pad 1 for 3×3, 0 for the 1×1 head."""
    w = p["kernel"]
    return F.conv2d(x, w.to(x.dtype), p["bias"].to(x.dtype), padding=w.shape[-1] // 2)


def _block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """conv-relu-conv-relu."""
    x = torch.relu(_conv(x, p["c1"]))
    return torch.relu(_conv(x, p["c2"]))


def forward(params, images: torch.Tensor, cfg: DetectorConfig) -> torch.Tensor:
    """[B, 3, S, S] float in [0,1] -> [B, S, S] f32 sigmoid probabilities.

    ``params``: the port's tree (OIHW kernels) or a ``UNet``."""
    if isinstance(params, UNet):
        params = params.tree()
    x = images
    skips = []
    for i in range(cfg.depth):
        x = _block(x, params["down"][i])
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)  # VALID: an odd last row / column is dropped
    x = _block(x, params["mid"])
    for i in reversed(range(cfg.depth)):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = torch.cat([x, skips[i]], dim=1)
        x = _block(x, params["up"][i])
    logits = _conv(x, params["head"])[:, 0]
    return torch.sigmoid(logits.float())


def _conv_module(p: dict) -> nn.Conv2d:
    w = p["kernel"]
    conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[-1], padding=w.shape[-1] // 2,
                     device=w.device, dtype=w.dtype)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(p["bias"])
    return conv


class _Block(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        self.c1 = _conv_module(p["c1"])
        self.c2 = _conv_module(p["c2"])


class UNet(nn.Module):
    """The U-Net as an ``nn.Module`` holding its own copy of a parameter tree
    (for training, and for the device-resident weights of a detector).
    ``forward`` takes NCHW [B, 3, S, S] in [0,1] and returns [B, S, S]."""

    def __init__(self, params: dict, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        self.down = nn.ModuleList(_Block(p) for p in params["down"])
        self.mid = _Block(params["mid"])
        self.up = nn.ModuleList(_Block(p) for p in params["up"])
        self.head = _conv_module(params["head"])

    def tree(self) -> dict:
        """The parameter tree as views of this module's parameters."""
        conv = lambda c: {"kernel": c.weight, "bias": c.bias}  # noqa: E731
        block = lambda b: {"c1": conv(b.c1), "c2": conv(b.c2)}  # noqa: E731
        return {"down": [block(b) for b in self.down], "mid": block(self.mid),
                "up": [block(b) for b in self.up], "head": conv(self.head)}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.tree(), images, self.cfg)


def segment_probs(params, pages_u8, cfg: DetectorConfig, out_h: int, out_w: int) -> torch.Tensor:
    """Pages [B, H, W, 3] uint8 RGB -> [B, out_h, out_w] f32 probabilities on
    the parameters' device: resize to cfg.input_size, /255, the U-Net, resize
    back.  The pages cross to the device as uint8 and are cast there."""
    if isinstance(params, UNet):
        params = params.tree()
    device = params["head"]["kernel"].device
    pages = torch.as_tensor(pages_u8)
    if pages.dtype != torch.uint8 or pages.ndim != 4 or pages.shape[-1] != 3:
        raise ValueError(f"segment_pages: pages must be uint8 [B, H, W, 3], got "
                         f"{tuple(pages.shape)} {pages.dtype}")
    pages = pages.to(device, non_blocking=True)
    s = cfg.input_size
    with fp32_products(), torch.no_grad():
        x = resize_bilinear(pages, s, s, channels_last=True)  # [B, s, s, 3] f32
        x = (x / 255.0).permute(0, 3, 1, 2).contiguous()
        prob = forward(params, x, cfg)
        return resize_bilinear(prob, out_h, out_w, channels_last=False)


def segment_pages(params, pages_u8, cfg: DetectorConfig, out_h: int, out_w: int) -> torch.Tensor:
    """Full detector graph: resize → U-Net → resize back → [B, out_h, out_w]
    0/255 uint8 masks on the device (the reference's ONNX wrapper contract:
    resize, /255, > 0.5)."""
    prob = segment_probs(params, pages_u8, cfg, out_h, out_w)
    return (prob > cfg.threshold).to(torch.uint8) * 255


# -- parameters -----------------------------------------------------------------


def _channels(cfg: DetectorConfig):
    """Per conv, in the tree's order (down, mid, up, head): its (key path,
    cin, cout, k)."""
    chans = [cfg.base_channels * (2**i) for i in range(cfg.depth)]
    mid_c = cfg.base_channels * (2**cfg.depth)
    below = [3] + chans[:-1]  # each down block's input
    above = chans[1:] + [mid_c]  # each up block's upsampled input
    convs = []
    for i in range(cfg.depth):
        convs += [(("down", i, "c1"), below[i], chans[i], 3),
                  (("down", i, "c2"), chans[i], chans[i], 3)]
    convs += [(("mid", "c1"), chans[-1], mid_c, 3), (("mid", "c2"), mid_c, mid_c, 3)]
    for i in range(cfg.depth):
        convs += [(("up", i, "c1"), above[i] + chans[i], chans[i], 3),
                  (("up", i, "c2"), chans[i], chans[i], 3)]
    convs.append((("head",), chans[0], 1, 1))
    return convs


def _tree(cfg: DetectorConfig, leaf) -> dict:
    """The JAX package's tree with ``leaf(cin, cout, k)`` at each conv, built
    in its order."""
    tree = {"down": [{} for _ in range(cfg.depth)], "mid": {},
            "up": [{} for _ in range(cfg.depth)]}
    for path, cin, cout, k in _channels(cfg):
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf(cin, cout, k)
    return tree


def init_params_numpy(cfg: DetectorConfig, seed: int = 0) -> dict:
    """Random weights in the JAX package's layout (HWIO kernels, numpy f32):
    He-normal ``N(0, 1)·sqrt(2/fan_in)`` from ``np.random.default_rng(seed)``
    in tree order, zero biases.  (JAX's ``PRNGKey`` draws are not
    reproducible here; the same numpy tree fed to both packages is.)"""
    rng = np.random.default_rng(seed)

    def leaf(cin, cout, k):
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        return {"kernel": (w * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    return _tree(cfg, leaf)


def params_from_jax(tree, device="cpu", dtype=torch.float32) -> dict:
    """The JAX package's tree (numpy or JAX arrays, HWIO kernels) -> the
    port's (torch tensors on ``device``, OIHW kernels)."""
    if isinstance(tree, dict):
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            kernel = torch.from_numpy(np.array(tree["kernel"], np.float32)).permute(3, 2, 0, 1)
            return {"kernel": kernel.contiguous().to(device, dtype),
                    "bias": torch.from_numpy(np.array(tree["bias"], np.float32)).to(device, dtype)}
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    raise TypeError(f"params_from_jax: unexpected leaf {type(tree)}")


def params_to_jax(tree) -> dict:
    """The port's tree (or a ``UNet``) -> the JAX package's layout as numpy
    f32 (HWIO kernels)."""
    if isinstance(tree, UNet):
        tree = tree.tree()
    if isinstance(tree, dict):
        if "kernel" in tree and isinstance(tree["kernel"], torch.Tensor):
            return {"kernel": tree["kernel"].detach().float().permute(2, 3, 1, 0).cpu().numpy(),
                    "bias": tree["bias"].detach().float().cpu().numpy()}
        return {k: params_to_jax(v) for k, v in tree.items()}
    return [params_to_jax(v) for v in tree]


def init_params(cfg: DetectorConfig, seed: int = 0, device="cpu", dtype=torch.float32) -> dict:
    """``init_params_numpy`` as the port's tree on ``device``."""
    return params_from_jax(init_params_numpy(cfg, seed), device, dtype)


def save_params(params, path: str) -> None:
    """Write the JAX package's flat ``.npz`` (slash-joined keys such as
    ``down/0/c1/kernel``, HWIO kernels): either package loads it."""
    save_npz(params_to_jax(params), path)


def save_npz(tree, path: str) -> None:
    """A tree in the JAX package's layout (numpy leaves) as the flat ``.npz``
    both packages share, its keys joined by slashes."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def fill_template(data, template):
    """Fill a tree ``template`` whose leaves are the JAX layout's shapes from a
    flat mapping with slash-joined keys ('a/b/0/kernel') -- the inverse of
    ``save_params``; numpy f32 leaves, each checked against its shape."""

    def fill(prefix, node):
        if isinstance(node, dict):
            return {k: fill(f"{prefix}/{k}" if prefix else k, v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(f"{prefix}/{i}", v) for i, v in enumerate(node)]
        want = tuple(node)
        got = np.asarray(data[prefix], np.float32)
        if got.shape != want:
            raise ValueError(f"load_params: {prefix} has shape {got.shape}, the config "
                             f"wants {want}")
        return got

    return fill("", template)


def load_params(path: str, cfg: DetectorConfig, device="cpu", dtype=torch.float32) -> dict:
    """A flat ``.npz`` written by either package -> the port's tree."""
    with np.load(path) as data:
        shapes = _tree(cfg, lambda cin, cout, k: {"kernel": (k, k, cin, cout), "bias": (cout,)})
        tree = fill_template(data, shapes)
    return params_from_jax(tree, device, dtype)
