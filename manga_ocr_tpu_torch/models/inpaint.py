"""LaMa inpainting generator (FFC-ResNet) on PyTorch (counterpart of
``manga_ocr_tpu/models/inpaint.py``).

The reference erases bubble text with the third-party lama-cleaner torch
package when available (``_run_lama_inpaint``, ``main_window.py:3590-3667``),
falling back to cv2 inpainting.  This module is the published LaMa
``FFCResNetGenerator``, structured 1:1 so real checkpoints convert exactly
(``models/convert_lama.py``):

- a reflect-padded 7x7 stem over [masked image, mask] (4 channels),
- ``downsamples`` zero-padded stride-2 convs (the last splits its output
  into local and global paths),
- ``num_blocks`` FFC residual blocks: reflect-padded local 3x3 convs
  cross-connected with a SpectralTransform global path (1x1 -> rFFT2 (ortho)
  -> 1x1 over interleaved (re, im) channels -> iFFT, with a residual around
  the Fourier unit -> 1x1),
- transposed-conv (k3 s2 p1 op1) upsampling, a reflect-padded 7x7 head and a
  sigmoid, composited so that known pixels pass through exactly.

It is plain PyTorch on the device, f32 with TF32 off (``fp32_products``):
the JAX graph is XLA convolutions and FFTs, with no Pallas kernel.  All
BatchNorms are folded into the convs by the converter; random init mirrors
the folded layout.  The page goes in in the channel order it is given (BGR
from ``typeset.cleanup.erase_area``), as in the JAX package.

Parameters keep the JAX package's tree (``stem``, ``down``, ``blocks``,
``up``, ``head`` of ``{"kernel", "bias"}``) with PyTorch's layouts: OIHW
conv kernels, and the upsamples' ``ConvTranspose2d`` weights [I, O, 3, 3]
un-flipped.  The JAX layout (HWIO; the upsamples spatially flipped for an
input-dilated conv) exists only at the edges: ``params_from_jax`` and
``params_to_jax``.  ``LamaInpainter(mesh=)`` splits batches across the
data devices of a ``parallel.mesh.Mesh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manga_ocr_tpu_torch.models.detector import fp32_products
from manga_ocr_tpu_torch.parallel import mesh as meshlib

# Padded pixels a dispatch of ``LamaInpainter.inpaint_many``: a shape group
# larger than this is split (at least one region a dispatch; a split changes
# no pixel).  Above it cuDNN's heuristics pick FFT convolutions for some
# batches at big-lama width -- 512x512 at B=5..8, 1024x1024 at B=2, 480x480
# at B=6: 3 to 100 times slower a region, up to 25 GiB -- while every batch
# of at most 4 * 512 * 512 pixels tried ran on implicit GEMMs, and single
# pages of 1704x1200 and 2048x2048 did too (chip_smoke.py's phase
# "inpaint", PERF.md).
DISPATCH_PIXELS = 4 * 512 * 512


@dataclasses.dataclass(frozen=True)
class InpaintConfig:
    base_channels: int = 64  # ngf
    num_blocks: int = 9  # FFC resnet blocks (big-lama uses 18)
    downsamples: int = 3
    global_ratio: float = 0.75  # global-path channel fraction in the blocks
    max_features: int = 1024

    def feats(self, i: int) -> int:
        return min(self.base_channels * (2**i), self.max_features)

    @property
    def deep_channels(self) -> int:
        return self.feats(self.downsamples)

    @property
    def cg(self) -> int:
        return int(self.deep_channels * self.global_ratio)

    @property
    def cl(self) -> int:
        return self.deep_channels - self.cg


# -- the generator ----------------------------------------------------------------


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of numpy's ``mode="reflect"`` padding by ``r`` of an axis of
    length ``n`` (edge excluded; periodic where ``r`` >= ``n``)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _reflect_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` of the last two axes by ``r``."""
    h, w = x.shape[-2:]
    if r < h and r < w:
        return F.pad(x, (r, r, r, r), mode="reflect")
    x = x.index_select(-2, _reflect_index(h, r, x.device))
    return x.index_select(-1, _reflect_index(w, r, x.device))


def _conv(x: torch.Tensor, p: dict, stride: int = 1, pad: str = "zero") -> torch.Tensor:
    """Conv with symmetric k//2 padding: zero (the downsample convs) or
    reflect (stem, blocks, head: LaMa's default)."""
    w = p["kernel"]
    r = w.shape[-1] // 2
    if r and pad == "reflect":
        x = _reflect_pad(x, r)
        r = 0
    return F.conv2d(x, w, p["bias"], stride=stride, padding=r)


def _deconv2x(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``: [B, I, h, w] ->
    [B, O, 2h, 2w]."""
    return F.conv_transpose2d(x, p["kernel"], p["bias"], stride=2, padding=1,
                              output_padding=1)


def _spectral(x: torch.Tensor, p: dict) -> torch.Tensor:
    """LaMa SpectralTransform: 1x1 reduce -> FourierUnit (with residual) ->
    1x1 expand.  The FFTs run in f32 with ortho normalization; (re, im) are
    interleaved per channel (channel 2c + k)."""
    x = torch.relu(_conv(x, p["conv1"]))
    b, c, h, w = x.shape
    f = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
    y = torch.stack((f.real, f.imag), dim=2).view(b, 2 * c, h, w // 2 + 1)
    y = torch.relu(_conv(y, p["fu"])).view(b, c, 2, h, w // 2 + 1)
    fu = torch.fft.irfft2(torch.complex(y[:, :, 0], y[:, :, 1]), s=(h, w), dim=(-2, -1),
                          norm="ortho")
    return _conv(x + fu, p["conv2"])


def _ffc_bn_act(xl, xg, p):
    """One FFC + (folded) BN + ReLU: local/global cross-connections."""
    yl = _conv(xl, p["l2l"], pad="reflect") + _conv(xg, p["g2l"], pad="reflect")
    yg = _conv(xl, p["l2g"], pad="reflect") + _spectral(xg, p["g2g"])
    return torch.relu(yl), torch.relu(yg)


def ffc_block(xl, xg, p):
    """FFC residual block: two FFC_BN_ACT units + per-path residual."""
    yl, yg = _ffc_bn_act(xl, xg, p["conv1"])
    yl, yg = _ffc_bn_act(yl, yg, p["conv2"])
    return xl + yl, xg + yg


def head_logits(params, images: torch.Tensor, masks: torch.Tensor, cfg: InpaintConfig):
    """The head's pre-sigmoid output [B, 3, H, W] for images [B, 3, H, W] in
    [0, 1] and masks [B, H, W] (1 = hole).  H and W must be multiples of
    2**cfg.downsamples.  ``params``: the port's tree or an
    ``FFCResNetGenerator``."""
    if isinstance(params, FFCResNetGenerator):
        params = params.tree()
    m = masks[:, None].to(images.dtype)
    x = torch.cat([images * (1.0 - m), m], dim=1)
    x = torch.relu(_conv(x, params["stem"], pad="reflect"))
    for dp in params["down"]:
        if "l2g" in dp:  # the final downsample splits local/global
            xl = torch.relu(_conv(x, dp["l2l"], stride=2))
            xg = torch.relu(_conv(x, dp["l2g"], stride=2))
        else:
            x = torch.relu(_conv(x, dp["l2l"], stride=2))
    for bp in params["blocks"]:
        xl, xg = ffc_block(xl, xg, bp)
    x = torch.cat([xl, xg], dim=1)
    for up in params["up"]:
        x = torch.relu(_deconv2x(x, up))
    return _conv(x, params["head"], pad="reflect").float()


def forward(params, images: torch.Tensor, masks: torch.Tensor, cfg: InpaintConfig):
    """Images [B, 3, H, W] f32 in [0, 1]; masks [B, H, W] (1 = hole).
    Returns the inpainted [B, 3, H, W] in [0, 1]: the sigmoid of the head
    inside the hole, the input elsewhere, exactly."""
    out = torch.sigmoid(head_logits(params, images, masks, cfg)).to(images.dtype)
    m = masks[:, None].to(images.dtype)
    return images * (1.0 - m) + out * m


def inpaint_batch(params, images_u8, masks_u8, cfg: InpaintConfig) -> torch.Tensor:
    """Images [B, H, W, 3] uint8, masks [B, H, W] uint8 (nonzero = hole) ->
    [B, H, W, 3] uint8 on the parameters' device: /255, the generator in f32
    with TF32 off, round half to even, clip.  The inputs cross to the device
    as uint8 and are cast there."""
    if isinstance(params, FFCResNetGenerator):
        params = params.tree()
    device = params["head"]["kernel"].device
    images = torch.as_tensor(images_u8).to(device, non_blocking=True)
    masks = torch.as_tensor(masks_u8).to(device, non_blocking=True)
    if images.dtype != torch.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"inpaint_batch: images must be uint8 [B, H, W, 3], got "
                         f"{tuple(images.shape)} {images.dtype}")
    if masks.shape != images.shape[:3]:
        raise ValueError(f"inpaint_batch: masks must be [B, H, W] = {tuple(images.shape[:3])}, "
                         f"got {tuple(masks.shape)}")
    with fp32_products(), torch.no_grad():
        x = images.permute(0, 3, 1, 2).float() / 255.0
        out = forward(params, x, (masks > 0).float(), cfg)
        out = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
        return out.permute(0, 2, 3, 1)


# -- the module ---------------------------------------------------------------------


def _to_module(node):
    if isinstance(node, dict):
        if "kernel" in node and isinstance(node["kernel"], torch.Tensor):
            return nn.ParameterDict({k: nn.Parameter(v.detach().clone(), requires_grad=False)
                                     for k, v in node.items()})
        return nn.ModuleDict({k: _to_module(v) for k, v in node.items()})
    return nn.ModuleList(_to_module(v) for v in node)


def _from_module(mod):
    if isinstance(mod, nn.ParameterDict):
        return dict(mod.items())
    if isinstance(mod, nn.ModuleDict):
        return {k: _from_module(v) for k, v in mod.items()}
    return [_from_module(v) for v in mod]


class FFCResNetGenerator(nn.Module):
    """The generator as an ``nn.Module`` holding its own copy of a parameter
    tree (the device-resident weights of an inpainter).  ``forward`` takes
    NCHW [B, 3, H, W] in [0, 1] and masks [B, H, W]."""

    def __init__(self, params: dict, cfg: InpaintConfig):
        super().__init__()
        self.cfg = cfg
        self.net = _to_module(params)

    def tree(self) -> dict:
        """The parameter tree as views of this module's parameters."""
        return _from_module(self.net)

    def forward(self, images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        return forward(self.tree(), images, masks, self.cfg)


# -- parameters ---------------------------------------------------------------------


def _tree(cfg: InpaintConfig, leaf) -> dict:
    """The JAX package's tree with ``leaf(cin, cout, k)`` at each conv, built
    in tree order (stem, down, blocks, up, head)."""
    cl, cg = cfg.cl, cfg.cg

    def ffc_unit():
        return {"l2l": leaf(cl, cl, 3), "g2l": leaf(cg, cl, 3), "l2g": leaf(cl, cg, 3),
                "g2g": {"conv1": leaf(cg, cg // 2, 1),
                        "fu": leaf(cg, cg, 1),  # over interleaved (re, im) channels
                        "conv2": leaf(cg // 2, cg, 1)}}

    stem = leaf(4, cfg.feats(0), 7)
    down = []
    for i in range(cfg.downsamples):
        cin, cout = cfg.feats(i), cfg.feats(i + 1)
        if i == cfg.downsamples - 1:
            down.append({"l2l": leaf(cin, cl, 3), "l2g": leaf(cin, cg, 3)})
        else:
            down.append({"l2l": leaf(cin, cout, 3)})
    blocks = [{"conv1": ffc_unit(), "conv2": ffc_unit()} for _ in range(cfg.num_blocks)]
    up = [leaf(cfg.feats(i + 1), cfg.feats(i), 3) for i in reversed(range(cfg.downsamples))]
    return {"stem": stem, "down": down, "blocks": blocks, "up": up,
            "head": leaf(cfg.feats(0), 3, 7)}


def init_params_numpy(cfg: InpaintConfig, seed: int = 0) -> dict:
    """Random weights in the JAX package's layout (HWIO kernels, numpy f32):
    ``N(0, 1)·sqrt(2/fan_in)`` from ``np.random.default_rng(seed)`` in tree
    order, zero biases (JAX's scheme; its ``PRNGKey`` draws are not
    reproducible here, the same numpy tree fed to both packages is)."""
    rng = np.random.default_rng(seed)

    def leaf(cin, cout, k):
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        return {"kernel": (w * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    return _tree(cfg, leaf)


def _map_convs(tree, fn, up=False):
    if isinstance(tree, dict):
        if "kernel" in tree and "bias" in tree and not isinstance(tree["kernel"], dict):
            return fn(tree, up)
        return {k: _map_convs(v, fn, up or k == "up") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_convs(v, fn, up) for v in tree]
    raise TypeError(f"inpaint: unexpected leaf {type(tree)}")


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's tree (numpy or JAX arrays) -> the port's, f32 on
    ``device``: HWIO -> OIHW; the upsamples' flipped [3, 3, I, O] -> the
    ``ConvTranspose2d`` weight [I, O, 3, 3], flipped back."""

    def conv(p, up):
        k = np.array(p["kernel"], np.float32)
        k = k[::-1, ::-1].transpose(2, 3, 0, 1) if up else k.transpose(3, 2, 0, 1)
        return {"kernel": torch.from_numpy(np.ascontiguousarray(k)).to(device),
                "bias": torch.from_numpy(np.array(p["bias"], np.float32)).to(device)}

    return _map_convs(tree, conv)


def params_to_jax(tree) -> dict:
    """The port's tree (or an ``FFCResNetGenerator``) -> the JAX package's
    layout as numpy f32."""
    if isinstance(tree, FFCResNetGenerator):
        tree = tree.tree()

    def conv(p, up):
        k = p["kernel"].detach().float().cpu().numpy()
        k = k.transpose(2, 3, 0, 1)[::-1, ::-1] if up else k.transpose(2, 3, 1, 0)
        return {"kernel": np.ascontiguousarray(k),
                "bias": p["bias"].detach().float().cpu().numpy()}

    return _map_convs(tree, conv)


def init_params(cfg: InpaintConfig, seed: int = 0, device="cpu") -> dict:
    """``init_params_numpy`` as the port's tree on ``device``."""
    return params_from_jax(init_params_numpy(cfg, seed), device)


# -- the wrapper ----------------------------------------------------------------------


class LamaInpainter:
    """Reference-wrapper contract: ``(bgr image, mask) -> np image`` (the
    callable shape the reference builds at ``main_window.py:3578``).

    ``params``: the port's tree (``init_params``, ``params_from_jax`` of a
    converted checkpoint) or an ``FFCResNetGenerator``; None leaves an
    inpainter that raises when called.  The weights are copied once, in f32,
    to ``device`` (default ``"cuda"``, which raises where CUDA is unavailable
    rather than running on the CPU).

    ``mesh``: a ``parallel.mesh.Mesh`` whose devices replace ``device``
    (they must be of its type).  A dispatch of at least the data-axis size
    of regions is zero-padded and split across the data devices (the
    weights replicated once, on the first such dispatch), at most
    ``DISPATCH_PIXELS`` padded pixels a device; a smaller one runs on the
    first device."""

    def __init__(self, params=None, cfg: InpaintConfig | None = None, device="cuda",
                 mesh: meshlib.Mesh | None = None):
        self.device = meshlib.serving_devices(mesh, device, "LamaInpainter")[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LamaInpainter: device='cuda' but CUDA is unavailable")
        self.cfg = cfg or InpaintConfig()
        self.mesh = mesh
        self.params = params
        self._net = None
        self._params_repl = None  # one tree per data device, made on first use
        if params is not None:
            tree = params.tree() if isinstance(params, FFCResNetGenerator) else params
            self._net = FFCResNetGenerator(tree, self.cfg).to(self.device, torch.float32)

    def _dispatch(self, imgs: np.ndarray, msks: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] / [N, H, W] uint8 (already factor-padded) -> [N, H, W, 3]:
        one call on the first device, or, under a mesh and with N at least
        the data-axis size, one call on each data device (zero-padded to a
        multiple of it), all launched before any is read back."""
        n = imgs.shape[0]
        if not meshlib.splits(self.mesh, n):
            return inpaint_batch(self._net, imgs, msks, self.cfg).cpu().numpy()
        if self._params_repl is None:
            self._params_repl = meshlib.dp_replicate(self._net.tree(), self.mesh)
        shards = zip(self._params_repl, meshlib.dp_shard_batch(imgs, self.mesh),
                     meshlib.dp_shard_batch(msks, self.mesh))
        return meshlib.dp_gather([inpaint_batch(t, i, m, self.cfg) for t, i, m in shards], n)

    def _pad(self, img: np.ndarray, msk: np.ndarray):
        """Pad to a multiple of the downsample factor: the image by its edge,
        the mask by zeros."""
        f = 2**self.cfg.downsamples
        h, w = img.shape[:2]
        ph, pw = (f - h % f) % f, (f - w % f) % f
        return (np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge"),
                np.pad(msk, ((0, ph), (0, pw)), mode="constant"))

    def __call__(self, image_bgr: np.ndarray, mask_u8: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("inpainter has no weights loaded")
        h, w = image_bgr.shape[:2]
        img, msk = self._pad(image_bgr, mask_u8)
        return self._dispatch(img[None], msk[None])[0][:h, :w]

    def inpaint_many(
        self, images_bgr: list[np.ndarray], masks_u8: list[np.ndarray]
    ) -> list[np.ndarray]:
        """Batched multi-region inpainting: regions grouped by factor-padded
        shape, one dispatch per shape group of at most ``DISPATCH_PIXELS``
        padded pixels a device (at least one region; under a mesh, the data
        devices' share while at least one region a device is left); results
        in input order."""
        if self.params is None:
            raise RuntimeError("inpainter has no weights loaded")
        prepped = [(*self._pad(img, msk), img.shape[0], img.shape[1])
                   for img, msk in zip(images_bgr, masks_u8)]
        by_shape: dict[tuple, list[int]] = {}
        for i, (img, _, _, _) in enumerate(prepped):
            by_shape.setdefault(img.shape[:2], []).append(i)
        out: list[np.ndarray | None] = [None] * len(prepped)
        for (ph, pw), group in sorted(by_shape.items()):
            cap = max(1, DISPATCH_PIXELS // (ph * pw))
            for part in meshlib.dispatch_slices(len(group), cap, self.mesh):
                idxs = group[part]
                res = self._dispatch(np.stack([prepped[i][0] for i in idxs]),
                                     np.stack([prepped[i][1] for i in idxs]))
                for row, i in enumerate(idxs):
                    h, w = prepped[i][2], prepped[i][3]
                    out[i] = res[row][:h, :w]
        return out  # type: ignore[return-value]
