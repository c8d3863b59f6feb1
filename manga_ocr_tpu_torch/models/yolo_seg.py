"""YOLO-family instance-segmentation detector on PyTorch (the second bubble
detector; counterpart of ``manga_ocr_tpu/models/yolo_seg.py``).

The reference's second detector family is Ultralytics YOLOv8-seg run as a
torch black box (``_run_yolov8_inference``, ``main_window.py:6817-6841``):
per-instance masks are OR-ed into one full-image 0/255 bubble mask.  This
module implements the architecture (config-scalable n/s/m widths):

- backbone: Conv(stride 2) stem, C2f stages (residual bottlenecks), SPPF,
- neck: top-down + bottom-up PAN over P3/P4/P5 (C2f without shortcuts),
- heads: anchor-free decoupled branches per level -- box (DFL over reg_max
  bins), class, and mask coefficients -- plus a proto net on P3 (conv,
  2x2-stride-2 transposed conv, conv, conv) producing mask bases,
- inference: the batched forward on the device (plain PyTorch, f32 with
  TF32 off; the JAX graph has no Pallas kernel); box decode + NMS +
  proto x coeff mask assembly on the host (data-dependent shapes), host
  NumPy copied from the JAX package.

Channel rules (box c2 = max(16, P3//4, 4*reg_max); cls c3 = max(P3,
min(nc, 100)); coeff c4 = max(P3//4, num_masks)) and stride-2 padding
(symmetric k//2, torch's convention) are the deployed checkpoints', so
real weights convert exactly (``models/convert_yolo.py``).

Parameters keep the JAX package's tree with kernels in PyTorch's layouts
(OIHW; the proto's transposed conv [I, O, 2, 2]); the JAX layout (HWIO)
exists only at the edges: ``params_from_jax``/``params_to_jax`` and the
flat ``.npz`` files ``save_params``/``load_params`` share with the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from manga_ocr_tpu_torch.models.detector import fill_template, fp32_products, save_npz
from manga_ocr_tpu_torch.ops.image import resize_bilinear


@dataclasses.dataclass(frozen=True)
class YoloSegConfig:
    input_size: int = 640
    num_classes: int = 1  # speech-bubble
    width: tuple = (16, 32, 64, 128, 256)  # stem..P5 channels (n-scale)
    depth: tuple = (1, 2, 2, 1)  # C2f bottleneck counts per stage
    reg_max: int = 16
    num_masks: int = 32
    conf_threshold: float = 0.25
    iou_threshold: float = 0.7
    mask_threshold: float = 0.5


def _conv(x, p, stride=1):
    """Conv with torch's symmetric k//2 padding (also at stride 2, where
    XLA's "SAME" would pad asymmetrically)."""
    w = p["kernel"]
    return F.conv2d(x, w, p["bias"], stride, w.shape[-1] // 2)


def _conv_silu(x, p, stride=1):
    return F.silu(_conv(x, p, stride))


def _conv_transpose2x2(x, p):
    """ConvTranspose2d(k=2, s=2, p=0): out[2i+u, 2j+v, o] = sum_c x[i,j,c] W[c,o,u,v] + b."""
    return F.conv_transpose2d(x, p["kernel"], p["bias"], 2)


def _bottleneck(x, p, shortcut=True):
    y = _conv_silu(_conv_silu(x, p["cv1"]), p["cv2"])
    return x + y if shortcut and x.shape == y.shape else y


def _c2f(x, p, shortcut=True):
    """YOLOv8 C2f; backbone stages use residual bottlenecks, neck stages
    pass shortcut=False (the checkpoints' structure)."""
    outs = list(torch.chunk(_conv_silu(x, p["cv1"]), 2, dim=1))
    for bp in p["m"]:
        outs.append(_bottleneck(outs[-1], bp, shortcut))
    return _conv_silu(torch.cat(outs, dim=1), p["cv2"])


def _sppf(x, p):
    pools = [_conv_silu(x, p["cv1"])]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return _conv_silu(torch.cat(pools, dim=1), p["cv2"])


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(params: dict, images: torch.Tensor, cfg: YoloSegConfig):
    """[B, 3, S, S] float in [0,1] -> (preds [B, N, no], protos [B, S/4, S/4, nm]).

    ``no = 4*reg_max + nc + nm``; N = sum of P3/P4/P5 grid cells; the
    outputs have the JAX package's layouts."""
    x = _conv_silu(images, params["stem"], stride=2)  # /2
    x = _conv_silu(x, params["down1"], stride=2)  # /4
    x = _c2f(x, params["c2f1"])
    x = _conv_silu(x, params["down2"], stride=2)  # /8
    p3 = _c2f(x, params["c2f2"])
    x = _conv_silu(p3, params["down3"], stride=2)  # /16
    p4 = _c2f(x, params["c2f3"])
    x = _conv_silu(p4, params["down4"], stride=2)  # /32
    p5 = _sppf(_c2f(x, params["c2f4"]), params["sppf"])

    # top-down (neck C2f: shortcut=False, matching the checkpoints)
    u4 = _c2f(torch.cat([_upsample2(p5), p4], 1), params["n_td4"], False)
    u3 = _c2f(torch.cat([_upsample2(u4), p3], 1), params["n_td3"], False)
    # bottom-up
    d4 = _c2f(torch.cat([_conv_silu(u3, params["n_bu3"], stride=2), u4], 1), params["n_bu4"], False)
    d5 = _c2f(torch.cat([_conv_silu(d4, params["n_bu4c"], stride=2), p5], 1), params["n_bu5"],
              False)

    # Proto: conv -> 2x2/s2 transposed conv -> conv -> conv (all SiLU but the transposed conv)
    pr = params["proto"]
    protos = _conv_transpose2x2(_conv_silu(u3, pr["cv1"]), pr["up"])
    protos = _conv_silu(_conv_silu(protos, pr["cv2"]), pr["cv3"])

    def _branch(feat, bp):
        y = _conv_silu(_conv_silu(feat, bp["c1"]), bp["c2"])
        return _conv(y, bp["out"])  # plain conv (bias, no BN/act)

    preds = []
    hp = params["heads"]
    for i, feat in enumerate((u3, d4, d5)):
        y = torch.cat([_branch(feat, hp["box"][i]), _branch(feat, hp["cls"][i]),
                       _branch(feat, hp["coeff"][i])], dim=1)
        preds.append(y.flatten(2).transpose(1, 2))  # [B, gh*gw, no], row-major cells
    return torch.cat(preds, dim=1), protos.permute(0, 2, 3, 1)


def infer(params: dict, images_u8, cfg: YoloSegConfig):
    """uint8 RGB [B, H, W, 3] -> raw (preds, protos) at cfg.input_size on the
    parameters' device: /255, the triangle-filter resize (``jax.image.resize``
    "linear"), the forward."""
    device = params["stem"]["kernel"].device
    if isinstance(images_u8, np.ndarray):
        images_u8 = np.ascontiguousarray(images_u8)  # torch takes no negative strides
    pages = torch.as_tensor(images_u8).to(device)
    s = cfg.input_size
    with fp32_products(), torch.no_grad():
        x = resize_bilinear(pages.to(torch.float32) / 255.0, s, s, channels_last=True)
        return forward(params, x.permute(0, 3, 1, 2).contiguous(), cfg)


# ---------------------------------------------------------------------------
# Host post-processing: decode, NMS, mask assembly (the JAX package's NumPy)
# ---------------------------------------------------------------------------


def _grid_anchors(size: int, strides=(8, 16, 32)) -> tuple[np.ndarray, np.ndarray]:
    pts, strs = [], []
    for st in strides:
        g = size // st
        yy, xx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        pts.append(np.stack([(xx + 0.5) * st, (yy + 0.5) * st], -1).reshape(-1, 2))
        strs.append(np.full((g * g,), st, np.float32))
    return np.concatenate(pts).astype(np.float32), np.concatenate(strs)


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> list[int]:
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return keep


def postprocess(
    preds: np.ndarray,  # [N, no] for ONE image
    protos: np.ndarray,  # [s/4, s/4, nm]
    cfg: YoloSegConfig,
    out_h: int,
    out_w: int,
) -> list[dict]:
    """Decode one image's raw outputs into instances:
    [{"box": [x1,y1,x2,y2] in output coords, "score", "mask" (bool [out])}]."""
    no = 4 * cfg.reg_max + cfg.num_classes + cfg.num_masks
    assert preds.shape[-1] == no
    rm = cfg.reg_max
    box_logits = preds[:, : 4 * rm].reshape(-1, 4, rm)
    cls_logits = preds[:, 4 * rm : 4 * rm + cfg.num_classes]
    coeffs = preds[:, 4 * rm + cfg.num_classes :]

    scores = 1.0 / (1.0 + np.exp(-cls_logits.max(axis=-1)))
    keep0 = scores >= cfg.conf_threshold
    if not keep0.any():
        return []
    anchors, strides = _grid_anchors(cfg.input_size)
    box_logits, scores, coeffs = box_logits[keep0], scores[keep0], coeffs[keep0]
    anchors, strides = anchors[keep0], strides[keep0]

    # DFL: softmax expectation over reg_max bins -> l,t,r,b distances
    e = np.exp(box_logits - box_logits.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    dist = (p * np.arange(rm)).sum(-1) * strides[:, None]  # [n,4]
    x1y1 = anchors - dist[:, :2]
    x2y2 = anchors + dist[:, 2:]
    boxes = np.concatenate([x1y1, x2y2], -1)

    keep = _nms(boxes, scores, cfg.iou_threshold)
    boxes, scores, coeffs = boxes[keep], scores[keep], coeffs[keep]

    # masks: sigmoid(protos @ coeff), crop to box, resize to page
    ph, pw, nm = protos.shape
    flat = protos.reshape(-1, nm)
    sx, sy = out_w / cfg.input_size, out_h / cfg.input_size
    instances = []
    for box, score, c in zip(boxes, scores, coeffs):
        m = 1.0 / (1.0 + np.exp(-(flat @ c))).reshape(ph, pw)
        # crop to box in proto coords
        bx = box / cfg.input_size * np.array([pw, ph, pw, ph])
        x1, y1, x2, y2 = np.clip(bx, 0, [pw, ph, pw, ph]).astype(int)
        crop_mask = np.zeros_like(m)
        crop_mask[y1:y2, x1:x2] = m[y1:y2, x1:x2]
        # nearest upsample to output size
        yi = np.clip((np.arange(out_h) * ph // out_h), 0, ph - 1)
        xi = np.clip((np.arange(out_w) * pw // out_w), 0, pw - 1)
        full = crop_mask[yi][:, xi] > cfg.mask_threshold
        out_box = box * np.array([sx, sy, sx, sy])
        instances.append({"box": out_box, "score": float(score), "mask": full})
    return instances


def combined_bubble_mask(instances: list[dict], out_h: int, out_w: int) -> np.ndarray:
    """OR all instance masks into one 0/255 mask (the reference contract)."""
    mask = np.zeros((out_h, out_w), np.uint8)
    for inst in instances:
        mask[inst["mask"]] = 255
    return mask


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _tree(cfg: YoloSegConfig, conv, up) -> dict:
    """The JAX package's tree, built in its order, with ``conv(cin, cout, k)``
    at each conv and ``up(c)`` at the proto's transposed conv."""
    w, d = cfg.width, cfg.depth
    nm, nc, rm = cfg.num_masks, cfg.num_classes, cfg.reg_max
    # Checkpoint channel rules (Detect/Segment head defaults)
    c2 = max(16, w[2] // 4, 4 * rm)  # box branch
    c3 = max(w[2], min(nc, 100))  # cls branch
    c4 = max(w[2] // 4, nm)  # mask-coeff branch
    cp = w[2]  # proto hidden channels (256 x width multiplier == P3 width)

    def c2f(cin, cout, n):
        half = cout // 2
        return {"cv1": conv(cin, cout, 1),
                "m": [{"cv1": conv(half, half, 3), "cv2": conv(half, half, 3)} for _ in range(n)],
                "cv2": conv(cout + half * n, cout, 1)}

    def branch(cin, mid, cout):
        return {"c1": conv(cin, mid, 3), "c2": conv(mid, mid, 3), "out": conv(mid, cout, 1)}

    return {
        "stem": conv(3, w[0], 3),
        "down1": conv(w[0], w[1], 3),
        "c2f1": c2f(w[1], w[1], d[0]),
        "down2": conv(w[1], w[2], 3),
        "c2f2": c2f(w[2], w[2], d[1]),
        "down3": conv(w[2], w[3], 3),
        "c2f3": c2f(w[3], w[3], d[2]),
        "down4": conv(w[3], w[4], 3),
        "c2f4": c2f(w[4], w[4], d[3]),
        "sppf": {"cv1": conv(w[4], w[4] // 2, 1), "cv2": conv(w[4] * 2, w[4], 1)},
        "n_td4": c2f(w[4] + w[3], w[3], d[0]),
        "n_td3": c2f(w[3] + w[2], w[2], d[0]),
        "n_bu3": conv(w[2], w[2], 3),
        "n_bu4": c2f(w[2] + w[3], w[3], d[0]),
        "n_bu4c": conv(w[3], w[3], 3),
        "n_bu5": c2f(w[3] + w[4], w[4], d[0]),
        "proto": {"cv1": conv(w[2], cp, 3), "up": up(cp), "cv2": conv(cp, cp, 3),
                  "cv3": conv(cp, nm, 1)},
        "heads": {
            "box": [branch(w[2 + i], c2, 4 * rm) for i in range(3)],
            "cls": [branch(w[2 + i], c3, nc) for i in range(3)],
            "coeff": [branch(w[2 + i], c4, nm) for i in range(3)],
        },
    }


def init_params_numpy(cfg: YoloSegConfig, seed: int = 0) -> dict:
    """Random weights in the JAX package's layout (HWIO kernels, numpy f32):
    He-normal convs and an N(0, 0.05) transposed conv, as JAX's
    ``init_params`` draws them, from ``np.random.default_rng(seed)`` in tree
    order; zero biases."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, k):
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        return {"kernel": (w * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    def up(c):
        w = rng.standard_normal((2, 2, c, c), dtype=np.float32)
        return {"kernel": (w * np.float32(0.05)).astype(np.float32),
                "bias": np.zeros((c,), np.float32)}

    return _tree(cfg, conv, up)


def _map_tree(tree, conv_fn, up_fn, path=()):
    if isinstance(tree, dict):
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            return (up_fn if path[-1] == "up" else conv_fn)(tree)
        return {k: _map_tree(v, conv_fn, up_fn, path + (k,)) for k, v in tree.items()}
    return [_map_tree(v, conv_fn, up_fn, path + (i,)) for i, v in enumerate(tree)]


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's tree (numpy or JAX arrays, HWIO kernels) -> the
    port's (tensors on ``device``; OIHW kernels, the proto's transposed conv
    [I, O, 2, 2])."""

    def leaf(p, perm):
        kernel = torch.from_numpy(np.array(p["kernel"], np.float32)).permute(*perm)
        return {"kernel": kernel.contiguous().to(device),
                "bias": torch.from_numpy(np.array(p["bias"], np.float32)).to(device)}

    return _map_tree(tree, lambda p: leaf(p, (3, 2, 0, 1)), lambda p: leaf(p, (2, 3, 0, 1)))


def params_to_jax(tree) -> dict:
    """The port's tree -> the JAX package's layout as numpy f32."""

    def leaf(p, perm):
        return {"kernel": np.ascontiguousarray(
                    p["kernel"].detach().permute(*perm).cpu().numpy()),
                "bias": p["bias"].detach().cpu().numpy()}

    return _map_tree(tree, lambda p: leaf(p, (2, 3, 1, 0)), lambda p: leaf(p, (2, 3, 0, 1)))


def init_params(cfg: YoloSegConfig, seed: int = 0, device="cpu") -> dict:
    """``init_params_numpy`` as the port's tree on ``device``."""
    return params_from_jax(init_params_numpy(cfg, seed), device)


def save_params(params: dict, path: str) -> None:
    """The flat ``.npz`` (HWIO kernels) either package loads."""
    save_npz(params_to_jax(params), path)


def load_params(path: str, cfg: YoloSegConfig, device="cpu") -> dict:
    """A flat ``.npz`` written by either package (or by ``convert_yolo``'s
    tree through ``models.detector.save_npz``) -> the port's tree, each
    leaf checked against the config's shapes."""
    shapes = _tree(cfg, lambda cin, cout, k: {"kernel": (k, k, cin, cout), "bias": (cout,)},
                   lambda c: {"kernel": (2, 2, c, c), "bias": (c,)})
    with np.load(path) as data:
        return params_from_jax(fill_template(data, shapes), device)


class YoloBubbleDetector:
    """The reference's contract: page BGR -> OR-ed 0/255 bubble mask.
    ``params``: the port's tree; the weights are copied once to ``device``
    (default ``"cuda"``, which raises where CUDA is unavailable
    rather than running on the CPU)."""

    def __init__(self, params: dict, cfg: YoloSegConfig | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("YoloBubbleDetector: device='cuda' but CUDA is unavailable")
        self.cfg = cfg or YoloSegConfig()
        def to_device(p):
            return {k: v.detach().to(self.device) for k, v in p.items()}

        self.params = _map_tree(params, to_device, to_device)

    def detect_bubble_mask(self, page_bgr: np.ndarray) -> np.ndarray:
        h, w = page_bgr.shape[:2]
        rgb = np.ascontiguousarray(page_bgr[None, ..., ::-1])
        preds, protos = infer(self.params, rgb, self.cfg)
        instances = postprocess(preds[0].cpu().numpy(), protos[0].cpu().numpy(),
                                self.cfg, h, w)
        return combined_bubble_mask(instances, h, w)
