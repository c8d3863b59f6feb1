"""ONNX graph -> PyTorch executor (the ONNX bubble-detector converter;
counterpart of ``manga_ocr_tpu/models/convert_onnx.py``).

The reference runs its primary DL bubble segmenter as an onnxruntime
session (``_run_onnx_inference``, ``main_window.py:6776-6815``: resize to
the model-declared input, /255 float32 NCHW, output squeezed to [H, W],
>0.5 -> 0/255 mask).  Without onnxruntime, this module executes the parsed
graph (``models/onnx_lite``) op by op on PyTorch tensors, covering the
conv-net op set U-Net-style segmenters use.  It is plain PyTorch on the
device; the JAX graph has no Pallas kernel.  Its f32 products run with
TF32 off (``models.detector.fp32_products``), as the JAX graph's are f32.

The op semantics are the JAX executor's, not the ONNX specification's
where the two part: ``Resize``/``Upsample`` follow ``jax.image.resize``
(``"linear"`` is the antialiased triangle filter, ``ops/image.py``'s
``resize_bilinear``; ``"nearest"`` samples half-pixel centres, torch's
``"nearest-exact"``) whatever ``coordinate_transformation_mode`` says, and
pooling strides default to the kernel shape.  ONNX pads may differ at the
two ends of an axis: convolutions and pools pad explicitly first (zeros
for a conv, -inf for MaxPool), since ``F.conv2d`` and ``F.max_pool2d`` pad
symmetrically only.  Tensors stay in ONNX's NCHW layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from manga_ocr_tpu_torch.models.detector import fp32_products
from manga_ocr_tpu_torch.models.onnx_lite import Graph, load_model
from manga_ocr_tpu_torch.ops.image import resize_bilinear


def _attr(node, name, default=None):
    a = node.attrs.get(name)
    if a is None:
        return default
    return a.value if hasattr(a, "value") else a  # parsed Attribute or raw


def _pads4(node):
    pads = _attr(node, "pads", [0, 0, 0, 0])
    if _attr(node, "auto_pad", b"NOTSET") not in (b"NOTSET", "NOTSET", None):
        raise NotImplementedError("auto_pad not supported; export with explicit pads")
    # ONNX: [x1_begin, x2_begin, x1_end, x2_end]
    return (int(pads[0]), int(pads[2])), (int(pads[1]), int(pads[3]))


def _pad_hw(x, node, value=0.0):
    """``x`` padded by the node's ``pads`` (F.pad's order: W, then H)."""
    (pt, pb), (pl, pr) = _pads4(node)
    if pt == pb == pl == pr == 0:
        return x
    return F.pad(x, (pl, pr, pt, pb), value=value)


def _bias(y, node, vals):
    if len(node.inputs) > 2:
        y = y + vals[node.inputs[2]].to(y.dtype)[None, :, None, None]
    return y


def _op_conv(node, vals):
    x, w = vals[node.inputs[0]], vals[node.inputs[1]]
    strides = tuple(int(s) for s in _attr(node, "strides", [1, 1]))
    dil = tuple(int(d) for d in _attr(node, "dilations", [1, 1]))
    groups = int(_attr(node, "group", 1))
    (pt, pb), (pl, pr) = _pads4(node)
    if pt == pb and pl == pr:  # symmetric: F.conv2d pads itself, no padded copy
        y = F.conv2d(x, w.to(x.dtype), None, strides, (pt, pl), dil, groups)
    else:
        y = F.conv2d(_pad_hw(x, node), w.to(x.dtype), None, strides, 0, dil, groups)
    return _bias(y, node, vals)


def _op_conv_transpose(node, vals):
    """JAX's input-dilated conv with the flipped kernel, as torch's full
    transposed conv (no padding) cropped by the pads: output row ``i`` is
    full row ``i + pt``; rows past the full output (``output_padding``
    beyond the end pad) are zeros before the bias."""
    x, w = vals[node.inputs[0]], vals[node.inputs[1]]  # w: [I, O/g, kh, kw]
    strides = tuple(int(s) for s in _attr(node, "strides", [1, 1]))
    (pt, pb), (pl, pr) = _pads4(node)
    opad = tuple(int(v) for v in _attr(node, "output_padding", [0, 0]))
    if int(_attr(node, "group", 1)) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    full = F.conv_transpose2d(x, w.to(x.dtype), None, strides)
    out_h = full.shape[2] - pt - pb + opad[0]
    out_w = full.shape[3] - pl - pr + opad[1]
    full = F.pad(full, (0, max(0, opad[1] - pr), 0, max(0, opad[0] - pb)))
    return _bias(full[:, :, pt : pt + out_h, pl : pl + out_w], node, vals)


def _op_batchnorm(node, vals):
    x = vals[node.inputs[0]]
    s, b, mean, var = (vals[node.inputs[i]].to(torch.float32) for i in (1, 2, 3, 4))
    eps = float(_attr(node, "epsilon", 1e-5))
    scale = s * torch.rsqrt(var + eps)
    y = x.to(torch.float32) * scale[None, :, None, None] + (b - mean * scale)[None, :, None, None]
    return y.to(x.dtype)


def _op_pool(node, vals, kind):
    x = vals[node.inputs[0]]
    ks = tuple(int(k) for k in _attr(node, "kernel_shape"))
    strides = tuple(int(s) for s in _attr(node, "strides", ks))
    if kind == "max":
        return F.max_pool2d(_pad_hw(x, node, float("-inf")), ks, strides)
    summed = F.avg_pool2d(_pad_hw(x, node), ks, strides, divisor_override=1)
    if int(_attr(node, "count_include_pad", 0)):
        return summed / float(ks[0] * ks[1])
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(_pad_hw(ones, node), ks, strides, divisor_override=1)
    return summed / counts


def _resize_hw(x, out_h, out_w, mode):
    """``jax.image.resize``'s methods: ``"nearest"`` by half-pixel centres,
    anything else the antialiased triangle filter."""
    if mode in (b"nearest", "nearest"):
        return F.interpolate(x, size=(int(out_h), int(out_w)), mode="nearest-exact")
    return resize_bilinear(x, int(out_h), int(out_w), channels_last=False).to(x.dtype)


def _op_resize(node, vals, host):
    x = vals[node.inputs[0]]
    mode = _attr(node, "mode", b"nearest")
    sizes = scales = None
    # opset>=11: inputs = X, roi, scales, sizes ; opset 10: X, scales
    for name in node.inputs[1:]:
        if not name:
            continue
        arr = host(name)
        if arr.size == 0:
            continue
        if arr.dtype in (np.int64, np.int32):
            sizes = arr
        elif arr.size == 4:
            scales = arr
    if sizes is not None:
        return _resize_hw(x, sizes[-2], sizes[-1], mode)
    if scales is not None:
        return _resize_hw(x, round(x.shape[2] * scales[2]), round(x.shape[3] * scales[3]), mode)
    raise ValueError("Resize without scales/sizes")


def _op_upsample(node, vals, host):
    x = vals[node.inputs[0]]
    scales = _attr(node, "scales")
    if scales is None:
        scales = host(node.inputs[1])
    return _resize_hw(
        x,
        round(x.shape[2] * float(scales[2])),
        round(x.shape[3] * float(scales[3])),
        _attr(node, "mode", b"nearest"),
    )


def _op_pad(node, vals, host):
    """``jnp.pad``'s modes: constant, reflect, and edge for any other mode
    name; reflect and edge gather the indices ``np.pad`` gives an arange."""
    x = vals[node.inputs[0]]
    pads = _attr(node, "pads")
    if pads is None:
        pads = host(node.inputs[1]).tolist()
    mode = _attr(node, "mode", b"constant")
    n = x.ndim
    cfg = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode in (b"constant", "constant"):
        cval = 0.0
        if len(node.inputs) > 2 and node.inputs[2]:
            cval = float(host(node.inputs[2]))
        return F.pad(x, [v for lo_hi in reversed(cfg) for v in lo_hi], value=cval)
    np_mode = "reflect" if mode in (b"reflect", "reflect") else "edge"
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[dim]), (lo, hi), mode=np_mode)
            x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def _op_clip(node, vals, host):
    def bound(i, name, default):
        if len(node.inputs) > i and node.inputs[i]:
            return float(host(node.inputs[i]))
        return _attr(node, name, default)

    return torch.clamp(vals[node.inputs[0]], bound(1, "min", -np.inf), bound(2, "max", np.inf))


def graph_constants(graph: Graph, device) -> dict:
    """The graph's initializers as the executor reads them: float tensors on
    ``device``; int64 arrays stay NumPy (shapes, sizes), as in JAX's."""
    return {name: arr if arr.dtype == np.int64 else torch.from_numpy(np.array(arr)).to(device)
            for name, arr in graph.initializers.items()}


def run_graph(graph: Graph, feeds: dict, consts: dict | None = None) -> list:
    """Execute the graph on the given input tensors; returns the output list.

    ``consts``: ``graph_constants(graph, device)``, built once by a caller
    that runs the graph repeatedly; else built here on the first feed's
    device.  Values that set shapes (sizes, scales, pads, clip bounds,
    reshape targets, axes) are read on the host from the initializers or
    Constant nodes where they come from, else copied from the device."""
    device = next(iter(feeds.values())).device if feeds else torch.device("cpu")
    if consts is None:
        consts = graph_constants(graph, device)
    vals: dict = dict(consts)
    vals.update(feeds)
    statics: dict = {}

    def host(name):
        if name in statics:
            return statics[name]
        if name in graph.initializers:
            return np.asarray(graph.initializers[name])
        v = vals[name]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    for node in graph.nodes:
        op = node.op_type
        if op == "Conv":
            out = _op_conv(node, vals)
        elif op == "ConvTranspose":
            out = _op_conv_transpose(node, vals)
        elif op == "BatchNormalization":
            out = _op_batchnorm(node, vals)
        elif op == "Relu":
            out = torch.relu(vals[node.inputs[0]])
        elif op == "LeakyRelu":
            out = F.leaky_relu(vals[node.inputs[0]], float(_attr(node, "alpha", 0.01)))
        elif op == "Sigmoid":
            out = torch.sigmoid(vals[node.inputs[0]])
        elif op == "Tanh":
            out = torch.tanh(vals[node.inputs[0]])
        elif op == "Clip":
            out = _op_clip(node, vals, host)
        elif op == "MaxPool":
            out = _op_pool(node, vals, "max")
        elif op == "AveragePool":
            out = _op_pool(node, vals, "avg")
        elif op == "GlobalAveragePool":
            out = torch.mean(vals[node.inputs[0]], dim=(2, 3), keepdim=True)
        elif op == "Concat":
            axis = int(_attr(node, "axis", 1))
            out = torch.cat([vals[i] for i in node.inputs], dim=axis)
        elif op == "Add":
            out = vals[node.inputs[0]] + vals[node.inputs[1]]
        elif op == "Mul":
            out = vals[node.inputs[0]] * vals[node.inputs[1]]
        elif op == "Resize":
            out = _op_resize(node, vals, host)
        elif op == "Upsample":
            out = _op_upsample(node, vals, host)
        elif op == "Pad":
            out = _op_pad(node, vals, host)
        elif op in ("Identity", "Cast", "Dropout"):
            out = vals[node.inputs[0]]
        elif op == "Constant":
            t = _attr(node, "value")
            arr = np.asarray(t.array if hasattr(t, "array") else t)
            for o in node.outputs:
                statics[o] = arr
            out = arr if arr.dtype == np.int64 else torch.from_numpy(np.array(arr)).to(device)
        elif op == "Reshape":
            shape = host(node.inputs[1]).tolist()
            x = vals[node.inputs[0]]
            shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
            out = torch.reshape(x, shape)
        elif op == "Transpose":
            x = vals[node.inputs[0]]
            perm = _attr(node, "perm")
            out = x.permute(*(perm if perm is not None else reversed(range(x.ndim))))
        elif op == "Squeeze":
            axes = _attr(node, "axes")
            if axes is None and len(node.inputs) > 1:
                axes = host(node.inputs[1]).tolist()
            x = vals[node.inputs[0]]
            out = x.squeeze(tuple(int(a) for a in axes)) if axes else x.squeeze()
        else:
            raise NotImplementedError(f"ONNX op not supported: {op}")
        for o in node.outputs:
            if o:
                vals[o] = out
    return [vals[vi.name] for vi in graph.outputs]


class OnnxBubbleDetector:
    """The reference's ONNX-wrapper contract on the PyTorch executor:
    page BGR uint8 -> 0/255 bubble mask at page size (threshold 0.5).

    Pages go one at a time: resized on the host with PIL (BILINEAR), /255,
    NCHW, the graph on ``device`` (default ``"cuda"``, which raises where
    CUDA is unavailable rather than running on the CPU), the probability map
    back to page size with PIL."""

    def __init__(self, graph: Graph, input_size: int | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OnnxBubbleDetector: device='cuda' but CUDA is unavailable")
        self.graph = graph
        # the image input is the first graph input that is NOT an
        # initializer (exporters with keep_initializers_as_inputs=True list
        # every weight tensor in graph.inputs too)
        data_inputs = [vi for vi in graph.inputs if vi.name not in graph.initializers]
        vi = data_inputs[0] if data_inputs else None
        self.input_name = vi.name if vi is not None else "input"
        dh = dw = None
        if vi is not None and len(vi.shape) == 4:
            h, w = vi.shape[2], vi.shape[3]
            if h and w:
                dh, dw = int(h), int(w)  # may be non-square
        if input_size:
            dh = dw = int(input_size)
        self.in_h = dh or 512  # reference fallback
        self.in_w = dw or 512
        self.input_size = self.in_h
        self._consts = graph_constants(graph, self.device)

    @staticmethod
    def from_file(path: str, input_size: int | None = None, device="cuda") -> "OnnxBubbleDetector":
        return OnnxBubbleDetector(load_model(path), input_size, device)

    def probabilities(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, in_h, in_w] float in [0,1] -> the graph's first output on
        the device, f32 products with TF32 off."""
        with fp32_products(), torch.no_grad():
            return run_graph(self.graph, {self.input_name: x.to(self.device)}, self._consts)[0]

    def page_probabilities(self, page_bgr: np.ndarray) -> np.ndarray:
        """The page's [H, W] f32 map before the threshold: the graph's
        output through uint8 and PIL's BILINEAR resize back to page size."""
        from PIL import Image

        h, w = page_bgr.shape[:2]
        # PIL copies a reversed-stride view slowly (~40 ms a 1700x1200 page):
        # hand it contiguous RGB, the same bytes
        rgb = np.asarray(
            Image.fromarray(np.ascontiguousarray(page_bgr[..., ::-1])).resize(
                (self.in_w, self.in_h), Image.BILINEAR),
            np.float32,
        )
        x = torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1)[None] / 255.0))
        prob = self.probabilities(x).float().cpu().numpy().squeeze()
        if prob.ndim != 2:
            prob = prob.reshape(prob.shape[-2], prob.shape[-1])
        return (
            np.asarray(
                Image.fromarray((prob * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
                np.float32,
            )
            / 255.0
        )

    def detect_bubble_mask(self, page_bgr: np.ndarray) -> np.ndarray:
        return (self.page_probabilities(page_bgr) > 0.5).astype(np.uint8) * 255

def unet_graph(params, cfg) -> Graph:
    """The port's U-Net (``models/detector.py``: a tree or a ``UNet`` and its
    ``DetectorConfig``) authored as an ONNX graph of Conv (pads 1, or 0 for
    the 1x1 head), Relu, MaxPool 2/2, Resize (nearest, 2x by int64 sizes),
    Concat and Sigmoid: input ``"input"`` [1, 3, S, S], output ``"prob"``
    [1, 1, S, S].  The same function as ``models.detector.forward``, for
    writing a segmenter as an ``.onnx`` checkpoint (``onnx_lite.save_model``).
    The sizes are int64 because the JAX package's jitted executor cannot read
    float scales from an initializer (it reads them on the host)."""
    from manga_ocr_tpu_torch.models import onnx_lite as ol
    from manga_ocr_tpu_torch.models.detector import UNet

    tree = params.tree() if isinstance(params, UNet) else params
    g = ol.Graph()

    def conv(x, p, name, pad):
        g.initializers[f"{name}.w"] = p["kernel"].detach().float().cpu().numpy()
        g.initializers[f"{name}.b"] = p["bias"].detach().float().cpu().numpy()
        g.nodes.append(ol.Node("Conv", name, [x, f"{name}.w", f"{name}.b"], [name],
                               {"pads": [pad] * 4}))
        return name

    def block(x, p, name):
        for c in ("c1", "c2"):
            g.nodes.append(ol.Node("Relu", f"{name}.{c}.relu", [conv(x, p[c], f"{name}.{c}", 1)],
                                   [f"{name}.{c}.relu"]))
            x = f"{name}.{c}.relu"
        return x

    x, skips = "input", []
    for i in range(cfg.depth):
        x = block(x, tree["down"][i], f"down{i}")
        skips.append(x)
        g.nodes.append(ol.Node("MaxPool", f"pool{i}", [x], [f"pool{i}"],
                               {"kernel_shape": [2, 2], "strides": [2, 2]}))
        x = f"pool{i}"
    x = block(x, tree["mid"], "mid")
    for i in reversed(range(cfg.depth)):
        side = cfg.input_size >> i
        g.initializers[f"up{i}.sizes"] = np.asarray([1, 1, side, side], np.int64)
        g.nodes.append(ol.Node("Resize", f"up{i}.resize", [x, "", "", f"up{i}.sizes"],
                               [f"up{i}.resize"], {"mode": b"nearest"}))
        g.nodes.append(ol.Node("Concat", f"up{i}.cat", [f"up{i}.resize", skips[i]],
                               [f"up{i}.cat"], {"axis": 1}))
        x = block(f"up{i}.cat", tree["up"][i], f"up{i}")
    g.nodes.append(ol.Node("Sigmoid", "prob", [conv(x, tree["head"], "head", 0)], ["prob"]))
    s = cfg.input_size
    g.inputs = [ol.ValueInfo("input", [1, 3, s, s])]
    g.outputs = [ol.ValueInfo("prob", [1, 1, s, s])]
    return g
