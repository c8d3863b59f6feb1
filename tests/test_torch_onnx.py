"""The port's ONNX reader/writer and executor (``models/onnx_lite.py``,
``models/convert_onnx.py``) against the JAX package's on the same graphs
and numpy inputs: every op the JAX executor runs, each on one-op graphs
(asymmetric pads, dilation, groups, ``output_padding``, Resize by sizes and
by scales at 3 -> 5 in both modes, Pad in each mode, ...) within
``OP_ATOL``; a U-Net authored as a graph by ``unet_graph`` and run through
both executors, and against the port's own ``UNet`` forward;
``OnnxBubbleDetector`` and ``BubbleDetector.from_checkpoint(".onnx")`` page
masks against JAX's, the pixels near the threshold counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu.detect import detector as jdetect
from manga_ocr_tpu.models import convert_onnx as jonnx
from manga_ocr_tpu.models import onnx_lite as jol
from manga_ocr_tpu_torch.detect import detector as tdetect
from manga_ocr_tpu_torch.models import convert_onnx as tonnx
from manga_ocr_tpu_torch.models import detector as tseg
from manga_ocr_tpu_torch.models import onnx_lite as tol
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# f32 on both sides; the executors differ by summation order only (XLA's
# convolutions against ATen's), well under 1e-5 at these magnitudes
OP_ATOL = 1e-5
# the page masks: the probability map goes through uint8 and PIL before the
# threshold, so a pixel may flip where the two packages' uint8 maps differ
# (by one step of 1/255) and the resized value lies this close to 0.5
MASK_EPS = 2.0 / 255


def _graph(nodes, inputs, outputs, inits=None):
    g = tol.Graph()
    g.nodes = nodes
    g.inputs = [tol.ValueInfo(n, list(s)) for n, s in inputs]
    g.outputs = [tol.ValueInfo(n, []) for n in outputs]
    g.initializers = dict(inits or {})
    return g


def _run_both(g, feeds):
    """One graph through both executors, each reading the port writer's
    bytes with its own package's reader."""
    data = _bytes(g)
    want = [np.asarray(v) for v in jonnx.run_graph(jol.load_model(data),
                                                  {k: jnp.asarray(v) for k, v in feeds.items()})]
    got = [v.numpy() for v in tonnx.run_graph(tol.load_model(data),
                                              {k: torch.from_numpy(v) for k, v in feeds.items()})]
    return got, want


def _bytes(g):
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.onnx")
        tol.save_model(g, path)
        with open(path, "rb") as f:
            return f.read()


def _node(op, inputs, attrs=None, out="y"):
    return tol.Node(op, op.lower(), list(inputs), [out], dict(attrs or {}))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(nodes, feeds, inits=None, exact=False):
    g = _graph(nodes, [(k, v.shape) for k, v in feeds.items()], ["y"], inits)
    (got,), (want,) = _run_both(g, feeds)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)
    return got


CONV_CASES = {
    "sym": dict(w=(6, 4, 3, 3), attrs={"pads": [1, 1, 1, 1]}),
    "asym pads stride 2": dict(w=(6, 4, 3, 3), attrs={"pads": [0, 1, 2, 1], "strides": [2, 2]}),
    "dilation": dict(w=(5, 4, 3, 3), attrs={"pads": [2, 2, 2, 2], "dilations": [2, 2]}),
    "groups": dict(w=(8, 2, 3, 3), attrs={"pads": [1, 0, 1, 2], "group": 2}),
    "1x1 no bias": dict(w=(3, 4, 1, 1), attrs={}, bias=False),
}


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv(case):
    c = CONV_CASES[case]
    inits = {"w": _x(c["w"], 1) * 0.3, "b": _x((c["w"][0],), 2)}
    inputs = ["x", "w", "b"] if c.get("bias", True) else ["x", "w"]
    _check([_node("Conv", inputs, c["attrs"])], {"x": _x((2, 4, 9, 11))}, inits)


CONV_T_CASES = {
    "2x2 s2": dict(k=2, attrs={"strides": [2, 2]}),
    "3x3 s2 pads": dict(k=3, attrs={"strides": [2, 2], "pads": [1, 1, 1, 1]}),
    "3x3 s2 asym pads + output_padding": dict(
        k=3, attrs={"strides": [2, 2], "pads": [1, 0, 0, 1], "output_padding": [1, 1]}),
    "4x4 s3 output_padding past the end pad": dict(
        k=4, attrs={"strides": [3, 3], "pads": [2, 1, 0, 0], "output_padding": [2, 1]}),
}


@pytest.mark.parametrize("case", CONV_T_CASES, ids=str)
def test_conv_transpose(case):
    c = CONV_T_CASES[case]
    inits = {"w": _x((4, 3, c["k"], c["k"]), 3) * 0.3, "b": _x((3,), 4)}
    _check([_node("ConvTranspose", ["x", "w", "b"], c["attrs"])], {"x": _x((2, 4, 5, 7))}, inits)


def test_conv_transpose_groups_raise_in_both():
    g = _graph([_node("ConvTranspose", ["x", "w"], {"group": 2})], [("x", (1, 4, 3, 3))], ["y"],
               {"w": _x((4, 1, 2, 2))})
    feeds = {"x": _x((1, 4, 3, 3))}
    with pytest.raises(NotImplementedError, match="grouped"):
        jonnx.run_graph(g, {k: jnp.asarray(v) for k, v in feeds.items()})
    with pytest.raises(NotImplementedError, match="grouped"):
        tonnx.run_graph(g, {k: torch.from_numpy(v) for k, v in feeds.items()})


def test_batchnorm():
    rng = np.random.default_rng(5)
    inits = {"s": rng.uniform(0.5, 1.5, 4).astype(np.float32),
             "b": rng.normal(size=4).astype(np.float32),
             "m": rng.normal(size=4).astype(np.float32),
             "v": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    _check([_node("BatchNormalization", ["x", "s", "b", "m", "v"], {"epsilon": 1e-3})],
           {"x": _x((2, 4, 5, 6))}, inits)


@pytest.mark.parametrize("op,attrs", [("Relu", {}), ("LeakyRelu", {"alpha": 0.2}),
                                      ("LeakyRelu", {}), ("Sigmoid", {}), ("Tanh", {}),
                                      ("Clip", {"min": -0.5, "max": 0.25}),
                                      ("Identity", {}), ("Cast", {"to": 1}), ("Dropout", {}),
                                      ("GlobalAveragePool", {})], ids=str)
def test_elementwise(op, attrs):
    _check([_node(op, ["x"], attrs)], {"x": _x((2, 3, 5, 4)) * 3})


def test_clip_bounds_from_inputs():
    inits = {"lo": np.asarray(-0.3, np.float32), "hi": np.asarray(0.6, np.float32)}
    _check([_node("Clip", ["x", "lo", "hi"])], {"x": _x((1, 2, 4, 4))}, inits)
    _check([_node("Clip", ["x", "", "hi"])], {"x": _x((1, 2, 4, 4))}, inits)


POOL_CASES = {
    "max 2/2": ("MaxPool", {"kernel_shape": [2, 2], "strides": [2, 2]}),
    "max 3/2 asym pads": ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2],
                                      "pads": [0, 1, 2, 1]}),
    "max 3, strides default": ("MaxPool", {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
    "avg 3/1 pads": ("AveragePool", {"kernel_shape": [3, 3], "strides": [1, 1],
                                     "pads": [1, 0, 2, 1]}),
    "avg 3/2 count_include_pad": ("AveragePool", {"kernel_shape": [3, 3], "strides": [2, 2],
                                                  "pads": [1, 1, 1, 1], "count_include_pad": 1}),
}


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool(case):
    op, attrs = POOL_CASES[case]
    _check([_node(op, ["x"], attrs)], {"x": _x((2, 3, 9, 10)) - 2.0})  # negatives: -inf pads


def test_concat_add_mul():
    feeds = {"a": _x((2, 3, 4, 5), 1), "b": _x((2, 2, 4, 5), 2), "c": _x((1, 5, 1, 5), 3)}
    nodes = [tol.Node("Concat", "cat", ["a", "b"], ["ab"], {"axis": 1}),
             tol.Node("Mul", "mul", ["ab", "c"], ["abc"]),
             tol.Node("Add", "add", ["abc", "s"], ["y"])]
    _check(nodes, feeds, {"s": np.asarray([[[[0.5]]]], np.float32)})


RESIZE_CASES = {
    "sizes 3->5 nearest": ("sizes", [1, 1, 5, 5], b"nearest"),
    "sizes 3->5 linear": ("sizes", [1, 1, 5, 5], b"linear"),
    "scales 5/3 nearest": ("scales", [1.0, 1.0, 5 / 3, 5 / 3], b"nearest"),
    "scales 5/3 linear": ("scales", [1.0, 1.0, 5 / 3, 5 / 3], b"linear"),
    "sizes 9->5 linear (antialiased)": ("sizes", [1, 1, 5, 6], b"linear"),
    "sizes 9->5 nearest": ("sizes", [1, 1, 5, 6], b"nearest"),
    "scales 2 nearest, half_pixel ignored": ("scales", [1.0, 1.0, 2.0, 2.0], b"nearest"),
    "sizes cubic as linear": ("sizes", [1, 1, 7, 4], b"cubic"),
}


@pytest.mark.parametrize("case", RESIZE_CASES, ids=str)
def test_resize(case):
    kind, value, mode = RESIZE_CASES[case]
    side = 9 if "9->" in case else 3
    x = _x((2, 3, side, side), 7)
    if kind == "sizes":
        inits, inputs = {"sizes": np.asarray(value, np.int64)}, ["x", "", "", "sizes"]
    else:
        inits, inputs = {"scales": np.asarray(value, np.float32)}, ["x", "roi", "scales"]
        inits["roi"] = np.zeros((0,), np.float32)
    attrs = {"mode": mode, "coordinate_transformation_mode": b"asymmetric"}
    got = _check([_node("Resize", inputs, attrs)], {"x": x}, inits, exact=mode == b"nearest")
    if mode == b"nearest" and "3->5" in case.replace("scales 5/3", "3->5"):
        # half-pixel centres (torch's "nearest-exact"), which torch's "nearest" is not at 3 -> 5
        # (the two agree at 2x)
        out = tuple(got.shape[2:])
        plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=out, mode="nearest")
        assert not np.array_equal(plain.numpy(), got)


@pytest.mark.parametrize("mode", [b"nearest", b"linear"])
def test_upsample(mode):
    x = _x((1, 2, 3, 4), 8)
    _check([_node("Upsample", ["x"], {"mode": mode, "scales": [1.0, 1.0, 5 / 3, 1.5]})],
           {"x": x}, exact=mode == b"nearest")
    _check([_node("Upsample", ["x", "s"], {"mode": mode})], {"x": x},
           {"s": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)}, exact=mode == b"nearest")


PAD_CASES = {
    "constant attr": ({"pads": [0, 0, 1, 2, 0, 1, 0, 3]}, None),
    "constant input + value": ({}, (np.asarray([0, 1, 2, 0, 0, 0, 1, 2], np.int64), 1.5)),
    "reflect": ({"mode": b"reflect", "pads": [0, 0, 2, 3, 0, 0, 3, 1]}, None),
    "edge": ({"mode": b"edge", "pads": [0, 1, 2, 0, 1, 0, 0, 3]}, None),
}


@pytest.mark.parametrize("case", PAD_CASES, ids=str)
def test_pad(case):
    attrs, inp = PAD_CASES[case]
    inits, inputs = {}, ["x"]
    if inp is not None:
        inits = {"pads": inp[0], "cval": np.asarray(inp[1], np.float32)}
        inputs = ["x", "pads", "cval"]
    _check([_node("Pad", inputs, attrs)], {"x": _x((2, 3, 4, 5))}, inits, exact=True)


def test_constant_reshape_transpose_squeeze():
    x = _x((2, 3, 1, 4))
    shape = tol.Tensor("shape", np.asarray([0, -1, 2], np.int64))
    nodes = [tol.Node("Constant", "k", [], ["shape"], {"value": shape}),
             tol.Node("Reshape", "r", ["x", "shape"], ["r"]),
             tol.Node("Transpose", "t", ["r"], ["t"], {"perm": [2, 0, 1]}),
             tol.Node("Transpose", "t2", ["t"], ["y"])]
    _check(nodes, {"x": x}, exact=True)
    _check([_node("Squeeze", ["x"], {"axes": [2]})], {"x": x}, exact=True)
    _check([_node("Squeeze", ["x", "axes"])], {"x": x}, {"axes": np.asarray([-2], np.int64)},
           exact=True)
    _check([_node("Squeeze", ["x"])], {"x": _x((1, 3, 1, 4))}, exact=True)
    scale = tol.Tensor("s", np.asarray([[[[2.0]]]], np.float32))
    _check([tol.Node("Constant", "k", [], ["s"], {"value": scale}), _node("Mul", ["x", "s"])],
           {"x": x}, exact=True)


def test_unknown_op_and_auto_pad_raise_in_both():
    feeds = {"x": _x((1, 1, 4, 4))}
    for node, err in ((_node("Softmax", ["x"]), NotImplementedError),
                      (_node("MaxPool", ["x"], {"kernel_shape": [2, 2], "auto_pad": b"SAME_UPPER"}),
                       NotImplementedError)):
        g = _graph([node], [("x", (1, 1, 4, 4))], ["y"])
        with pytest.raises(err):
            jonnx.run_graph(g, {"x": jnp.asarray(feeds["x"])})
        with pytest.raises(err):
            tonnx.run_graph(g, {"x": torch.from_numpy(feeds["x"])})


# -- a U-Net as an ONNX graph -------------------------------------------------------

UNET_CFG = tseg.DetectorConfig(input_size=32, base_channels=4, depth=2)


@pytest.fixture(scope="module")
def unet():
    tree = tseg.init_params_numpy(UNET_CFG, 3)
    rng = np.random.default_rng(4)
    for leaf in jax.tree.leaves(tree):
        if leaf.ndim == 1:
            leaf += rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
    return tseg.params_from_jax(tree)


@pytest.fixture(scope="module")
def unet_path(unet, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("onnx") / "unet.onnx")
    tol.save_model(tonnx.unet_graph(unet, UNET_CFG), path)
    return path


def test_unet_graph_round_trip(unet, unet_path):
    jg, tg = jol.load_model(unet_path), tol.load_model(unet_path)
    assert [n.op_type for n in jg.nodes] == [n.op_type for n in tg.nodes]
    assert {"Conv", "Relu", "MaxPool", "Resize", "Concat", "Sigmoid"} == {n.op_type
                                                                          for n in tg.nodes}
    x = np.random.default_rng(0).random((2, 3, 32, 32), dtype=np.float32)
    want = np.asarray(jonnx.run_graph(jg, {"input": jnp.asarray(x)})[0])
    got = tonnx.run_graph(tg, {"input": torch.from_numpy(x)})[0].numpy()
    assert got.shape == want.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL)
    # the same function as the port's own U-Net forward on the same weights
    direct = tseg.forward(unet, torch.from_numpy(x), UNET_CFG).numpy()
    np.testing.assert_allclose(got[:, 0], direct, rtol=0, atol=OP_ATOL)


def test_onnx_detector_pages_match_jax(unet_path):
    jdet = jonnx.OnnxBubbleDetector.from_file(unet_path)
    tdet = tonnx.OnnxBubbleDetector.from_file(unet_path, device="cpu")
    assert (tdet.input_name, tdet.in_h, tdet.in_w) == (jdet.input_name, jdet.in_h, jdet.in_w)
    rng = np.random.default_rng(1)
    near_total = differ = pixels = 0
    for hw in ((70, 50), (33, 96)):
        page = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        got, want = tdet.detect_bubble_mask(page), jdet.detect_bubble_mask(page)
        assert got.shape == hw and got.dtype == np.uint8
        # the port's map before its threshold, as JAX's detector computes it
        near = np.abs(tdet.page_probabilities(page) - 0.5) <= MASK_EPS
        near_total += int(near.sum())
        differ += int((got != want).sum())
        pixels += near.size
        assert not ((got != want) & ~near).any()
    print(f"{differ} of {pixels} mask pixels differ; {near_total} lie within {MASK_EPS:.4f} of "
          f"the threshold")


def test_bubble_detector_from_onnx_checkpoint(unet_path):
    tdet = tdetect.BubbleDetector.from_checkpoint(unet_path, device="cpu")
    jdet = jdetect.BubbleDetector.from_checkpoint(unet_path)
    assert isinstance(tdet, tdetect.OnnxWrappedDetector)
    assert tdet._onnx.device.type == "cpu"
    pages = [np.full((64, 48, 3), 255, np.uint8),
             np.random.default_rng(2).integers(0, 256, (64, 48, 3), dtype=np.uint8)]
    pages[0][10:40, 8:30] = 0
    for got, want in zip(tdet.detect_bubble_masks(pages), jdet.detect_bubble_masks(pages)):
        np.testing.assert_array_equal(got, want)
    got, want = tdet.detect_pages(pages), jdet.detect_pages(pages)
    assert [len(d) for d in got] == [len(d) for d in want]
    assert tdet.detect_bubble_mask(pages[0]).shape == (64, 48)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdetect.BubbleDetector.from_checkpoint(unet_path)  # the default device is "cuda"
