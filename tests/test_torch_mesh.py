"""Data-parallel serving in the port (``parallel/mesh.py``, ``mesh=`` on the
engine, ``BubbleDetector``, ``LamaInpainter`` and ``TorchLatinEngine``) on an
8-way virtual CPU mesh, and the kernels' device guard (``build.call``).

The sharded ``TorchMangaOcrEngine`` must return the single-device port
engine's strings and JAX's single-device ``TpuMangaOcrEngine``'s, for 5
crops, 3 crops (the padding case) and a three-bucket page, in the int8
serving configuration and on the reference path (``serving_kernels=False``);
the tolerance is string equality.  The secondary models take 9 same-shape
inputs (split across the mesh) and 1 odd-shape input (the single-device
path): equal to the single-device output (LaMa within the host bound of
``tests/test_torch_inpaint.py``).  Weights are made from numpy seeds and
carried across with ``params_from_jax``."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.engine import TpuMangaOcrEngine
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.engine.engine import HostCopy
from manga_ocr_tpu_torch.kernels import build, launch
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer as PortTokenizer
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_LEN = 12
N_DATA = 8
# LaMa's uint8 output: hole pixels one level apart on at most this share
# (the host bound of tests/test_torch_inpaint.py, HOLE_SHARE)
HOLE_SHARE = 0.005


def _crop(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_mesh(N_DATA, devices=[torch.device("cpu")] * N_DATA)


@pytest.fixture(scope="module")
def engines(mesh):
    """``engines(**kw)``: JAX's single-device engine, the port's
    single-device engine and the port's sharded engine on the same std-0.1
    weights, built once per configuration in this module."""
    built = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in built:
            cfg = MangaOCRConfig.tiny()
            np_params = init_params_numpy(cfg, 0, std=0.1)
            jax_engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(),
                                           max_length=MAX_LEN, dtype=jnp.float32, **kw)
            port = [TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                                        PortTokenizer.synthetic(), max_length=MAX_LEN,
                                        dtype=torch.float32, device="cpu", mesh=m, **kw)
                    for m in (None, mesh)]
            built[key] = (jax_engine, *port)
        return built[key]

    return get


PAGES = {
    "5_crops": [_crop(40, 60, i) for i in range(5)],
    "3_crops": [_crop(30, 30, 10 + i) for i in range(3)],
    "3_buckets": [_crop(40, 60, 20), _crop(300, 90, 21), _crop(100, 400, 22),
                  _crop(44, 52, 23)],
}
CONFIGS = {"int8_serving": {}, "reference": {"serving_kernels": False}}


@pytest.mark.parametrize("page", list(PAGES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_engine_equals_single_device_and_jax(engines, config, page):
    jax_engine, single, sharded = engines(**CONFIGS[config])
    crops = PAGES[page]
    want = single.ocr_page(crops)
    assert sharded.ocr_page(crops) == want
    assert jax_engine.ocr_page(crops) == want
    assert len(set(want)) > 1  # texts depend on the crop


def test_dispatch_launches_every_shard_before_readback(engines):
    """``_dispatch_page`` returns, per bucket, one output per data device,
    each a ``HostCopy`` started at dispatch and not waited on (a one-bucket
    page: ``fused`` is None); the 3-crop bucket is padded to 8 rows by
    repeating its last crop."""
    _, _, sharded = engines()
    outs, fused = sharded._dispatch_page(PAGES["3_crops"], 1, None)
    assert len(outs) == 1 and fused is None
    b, shards = outs[0]
    assert b.valid == 3 and len(shards) == N_DATA
    assert all(isinstance(s, HostCopy) and s.shape == (1, MAX_LEN + 1) for s in shards)
    rows = np.concatenate([s.numpy() for s in shards])
    # rows 3..7 decode the repeated last crop
    assert all((r == rows[2]).all() for r in rows[3:])
    assert sharded._collect_page((outs, fused), None) == sharded.ocr_page(PAGES["3_crops"])


def test_params_replicated_once_per_data_device(engines, mesh):
    _, single, sharded = engines()
    assert sharded.device == torch.device("cpu") and sharded.mesh is mesh
    assert len(sharded._replicas) == N_DATA
    leaf = sharded.params["decoder"]["tok_embed"]
    # a virtual mesh repeats one device: every replica shares the leaves
    assert all(r["decoder"]["tok_embed"] is leaf for r in sharded._replicas)
    assert torch.equal(leaf, single.params["decoder"]["tok_embed"])


def test_streamed_pages_and_perform_ocr_on_the_mesh(engines):
    _, single, sharded = engines()
    pages = [PAGES["5_crops"], [], PAGES["3_buckets"]]
    assert sharded.ocr_pages(pages, lookahead=2) == [single.ocr_page(p) for p in pages]
    settings = {"orientation": "Vertical"}
    crop = PAGES["3_crops"][0]
    assert sharded.perform_ocr(crop, settings) == single.perform_ocr(crop, settings)


def test_warmup_rounds_batches_to_the_mesh_multiple(engines):
    _, _, sharded = engines()
    sharded._warmed.clear()
    sharded.warmup(bucket_hws=[(128, 128)], batch_sizes=[3, 7, 8])
    assert sharded._warmed == {((128, 128), 8)}


@pytest.fixture(scope="module")
def tp_texts():
    """Each page's strings from the port's single-device reference engine and
    from JAX's tensor-parallel engine (``serving_kernels=False`` on its
    (4, 2) mesh, as ``__graft_entry__.dryrun_multichip`` runs it)."""
    from manga_ocr_tpu.parallel import mesh as jmesh

    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, 0, std=0.1)
    jax_tp = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), max_length=MAX_LEN,
                               dtype=jnp.float32, mesh=jmesh.make_mesh(4, 2),
                               serving_kernels=False)
    single = TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                                 PortTokenizer.synthetic(), max_length=MAX_LEN,
                                 dtype=torch.float32, device="cpu", serving_kernels=False)
    return {name: (single.ocr_page(crops), jax_tp.ocr_page(crops))
            for name, crops in PAGES.items()}


@pytest.mark.parametrize("serving_kernels, match", [
    (True, "data-parallel"), (False, None), (None, None)])
def test_model_axis_above_one_raises(serving_kernels, match, tp_texts):
    """On a (4, 2) mesh the serving kernels raise (they hold whole weights,
    as in the JAX engine); ``serving_kernels=False`` and the default serve
    tensor-parallel on the plain route: every page's strings equal the
    single-device reference engine's and JAX's tensor-parallel engine's."""
    cfg = port_config(MangaOCRConfig.tiny())
    mesh = meshlib.make_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    params = params_from_jax(init_params_numpy(MangaOCRConfig.tiny(), 0, std=0.1), "cpu")
    kw = dict(max_length=MAX_LEN, dtype=torch.float32, device="cpu", mesh=mesh,
              serving_kernels=serving_kernels)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            TorchMangaOcrEngine(params, cfg, PortTokenizer.synthetic(), **kw)
        return
    engine = TorchMangaOcrEngine(params, cfg, PortTokenizer.synthetic(), **kw)
    assert engine.cfg == cfg and len(engine._replicas) == 4
    assert all(len(cols) == 2 for cols in engine._replicas)
    for name, crops in PAGES.items():
        want, jax_want = tp_texts[name]
        assert engine.ocr_page(crops) == want == jax_want, name
    assert len(set(tp_texts["5_crops"][0])) > 1


def test_a_mesh_of_another_device_type_raises(mesh):
    """No fallback that hides the device: a CPU mesh under a CUDA request
    (and a CUDA mesh under a CPU request) raises before anything runs."""
    from manga_ocr_tpu_torch.detect.detector import BubbleDetector

    cfg = port_config(MangaOCRConfig.tiny())
    with pytest.raises(ValueError, match="mesh devices"):
        TorchMangaOcrEngine({}, cfg, PortTokenizer.synthetic(), device="cuda", mesh=mesh)
    cuda_mesh = meshlib.make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="mesh devices"):
        BubbleDetector(None, device="cpu", mesh=cuda_mesh)


def test_make_mesh_shapes_and_refusals():
    cpus = [torch.device("cpu")] * 8
    m = meshlib.make_mesh(devices=cpus)
    assert m.shape == {"data": 8, "model": 1} and meshlib.dp_size(m) == 8
    assert meshlib.make_mesh(2, 2, devices=cpus).devices.shape == (2, 2)
    assert meshlib.make_mesh(2, devices=["cpu", "cpu"]).data_devices == cpus[:2]
    with pytest.raises(ValueError, match="positive device count"):
        meshlib.make_mesh(0, devices=cpus)
    with pytest.raises(ValueError, match=r'needs 16 devices but only 8.*torch.device\("cpu"\)\] \* 16'):
        meshlib.make_mesh(16, devices=cpus)
    if not torch.cuda.is_available():  # no CUDA: no device is visible, never the CPU
        with pytest.raises(ValueError, match="only 0 are visible"):
            meshlib.make_mesh(2)


def test_shard_replicate_gather(mesh):
    arr = np.arange(9 * 3, dtype=np.int32).reshape(9, 3)
    shards = meshlib.dp_shard_batch(arr, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * N_DATA
    assert (shards[-1].numpy()[1:] == 0).all()  # zero padding
    np.testing.assert_array_equal(meshlib.dp_gather(shards, 9), arr)
    tree = {"w": torch.ones(2), "layers": [torch.zeros(1), (torch.ones(1),)]}
    repl = meshlib.dp_replicate(tree, mesh)
    assert len(repl) == N_DATA and repl[3]["layers"][1][0] is tree["layers"][1][0]


@pytest.mark.parametrize("n, cap, n_data, want", [
    (9, 4, 0, [(0, 4), (4, 8), (8, 12)]), (9, 4, 8, [(0, 32)]), (9, 1, 8, [(0, 8), (8, 9)]),
    (3, 2, 8, [(0, 2), (2, 4)]), (20, 2, 8, [(0, 16), (16, 18), (18, 20)]), (0, 4, 8, [])],
    ids=str)
def test_dispatch_slices_and_splits(n, cap, n_data, want):
    """At most ``cap`` items a device a dispatch; a remainder below one item
    a data device goes to the first device alone."""
    mesh = meshlib.make_mesh(n_data, devices=["cpu"] * n_data) if n_data else None
    got = meshlib.dispatch_slices(n, cap, mesh)
    assert [(s.start, s.stop) for s in got] == want
    assert [meshlib.splits(mesh, len(range(n)[s])) for s in got] == [
        bool(n_data) and len(range(n)[s]) >= n_data for s in got]


# -- the secondary models -----------------------------------------------------------


def _counting(monkeypatch, module, name):
    """Record the leading dim of each batch ``module.name`` is called on."""
    calls = []
    fn = getattr(module, name)

    def wrapped(params, batch, *args, **kwargs):
        calls.append(batch.shape[0])
        return fn(params, batch, *args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_bubble_detector_on_the_mesh(mesh, monkeypatch):
    from manga_ocr_tpu_torch.detect import detector as tdetect
    from manga_ocr_tpu_torch.models import detector as seg

    cfg = seg.DetectorConfig(input_size=32, base_channels=4, depth=2)
    params = seg.params_from_jax(seg.init_params_numpy(cfg, 0))
    rng = np.random.default_rng(0)
    pages = [rng.integers(0, 256, size=(40, 56, 3)).astype(np.uint8) for _ in range(9)]
    pages.append(rng.integers(0, 256, size=(48, 48, 3)).astype(np.uint8))
    single = tdetect.BubbleDetector(params, cfg, device="cpu").detect_bubble_masks(pages)
    det = tdetect.BubbleDetector(params, cfg, device="cpu", mesh=mesh)
    calls = _counting(monkeypatch, seg, "segment_pages")
    sharded = det.detect_bubble_masks(pages)
    assert det._params_repl is not None and len(det._params_repl) == N_DATA
    # 9 pages padded to 16: 2 a device in one dispatch each; the odd page alone
    assert calls == [2] * N_DATA + [1]
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(a, b)
    assert any(m.any() for m in single) and any((m == 0).any() for m in single)


def test_onnx_detector_ignores_the_mesh_with_a_note(mesh, tmp_path, capsys):
    from manga_ocr_tpu_torch.detect import detector as tdetect
    from manga_ocr_tpu_torch.models import convert_onnx as conv
    from manga_ocr_tpu_torch.models import detector as seg
    from manga_ocr_tpu_torch.models import onnx_lite

    cfg = seg.DetectorConfig(input_size=32, base_channels=4, depth=2)
    path = str(tmp_path / "bubbles.onnx")
    onnx_lite.save_model(conv.unet_graph(seg.params_from_jax(seg.init_params_numpy(cfg, 0)),
                                         cfg), path)
    det = tdetect.BubbleDetector.from_checkpoint(path, mesh=mesh, device="cpu")
    assert "mesh ignored for .onnx" in capsys.readouterr().err
    page = np.random.default_rng(3).integers(0, 256, size=(40, 56, 3)).astype(np.uint8)
    plain = tdetect.BubbleDetector.from_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(det.detect_bubble_mask(page), plain.detect_bubble_mask(page))


def test_lama_inpainter_on_the_mesh(mesh, monkeypatch):
    from manga_ocr_tpu_torch.models import inpaint as tip

    cfg = tip.InpaintConfig(base_channels=4, num_blocks=1, downsamples=2, max_features=16)
    params = tip.params_from_jax(tip.init_params_numpy(cfg, 1))
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=(24, 20, 3)).astype(np.uint8) for _ in range(9)]
    imgs.append(rng.integers(0, 256, size=(20, 28, 3)).astype(np.uint8))
    msks = [(rng.random(im.shape[:2]) > 0.8).astype(np.uint8) * 255 for im in imgs]
    plain = tip.LamaInpainter(params, cfg, device="cpu")
    shard = tip.LamaInpainter(params, cfg, device="cpu", mesh=mesh)
    np.testing.assert_array_equal(shard(imgs[0], msks[0]), plain(imgs[0], msks[0]))
    assert shard._params_repl is None  # one region is never split
    calls = _counting(monkeypatch, tip, "inpaint_batch")
    got = shard.inpaint_many(imgs, msks)
    assert shard._params_repl is not None and len(shard._params_repl) == N_DATA
    assert sorted(calls) == [1] + [2] * N_DATA  # the odd shape alone, then 16 rows split
    for a, b, im, m in zip(plain.inpaint_many(imgs, msks), got, imgs, msks):
        assert b.shape == im.shape
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= HOLE_SHARE
        np.testing.assert_array_equal(b[m == 0], im[m == 0])  # known pixels pass through


def test_lama_dispatch_cap_per_device(mesh, monkeypatch):
    """``DISPATCH_PIXELS`` holds per device: a cap of one region a device
    splits 9 regions into 8 (one a device) and the remainder of 1 alone."""
    from manga_ocr_tpu_torch.models import inpaint as tip

    cfg = tip.InpaintConfig(base_channels=4, num_blocks=1, downsamples=2, max_features=16)
    params = tip.params_from_jax(tip.init_params_numpy(cfg, 1))
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, size=(16, 16, 3)).astype(np.uint8) for _ in range(9)]
    msks = [np.full((16, 16), 255, np.uint8)] * 9
    monkeypatch.setattr(tip, "DISPATCH_PIXELS", 16 * 16)
    calls = _counting(monkeypatch, tip, "inpaint_batch")
    got = tip.LamaInpainter(params, cfg, device="cpu", mesh=mesh).inpaint_many(imgs, msks)
    assert calls == [1] * N_DATA + [1]
    want = tip.LamaInpainter(params, cfg, device="cpu").inpaint_many(imgs, msks)
    for a, b in zip(want, got):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_latin_engine_on_the_mesh(mesh, monkeypatch):
    from manga_ocr_tpu_torch.engine import latin as tlatin
    from manga_ocr_tpu_torch.models import craft as tcraft
    from manga_ocr_tpu_torch.models import crnn as tcrnn

    charset = "abc"
    craft_cfg = tcraft.CraftConfig(vgg_channels=(4, 8, 16, 32, 32, 64), head_channels=8)
    crnn_cfg = tcrnn.CrnnConfig(num_classes=len(charset) + 1, output_channel=32, hidden_size=16)
    craft_p = tcraft.params_from_jax(tcraft.init_craft_params_numpy(craft_cfg, 0))
    crnn_p = tcrnn.params_from_jax(tcrnn.init_crnn_params_numpy(crnn_cfg, 0))
    kw = dict(charset=charset, craft_cfg=craft_cfg, crnn_cfg=crnn_cfg, det_buckets=(64,),
              rec_width_buckets=(32, 64), device="cpu")
    plain = tlatin.TorchLatinEngine(craft_p, crnn_p, **kw)
    shard = tlatin.TorchLatinEngine(craft_p, crnn_p, mesh=mesh, **kw)
    rng = np.random.default_rng(2)
    pages = np.stack([rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
                      for _ in range(9)])
    calls = _counting(monkeypatch, tcraft, "detect_maps")
    for a, b in zip(plain.detect_maps(pages), shard.detect_maps(pages)):
        np.testing.assert_array_equal(a, b)
    assert calls == [9] + [2] * N_DATA  # the plain engine's one call, then the shards
    repl = shard._craft_repl
    assert repl[0] is shard.craft_params and len(repl[1]) == N_DATA
    shard.detect_maps(pages)
    assert shard._craft_repl is repl  # cached per raw tree
    images = [p[:50, :60] for p in pages]
    assert plain.detect_boxes_batch(images) == shard.detect_boxes_batch(images)
    calls.clear()
    assert plain.detect_boxes(images[0]) == shard.detect_boxes(images[0])
    assert calls == [1, 1]  # one page: the single-device path on both
    crops = [rng.integers(0, 256, size=(14, 28 + 2 * i)).astype(np.uint8) for i in range(9)]
    crops.append(rng.integers(0, 256, size=(14, 100)).astype(np.uint8))  # the odd width
    batch = np.random.default_rng(4).normal(size=(9, 32, 64, 1)).astype(np.float32)
    np.testing.assert_array_equal(plain.recognize_logits(batch), shard.recognize_logits(batch))
    assert len(shard._crnn_repl[1]) == N_DATA
    assert plain.recognize_lines(crops) == shard.recognize_lines(crops)


# -- the kernels' device guard ----------------------------------------------------------


class _FakeCuda:
    """Stands in for the CUDA runtime: ``torch.cuda.device`` makes a device
    current (and restores the last on exit), ``current_stream`` names one
    stream per device, and the library records the current device and the
    stream at each call."""

    def __init__(self, monkeypatch):
        self.current = "cuda:0"
        self.calls = []
        self.switches = 0
        fake = self

        class Device:
            def __init__(self, device):
                self.device = str(device)

            def __enter__(self):
                fake.switches += 1
                self.prev, fake.current = fake.current, self.device

            def __exit__(self, *exc):
                fake.current = self.prev

        class Stream:
            def __init__(self, device):
                self.cuda_stream = f"stream of {device}"

        class Lib:
            def __getattr__(self, name):
                def entry(*args):
                    fake.calls.append((name, fake.current, args[-1]))
                    if name == "mocr_decode_loop_blocks_per_sm":
                        args[-1]._obj.value = 1  # ctypes.byref(out)
                    return 0
                return entry

        monkeypatch.setattr(torch.cuda, "device", Device)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: int(fake.current[5:]))
        monkeypatch.setattr(torch.cuda, "current_stream", Stream)
        monkeypatch.setattr(build, "load", lambda: Lib())


def test_build_call_makes_the_tensors_device_current(monkeypatch):
    fake = _FakeCuda(monkeypatch)
    build.call(torch.device("cuda", 1), "x", "mocr_ln_rows_bf16", 1, 2)
    build.call(torch.device("cuda", 1), "x", "mocr_decode_loop_blocks_per_sm",
               ctypes.byref(ctypes.c_int(0)), stream=False)
    assert fake.calls[0] == ("mocr_ln_rows_bf16", "cuda:1", "stream of cuda:1")
    assert fake.calls[1][:2] == ("mocr_decode_loop_blocks_per_sm", "cuda:1")
    assert fake.current == "cuda:0" and fake.switches == 2  # restored after each call
    build.call(torch.device("cuda", 0), "x", "mocr_ln_rows_bf16", 1, 2)
    build.call(torch.device("cuda"), "x", "mocr_ln_rows_bf16", 1, 2)
    assert [c[1] for c in fake.calls[2:]] == ["cuda:0", "cuda:0"]
    assert fake.switches == 2  # the current device is not set again


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _i8(*shape):
    return torch.zeros(shape, dtype=torch.int8)


def test_every_launcher_calls_under_its_tensors_device(monkeypatch):
    """Every C entry point of the library is reached from ``launch.py``
    through ``build.call`` with the device of its launcher's tensors
    current and that device's stream (CPU tensors, with the CUDA device
    check lifted, stand in for a card's)."""

    def expect_on_cpu(t, dtype, shape, name):
        assert t.dtype == dtype and tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(launch, "_expect", expect_on_cpu)
    monkeypatch.setattr(launch, "_BLOCKS_PER_SM", {})
    fake = _FakeCuda(monkeypatch)
    d, b, s, i32 = 64, 2, 5, torch.int32
    ln = (_f32(d) + 1, _f32(d))
    launch.ln_quant_rows(_bf(b, d), ln)
    launch.int8_gemm(_i8(b, d), _i8(8, d), _f32(b), _f32(8), _f32(8), launch.GEMM_BF16)
    launch.attention(_bf(b * s, 3 * d), b, s, 1, s, 0.125)
    launch.attention(_bf(b * s, 3 * d), b, s, 1, s, 0.125, sdpa_int8=True)
    launch.attention_packed(_bf(b, s, d), _bf(b, s, d), _bf(b, s, d), 1, s, 0.125)
    launch.attention_heads(_bf(b, 1, s, d), _bf(b, 1, s, d), _bf(b, 1, s, d), s, 0.125)
    tokens, lengths = torch.zeros((b, 3), dtype=i32), torch.zeros((b,), dtype=i32)
    launch.decode_loop([0], [0], 0.125, 1e-12, tokens, lengths)
    launch.decode_cluster([0], [0], 0.125, 1e-12, tokens, lengths)
    assert launch.decode_loop_blocks_per_sm(torch.device("cpu"), False, False, False, 1, 0) == 1
    launch.ln_rows_bf16(_bf(b, d), ln, 1e-12)
    launch.bf16_gemm(_bf(b, d), _bf(d, 8), _f32(8), launch.BF16_BIAS)
    assert launch.check_gelu_erf_rcp("cpu") == 0
    weights = [_bf(1, d, 3 * d), None, _f32(1, 3 * d), _bf(1, d, d), None, _f32(1, d),
               _f32(1, d), _f32(1, d), _bf(1, d, d), None, _f32(1, d), _bf(1, d, d), None,
               _f32(1, d), _f32(1, d), _f32(1, d)]
    launch.encoder_layers(_bf(b, s, d), weights, 0, 1, False,
                          launch.encoder_scratch(b * s, d, d, False, "cpu"), 1, 1e-12, 0.125,
                          False)
    launch.fused_head(_bf(b, d), _bf(d, d), _f32(d), *ln, _bf(d, 64), _f32(64), 1e-12)
    launch.self_attn_step(_f32(b, 3 * d), _bf(4, b, d), _bf(4, b, d), 1, 0, 0.125, torch.float32)
    launch.cross_attn_step(_f32(b, d), _bf(b, s, d), _bf(b, s, d), None, None, 1, s, 0.125,
                           torch.float32)
    assert {name for name, _, _ in fake.calls} == set(build._SIGNATURES)
    for name, current, last in fake.calls:
        assert current == "cpu", name
        if name != "mocr_decode_loop_blocks_per_sm":
            assert last == "stream of cpu", name
