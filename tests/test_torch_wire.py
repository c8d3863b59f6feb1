"""The engine's wire formats and page coalescing in the port against the JAX
package: the packed wire's host prep (``native.prep_gray_packed``,
``batching.prep_page_packed``) byte for byte, ``unpack_packed_page`` byte
for byte against JAX's and against ``prep_page_gray``'s batch, the fused
wire's int32 extents read back from its bytes, and the engines with
``wire="gray"|"packed"`` and ``coalesce=True|False``: strings identical to
JAX's engine in the same setting (``ocr_page``, ``ocr_pages``,
``ocr_page_dual``) on a page of three buckets, ``_dispatch_page``'s
``(outs, fused)``, one "h2d" stage a transfer and one "readback" a copy
waited on (``StageTimer``), the coalesced readback on a 2-way virtual CPU
mesh, and the constructor's refusals.  Weights are made with numpy (std
0.1, so the texts differ from crop to crop); the tolerance is equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu import native as jnative
from manga_ocr_tpu.engine import TpuMangaOcrEngine
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer
from manga_ocr_tpu.ops import preprocess as jpp
from manga_ocr_tpu.parallel import batching as jbatch
from manga_ocr_tpu_torch import native
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.engine import engine as tengine
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer as PortTokenizer
from manga_ocr_tpu_torch.ops import preprocess as tpp
from manga_ocr_tpu_torch.parallel import batching as tbatch
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from manga_ocr_tpu_torch.utils.metrics import StageTimer
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_LEN = 8
SETTINGS = {
    "gray_coalesce": {"wire": "gray", "coalesce": True},
    "gray_per_bucket": {"wire": "gray", "coalesce": False},
    "packed_coalesce": {"wire": "packed", "coalesce": True},
    "packed_per_bucket": {"wire": "packed", "coalesce": False},
}


def _crop(h, w, seed, ch=3):
    shape = (h, w) if ch == 0 else (h, w, ch)
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


# three buckets under Vertical (128x128, 256x128, 512x256: a wide crop turns
# tall), a 2-D and a [h, w, 1] crop; OVERSIZED fits no bucket (downscaled on
# the host)
PAGE = [_crop(40, 60, 1), _crop(200, 90, 2), _crop(100, 400, 3), _crop(50, 45, 4, ch=0),
        _crop(45, 50, 5, ch=1), _crop(30, 30, 6)]
OVERSIZED = _crop(1400, 700, 7)
DEGENERATE = [np.zeros((0, 50, 3), np.uint8), np.zeros((50, 0, 3), np.uint8),
              np.full((40, 40, 3), 77, np.uint8)]


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.load() is not None, "the port's native prep library did not build"
    assert jnative.load() is not None, "the JAX package's native prep library did not build"


@pytest.mark.parametrize("crops", ["page", "oversized", "degenerate"])
@pytest.mark.parametrize("orientation", [0, 1, 2], ids=["auto", "vertical", "horizontal"])
def test_prep_page_packed_byte_identical_to_jax(orientation, crops):
    crops = {"page": PAGE, "oversized": PAGE + [OVERSIZED], "degenerate": DEGENERATE}[crops]
    want = jbatch.prep_page_packed(crops, orientation)
    got = tbatch.prep_page_packed(crops, orientation)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert isinstance(g, tbatch.PackedBatch) and isinstance(w, jbatch.PackedBatch)
        assert (g.bucket_hw, g.indices, g.valid) == (w.bucket_hw, w.indices, w.valid)
        for field in ("flat", "offsets", "sizes"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rot", [0, 1, 2])
def test_native_prep_gray_packed_matches_jax(rot):
    crops = [_crop(20, 30, 10), _crop(30, 20, 11, ch=0), _crop(25, 25, 12)]
    heights = [c.shape[1] if rot else c.shape[0] for c in crops]
    offsets = np.cumsum([0] + heights[:-1]).astype(np.int64)
    rots = np.full(len(crops), rot, np.int32)
    want = np.full((sum(heights) + 3, 64), 9, np.uint8)
    got = want.copy()
    assert jnative.prep_gray_packed(crops, rots, offsets, want)
    assert native.prep_gray_packed(crops, rots, offsets, got)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="past"):
        native.prep_gray_packed(crops, rots, offsets + 4, got)


@pytest.mark.parametrize("crops", ["page", "degenerate"])
@pytest.mark.parametrize("orientation", [0, 1, 2], ids=["auto", "vertical", "horizontal"])
def test_unpack_packed_page_equals_jax_and_the_gray_batch(orientation, crops):
    crops = PAGE + [OVERSIZED] if crops == "page" else DEGENERATE
    packed = tbatch.prep_page_packed(crops, orientation)
    gray = tbatch.prep_page_gray(crops, orientation)
    assert len(packed) == len(gray)
    for pb, gb in zip(packed, gray):
        assert pb.flat.size < gb.crops.size  # the height padding stays off the wire
        meta = np.concatenate([pb.sizes, pb.offsets[:, None]], axis=1)
        got, got_sizes = tpp.unpack_packed_page(torch.from_numpy(pb.flat),
                                                torch.from_numpy(meta), *pb.bucket_hw)
        want, want_sizes = jpp.unpack_packed_page(jnp.asarray(pb.flat), jnp.asarray(meta),
                                                  bh=pb.bucket_hw[0], bw=pb.bucket_hw[1])
        assert got.dtype == torch.uint8 and got_sizes.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), gb.crops)
        np.testing.assert_array_equal(got_sizes.numpy(), np.asarray(want_sizes))
        np.testing.assert_array_equal(got_sizes.numpy(), gb.sizes)
        assert (pb.indices, pb.valid) == (gb.indices, gb.valid)


def test_fused_wire_int32_extents_round_trip():
    sizes = np.array([[40, 60], [300, 90], [65535, 1], [0, 2**31 - 1]], np.int32)
    crops = _crop(4, 8, 20, ch=0)  # 32 bytes: the extents start on a multiple of 4
    buf = torch.from_numpy(np.concatenate([crops.reshape(-1), sizes.view(np.uint8).reshape(-1)]))
    back = tengine._int32_rows(buf[32:], len(sizes))
    assert back.dtype == torch.int32 and back.data_ptr() == buf[32:].data_ptr()  # a view
    np.testing.assert_array_equal(back.numpy(), sizes)
    with pytest.raises(ValueError, match="multiple of 4"):
        tengine._int32_rows(buf[31:31 + 8], 1)


@pytest.fixture(scope="module")
def engines():
    """``engines(setting, config)``: JAX's engine and the port's on the same
    std-0.1 weights in one wire/coalesce setting, in the int8 serving
    configuration ("serving") or on the exact reference path ("reference",
    ``serving_kernels=False``: what the JAX parity runs, its engine
    compiling in seconds where the interpreted serving kernels take
    tens), built once per (setting, config) in this module."""
    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, 0, std=0.1)
    built = {}

    def get(setting, config="serving"):
        key = (setting, config)
        if key not in built:
            kw = dict(SETTINGS[setting], serving_kernels=config == "serving")
            built[key] = (
                TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), max_length=MAX_LEN,
                                  dtype=jnp.float32, **kw),
                TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                                    PortTokenizer.synthetic(), max_length=MAX_LEN,
                                    dtype=torch.float32, device="cpu", **kw),
            )
        return built[key]

    return get


PAGES = [PAGE, [], PAGE[:2], PAGE[2:]]
# the dual pass's page (Auto-Detect: no turn) in two of PAGE's buckets, so
# the JAX engine reuses the programs PAGE compiled
DUAL = PAGE[:2] + PAGE[3:4]


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_engine_strings_identical_to_jax_in_each_setting(engines, setting):
    """``ocr_page``, ``ocr_pages`` (lookahead 0 and 2) and ``ocr_page_dual``
    on the reference path, against JAX's engine in the same setting."""
    jax_engine, port = engines(setting, "reference")
    assert len(tbatch.prep_page_gray(PAGE, 1)) == 3
    want = jax_engine.ocr_page(PAGE)
    assert port.ocr_page(PAGE) == want
    assert len(set(want)) > 3  # texts depend on the crop
    want_pages = [jax_engine.ocr_page(p) for p in PAGES]
    assert port.ocr_pages(PAGES, lookahead=0) == want_pages
    assert port.ocr_pages(PAGES, lookahead=2) == want_pages
    assert port.ocr_page_dual(DUAL) == jax_engine.ocr_page_dual(DUAL)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_serving_engine_strings_equal_across_settings(engines, setting):
    """The int8 serving engine: every setting returns the gray, coalesced
    engine's strings (``tests/test_torch_engine.py`` holds that one to
    JAX's), for each entry point."""
    port, base = engines(setting)[1], engines("gray_coalesce")[1]
    want = base.ocr_page(PAGE)
    assert port.ocr_page(PAGE) == want and len(set(want)) > 3
    want_pages = [base.ocr_page(p) for p in PAGES]
    assert port.ocr_pages(PAGES, lookahead=0) == want_pages
    assert port.ocr_pages(PAGES, lookahead=2) == want_pages
    assert port.ocr_page_dual(DUAL) == base.ocr_page_dual(DUAL)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_dispatch_page_returns_fused_on_multi_bucket_pages(engines, setting):
    _, port = engines(setting)
    outs, fused = port._dispatch_page(PAGE, 1, None)
    assert len(outs) == 3
    if SETTINGS[setting]["coalesce"]:
        assert len(fused) == 1 and isinstance(fused[0], tengine.HostCopy)
        assert fused[0].shape == (sum(shards[0].shape[0] for _, shards in outs), MAX_LEN + 1)
    else:
        assert fused is None
        assert all(isinstance(c, tengine.HostCopy) for _, copies in outs for c in copies)
    assert port._collect_page((outs, fused), None) == port.ocr_page(PAGE)
    outs, fused = port._dispatch_page(PAGE[:1] + PAGE[5:], 1, None)
    assert len(outs) == 1 and fused is None
    packed = SETTINGS[setting]["wire"] == "packed"
    want_type = tbatch.PackedBatch if packed else tbatch.BucketedBatch
    assert isinstance(outs[0][0], want_type)


# transfers and readbacks of the three-bucket page: (h2d, readback)
DESIGN = {"gray_coalesce": (1, 1), "gray_per_bucket": (6, 3), "packed_coalesce": (6, 1),
          "packed_per_bucket": (6, 3)}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_transfer_and_readback_counts_are_the_design(engines, setting):
    _, port = engines(setting)
    timer = StageTimer()
    texts = port.ocr_page(PAGE, timer=timer)
    s = timer.summary()
    assert (s["h2d"]["count"], s["readback"]["count"]) == DESIGN[setting]
    assert s["detok"]["count"] == 3 and {"host_prep", "dispatch"} <= s.keys()
    assert texts == port.ocr_page(PAGE)
    timer = StageTimer()
    port.ocr_page(PAGE[:1], timer=timer)  # one bucket: two transfers, one readback
    assert (timer.summary()["h2d"]["count"], timer.summary()["readback"]["count"]) == (2, 1)


def test_packed_wire_falls_back_to_gray_batches_without_the_library(engines, monkeypatch):
    _, port = engines("packed_coalesce")
    want = port.ocr_page(PAGE)
    monkeypatch.setattr(native, "load", lambda: None)
    batches = tbatch.prep_page_packed(PAGE, 1)
    assert all(isinstance(b, tbatch.BucketedBatch) for b in batches)
    for g, w in zip(batches, jbatch.prep_page_gray(PAGE, 1)):
        np.testing.assert_array_equal(g.crops, w.crops)
    timer = StageTimer()
    assert port.ocr_page(PAGE, timer=timer) == want
    assert timer.summary()["h2d"]["count"] == 1  # gray batches take the fused wire


def test_coalesced_readback_on_a_virtual_mesh_equals_one_device(engines):
    _, port = engines("gray_coalesce")
    mesh = meshlib.make_mesh(2, devices=[torch.device("cpu")] * 2)
    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, 0, std=0.1)
    sharded = {c: TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                                      PortTokenizer.synthetic(), max_length=MAX_LEN,
                                      dtype=torch.float32, device="cpu", mesh=mesh, coalesce=c)
               for c in (True, False)}
    want = port.ocr_page(PAGE)
    outs, fused = sharded[True]._dispatch_page(PAGE, 1, None)
    assert len(outs) == 3 and len(fused) == 2  # one readback a data device
    assert all(len(shards) == 2 for _, shards in outs)
    assert sharded[True]._collect_page((outs, fused), None) == want
    timer = StageTimer()
    assert sharded[False].ocr_page(PAGE, timer=timer) == want
    # the wire stays per bucket and per shard under a mesh
    assert (timer.summary()["h2d"]["count"], timer.summary()["readback"]["count"]) == (12, 6)
    timer = StageTimer()
    assert sharded[True].ocr_page(PAGE, timer=timer) == want
    assert (timer.summary()["h2d"]["count"], timer.summary()["readback"]["count"]) == (12, 2)
    assert sharded[True].ocr_pages([PAGE, PAGE[:2]], lookahead=2) == [want, want[:2]]


def test_constructor_refuses_an_unknown_wire_and_packed_under_a_mesh():
    cfg = MangaOCRConfig.tiny()
    np_params = init_params_numpy(cfg, 0, std=0.1)
    mesh = meshlib.make_mesh(2, devices=[torch.device("cpu")] * 2)
    messages = []
    for kw in ({"wire": "rgb"}, {"wire": "packed", "mesh": mesh}):
        with pytest.raises(ValueError) as e:
            TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                                PortTokenizer.synthetic(), device="cpu", **kw)
        messages.append(str(e.value))
    from manga_ocr_tpu.parallel import mesh as jmesh

    for kw, message in zip(({"wire": "rgb"},
                            {"wire": "packed", "mesh": jmesh.make_mesh(n_data=2, n_model=1)}),
                           messages):
        with pytest.raises(ValueError) as e:
            TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), **kw)
        assert str(e.value) == message
    assert messages[0] == "wire must be 'gray' or 'packed', got 'rgb'"
