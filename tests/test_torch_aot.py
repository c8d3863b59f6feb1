"""The engine's compile-once dispatches (``TorchMangaOcrEngine(aot=...)``,
``engine/graphs.py``) against the JAX engine's AOT executable store.

- ``aot`` follows JAX's rule (on for one device, off under ``mesh=``) and is
  off on the CPU, where the port has no graphs, and for every decode but
  kernel C's loop (``graphs_apply``: the step-by-step decode reads its
  "done" flags on the host);
- ``serve.parser()`` takes ``--no-aot``, and ``serve.build_engine`` and the
  ``ocr`` command pass ``aot`` as JAX's ``cli._build_engine`` does;
- with ``aot=True`` on both (JAX's store in a temporary directory through
  ``MANGA_OCR_TPU_AOT_DIR``), the port's engine reads JAX's strings and
  counts JAX's ``COMPILE_EVENTS`` over one mixed page sequence, cold and after
  ``warmup(..., full=True)`` (as ``tests/test_engine.py``'s compile coverage);
- the static-buffer protocol of ``graphs.BucketGraphs`` (static inputs
  copied into, one static output a shape, a fresh copy out) on the CPU,
  through ``StandInGraphs`` below, whose replay runs the program on the
  static inputs into the static output in place: over shapes dispatched in
  the order opposite to their capture, both wires, ``coalesce`` on and off
  and ``ocr_pages(lookahead=2)``, the rows are the eager engine's; a shape
  outside the warmed set is captured at its first dispatch, from the
  lookahead thread, and counted; a failed capture or replay raises; an
  engine with graphs is freed by reference counting alone (its graphs hold
  no reference back to it).
"""

import dataclasses
import gc
import glob
import os
import threading
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu import cli as jcli
from manga_ocr_tpu.engine import TpuMangaOcrEngine
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer
from manga_ocr_tpu.parallel import mesh as jmesh
from manga_ocr_tpu.utils.metrics import COMPILE_EVENTS as JAX_EVENTS
from manga_ocr_tpu_torch import cli as tcli
from manga_ocr_tpu_torch import serve as tsrv
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine, graphs
from manga_ocr_tpu_torch.models import convert as tconv
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer as PortTokenizer
from manga_ocr_tpu_torch.parallel import mesh as tmesh
from manga_ocr_tpu_torch.utils.metrics import COMPILE_EVENTS as PORT_EVENTS
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "eval")
MAX_LEN = 10
BUCKETS = ((128, 128), (256, 128))
BATCHES = (8, 16)


def _crop(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


# test_engine.py's mix (two buckets at batch 8), a single-bucket page, and
# nine crops of the small bucket (batch 16) beside one tall crop
MIX = [_crop(60, 100, 0), _crop(40, 40, 1), _crop(200, 120, 2), _crop(111, 99, 3)]
PAGES = [MIX, [_crop(50, 70, 4)], [_crop(30 + 9 * i, 90 - 5 * i, 10 + i) for i in range(9)]
         + [_crop(180, 80, 20)], MIX[::-1]]


def _tiny():
    cfg = MangaOCRConfig.tiny()
    return cfg, init_params_numpy(cfg, 0, std=0.1)


def _port_engine(np_params, cfg, **kw):
    return TorchMangaOcrEngine(params_from_jax(np_params, "cpu"), port_config(cfg),
                               PortTokenizer.synthetic(), max_length=MAX_LEN,
                               dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("aot, mesh", [(False, False), (True, False), (True, True)],
                         ids=["default", "one_device", "mesh"])
def test_aot_follows_jax_rule_and_is_off_on_the_cpu(aot, mesh):
    cfg, np_params = _tiny()
    jax_engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), max_length=MAX_LEN,
                                   dtype=jnp.float32, serving_kernels=False, aot=aot,
                                   mesh=jmesh.make_mesh(2) if mesh else None)
    port = _port_engine(np_params, cfg, serving_kernels=False, aot=aot,
                        mesh=tmesh.make_mesh(2, devices=["cpu", "cpu"]) if mesh else None)
    assert jax_engine._aot is (aot and not mesh)
    assert port._aot is False and port._graphs is None


@pytest.mark.parametrize("serving_kernels", [True, False], ids=["kernel_c_loop", "step_by_step"])
@pytest.mark.parametrize("aot, mesh, device", [
    (True, None, "cuda"), (False, None, "cuda"), (True, "mesh", "cuda"), (True, None, "cpu")],
    ids=["one_card", "no_aot", "mesh", "cpu"])
def test_graphs_apply_only_where_the_whole_decode_runs_on_one_card(serving_kernels, aot, mesh,
                                                                  device):
    """JAX's rule on one CUDA device, and only for kernel C's whole loop:
    the step-by-step decode (``serving_kernels=False``) reads its "done"
    flags on the host between chunks."""
    from manga_ocr_tpu_torch.engine.engine import graphs_apply
    from manga_ocr_tpu_torch.models.config import with_serving_kernels

    cfg = port_config(MangaOCRConfig.tiny())
    if serving_kernels:
        cfg = with_serving_kernels(cfg, quantized=True)
    want = aot and mesh is None and device == "cuda" and serving_kernels
    assert graphs_apply(aot, mesh, torch.device(device), cfg) is want


# -- the command lines --------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig as PortConfig
    from manga_ocr_tpu_torch.models.params import init_params

    cfg = dataclasses.replace(PortConfig.tiny(), max_length=12)
    path = str(tmp_path_factory.mktemp("hf_tiny"))
    tconv.save_hf_checkpoint(path, init_params(cfg, 0, "cpu", std=0.1), cfg,
                             tokenizer=PortTokenizer.synthetic())
    return path


@pytest.fixture
def built(monkeypatch, tmp_path_factory):
    """Both packages' engine classes replaced by recorders: ``built`` maps
    "port" and "jax" to the ``aot`` each builder passed."""
    monkeypatch.setenv("MANGA_OCR_TPU_XLA_CACHE", str(tmp_path_factory.getbasetemp() / "xla"))
    monkeypatch.delenv("MANGA_OCR_CHECKPOINT", raising=False)
    seen = {}

    def recorder(name):
        class Recorder:
            def __init__(self, *args, **kw):
                seen[name] = kw["aot"]

            def ocr_page(self, crops, *args, **kw):
                return [""] * len(crops)

        return Recorder

    import manga_ocr_tpu.engine
    import manga_ocr_tpu_torch.engine

    monkeypatch.setattr(manga_ocr_tpu_torch.engine, "TorchMangaOcrEngine", recorder("port"))
    monkeypatch.setattr(manga_ocr_tpu.engine, "TpuMangaOcrEngine", recorder("jax"))
    return seen


@pytest.mark.parametrize("flags, aot", [([], True), (["--no-aot"], False)],
                         ids=["serve", "serve_no_aot"])
def test_serve_no_aot_reaches_the_engine_as_in_jax(hf_dir, built, flags, aot):
    args = tsrv.parser().parse_args(["--checkpoint", hf_dir, "--device", "cpu", *flags])
    assert args.no_aot is not aot
    tsrv.build_engine(args)
    jcli._build_engine(args)
    assert built == {"port": aot, "jax": aot}


def test_ocr_command_stays_eager_as_in_jax(hf_dir, built, capsys):
    path = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))[0]
    assert tcli.main(["--checkpoint", hf_dir, "--device", "cpu", "ocr", path]) == 0
    assert jcli.main(["--checkpoint", hf_dir, "ocr", path]) == 0
    assert built == {"port": False, "jax": False}


# -- strings and compile events against JAX's AOT store -------------------------------


def _drive(engine, events, warm: bool):
    """(strings, COMPILE_EVENTS) per page of PAGES, after ``warmup(BUCKETS,
    BATCHES, full=True)`` where ``warm``."""
    if warm:
        engine.warmup(bucket_hws=BUCKETS, batch_sizes=BATCHES, full=True)
    events.reset()
    out = []
    for page in PAGES:
        out.append((engine.ocr_page(page), events.summary()))
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's engines under ``aot=True``, cold and warmed, each over PAGES
    once (their compiles shared by this module's tests)."""
    cfg, np_params = _tiny()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MANGA_OCR_TPU_AOT_DIR", str(tmp_path_factory.mktemp("aot")))
        for warm in (False, True):
            engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(),
                                       max_length=MAX_LEN, dtype=jnp.float32,
                                       serving_kernels=False, aot=True)
            assert engine._aot
            runs[warm] = _drive(engine, JAX_EVENTS, warm)
    return runs


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "full_warmup"])
def test_strings_and_compile_events_equal_jax_aot(jax_runs, warm):
    cfg, np_params = _tiny()
    port = _port_engine(np_params, cfg, serving_kernels=False, aot=True)
    got = _drive(port, PORT_EVENTS, warm)
    assert got == jax_runs[warm]
    if warm:
        assert all(events == {} for _, events in got)
    else:
        assert got[0][1] == {"unplanned_compile": 2, "unplanned:128x128@8": 1,
                             "unplanned:256x128@8": 1}
        assert got[-1][1]["unplanned_compile"] == 3
    assert len({s for strings, _ in got for s in strings}) > 3


# -- the static-buffer protocol on the CPU --------------------------------------


class StandInGraphs(graphs.BucketGraphs):
    """``BucketGraphs`` with a CPU stand-in for the CUDA graph: the capture
    runs the program once on the static inputs and keeps its rows as the
    static output; a replay runs it on the static inputs again and writes
    the rows into that output in place, as a graph's replay does."""

    def __init__(self, *args):
        super().__init__(*args)
        self.replays = 0
        self.capture_threads = []

    def _record(self, cap, program):
        self.capture_threads.append(threading.get_ident())
        cap.graph = weakref.WeakMethod(program)  # no reference to the engine, as a graph's
        cap.out = program(cap.crops, cap.ext)

    def _replay(self, cap):
        self.replays += 1
        cap.out.copy_(cap.graph()(cap.crops, cap.ext))


def _stand_in(engine):
    engine._graphs = StandInGraphs(engine.device, engine._lock)
    return engine._graphs


@pytest.fixture(scope="module")
def serving():
    """The int8 serving configuration (the kernels' plain versions) on the
    tiny config, and its eager rows and strings of every page."""
    cfg, np_params = _tiny()
    eager = _port_engine(np_params, cfg)
    pages = PAGES + [PAGES[2][::-1], [_crop(60, 60, 30)] + PAGES[1]]
    rows = [eager._page_rows(eager._dispatch_page(p, 1, None)) for p in pages]
    return cfg, np_params, pages, rows, [eager.ocr_page(p) for p in pages]


def _equal_rows(got, want):
    return len(got) == len(want) and all(
        g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("wire", ["gray", "packed"])
@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce", "per_bucket"])
def test_replays_equal_eager_in_every_wire_setting(serving, wire, coalesce):
    cfg, np_params, pages, rows, texts = serving
    engine = _port_engine(np_params, cfg, wire=wire, coalesce=coalesce)
    stand_in = _stand_in(engine)
    # captured in the order opposite to the one the pages reach them in
    order = [(hw, n) for hw in BUCKETS[::-1] for n in BATCHES[::-1]]
    engine.warmup(bucket_hws=BUCKETS[::-1], batch_sizes=BATCHES[::-1], full=True)
    assert list(stand_in.captures) == order
    PORT_EVENTS.reset()
    for page, want in zip(pages, rows):
        assert _equal_rows(engine._page_rows(engine._dispatch_page(page, 1, None)), want)
    # every page dispatched before any is read: each later replay of a shape
    # writes its static output again
    dispatched = [engine._dispatch_page(page, 1, None) for page in pages]
    assert all(_equal_rows(engine._page_rows(d), want) for d, want in zip(dispatched, rows))
    assert stand_in.replays == 2 * sum(len(want) for want in rows)
    assert engine.ocr_pages(pages, lookahead=2) == texts
    assert engine.ocr_pages(pages[::-1], lookahead=2) == texts[::-1]
    assert PORT_EVENTS.summary() == {} and list(stand_in.captures) == order


def test_unwarmed_shape_is_captured_in_the_lookahead_thread_and_counted(serving):
    cfg, np_params, pages, _, texts = serving
    engine = _port_engine(np_params, cfg)
    stand_in = _stand_in(engine)
    engine.warmup(bucket_hws=BUCKETS, batch_sizes=BATCHES[:1], full=True)
    PORT_EVENTS.reset()
    assert engine.ocr_pages(pages, lookahead=2) == texts
    assert PORT_EVENTS.summary() == {"unplanned_compile": 1, "unplanned:128x128@16": 1}
    assert list(stand_in.captures)[-1] == ((128, 128), 16)
    assert stand_in.capture_threads[-1] != threading.get_ident()


@pytest.mark.parametrize("step", ["_record", "_replay"])
def test_a_failed_capture_or_replay_raises(serving, monkeypatch, step):
    cfg, np_params, pages, _, _ = serving
    engine = _port_engine(np_params, cfg)
    stand_in = _stand_in(engine)

    def fail(*args):
        raise RuntimeError(f"{step} failed")

    monkeypatch.setattr(stand_in, step, fail)
    if step == "_replay":
        stand_in.capture(engine._bucket_program, BUCKETS[0], BATCHES[0])
    with pytest.raises(RuntimeError, match=f"{step} failed"):
        engine.ocr_page(pages[1])


def test_an_engine_with_graphs_is_freed_without_the_cycle_collector(serving):
    cfg, np_params, _, _, _ = serving
    engine = _port_engine(np_params, cfg)
    _stand_in(engine).capture(engine._bucket_program, BUCKETS[0], BATCHES[0])
    gone = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert gone() is None
    finally:
        gc.enable()
