"""The batched OCR engine on PyTorch (counterpart of
``manga_ocr_tpu/engine/engine.py`` ``TpuMangaOcrEngine``).

Same public surface and contracts: ``ocr_page(crops) -> [str]`` runs every
crop of a page through ONE dispatch per shape bucket (host prep -> uint8
gray crops to the device -> preprocess -> encoder -> cross-K/V -> greedy
decode -> a [lengths | tokens] int32 matrix back to the host -> tokenizer);
``perform_ocr(cv_bgr_image, settings)`` keeps the reference's single-crop
contract with ``"[ERROR: ...]"`` sentinels.

The three single-device configurations of the JAX engine: int8 serving
(the default: kernels A, B and C), unquantized serving
(``quantize_int8=False``: kernels E, D and C) and the exact reference path
(``serving_kernels=False``: reference attention and MLP, the step-by-step
decode with the reference head).

``ocr_page_dual(crops)`` is the reference's enhanced dual pass: each raw
crop and its ``ocr_preprocess`` variant (skew-corrected, equalized, Otsu
binarized), both through one ``ocr_page``, or the variant through a second
engine.

``mesh`` (``parallel.mesh.make_mesh``) serves data-parallel as the JAX
engine does under a (data, 1) mesh: the params replicated once per data
device, each bucket's batch padded to a multiple of the data-axis size
(repeating its last crop), split, every shard launched on its device
before any is read back, and the rows joined in order.  On a model axis
above 1 (tensor parallelism; ``serving_kernels`` then defaults to off, as
in the JAX engine) the params are split by ``parallel.mesh.shard_params``
and a bucket's data rows run ``models.model.ocr_forward_rows`` on their
model columns: every row's work queued before the decode loop's one host
read between chunks.

The host <-> device traffic is the JAX engine's.  ``wire="gray"`` ships
each bucket's padded [B, bh, bw] uint8 batch and its [B, 2] extents;
``wire="packed"`` ships each bucket's crop rows height-tight with a [B, 3]
(h, w, row offset) array, and the device rebuilds the same batch with one
row gather (``ops.preprocess.unpack_packed_page``).  ``coalesce=True`` (the
default) gives a multi-bucket page one transfer each way: on one device
its gray buckets travel as ONE uint8 buffer, split on the device by static
slices, and under any configuration its buckets' ``[lengths | tokens]``
matrices are joined on the device and read back once (once per data
device under a mesh).  Every copy to the host starts at dispatch
(``HostCopy``: a pinned host tensor and a CUDA event), so ``ocr_pages``'s
lookahead only waits on those copies.

``aot=True`` is the counterpart of the JAX engine's AOT executable store
on one CUDA device: every dispatch of a (bucket, padded batch) shape,
whichever wire brought its crops, replays ONE CUDA graph of
``_bucket_program`` (``engine/graphs.py``), captured by ``warmup`` for the
shapes it warms and at its first dispatch for any other (which
``COMPILE_EVENTS`` counts as an unplanned compile, as JAX's does).  The rows
are the eager dispatch's, bit for bit.  The CPU runs eagerly (it has no
graphs), and so does a mesh, as under JAX's store, which is single-device
(a data-parallel shard's graph would be one more per device, not ported).
So does every decode but kernel C's whole loop (``step_kernel="fused_loop"``,
the serving kernels): the step-by-step decodes (the exact reference path,
``serving_kernels=False``, and the tensor-parallel decode) read their "done"
flags on the host between chunks (``models.model.greedy_loop``), which no
graph can, and a graph would fix their number of steps.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from manga_ocr_tpu_torch.engine import graphs
from manga_ocr_tpu_torch.models import model as mdl
from manga_ocr_tpu_torch.models.config import MangaOCRConfig, with_serving_kernels
from manga_ocr_tpu_torch.models.quantize import quantize_encoder
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.ops import preprocess as pp
from manga_ocr_tpu_torch.parallel import batching
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from manga_ocr_tpu_torch.parallel import tensor
from manga_ocr_tpu_torch.utils.metrics import COMPILE_EVENTS


def _stage_fn(timer):
    """StageTimer adapter: ``None`` timer -> no-op context factory."""
    if timer is not None:
        return timer.stage
    from contextlib import nullcontext

    return lambda _name: nullcontext()


def _err(msg: str) -> str:
    return f"[ERROR: {msg}]"


def _joined(out: mdl.GreedyResult) -> torch.Tensor:
    """A decode's [B, 1 + L] int32 ``[lengths | tokens]`` rows."""
    return torch.cat([out.lengths[:, None], out.tokens], dim=1)


def _cast_quantized(tree, dtype):
    """Cast float leaves to ``dtype``, keeping int8 weights and the f32
    per-channel scales of quantized denses."""
    if "w_q" in tree:
        out = dict(tree)
        out["scale"] = tree["scale"].float()
        if tree.get("bias") is not None:
            out["bias"] = tree["bias"].to(dtype)
        return out
    return {
        k: _cast_quantized(v, dtype) if isinstance(v, dict)
        else (v.to(dtype) if v.is_floating_point() else v)
        for k, v in tree.items()
    }


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _pinned(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as the source of a transfer to ``device``: a pinned
    copy for CUDA (a copy from pageable memory is synchronous, whatever
    ``non_blocking`` says; PyTorch's pinned-memory cache keeps the block
    until the copy that reads it has run), the array's own tensor on the
    CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.pin_memory() if device.type == "cuda" else t


def _h2d(host: torch.Tensor, device: torch.device, stage, timed: bool) -> torch.Tensor:
    """One host -> device transfer in a "h2d" stage of its own (on the CPU
    the tensor itself: no transfer).  With a timer on CUDA the host first
    waits for the work queued on the stream (counted in "dispatch"), then
    for the copy, so "h2d" times the copy alone."""
    cuda = timed and device.type == "cuda"
    if cuda:
        with stage("dispatch"):
            torch.cuda.current_stream(device).synchronize()
    with stage("h2d"):
        out = host.to(device, non_blocking=True)
        if cuda:
            torch.cuda.current_stream(device).synchronize()
    return out


def _int32_rows(buf: torch.Tensor, n: int) -> torch.Tensor:
    """``8 n`` little-endian bytes of a uint8 tensor -> its [n, 2] int32
    view, no copy.  ``view(torch.int32)`` needs the slice's storage offset
    to be a multiple of 4: the fused wire keeps it so (every bucket's
    ``bh * bw`` is a multiple of 4), and this checks it."""
    if buf.storage_offset() % 4:
        raise ValueError(f"fused wire: extents at byte {buf.storage_offset()}, not a multiple of 4")
    return buf.view(torch.int32).view(n, 2)


class HostCopy:
    """A device tensor's copy to the host, started when this is made (the
    counterpart of JAX's ``copy_to_host_async``).  On CUDA: a
    ``non_blocking`` copy into a pinned host tensor of its own, then an
    event recorded on the stream that runs the copy (the current stream of
    the tensor's device, in the dispatching thread); ``numpy()`` waits on
    that event alone.  The pinned tensor lives as long as this object, and
    no two pages share one.  On the CPU the tensor is its own host copy."""

    def __init__(self, src: torch.Tensor):
        self.shape = src.shape
        if src.device.type == "cuda":
            self._host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._host.copy_(src, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(src.device))
        else:
            self._host, self._event = src, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def graphs_apply(aot: bool, mesh, device: torch.device, cfg: MangaOCRConfig) -> bool:
    """Whether an engine asked for ``aot`` replays CUDA graphs: on one CUDA
    device (JAX's store is single-device), and only where the whole decode
    runs on the device (kernel C's loop; see the module docstring)."""
    return (bool(aot) and mesh is None and device.type == "cuda"
            and cfg.decoder.step_kernel == "fused_loop")


class TorchMangaOcrEngine:
    """Batched manga-ocr engine on a CUDA device (or the CPU, for tests).

    ``params``: the JAX-layout parameter tree as torch tensors
    (``models.params.params_from_jax`` / ``init_params``), on any device —
    they are moved to ``device``.  ``device`` is explicit: ``"cuda"`` raises
    when CUDA is unavailable instead of running on the CPU.

    ``serving_kernels`` (default on without a model axis above 1) selects
    the serving configuration (``config.with_serving_kernels``);
    ``quantize_int8`` (default: as ``serving_kernels``) picks its int8 form
    (encoder quantized, kernels A, B, C) or its unquantized form (bf16
    params, kernels E, D, C).  ``serving_kernels=False`` runs ``cfg`` as
    given on params cast to ``dtype``: with ``MangaOCRConfig.base()`` that
    is the exact reference path.

    ``mesh``: a ``parallel.mesh.Mesh``; every crop batch is sharded over its
    data axis (None = ``device`` alone).  Its devices replace ``device``,
    which must then be of their type (CUDA or CPU, so a CUDA request never
    runs on the CPU); ``self.device`` is the first of them.  On a model axis
    above 1 the engine serves tensor-parallel on the plain route: the
    params split over each data row's model columns (``shard_params``), the
    rows' shards through ``models.model.ocr_forward_rows``;
    ``serving_kernels=True`` raises there (the kernels hold whole weights),
    as does a ``cfg`` that names a kernel.

    ``wire``: the host -> device crop format, "gray" (padded batches) or
    "packed" (height-tight rows, rebuilt on the device; one device only:
    a ``ValueError`` under a mesh).  ``coalesce``: a multi-bucket page's
    single h2d buffer (one device, gray batches) and single readback (any
    configuration); ``False`` sends and reads back bucket by bucket.

    ``aot``: replay one CUDA graph per (bucket, padded batch) shape (see the
    module docstring); on only for one CUDA device serving through kernel
    C's loop, off on the CPU, under a mesh and for ``serving_kernels=False``
    (``graphs_apply``; False by default, as JAX's; ``serve.py`` turns it on
    unless given ``--no-aot``)."""

    def __init__(
        self,
        params: dict,
        cfg: MangaOCRConfig,
        tokenizer: CharTokenizer,
        max_length: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        serving_kernels: bool | None = None,
        quantize_int8: bool | None = None,
        mesh: meshlib.Mesh | None = None,
        wire: str = "gray",
        coalesce: bool = True,
        aot: bool = False,
    ):
        devices = meshlib.serving_devices(mesh, device, "TorchMangaOcrEngine")
        self.device = devices[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchMangaOcrEngine: device='cuda' but CUDA is unavailable")
        if wire not in ("gray", "packed"):
            raise ValueError(f"wire must be 'gray' or 'packed', got {wire!r}")
        if wire == "packed" and mesh is not None:
            raise ValueError(
                "wire='packed' is single-device only (global offsets); "
                "use the default gray wire under a mesh"
            )
        self._wire = wire
        self._coalesce = coalesce
        n_model = mesh.shape[meshlib.MODEL_AXIS] if mesh is not None else 1
        if serving_kernels is None:
            serving_kernels = n_model == 1
        if serving_kernels and n_model > 1:
            raise ValueError(
                "fused serving kernels support data-parallel meshes only "
                f"(model axis size 1, got {n_model}); pass "
                "serving_kernels=False to serve tensor-parallel through the "
                "XLA path"
            )
        if n_model > 1:
            tensor.check_plain(cfg, n_model)
        if quantize_int8 is None:
            quantize_int8 = serving_kernels
        if serving_kernels:
            cfg = with_serving_kernels(cfg, quantized=bool(quantize_int8))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_length = max_length or cfg.max_length
        self.dtype = dtype
        params = _params_to(params, self.device)
        if serving_kernels and quantize_int8:
            # quantize from the original (pre-cast) weights, as the JAX
            # engine does; the decoder stays unquantized in the compute dtype
            self.params = {
                "encoder": _cast_quantized(
                    quantize_encoder(params["encoder"], quantize_attn_proj=True), dtype
                ),
                "decoder": mdl.cast_params(params["decoder"], dtype),
            }
        else:
            self.params = mdl.cast_params(params, dtype)
        self.mesh = mesh
        # one replica per data device, copied once; the kernels' prepared
        # weights are cached per replica's leaves (a virtual mesh that
        # repeats a device shares one replica, so one cache entry).  Under
        # tensor parallelism a replica is the row's column trees.
        self._devices = devices
        self._tensor_parallel = n_model > 1
        if mesh is None:
            self._replicas = [self.params]
        elif self._tensor_parallel:
            self._replicas = meshlib.shard_params(self.params, mesh)
        else:
            self._replicas = meshlib.dp_replicate(self.params, mesh)
        self._batch_multiple = len(devices)
        self._lock = threading.Lock()
        self._warmed: set = set()  # (bucket_hw, padded_batch) pairs run once
        self._aot = graphs_apply(aot, mesh, self.device, cfg)
        self._graphs = graphs.BucketGraphs(self.device, self._lock) if self._aot else None

    # -- one dispatch ---------------------------------------------------------

    def _bucket_program(self, crops: torch.Tensor, ext: torch.Tensor,
                        shard: int = 0) -> torch.Tensor:
        """[B, bh, bw] uint8 gray crops + [B, 2] int32 extents, both on data
        device ``shard`` -> [B, 1 + L] int32 ``[lengths | tokens]`` there,
        with its replica (not read back)."""
        with torch.inference_mode():
            pixels = pp.model_preprocess(crops, ext, self.cfg.encoder.image_size).to(self.dtype)
            out = mdl.ocr_forward(self._replicas[shard], pixels, self.cfg,
                                  max_length=self.max_length)
            return _joined(out)

    def _program(self, crops: torch.Tensor, ext: torch.Tensor, shard: int = 0) -> torch.Tensor:
        """``_bucket_program``, through its shape's CUDA graph under
        ``aot``."""
        if self._graphs is None:
            return self._bucket_program(crops, ext, shard)
        return self._graphs.run(self._bucket_program, crops, ext)

    def _send(self, crops_u8: np.ndarray, sizes: np.ndarray, shard: int, stage,
              timed: bool) -> tuple:
        """A gray-wire bucket's crops and extents to data device ``shard``,
        in two transfers."""
        device = self._devices[shard]
        with stage("host_prep"):
            crops_h = _pinned(crops_u8, device)
            ext_h = _pinned(np.ascontiguousarray(sizes, np.int32), device)
        return _h2d(crops_h, device, stage, timed), _h2d(ext_h, device, stage, timed)

    def _run_bucket(self, crops_u8: np.ndarray, sizes: np.ndarray, shard: int = 0,
                    stage=None, timed: bool = False) -> torch.Tensor:
        """A gray-wire bucket on data device ``shard``: ``_send``, then
        ``_program``."""
        stage = stage or _stage_fn(None)
        crops, ext = self._send(crops_u8, sizes, shard, stage, timed)
        with stage("dispatch"):
            return self._program(crops, ext, shard)

    def _run_sharded(self, crops_u8: np.ndarray, sizes: np.ndarray, stage=None,
                     timed: bool = False) -> list[torch.Tensor]:
        """A batch whose rows divide by the data-axis size -> one output per
        data device, every shard launched before any is read back: each
        slice through ``_run_bucket``, or under tensor parallelism every
        slice sent, then all the rows through ``ocr_forward_rows`` (one
        decode loop, whose host read between chunks covers every row)."""
        rows = crops_u8.shape[0] // self._batch_multiple
        parts = [slice(i * rows, (i + 1) * rows) for i in range(self._batch_multiple)]
        if not self._tensor_parallel:
            return [self._run_bucket(crops_u8[sl], sizes[sl], i, stage, timed)
                    for i, sl in enumerate(parts)]
        stage = stage or _stage_fn(None)
        sent = [self._send(crops_u8[sl], sizes[sl], i, stage, timed) for i, sl in enumerate(parts)]
        with stage("dispatch"), torch.inference_mode():
            size = self.cfg.encoder.image_size
            pixels = [pp.model_preprocess(c, e, size).to(self.dtype) for c, e in sent]
            outs = mdl.ocr_forward_rows(self._replicas, pixels, self.cfg,
                                        max_length=self.max_length)
            return [_joined(out) for out in outs]

    def _run_packed(self, b: batching.PackedBatch, stage, timed: bool) -> torch.Tensor:
        """A packed-wire bucket: the row buffer and the [B, 3] (h, w, row
        offset) array in two transfers, the padded batch rebuilt on the
        device, then ``_program``."""
        device = self.device
        with stage("host_prep"):
            flat_h = _pinned(b.flat, device)
            meta_h = _pinned(np.concatenate([b.sizes, b.offsets[:, None]], axis=1), device)
        flat = _h2d(flat_h, device, stage, timed)
        meta = _h2d(meta_h, device, stage, timed)
        with stage("dispatch"):
            crops, ext = pp.unpack_packed_page(flat, meta, *b.bucket_hw)
            return self._program(crops, ext.contiguous())

    def _dispatch_fused_wire(self, batches, stage, timed: bool) -> list:
        """A multi-bucket gray page over ONE transfer (the wire half of
        ``coalesce``): each bucket's crop bytes, then its int32 extents'
        bytes, in one uint8 buffer (pinned on CUDA), split on the device by
        static slices."""
        device = self.device
        with stage("host_prep"):
            # the page-sized memcpy is prep, so that "h2d" is the transfer alone
            parts = [p.reshape(-1).view(np.uint8) for b in batches
                     for p in (b.crops, np.ascontiguousarray(b.sizes, np.int32))]
            wire = torch.empty(sum(p.size for p in parts), dtype=torch.uint8,
                               pin_memory=device.type == "cuda")
            np.concatenate(parts, out=wire.numpy())
        dwire = _h2d(wire, device, stage, timed)
        outs, off = [], 0
        with stage("dispatch"):
            for b in batches:
                (n, bh, bw) = b.crops.shape
                crops = dwire[off:off + n * bh * bw].view(n, bh, bw)
                off += n * bh * bw
                ext = _int32_rows(dwire[off:off + 8 * n], n)
                off += 8 * n
                self._note_dispatch_shape(b.bucket_hw, n)
                outs.append((b, [self._program(crops, ext)]))
        return outs

    # -- batched entry points ---------------------------------------------------

    def ocr_page(
        self,
        crops: Sequence[np.ndarray],
        orientation: int = pp.ORIENT_VERTICAL,
        timer=None,
    ) -> list[str]:
        """OCR every crop of a page: bucket, pad, one dispatch per bucket.
        ``orientation`` follows the reference's manga-ocr rule, applied
        host-side per crop before bucketing; ``timer`` is an optional
        ``utils.metrics.StageTimer`` (host_prep, h2d, dispatch, readback,
        detok; one "h2d" entry a transfer, one "readback" a copy waited
        on)."""
        return self._collect_page(self._dispatch_page(crops, orientation, timer), timer)

    def ocr_pages(
        self,
        pages: Sequence[Sequence[np.ndarray]],
        orientation: int = pp.ORIENT_VERTICAL,
        lookahead: int = 2,
    ) -> list[list[str]]:
        """Streaming multi-page OCR: up to ``lookahead`` pages are dispatched
        on one background thread before the first is collected, so a page's
        host prep and transfer overlap the previous page's device work.
        ``lookahead=0`` keeps everything on the calling thread."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        results: list[list[str]] = []
        if lookahead <= 0:
            for page in pages:
                results.append(self._collect_page(self._dispatch_page(page, orientation, None), None))
            return results
        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as ex:
            for page in pages:
                pending.append(ex.submit(self._dispatch_page, page, orientation, None))
                if len(pending) > lookahead:
                    results.append(self._collect_page(pending.popleft().result(), None))
            while pending:
                results.append(self._collect_page(pending.popleft().result(), None))
        return results

    def _dispatch_page(self, crops, orientation, timer):
        """Host prep + transfers + device dispatch for one page, with no
        wait on the device.  Returns ``(outs, fused)``: ``outs`` is one
        ``(batch, outputs)`` pair a bucket, an output a data device;
        ``fused`` is one ``HostCopy`` a data device of every bucket's
        outputs joined on the device (a multi-bucket page under
        ``coalesce``), else None, and then each output is a ``HostCopy``."""
        if not len(crops):
            return [], None
        stage = _stage_fn(timer)
        timed = timer is not None
        with stage("host_prep"):
            # the native orient + gray (+ pad) pass, else NumPy: the same bytes
            if self._wire == "packed":
                batches = batching.prep_page_packed(crops, orientation)
            else:
                batches = batching.prep_page_gray(crops, orientation)
        if (
            self._coalesce
            and len(batches) > 1
            and self.mesh is None
            and not any(isinstance(b, batching.PackedBatch) for b in batches)
        ):
            return self._finish_dispatch(self._dispatch_fused_wire(batches, stage, timed), stage)
        outs = []
        for b in batches:
            if isinstance(b, batching.PackedBatch):
                self._note_dispatch_shape(b.bucket_hw, b.sizes.shape[0])
                outs.append((b, [self._run_packed(b, stage, timed)]))
                continue
            arr, sizes = b.crops, b.sizes
            if arr.shape[0] % self._batch_multiple:
                # repeat the last crop and its extents (JAX engine.py:528-531)
                pad = self._batch_multiple - arr.shape[0] % self._batch_multiple
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
                sizes = np.concatenate([sizes, np.repeat(sizes[-1:], pad, axis=0)])
            self._note_dispatch_shape(b.bucket_hw, arr.shape[0])
            outs.append((b, self._run_sharded(arr, sizes, stage, timed)))
        return self._finish_dispatch(outs, stage)

    def _finish_dispatch(self, outs, stage):
        """The dispatch's tail: join the buckets' outputs on each data
        device for one readback there (the readback half of ``coalesce``),
        or else copy each output back by itself; either way the copies to
        the host start now, so they run as soon as the work ends."""
        fused = None
        with stage("dispatch"), torch.inference_mode():
            if len(outs) > 1 and self._coalesce:
                fused = [HostCopy(torch.cat([shards[i] for _, shards in outs]))
                         for i in range(self._batch_multiple)]
            else:
                outs = [(b, [HostCopy(s) for s in shards]) for b, shards in outs]
        return outs, fused

    def _collect_page(self, page, timer) -> list[str]:
        """Wait on one page's copies to the host, then detokenize each
        bucket's valid rows."""
        outs, _ = page
        if not outs:
            return []
        stage = _stage_fn(timer)
        texts = []
        for packed in self._page_rows(page, stage):
            with stage("detok"):
                texts.append(self.tokenizer.decode_batch(packed[:, 1:], packed[:, 0]))
        return batching.scatter_results([b for b, _ in outs], texts)

    def _page_rows(self, page, stage=None) -> list[np.ndarray]:
        """A dispatched page's ``[lengths | tokens]`` rows on the host, one
        [valid, 1 + L] int32 array a bucket: each copy waited on in a
        "readback" stage of its own, the shards' rows joined in order and
        the padding rows dropped."""
        outs, fused = page
        stage = stage or _stage_fn(None)

        def wait(copy: HostCopy) -> np.ndarray:
            with stage("readback"):
                return copy.numpy()

        def join(parts: list) -> np.ndarray:
            return np.concatenate(parts) if len(parts) > 1 else parts[0]

        if fused is None:
            return [join([wait(c) for c in copies])[: b.valid] for b, copies in outs]
        hosts = [wait(f) for f in fused]
        rows, off = [], 0
        for b, shards in outs:
            n = shards[0].shape[0]
            rows.append(join([h[off:off + n] for h in hosts])[: b.valid])
            off += n
        return rows

    def ocr_page_dual(
        self,
        crops: Sequence[np.ndarray],
        orientation: int = pp.ORIENT_AUTO,
        second_engine=None,
        settings: dict | None = None,
    ) -> list[tuple[str, str]]:
        """Enhanced dual pass (``workers.py:383-420``): the raw crop goes to
        this model under ``orientation``, and a skew-corrected, equalized,
        Otsu-binarized variant (``ocr_preprocess`` with Auto-Detect, on
        ``self.device``, one call per shape bucket) goes to ``second_engine``
        (any ``perform_ocr(img, settings)`` object; the reference uses
        Tesseract(jpn)) with the caller's ``settings`` under the Tesseract/jpn
        overrides.  Without one, both variants go through one ``ocr_page``
        of this model.  Returns (raw_text, second_text) per crop."""
        if not len(crops):
            return []
        crops = [np.asarray(c, np.uint8) for c in crops]
        pre = self._binarized_variants(crops)
        if second_engine is not None:
            raw_texts = self.ocr_page(crops, orientation)
            # the reference forces Tesseract(jpn) on top of the caller's
            # settings ({**settings, ...}, workers.py:399-403)
            second_settings = {
                **(settings or {}),
                "ocr_engine": "Tesseract",
                "ocr_lang": "jpn",
                "tesseract_lang": "jpn",
            }
            second = [second_engine.perform_ocr(p, second_settings) for p in pre]
        else:
            both = self.ocr_page(crops + pre, orientation)
            raw_texts, second = both[: len(crops)], both[len(crops):]
        return list(zip(raw_texts, second))

    def _binarized_variants(self, crops: list[np.ndarray]) -> list[np.ndarray]:
        """Each crop's ``ocr_preprocess`` (Auto-Detect) variant, [h, w, 3]
        uint8: one call per shape bucket on ``self.device``, the statistics
        over each crop's valid extent, the output cropped back to it."""
        batches = batching.bucket_crops(crops)
        results = []
        with torch.inference_mode():
            for b in batches:
                out, _ = pp.ocr_preprocess(
                    torch.from_numpy(b.crops).to(self.device),
                    pp.ORIENT_AUTO,
                    torch.from_numpy(b.sizes).to(self.device),
                )
                out = out[: b.valid].cpu().numpy()
                results.append([img[: hw[0], : hw[1]] for img, hw in zip(out, b.sizes[: b.valid])])
        return batching.scatter_results(batches, results)

    # -- reference-compatible single-crop entry -------------------------------------

    def perform_ocr(self, cv_bgr_image: np.ndarray, settings: dict | None = None) -> str:
        """Single-crop OCR with the reference's contract: BGR uint8 in, text
        or ``"[ERROR: ...]"`` out; orientation from settings."""
        try:
            if cv_bgr_image is None or cv_bgr_image.size == 0:
                return _err("empty image")
            if cv_bgr_image.ndim == 2:
                cv_bgr_image = np.repeat(cv_bgr_image[..., None], 3, axis=-1)
            return self.ocr_page([cv_bgr_image], _orientation_from_settings(settings))[0]
        except Exception as e:  # contract: errors become sentinel strings
            return _err(f"{type(e).__name__}: {e}")

    # -- shape coverage ------------------------------------------------------------

    def warm_set(
        self,
        bucket_hws: Sequence[tuple[int, int]] | None = None,
        batch_sizes: Sequence[int] | None = None,
    ) -> list[tuple[tuple[int, int], int]]:
        """Every (bucket, padded batch) shape ``ocr_page`` can dispatch."""
        return [
            (hw, n)
            for hw in (bucket_hws or batching.DEFAULT_BUCKETS)
            for n in (batch_sizes or batching.BATCH_SCHEDULE)
        ]

    def _note_dispatch_shape(self, bucket_hw, batch: int) -> None:
        """Count dispatch shapes outside the warmed set (a first call pays
        the kernel library load and the allocator's growth)."""
        key = (bucket_hw, batch)
        with self._lock:
            if key in self._warmed:
                return
            self._warmed.add(key)
        COMPILE_EVENTS.add("unplanned_compile")
        COMPILE_EVENTS.add(f"unplanned:{bucket_hw[0]}x{bucket_hw[1]}@{batch}")

    def warmup(
        self,
        bucket_hws: Sequence[tuple[int, int]] | None = None,
        batch_sizes: Sequence[int] | None = None,
        full: bool = False,
    ) -> None:
        """Run one dispatch per bucket x batch shape (``full=True``: the whole
        ``warm_set()``; default: the common buckets at the smallest batch),
        each batch rounded up to the data-axis multiple first, then
        deduplicated; under ``aot`` capture each shape's CUDA graph
        instead, in that order."""
        if full:
            pairs = self.warm_set(bucket_hws, batch_sizes)
        else:
            default = ((128, 128), (256, 128), (128, 256), (256, 256))
            pairs = [
                (hw, n)
                for hw in (bucket_hws or default)
                for n in (batch_sizes or batching.BATCH_SCHEDULE[:1])
            ]
        rounded = []
        for hw, n in pairs:
            n += -n % self._batch_multiple
            if (hw, n) not in rounded:
                rounded.append((hw, n))
        for hw, n in rounded:
            if self._graphs is not None:
                self._graphs.capture(self._bucket_program, hw, n)
            else:
                dummy = np.zeros((n, hw[0], hw[1]), np.uint8)  # gray wire
                sizes = np.full((n, 2), hw, np.int32)
                meshlib.dp_gather(self._run_sharded(dummy, sizes), n)
            with self._lock:
                self._warmed.add((hw, n))


def _orientation_from_settings(settings: dict | None) -> int:
    """The reference's orientation strings -> preprocess modes; missing or
    unknown values mean Auto-Detect (no rotation on this path)."""
    if not settings:
        return pp.ORIENT_AUTO
    val = str(settings.get("orientation", "Auto-Detect"))
    return {
        "Vertical": pp.ORIENT_VERTICAL,
        "Horizontal": pp.ORIENT_HORIZONTAL,
        "Auto-Detect": pp.ORIENT_AUTO,
        "None": pp.ORIENT_NONE,
    }.get(val, pp.ORIENT_AUTO)
