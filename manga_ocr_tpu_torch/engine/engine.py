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
before any is read back, and the rows joined in order.

Not ported (each is absent, see ROADMAP.md): the packed and fused
multi-bucket wire formats, tensor parallelism (a model axis above 1), the
AOT executable store, and CUDA graph capture.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from manga_ocr_tpu_torch.models import model as mdl
from manga_ocr_tpu_torch.models.config import MangaOCRConfig, with_serving_kernels
from manga_ocr_tpu_torch.models.quantize import quantize_encoder
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.ops import preprocess as pp
from manga_ocr_tpu_torch.parallel import batching
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from manga_ocr_tpu_torch.utils.metrics import COMPILE_EVENTS


def _stage_fn(timer):
    """StageTimer adapter: ``None`` timer -> no-op context factory."""
    if timer is not None:
        return timer.stage
    from contextlib import nullcontext

    return lambda _name: nullcontext()


def _err(msg: str) -> str:
    return f"[ERROR: {msg}]"


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


class TorchMangaOcrEngine:
    """Batched manga-ocr engine on a CUDA device (or the CPU, for tests).

    ``params``: the JAX-layout parameter tree as torch tensors
    (``models.params.params_from_jax`` / ``init_params``), on any device —
    they are moved to ``device``.  ``device`` is explicit: ``"cuda"`` raises
    when CUDA is unavailable instead of running on the CPU.

    ``serving_kernels`` (default on) selects the serving configuration
    (``config.with_serving_kernels``); ``quantize_int8`` (default: as
    ``serving_kernels``) picks its int8 form (encoder quantized, kernels A,
    B, C) or its unquantized form (bf16 params, kernels E, D, C).
    ``serving_kernels=False`` runs ``cfg`` as given on params cast to
    ``dtype``: with ``MangaOCRConfig.base()`` that is the exact reference
    path.

    ``mesh``: a ``parallel.mesh.Mesh``; every crop batch is sharded over its
    data axis (None = ``device`` alone).  Its devices replace ``device``,
    which must then be of their type (CUDA or CPU, so a CUDA request never
    runs on the CPU); ``self.device`` is the first of them.  A model axis
    above 1 raises: the serving kernels are data-parallel only, and tensor
    parallelism is not ported."""

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
    ):
        devices = meshlib.serving_devices(mesh, device, "TorchMangaOcrEngine")
        self.device = devices[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchMangaOcrEngine: device='cuda' but CUDA is unavailable")
        n_model = mesh.shape[meshlib.MODEL_AXIS] if mesh is not None else 1
        if n_model > 1 and serving_kernels:
            raise ValueError(
                "fused serving kernels support data-parallel meshes only "
                f"(model axis size 1, got {n_model})"
            )
        if n_model > 1:
            raise ValueError(
                f"a model axis of {n_model} (tensor parallelism) is not ported; serve on a "
                "(data, 1) mesh (ROADMAP.md queue 1 item 7)"
            )
        if serving_kernels is None:
            serving_kernels = True
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
        # repeats a device shares one replica, so one cache entry)
        self._devices = devices
        self._replicas = [self.params] if mesh is None else meshlib.dp_replicate(self.params, mesh)
        self._batch_multiple = len(devices)
        self._lock = threading.Lock()
        self._warmed: set = set()  # (bucket_hw, padded_batch) pairs run once

    # -- one dispatch ---------------------------------------------------------

    def _run_bucket(self, crops_u8: np.ndarray, sizes: np.ndarray, shard: int = 0) -> torch.Tensor:
        """[B, bh, bw] uint8 gray crops + [B, 2] extents -> [B, 1 + L] int32
        ``[lengths | tokens]`` on data device ``shard`` with its replica (not
        yet read back)."""
        device, params = self._devices[shard], self._replicas[shard]
        crops = torch.from_numpy(np.ascontiguousarray(crops_u8)).to(device, non_blocking=True)
        ext = torch.from_numpy(np.ascontiguousarray(sizes, np.int32)).to(device)
        with torch.inference_mode():
            pixels = pp.model_preprocess(crops, ext, self.cfg.encoder.image_size).to(self.dtype)
            out = mdl.ocr_forward(params, pixels, self.cfg, max_length=self.max_length)
            return torch.cat([out.lengths[:, None], out.tokens], dim=1)

    def _run_sharded(self, crops_u8: np.ndarray, sizes: np.ndarray) -> list[torch.Tensor]:
        """A batch whose rows divide by the data-axis size -> one output per
        data device (``_run_bucket`` on each slice), every shard launched
        before any is read back."""
        rows = crops_u8.shape[0] // self._batch_multiple
        return [self._run_bucket(crops_u8[i * rows:(i + 1) * rows], sizes[i * rows:(i + 1) * rows],
                                 i) for i in range(self._batch_multiple)]

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
        ``utils.metrics.StageTimer``."""
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
        """Host prep + transfer + device dispatch for one page; returns
        (batch, device output) pairs with no host readback."""
        if not len(crops):
            return []
        stage = _stage_fn(timer)
        with stage("host_prep"):
            batches = batching.prep_page_gray(crops, orientation)
        outs = []
        for b in batches:
            arr, sizes = b.crops, b.sizes
            if arr.shape[0] % self._batch_multiple:
                # repeat the last crop and its extents (JAX engine.py:528-531)
                pad = self._batch_multiple - arr.shape[0] % self._batch_multiple
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
                sizes = np.concatenate([sizes, np.repeat(sizes[-1:], pad, axis=0)])
            self._note_dispatch_shape(b.bucket_hw, arr.shape[0])
            with stage("dispatch"):
                outs.append((b, self._run_sharded(arr, sizes)))
        return outs

    def _collect_page(self, outs, timer) -> list[str]:
        """Token readback + detokenization for one page's dispatches."""
        if not outs:
            return []
        stage = _stage_fn(timer)
        texts = []
        for b, shards in outs:
            with stage("readback"):
                packed = meshlib.dp_gather(shards, b.valid)
            with stage("detok"):
                texts.append(self.tokenizer.decode_batch(packed[:, 1:], packed[:, 0]))
        return batching.scatter_results([b for b, _ in outs], texts)

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
        deduplicated."""
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
