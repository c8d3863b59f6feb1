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

Not ported (each raises or is absent, see ROADMAP.md): the packed and fused
multi-bucket wire formats, meshes, the AOT executable store,
``ocr_page_dual`` (needs ``ocr_preprocess``), and CUDA graph capture.
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
    path."""

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
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchMangaOcrEngine: device='cuda' but CUDA is unavailable")
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
        self._lock = threading.Lock()
        self._warmed: set = set()  # (bucket_hw, padded_batch) pairs run once

    # -- one dispatch ---------------------------------------------------------

    def _run_bucket(self, crops_u8: np.ndarray, sizes: np.ndarray) -> torch.Tensor:
        """[B, bh, bw] uint8 gray crops + [B, 2] extents -> [B, 1 + L] int32
        ``[lengths | tokens]`` on the device (not yet read back)."""
        crops = torch.from_numpy(np.ascontiguousarray(crops_u8)).to(self.device, non_blocking=True)
        ext = torch.from_numpy(np.ascontiguousarray(sizes, np.int32)).to(self.device)
        with torch.inference_mode():
            pixels = pp.model_preprocess(crops, ext, self.cfg.encoder.image_size).to(self.dtype)
            out = mdl.ocr_forward(self.params, pixels, self.cfg, max_length=self.max_length)
            return torch.cat([out.lengths[:, None], out.tokens], dim=1)

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
            self._note_dispatch_shape(b.bucket_hw, b.crops.shape[0])
            with stage("dispatch"):
                outs.append((b, self._run_bucket(b.crops, b.sizes)))
        return outs

    def _collect_page(self, outs, timer) -> list[str]:
        """Token readback + detokenization for one page's dispatches."""
        if not outs:
            return []
        stage = _stage_fn(timer)
        texts = []
        for b, out in outs:
            with stage("readback"):
                packed = out.cpu().numpy()[: b.valid]
            with stage("detok"):
                texts.append(self.tokenizer.decode_batch(packed[:, 1:], packed[:, 0]))
        return batching.scatter_results([b for b, _ in outs], texts)

    def ocr_page_dual(self, *args, **kwargs):
        raise NotImplementedError(
            "ocr_page_dual needs ops.preprocess.ocr_preprocess, which is not ported yet"
        )

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
        ``warm_set()``; default: the common buckets at the smallest batch)."""
        if full:
            pairs = self.warm_set(bucket_hws, batch_sizes)
        else:
            default = ((128, 128), (256, 128), (128, 256), (256, 256))
            pairs = [
                (hw, n)
                for hw in (bucket_hws or default)
                for n in (batch_sizes or batching.BATCH_SCHEDULE[:1])
            ]
        for hw, n in pairs:
            dummy = np.zeros((n, hw[0], hw[1]), np.uint8)  # gray wire
            sizes = np.full((n, 2), hw, np.int32)
            self._run_bucket(dummy, sizes).cpu()
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
