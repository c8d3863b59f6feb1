"""The full model on the serving path (counterpart of
``manga_ocr_tpu/models/model.py``): encoder -> cross-K/V precompute -> the
whole greedy decode (kernel C)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models import decoder as dec
from manga_ocr_tpu_torch.models import vit
from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop, greedy_decode_loop_reference


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_len] int32, starts with BOS, PAD after EOS
    lengths: torch.Tensor  # [B] int32 — valid tokens incl. BOS and EOS


def encode(
    params: dict, pixel_values: torch.Tensor, cfg: MangaOCRConfig, use_kernels: bool = True
) -> torch.Tensor:
    return vit.encode(params["encoder"], pixel_values, cfg.encoder, use_kernels=use_kernels)


def ocr_forward(
    params: dict,
    pixel_values: torch.Tensor,
    cfg: MangaOCRConfig,
    max_length: int | None = None,
    stop_lengths: torch.Tensor | None = None,
    use_kernels: bool = True,
) -> GreedyResult:
    """pixels [B, H, W, C] (normalized) -> greedy token ids, in the dtype of
    ``pixel_values``.  ``use_kernels=False`` runs the plain versions of the
    three kernels on any device."""
    dcfg = cfg.decoder
    if dcfg.step_kernel != "fused_loop" or dcfg.fuse_cross_kv:
        raise NotImplementedError(
            "ocr_forward: only the serving decode (step_kernel='fused_loop', "
            "fuse_cross_kv off) is ported"
        )
    max_len = max_length or cfg.max_length
    enc_out = encode(params, pixel_values, cfg, use_kernels)
    cross = dec.precompute_cross_kv_packed(params["decoder"], enc_out, dcfg, int8=False)
    loop = greedy_decode_loop if use_kernels else greedy_decode_loop_reference
    tokens, lengths = loop(
        params["decoder"], cross, dcfg, steps=max_len - 1, dtype=enc_out.dtype,
        stop_lengths=stop_lengths,
    )
    return GreedyResult(tokens[:, :max_len], torch.clamp(lengths, max=max_len))


def cast_params(params, dtype):
    """Cast every floating-point leaf to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params
