"""The full model (counterpart of ``manga_ocr_tpu/models/model.py``):
encoder -> cross-K/V precompute -> greedy decode.

``greedy_decode`` dispatches on ``cfg.decoder.step_kernel`` as the JAX
function does: ``"fused_loop"`` runs the whole decode as kernel C over the
packed slabs in the compute dtype (bf16 or int8 decoder weights);
``"xla"`` and ``"fused_layer"`` run the chunked step-by-step loop over
``decoder.decode_step_greedy``, checking for early exit only between chunks
of ``chunk_size`` steps (``"fused_layer"`` over packed cross-K/V, int8 when
``cfg.decoder.cross_kv_int8``, the packed cache and the weights of kernels
J, K and B prepared once).  ``ocr_forward`` under ``"fused_loop"`` with
``fuse_cross_kv`` hands kernel C the encoder's raw output instead (C's
``fuse_kv`` form: the final LN and the cross-K/V projections run inside
its launch, and no slab is precomputed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.models.config import MangaOCRConfig
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


def greedy_decode(
    params: dict,
    enc_out: torch.Tensor,
    cfg: MangaOCRConfig,
    max_length: int | None = None,
    chunk_size: int = 8,
    stop_lengths: torch.Tensor | None = None,
    use_kernels: bool = True,
) -> GreedyResult:
    """Greedy decode of a batch of encoder outputs [B, S, D], in their dtype.

    The step-by-step form decodes whole chunks of ``chunk_size`` tokens and
    tests for "every row done" only between chunks, as the JAX loop does
    (its while-loop condition costs a host sync); rows write PAD after EOS
    and stop counting.  The cache holds ``1 + n_chunks * chunk_size``
    positions, so the last chunk may run past ``max_length - 1``; the result
    is sliced to ``max_length`` and the lengths clamped.

    ``stop_lengths`` ([B] int32) is the benchmark instrument: rows behave as
    if EOS fired at that length.  ``use_kernels=False`` runs the kernels'
    plain versions on any device."""
    dcfg = cfg.decoder
    max_len = max_length or cfg.max_length
    b, dtype, dev = enc_out.shape[0], enc_out.dtype, enc_out.device
    if dcfg.step_kernel == "fused_loop":
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc_out, dcfg, int8=False)
        loop = greedy_decode_loop if use_kernels else greedy_decode_loop_reference
        tokens, lengths = loop(
            params["decoder"], cross, dcfg, steps=max_len - 1, dtype=dtype,
            stop_lengths=stop_lengths,
        )
        return GreedyResult(tokens[:, :max_len], torch.clamp(lengths, max=max_len))
    if dcfg.step_kernel not in ("xla", "fused_layer"):
        raise NotImplementedError(f"greedy_decode: step_kernel={dcfg.step_kernel!r} is not ported")

    n_chunks = -(-(max_len - 1) // chunk_size)
    padded_len = 1 + n_chunks * chunk_size
    prepared = None
    if dcfg.step_kernel == "fused_layer":
        cross = dec.precompute_cross_kv_packed(params["decoder"], enc_out, dcfg)
        prepared = dec.prepare_fused_layer(params["decoder"], dcfg, dtype)
    else:
        cross = dec.precompute_cross_kv(params["decoder"], enc_out, dcfg)
    cache = dec.init_cache(dcfg, b, padded_len, dtype, dev)
    tokens = torch.full((b, padded_len), dcfg.pad_token_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = dcfg.bos_token_id
    last = torch.full((b,), dcfg.bos_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.ones((b,), dtype=torch.int32, device=dev)
    stops = None if stop_lengths is None else torch.as_tensor(stop_lengths, device=dev)
    pad = torch.full_like(last, dcfg.pad_token_id)
    step = 0
    while step < max_len - 1 and not bool(done.all()):
        for _ in range(chunk_size):
            nxt, cache = dec.decode_step_greedy(
                params["decoder"], last, step, cache, cross, dcfg, use_kernels, prepared
            )
            nxt = torch.where(done, pad, nxt)
            newly = nxt == dcfg.eos_token_id
            if stops is not None:
                newly = newly | (step + 2 >= stops)
            tokens[:, step + 1] = nxt
            lengths += (~done).to(torch.int32)
            last = nxt
            done = done | newly
            step += 1
    return GreedyResult(tokens[:, :max_len], torch.clamp(lengths, max=max_len))


def ocr_forward(
    params: dict,
    pixel_values: torch.Tensor,
    cfg: MangaOCRConfig,
    max_length: int | None = None,
    chunk_size: int = 8,
    stop_lengths: torch.Tensor | None = None,
    use_kernels: bool = True,
) -> GreedyResult:
    """pixels [B, H, W, C] (normalized) -> greedy token ids, in the dtype of
    ``pixel_values``.  ``use_kernels=False`` runs the plain versions of the
    kernels on any device."""
    dcfg = cfg.decoder
    if dcfg.step_kernel == "fused_loop" and dcfg.fuse_cross_kv:
        # kernel C's fuse_kv form, on the encoder output before its final LN
        enc_raw = vit.encode(params["encoder"], pixel_values, cfg.encoder,
                             use_kernels=use_kernels, raw_padded=True)
        max_len = max_length or cfg.max_length
        loop = greedy_decode_loop if use_kernels else greedy_decode_loop_reference
        tokens, lengths = loop(
            params["decoder"], None, dcfg, steps=max_len - 1, dtype=enc_raw.dtype,
            stop_lengths=stop_lengths, enc_raw=enc_raw, s_valid=cfg.encoder.seq_len,
            enc_final_ln=params["encoder"]["final_ln"],
        )
        return GreedyResult(tokens[:, :max_len], torch.clamp(lengths, max=max_len))
    enc_out = encode(params, pixel_values, cfg, use_kernels)
    return greedy_decode(params, enc_out, cfg, max_length, chunk_size, stop_lengths, use_kernels)


def cast_params(params, dtype):
    """Cast every floating-point leaf to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params
