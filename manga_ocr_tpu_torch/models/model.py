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
``fuse_kv`` form: the final LN and the cross-K/V projections run in
kernel C's own prologue, not through ``precompute_cross_kv_packed``).

Tensor parallelism: ``encode``, ``greedy_decode`` and ``ocr_forward`` on
the plain route (``step_kernel="xla"``) also take a list of a data row's
model columns (``parallel.mesh.shard_params``' full trees), and
``ocr_forward_rows`` runs several data rows at once: every row's encoder,
then their decodes in one loop whose "every row done" read covers all the
rows, so that no row's read waits before another row's work is queued.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models import decoder as dec
from manga_ocr_tpu_torch.models import vit
from manga_ocr_tpu_torch.ops.common import tree_device
from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop, greedy_decode_loop_reference


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_len] int32, starts with BOS, PAD after EOS
    lengths: torch.Tensor  # [B] int32 — valid tokens incl. BOS and EOS


def subtree(params, key: str):
    """A tree's subtree ``key``, or each model column's."""
    return [c[key] for c in params] if isinstance(params, list) else params[key]


def _check_columns(params, dcfg) -> None:
    """Model columns decode on the plain step route only: ``ValueError``
    where ``params`` is a list of columns and ``dcfg`` names a kernel."""
    flags = (dcfg.step_kernel, dcfg.head_kernel, dcfg.step_mlp_kernel)
    if isinstance(params, list) and (flags != ("xla",) * 3 or dcfg.cross_kv_int8):
        raise ValueError(f"greedy decode: model columns run the plain step route only, not "
                         f"step/head/step_mlp kernels {flags}, cross_kv_int8="
                         f"{dcfg.cross_kv_int8}")


def encode(
    params, pixel_values: torch.Tensor, cfg: MangaOCRConfig, use_kernels: bool = True
) -> torch.Tensor:
    return vit.encode(subtree(params, "encoder"), pixel_values, cfg.encoder,
                      use_kernels=use_kernels)


def greedy_decode(
    params,
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
    and stop counting.  The cache holds ``cache_len`` positions (whole
    chunks), so the last chunk may run past ``max_length - 1``; the result
    is sliced to ``max_length`` and the lengths clamped.

    ``stop_lengths`` ([B] int32) is the benchmark instrument: rows behave as
    if EOS fired at that length.  ``use_kernels=False`` runs the kernels'
    plain versions on any device."""
    dcfg = cfg.decoder
    _check_columns(params, dcfg)
    max_len = max_length or cfg.max_length
    dtype = enc_out.dtype
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
    step_fn = _stepper(params, enc_out, dcfg, max_len, chunk_size, use_kernels)
    return greedy_loop([step_fn], [enc_out], dcfg, max_len, chunk_size, [stop_lengths])[0]


def cache_len(max_len: int, chunk_size: int) -> int:
    """Positions the step-by-step decode's cache holds: BOS, then whole
    chunks covering ``max_len - 1`` steps."""
    return 1 + -(-(max_len - 1) // chunk_size) * chunk_size


def _stepper(params, enc_out: torch.Tensor, dcfg, max_len: int, chunk_size: int,
             use_kernels: bool):
    """One data row's greedy step ``fn(last_tokens, step) -> next ids [B]
    int32``, with its cross-K/V and its cache (written in place by the
    step) made here: one of each a model column for a list of columns."""
    b, dtype = enc_out.shape[0], enc_out.dtype
    n = cache_len(max_len, chunk_size)
    prepared = None
    if isinstance(params, list):
        _check_columns(params, dcfg)
        decs = subtree(params, "decoder")
        cross = dec.precompute_cross_kv(decs, enc_out, dcfg)
        ccfg = dec.column_cfg(dcfg, len(decs))
        cache = [dec.init_cache(ccfg, b, n, dtype, tree_device(c)) for c in decs]
    else:
        decs = params["decoder"]
        if dcfg.step_kernel == "fused_layer":
            cross = dec.precompute_cross_kv_packed(decs, enc_out, dcfg)
            prepared = dec.prepare_fused_layer(decs, dcfg, dtype)
        else:
            cross = dec.precompute_cross_kv(decs, enc_out, dcfg)
        cache = dec.init_cache(dcfg, b, n, dtype, enc_out.device)
    return lambda last, step: dec.decode_step_greedy(
        decs, last, step, cache, cross, dcfg, use_kernels, prepared)[0]


def _all_done(dones: list) -> bool:
    """Whether every row of every data row is done: one host read (the
    rows' flags put together on the first one's device)."""
    if len(dones) == 1:
        return bool(dones[0].all())
    dev = dones[0].device
    return bool(torch.stack([d.all().to(dev) for d in dones]).all())


def greedy_loop(step_fns: list, enc_outs: list, dcfg, max_len: int, chunk_size: int,
                stop_lengths: list | None = None) -> list:
    """The step-by-step greedy loop over one or several data rows:
    ``step_fns[r](last_tokens, step)`` gives row ``r``'s next ids [B] int32
    (writing its caches in place); at every position each row's step is
    launched in turn; chunks of ``chunk_size`` steps, "every row done" read
    once between chunks across all the rows; PAD after EOS.  One
    ``GreedyResult`` a row, on its encoder output's device."""
    stop_lengths = stop_lengths or [None] * len(enc_outs)
    rows = []
    for enc_out, stop in zip(enc_outs, stop_lengths):
        b, dev = enc_out.shape[0], enc_out.device
        tokens = torch.full((b, cache_len(max_len, chunk_size)), dcfg.pad_token_id,
                            dtype=torch.int32, device=dev)
        tokens[:, 0] = dcfg.bos_token_id
        rows.append({
            "tokens": tokens,
            "last": torch.full((b,), dcfg.bos_token_id, dtype=torch.int32, device=dev),
            "done": torch.zeros((b,), dtype=torch.bool, device=dev),
            "lengths": torch.ones((b,), dtype=torch.int32, device=dev),
            "stops": None if stop is None else torch.as_tensor(stop, device=dev),
            "pad": torch.full((b,), dcfg.pad_token_id, dtype=torch.int32, device=dev),
        })
    step = 0
    while step < max_len - 1 and not _all_done([r["done"] for r in rows]):
        for _ in range(chunk_size):
            for r, step_fn in zip(rows, step_fns):
                done = r["done"]
                nxt = torch.where(done, r["pad"], step_fn(r["last"], step))
                newly = nxt == dcfg.eos_token_id
                if r["stops"] is not None:
                    newly = newly | (step + 2 >= r["stops"])
                r["tokens"][:, step + 1] = nxt
                r["lengths"] += (~done).to(torch.int32)
                r["last"] = nxt
                r["done"] = done | newly
            step += 1
    return [GreedyResult(r["tokens"][:, :max_len], torch.clamp(r["lengths"], max=max_len))
            for r in rows]


def ocr_forward_rows(rows: list, pixel_values: list, cfg: MangaOCRConfig,
                     max_length: int | None = None, chunk_size: int = 8) -> list:
    """``ocr_forward``'s step-by-step route on several data rows at once:
    ``rows[r]`` is a row's params (a tree, or a list of its model columns'),
    ``pixel_values[r]`` its pixels on its (first) device.  Every row's
    encoder and its cross-K/V are launched, then the rows decode in one
    ``greedy_loop``, so that the loop's host read between chunks waits on
    work already queued for every row.  One ``GreedyResult`` a row."""
    max_len = max_length or cfg.max_length
    encs = [encode(p, px, cfg) for p, px in zip(rows, pixel_values)]
    fns = [_stepper(p, e, cfg.decoder, max_len, chunk_size, True) for p, e in zip(rows, encs)]
    return greedy_loop(fns, encs, cfg.decoder, max_len, chunk_size)


def ocr_forward(
    params,
    pixel_values: torch.Tensor,
    cfg: MangaOCRConfig,
    max_length: int | None = None,
    chunk_size: int = 8,
    stop_lengths: torch.Tensor | None = None,
    use_kernels: bool = True,
) -> GreedyResult:
    """pixels [B, H, W, C] (normalized) -> greedy token ids, in the dtype of
    ``pixel_values``.  ``use_kernels=False`` runs the plain versions of the
    kernels on any device.  ``params`` may be a list of a data row's model
    columns (the plain route)."""
    dcfg = cfg.decoder
    _check_columns(params, dcfg)
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
