"""BERT-style decoder pieces of the serving path (counterpart of parts of
``manga_ocr_tpu/models/decoder.py``): the token embedding and the
cross-attention K/V precompute in the packed [L, B, S, D] layout that kernel
C reads.  The greedy loop itself is ``ops/decode_loop.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu.models.config import DecoderConfig
from manga_ocr_tpu_torch.ops.common import dense, layer_norm


class CrossKVPacked(NamedTuple):
    """Cross-attention K/V, heads merged: k/v [L, B, S, D] in the compute
    dtype (the JAX package's int8 form is not ported)."""

    k: torch.Tensor
    v: torch.Tensor


def embed(params: dict, tokens: torch.Tensor, position_offset: int, cfg: DecoderConfig) -> torch.Tensor:
    """Word + absolute position + token-type(0) embeddings, then LN.
    ``tokens``: [B, S] int."""
    s = tokens.shape[-1]
    we = params["tok_embed"][tokens.long()]
    pe = params["pos_embed"][position_offset : position_offset + s]
    x = we + pe + params["tok_type"]
    return layer_norm(x, params["emb_ln"]["scale"], params["emb_ln"]["bias"], cfg.layer_norm_eps)


def precompute_cross_kv_packed(
    params: dict, enc_out: torch.Tensor, cfg: DecoderConfig, int8: bool = False
) -> CrossKVPacked:
    """Project the encoder output to per-layer cross K/V once per dispatch:
    [L, B, S, D] slabs in ``enc_out.dtype``.  ``dense`` is column-independent,
    so per-layer projections equal the JAX package's one wide matmul."""
    if int8:
        raise NotImplementedError("precompute_cross_kv_packed: int8 slabs are not ported")
    ca = params["layers"]["cross_attn"]
    ks, vs = [], []
    for l in range(cfg.num_layers):
        ks.append(dense(enc_out, ca["k"]["kernel"][l], ca["k"]["bias"][l]))
        vs.append(dense(enc_out, ca["v"]["kernel"][l], ca["v"]["bias"][l]))
    return CrossKVPacked(torch.stack(ks), torch.stack(vs))
