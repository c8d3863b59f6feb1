"""Fused greedy LM head (kernel F): transform -> GELU -> LN -> vocab matmul
-> argmax.

Counterpart of ``manga_ocr_tpu/ops/fused_head.py`` ``fused_greedy_head``
(``_head_kernel``), the head of the step-by-step decode when
``head_kernel="fused"``: the f32 transform plus its bias, the erf-polynomial
GELU in f32, LN with f32 statistics, the result cast to the compute dtype
before the vocab product, the f32 vocab bias, and the first maximum winning
within and across 512-wide vocab tiles.  Only the ids [B] leave the kernel.

On CUDA tensors it runs ``csrc/fused_head.cu``: the transform on the bf16
GEMM (tensor cores), a GELU + LN row pass, the vocab product on the same
pipeline with the argmax taken in its epilogue (one partial per row and
64-column slot; the logits never reach memory), and a reduce of the
partials in column order.  Each piece has its plain version here
(``head_rows_reference``, ``vocab_partials_reference``,
``reduce_partials_reference``; the transform's is
``fused_mlp.bf16_gemm_reference``).  On CPU tensors the wrapper takes
``fused_greedy_head_reference``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops import encoder_weights as ew
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_erf, ln32

VOCAB_TILE = 512
VOCAB_SLOT = launch.HEAD_SLOT  # vocab columns per partial of the vocab product


def head_rows_reference(h: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """The row pass: f32 transform rows [B, D] -> ``LN(gelu_erf(h))`` in f32
    (the kernel casts it to bf16)."""
    return ln32(gelu_erf(h.float()), lns, lnb, eps)


def head_hidden_reference(x, wt, bt, lns, lnb, eps: float = 1e-12) -> torch.Tensor:
    """``_head_kernel``'s hidden rows [B, D] in f32, before their cast to
    ``x.dtype``: the transform, the GELU and LN in one expression."""
    return ln32(gelu_erf(x.float() @ wt.to(x.dtype).float() + bt.float()), lns, lnb, eps)


def head_logits_reference(
    x: torch.Tensor,
    wt: torch.Tensor,
    bt: torch.Tensor,
    lns: torch.Tensor,
    lnb: torch.Tensor,
    wp: torch.Tensor,
    bp: torch.Tensor,
    eps: float = 1e-12,
) -> torch.Tensor:
    """The f32 vocab logits [B, V] that ``_head_kernel`` takes the argmax of."""
    h = head_hidden_reference(x, wt, bt, lns, lnb, eps).to(x.dtype)
    return h.float() @ wp.to(x.dtype).float() + bp.float()


def fused_greedy_head_reference(x, wt, bt, lns, lnb, wp, bp, eps: float = 1e-12) -> torch.Tensor:
    """Plain version: the first argmax of ``head_logits_reference``, int32."""
    logits = head_logits_reference(x, wt, bt, lns, lnb, wp, bp, eps)
    return torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum


def vocab_partials_reference(logits: torch.Tensor, slot: int = VOCAB_SLOT):
    """The vocab product's epilogue: logits [B, V] -> (value [B, V / slot]
    f32, column [B, V / slot] int32), the first maximum of each row's
    ``slot``-column slot."""
    b, v = logits.shape
    at = torch.argmax(logits.view(b, v // slot, slot), dim=-1)  # first maximum
    value = torch.gather(logits.view(b, v // slot, slot), 2, at[..., None])[..., 0]
    col = at + torch.arange(0, v, slot, device=logits.device)
    return value, col.to(torch.int32)


def reduce_partials_reference(value: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The reduce: per row, the slots in column order, a later one taken
    only when strictly larger -> ids [B] int32."""
    best_v, best_i = value[:, 0], col[:, 0]
    for s in range(1, value.shape[1]):
        upd = value[:, s] > best_v
        best_v = torch.where(upd, value[:, s], best_v)
        best_i = torch.where(upd, col[:, s], best_i)
    return best_i.to(torch.int32)


class HeadWeights(NamedTuple):
    """The head's params as the kernels read them: bf16 [K, N] matrices,
    f32 vectors, each a new contiguous tensor."""

    wt: torch.Tensor
    bt: torch.Tensor
    lns: torch.Tensor
    lnb: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor


def prepare_head(wt, bt, lns, lnb, wp, bp) -> HeadWeights:
    """``HeadWeights`` of the head's params, made once per set of params
    (``encoder_weights.prepared``: a second call on the same tensors
    prepares nothing, an in-place write to one of them prepares anew)."""
    tree = {"wt": wt, "bt": bt, "lns": lns, "lnb": lnb, "wp": wp, "bp": bp}

    def make():
        def f32(t):
            return t.to(torch.float32, copy=True).contiguous()

        return HeadWeights(wt.to(torch.bfloat16, copy=True).contiguous(), f32(bt), f32(lns),
                           f32(lnb), wp.to(torch.bfloat16, copy=True).contiguous(), f32(bp))

    return ew.prepared(tree, ("fused_head",), make)


def fused_greedy_head(
    x: torch.Tensor,  # [B, D]
    wt: torch.Tensor,  # [D, D] transform dense kernel
    bt: torch.Tensor,  # [D]
    lns: torch.Tensor,  # [D] LN scale
    lnb: torch.Tensor,  # [D] LN bias
    wp: torch.Tensor,  # [D, V] vocab projection
    bp: torch.Tensor,  # [V]
    eps: float = 1e-12,
) -> torch.Tensor:
    """Argmax token ids [B] int32.  The vocab must be a multiple of the
    512-wide tile, as the JAX kernel asserts (manga-ocr: 6144 = 12 x 512).
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (bf16 x, D a multiple of 64: ``launch.fused_head``; else ValueError)."""
    vocab = wp.shape[1]
    if vocab % VOCAB_TILE:
        raise ValueError(f"vocab {vocab} not a multiple of {VOCAB_TILE}")
    if x.device.type == "cpu":
        return fused_greedy_head_reference(x, wt, bt, lns, lnb, wp, bp, eps)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_greedy_head: the CUDA kernel takes bf16, got {x.dtype}")
    ids = launch.fused_head(x.contiguous(), *prepare_head(wt, bt, lns, lnb, wp, bp), eps)
    fused_greedy_head.launches += 1
    return ids


fused_greedy_head.launches = 0  # launches of the CUDA kernels (CPU calls do not count)
