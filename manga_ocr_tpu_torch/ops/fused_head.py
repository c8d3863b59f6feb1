"""Fused greedy LM head (kernel F): transform -> GELU -> LN -> vocab matmul
-> argmax.

Counterpart of ``manga_ocr_tpu/ops/fused_head.py`` ``fused_greedy_head``
(``_head_kernel``), the head of the step-by-step decode when
``head_kernel="fused"``: the f32 transform plus its bias, the erf-polynomial
GELU in f32, LN with f32 statistics, the result cast to the compute dtype
before the vocab product, the f32 vocab bias, and the first maximum winning
within and across 512-wide vocab tiles.  Only the ids [B] leave the kernel.

On CUDA tensors it runs ``csrc/fused_head.cu``, whose device code is kernel
C's head; on CPU tensors ``fused_greedy_head_reference``.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.ops.decode_loop import rows_per_block
from manga_ocr_tpu_torch.ops.kernel_utils import gelu_erf, ln32

VOCAB_TILE = 512


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
    dt = x.dtype
    h = gelu_erf(x.float() @ wt.to(dt).float() + bt.float())
    h = ln32(h, lns, lnb, eps).to(dt)
    return h.float() @ wp.to(dt).float() + bp.float()


def fused_greedy_head_reference(x, wt, bt, lns, lnb, wp, bp, eps: float = 1e-12) -> torch.Tensor:
    """Plain version: the first argmax of ``head_logits_reference``, int32."""
    logits = head_logits_reference(x, wt, bt, lns, lnb, wp, bp, eps)
    return torch.argmax(logits, dim=-1).to(torch.int32)  # first maximum


def _vocab_splits(n_row_blocks: int, vocab: int, device) -> int:
    """Contiguous runs of whole vocab tiles per row block, so that small
    batches still fill the SMs: the fewest splits that give one wave of
    co-resident blocks, each split the same number of tiles."""
    tiles = vocab // VOCAB_TILE
    slots = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    want = min(tiles, max(1, -(-slots // n_row_blocks)))
    per = -(-tiles // want)
    while tiles % per:
        per += 1
    return tiles // per


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
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    vocab = wp.shape[1]
    if vocab % VOCAB_TILE:
        raise ValueError(f"vocab {vocab} not a multiple of {VOCAB_TILE}")
    if x.device.type == "cpu":
        return fused_greedy_head_reference(x, wt, bt, lns, lnb, wp, bp, eps)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_greedy_head: the CUDA kernel takes bf16, got {x.dtype}")
    rows = rows_per_block(x.shape[0], x.device)
    n_split = _vocab_splits(-(-x.shape[0] // rows), vocab, x.device)
    ids = launch.fused_head(
        x.contiguous(), wt.to(torch.bfloat16).contiguous(), bt.float().contiguous(),
        lns.float().contiguous(), lnb.float().contiguous(), wp.to(torch.bfloat16).contiguous(),
        bp.float().contiguous(), eps, n_split, rows,
    )
    fused_greedy_head.launches += 1
    return ids


fused_greedy_head.launches = 0  # launches of the CUDA kernel (CPU calls do not count)
