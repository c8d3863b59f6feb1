"""Operations and bytes of the model and of its kernels, from shapes alone,
and the card's published peaks.

The model's FLOPs (a product of [m, k] by [k, n] is 2 m k n) count what one
crop needs: the encoder over its real tokens, the cross-attention keys and
values once, and each decode step with self-attention over the keys that
step has (1 at the first, a triangle over the row), not a full cache.

A kernel family's lower bound is the least time of the function that the
family computes over the window's returned crops, whatever the program's
batching: its operations over the peak of their type, or its bytes over
the memory's bandwidth, whichever is larger, with each byte counted once:
what enters the family, what leaves it, and its weights once for the
window; nothing that the family writes between its own launches.  Padding
rows are the program's choice and are not counted, so a program that pads
less reads a higher share, and no program can read above 100%.
"""

from __future__ import annotations

from perfbench.reference.dims import Dims

# NVIDIA H100 SXM, published dense peaks (no sparsity), at its 700 W limit
PEAK_BF16 = 989e12  # FLOP/s, bf16 and fp16 tensor cores
PEAK_INT8 = 1979e12  # OP/s, int8 tensor cores
HBM_BYTES_S = 3.35e12  # B/s


def encoder_flops(dims: Dims) -> float:
    """One crop's encoder: the patch embedding and every block."""
    e = dims.encoder
    s, d, i = e.seq_len, e.hidden, e.intermediate
    patch = 2 * (s - 1) * (e.patch_size ** 2 * e.channels) * d
    block = 2 * s * d * 4 * d + 2 * 2 * s * s * d + 2 * 2 * s * d * i
    return float(patch + e.layers * block)


def decode_flops(dims: Dims, steps: int) -> float:
    """One crop's cross-attention keys and values and ``steps`` greedy
    steps (the tokens after BOS), self-attention over a growing cache."""
    d_ = dims.decoder
    d, i, v, s = d_.hidden, d_.intermediate, d_.vocab, dims.encoder.seq_len
    cross_kv = d_.layers * 2 * 2 * s * d * d
    per_step = d_.layers * (2 * 4 * d * d + 2 * 2 * d * d + 2 * 2 * s * d + 2 * 2 * d * i)
    keys = steps * (steps + 1) // 2  # step t attends t + 1 keys
    self_attn = d_.layers * 2 * 2 * d * keys
    head = steps * (2 * d * d + 2 * d * v)
    return float(cross_kv + steps * per_step + self_attn + head)


def crop_flops(dims: Dims, steps: int) -> float:
    return encoder_flops(dims) + decode_flops(dims, steps)


def _floor(ops_int8: float = 0.0, ops_bf16: float = 0.0, nbytes: float = 0.0) -> float:
    return max(ops_int8 / PEAK_INT8 + ops_bf16 / PEAK_BF16, nbytes / HBM_BYTES_S)


def encoder_bound_s(dims: Dims, rows: int, form: str) -> float:
    """Least seconds of the encoder family's kernels on ``rows`` crops.

    ``form`` "int8" (kernels A and B run the whole block, LayerNorms to
    fc2): the four projections' products at the int8 peak, and the
    attention core's there too (a floor holds whatever type the core
    takes); bytes: the block's input and output (the bf16 residual stream)
    and its int8 weights.  "bf16" (kernel E's attention core, kernel D's
    MLP block; the q/k/v/o projections run outside the family as f32
    products): the core's and the MLP's products at the bf16 peak; bytes:
    the core's q, k and v in and its context out, the MLP block's input and
    output, its bf16 weights."""
    e = dims.encoder
    s, d, i, layers = e.seq_len, e.hidden, e.intermediate, e.layers
    m = rows * s
    attn = 2 * 2 * rows * s * s * d
    mlp = 2 * 2 * m * d * i
    if form == "int8":
        ops = layers * (2 * m * d * 4 * d + mlp + attn)
        nbytes = layers * (2 * m * d * 2 + 4 * d * d + 2 * d * i)
        return _floor(ops_int8=ops, nbytes=nbytes)
    if form == "bf16":
        ops = layers * (attn + mlp)
        nbytes = layers * (m * 4 * d * 2 + 2 * m * d * 2 + 2 * d * i * 2)
        return _floor(ops_bf16=ops, nbytes=nbytes)
    raise ValueError(f"encoder form {form!r}")


def decode_bound_s(dims: Dims, row_steps: list[int]) -> float:
    """Least seconds of kernel C over rows that ran ``row_steps`` steps each:
    the decode's products in bf16 (not the cross-attention slabs', made
    before it); bytes: its bf16 weights, each row's slabs and its tokens."""
    d_ = dims.decoder
    d, i, v, s = d_.hidden, d_.intermediate, d_.vocab, dims.encoder.seq_len
    slabs = d_.layers * 2 * 2 * s * d * d
    ops = sum(decode_flops(dims, n) - slabs for n in row_steps)
    weights = d_.layers * (6 * d * d + 2 * d * i) + d * d + d * v
    nbytes = 2 * weights + sum(d_.layers * 2 * s * d * 2 + 4 * n for n in row_steps)
    return _floor(ops_bf16=ops, nbytes=nbytes)
