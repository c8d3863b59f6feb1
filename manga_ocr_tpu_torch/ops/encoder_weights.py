"""The encoder's layer weights in the layouts its CUDA kernels read.

Kernels A (``fused_attn_layer``), B and D (``fused_mlp_block``), H
(``fused_encoder_layer``) and I (``encoder_stack``) read a layer as:

- q|k|v as ONE projection over the concatenated [D, 3D] weights (bit-exact:
  each output column's contraction is unchanged), and o, fc1, fc2;
- int8 weights as ``Int8Weight`` (the int8 GEMM reads the [N, K] copy),
  float weights as [K, N] matrices in the compute dtype, biases, int8
  scales and LayerNorm parameters in f32;

each stacked over layers [L, ...], so that kernel I reads per-layer
pointers into one array and ``layer_view`` hands a single layer to A, B, D
or H without a copy.  ``prepare_layers`` builds them once per parameter
tree: it remembers the last preparation per tree (keyed on the tree's
first leaf, checked against the identity, storage and version counter of
every leaf), so a second encode of the same params prepares nothing, and an
in-place write to a leaf (``copy_``, loading a state into existing
tensors) prepares anew.  Tensors made under ``torch.inference_mode`` keep
no version counter: an in-place write to one of those is not seen, so such
params are replaced, not written over.  Every prepared array is a new
tensor, so the memory holds no reference to the params it was made from.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from manga_ocr_tpu_torch.ops.fused_mlp import Int8Weight, Proj, prepare_proj


class LN(NamedTuple):
    scale: torch.Tensor  # f32 [..., D]
    bias: torch.Tensor


class LayerWeights(NamedTuple):
    """One encoder layer's weights (or L layers', stacked [L, ...])."""

    qkv: Proj
    o: Proj
    ln1: LN
    fc1: Proj
    fc2: Proj
    ln2: LN


def _ln(p: dict) -> LN:
    return LN(p["scale"].to(torch.float32, copy=True), p["bias"].to(torch.float32, copy=True))


def prepare_weights(layer: dict, dtype: torch.dtype) -> LayerWeights:
    """A layer's params (the JAX tree's ``ln1``, ``attn``, ``ln2``, ``mlp``;
    [..] or layer-stacked [L, ..] leaves; each dense float or int8) ->
    ``LayerWeights``, float weights in ``dtype``."""
    attn, mlp = layer["attn"], layer["mlp"]
    return LayerWeights(
        qkv=prepare_proj([attn["q"], attn["k"], attn["v"]], dtype),
        o=prepare_proj([attn["o"]], dtype),
        ln1=_ln(layer["ln1"]),
        fc1=prepare_proj([mlp["fc1"]], dtype),
        fc2=prepare_proj([mlp["fc2"]], dtype),
        ln2=_ln(layer["ln2"]),
    )


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


_PREPARED = WeakIdKeyDictionary()  # first leaf -> (stamp, LayerWeights)


def prepare_layers(layers: dict, dtype: torch.dtype) -> LayerWeights:
    """``prepare_weights`` of a stacked layer tree, once per tree and
    dtype (see the module docstring)."""
    leaves = _leaves(layers)
    stamp = (dtype, tuple((id(t), t.data_ptr(), -1 if t.is_inference() else t._version)
                          for t in leaves))
    hit = _PREPARED.get(leaves[0])
    if hit is not None and hit[0] == stamp:
        return hit[1]
    weights = prepare_weights(layers, dtype)
    _PREPARED[leaves[0]] = (stamp, weights)
    return weights


def _index(t, l: int):
    if t is None or isinstance(t, torch.Tensor):
        return None if t is None else t[l]
    return type(t)(*(_index(u, l) for u in t))


def layer_view(weights: LayerWeights, l: int) -> LayerWeights:
    """Layer ``l`` of stacked ``LayerWeights`` (views, no copy)."""
    return _index(weights, l)


def is_int8(proj: Proj) -> bool:
    return isinstance(proj.w, Int8Weight)


def _flat_proj(proj: Proj) -> list:
    if is_int8(proj):
        return [proj.w.w_t, proj.w.scale, proj.bias]
    return [proj.w, None, proj.bias]


def flat_weights(w: LayerWeights) -> list:
    """The 16 arrays of ``csrc/encoder_layer.cu`` in its slot order: q|k|v,
    o (weight, int8 scales or None, bias), LN1, fc1, fc2, LN2."""
    return [*_flat_proj(w.qkv), *_flat_proj(w.o), *w.ln1, *_flat_proj(w.fc1),
            *_flat_proj(w.fc2), *w.ln2]
