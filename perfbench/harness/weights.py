"""Random weights from the seed, made on the device.

The tree has the layout that both the program and the reference read:
nested dicts of layer-stacked ``[L, ...]`` tensors (the JAX package's
layout, which the port keeps).  Every weight matrix and embedding is
N(0, std); LayerNorm scales are 1 and every bias 0.  All normal draws come
from ONE ``torch.randn`` call of a ``torch.Generator`` on the device, seeded
with the run's seed, and the leaves are views of that buffer in a fixed
order, so the same seed gives the same weights on every run.
"""

from __future__ import annotations

import torch

from perfbench.reference.dims import Dims

# (kind, shape) leaves; kind "normal" is drawn, "ones" and "zeros" are filled
_N, _ONE, _ZERO = "normal", "ones", "zeros"


def layout(dims: Dims) -> dict:
    """The tree's leaves as ``(kind, shape)``."""
    e, d = dims.encoder, dims.decoder

    def proj(layers, din, dout):
        return {"kernel": (_N, (layers, din, dout)), "bias": (_ZERO, (layers, dout))}

    def ln(*lead, width):
        return {"scale": (_ONE, (*lead, width)), "bias": (_ZERO, (*lead, width))}

    le, ld = e.layers, d.layers
    encoder = {
        "patch_embed": {"kernel": (_N, (e.patch_size, e.patch_size, e.channels, e.hidden)),
                        "bias": (_ZERO, (e.hidden,))},
        "cls_token": (_N, (1, 1, e.hidden)),
        "pos_embed": (_N, (1, e.seq_len, e.hidden)),
        "layers": {
            "ln1": ln(le, width=e.hidden),
            "attn": {k: proj(le, e.hidden, e.hidden) for k in ("q", "k", "v", "o")},
            "ln2": ln(le, width=e.hidden),
            "mlp": {"fc1": proj(le, e.hidden, e.intermediate),
                    "fc2": proj(le, e.intermediate, e.hidden)},
        },
        "final_ln": ln(width=e.hidden),
    }
    decoder = {
        "tok_embed": (_N, (d.vocab, d.hidden)),
        "pos_embed": (_N, (d.positions, d.hidden)),
        "tok_type": (_N, (d.hidden,)),
        "emb_ln": ln(width=d.hidden),
        "layers": {
            "self_attn": {k: proj(ld, d.hidden, d.hidden) for k in ("q", "k", "v", "o")},
            "self_ln": ln(ld, width=d.hidden),
            "cross_attn": {k: proj(ld, d.hidden, d.hidden) for k in ("q", "k", "v", "o")},
            "cross_ln": ln(ld, width=d.hidden),
            "mlp": {"fc1": proj(ld, d.hidden, d.intermediate),
                    "fc2": proj(ld, d.intermediate, d.hidden)},
            "mlp_ln": ln(ld, width=d.hidden),
        },
        "head": {
            "transform": {"dense": {"kernel": (_N, (d.hidden, d.hidden)),
                                    "bias": (_ZERO, (d.hidden,))},
                          "ln": ln(width=d.hidden)},
            "proj": {"kernel": (_N, (d.hidden, d.vocab)), "bias": (_ZERO, (d.vocab,))},
        },
    }
    return {"encoder": encoder, "decoder": decoder}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def normal_count(dims: Dims) -> int:
    """How many numbers the one normal draw makes."""
    total = 0
    for _, (kind, shape) in _leaves(layout(dims)):
        if kind == _N:
            n = 1
            for s in shape:
                n *= s
            total += n
    return total


def make(dims: Dims, seed: int, std: float, device) -> dict:
    """The float32 tree on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(normal_count(dims), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(std)
    tree: dict = {}
    offset = 0
    for path, (kind, shape) in _leaves(layout(dims)):
        if kind == _N:
            n = 1
            for s in shape:
                n *= s
            leaf = flat[offset:offset + n].view(shape)
            offset += n
        elif kind == _ONE:
            leaf = torch.ones(shape, device=device)
        else:
            leaf = torch.zeros(shape, device=device)
        _set(tree, path, leaf)
    return tree
