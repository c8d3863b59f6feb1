"""The weight bridge between the JAX package's parameter tree and the port.

Both packages use the same tree: nested dicts of stacked ``[L, ...]``
arrays (``manga_ocr_tpu/models/vit.py`` and ``decoder.py`` ``init_params``),
with quantized denses as ``{"w_q", "scale", "bias"}``.  The port keeps that
layout, with torch tensors as leaves, so a checkpoint converted for the JAX
package, or random weights made once with numpy, run identically in both.
"""

from __future__ import annotations

import numpy as np
import torch

from manga_ocr_tpu_torch.models.config import DecoderConfig, EncoderConfig, MangaOCRConfig


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 (numpy has no native one)
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX arrays are read-only


def params_from_jax(tree, device) -> dict:
    """JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``, a loaded checkpoint, or ``init_params_numpy``) -> the same
    tree of torch tensors on ``device`` with identical values."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _to_tensor(tree, device)


def layer_params(tree, l: int):
    """Layer ``l`` of a stacked [L, ...] parameter tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def _encoder_numpy(cfg: EncoderConfig, rng: np.random.Generator, std: float) -> dict:
    d, i, l, p = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.patch_size

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float32)

    def ln():
        return {"scale": np.ones((l, d), np.float32), "bias": np.zeros((l, d), np.float32)}

    def proj(din, dout):
        return {"kernel": w(l, din, dout), "bias": np.zeros((l, dout), np.float32)}

    return {
        "patch_embed": {"kernel": w(p, p, cfg.num_channels, d), "bias": np.zeros((d,), np.float32)},
        "cls_token": w(1, 1, d),
        "pos_embed": w(1, cfg.seq_len, d),
        "layers": {
            "ln1": ln(),
            "attn": {k: proj(d, d) for k in ("q", "k", "v", "o")},
            "ln2": ln(),
            "mlp": {"fc1": proj(d, i), "fc2": proj(i, d)},
        },
        "final_ln": {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)},
    }


def _decoder_numpy(cfg: DecoderConfig, rng: np.random.Generator, std: float) -> dict:
    d, i, l, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float32)

    def ln(stacked=True):
        shape = (l, d) if stacked else (d,)
        return {"scale": np.ones(shape, np.float32), "bias": np.zeros(shape, np.float32)}

    def proj(din, dout):
        return {"kernel": w(l, din, dout), "bias": np.zeros((l, dout), np.float32)}

    def attn():
        return {k: proj(d, d) for k in ("q", "k", "v", "o")}

    return {
        "tok_embed": w(v, d),
        "pos_embed": w(cfg.max_position_embeddings, d),
        "tok_type": w(d),
        "emb_ln": ln(stacked=False),
        "layers": {
            "self_attn": attn(),
            "self_ln": ln(),
            "cross_attn": attn(),
            "cross_ln": ln(),
            "mlp": {"fc1": proj(d, i), "fc2": proj(i, d)},
            "mlp_ln": ln(),
        },
        "head": {
            "transform": {
                "dense": {"kernel": w(d, d), "bias": np.zeros((d,), np.float32)},
                "ln": ln(stacked=False),
            },
            "proj": {"kernel": w(d, v), "bias": np.zeros((v,), np.float32)},
        },
    }


def init_params_numpy(cfg: MangaOCRConfig, seed: int, std: float = 0.02) -> dict:
    """Random weights as a numpy tree in the JAX package's layout: feed it to
    either package.  Weight matrices and embeddings are N(0, std) (0.02 is
    the HF-like init); LN scales are 1 and biases 0.  A larger ``std`` gives
    random models whose outputs depend visibly on the input image."""
    rng = np.random.default_rng(seed)
    return {
        "encoder": _encoder_numpy(cfg.encoder, rng, std),
        "decoder": _decoder_numpy(cfg.decoder, rng, std),
    }


def init_params(cfg: MangaOCRConfig, seed: int, device, std: float = 0.02) -> dict:
    """``init_params_numpy`` as torch tensors on ``device``."""
    return params_from_jax(init_params_numpy(cfg, seed, std), device)
