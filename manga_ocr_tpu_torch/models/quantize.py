"""int8 quantization of the encoder and the decoder (counterpart of
``manga_ocr_tpu/models/quantize.py``).

Each quantized dense becomes ``{"w_q": int8 [L, K, N], "scale": f32 [L, N],
"bias": ...}`` in place of ``{"kernel", "bias"}``.
"""

from __future__ import annotations

from manga_ocr_tpu_torch.ops.quant import quantize_weight_per_col


def _quantize_dense_stacked(p: dict) -> dict:
    """Quantize a stacked [L, K, N] dense, per layer and output column."""
    w_q, scale = quantize_weight_per_col(p["kernel"])
    return {"w_q": w_q, "scale": scale, "bias": p["bias"]}


def quantize_encoder(encoder_params: dict, quantize_attn_proj: bool = False) -> dict:
    """Encoder params with an int8 MLP (and, optionally, int8 attention
    projections — what the serving engine uses)."""
    out = dict(encoder_params)
    layers = dict(encoder_params["layers"])
    mlp = layers["mlp"]
    layers["mlp"] = {
        "fc1": _quantize_dense_stacked(mlp["fc1"]),
        "fc2": _quantize_dense_stacked(mlp["fc2"]),
    }
    if quantize_attn_proj:
        attn = dict(layers["attn"])
        for key in ("q", "k", "v", "o"):
            attn[key] = _quantize_dense_stacked(attn[key])
        layers["attn"] = attn
    out["layers"] = layers
    return out


def quantize_decoder(decoder_params: dict) -> dict:
    """Decoder params with int8 projections for the fused decode step
    (kernels J, K and B): self q/k/v/o, cross q/o and the MLP.  Cross k/v
    stay float (they run once per dispatch in
    ``decoder.precompute_cross_kv_packed``), as do the embeddings and the
    LM head."""
    out = dict(decoder_params)
    layers = dict(decoder_params["layers"])
    sa = dict(layers["self_attn"])
    for key in ("q", "k", "v", "o"):
        sa[key] = _quantize_dense_stacked(sa[key])
    layers["self_attn"] = sa
    ca = dict(layers["cross_attn"])
    for key in ("q", "o"):
        ca[key] = _quantize_dense_stacked(ca[key])
    layers["cross_attn"] = ca
    mlp = layers["mlp"]
    layers["mlp"] = {
        "fc1": _quantize_dense_stacked(mlp["fc1"]),
        "fc2": _quantize_dense_stacked(mlp["fc2"]),
    }
    out["layers"] = layers
    return out
