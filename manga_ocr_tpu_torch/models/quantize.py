"""int8 quantization of the encoder (counterpart of
``manga_ocr_tpu/models/quantize.py`` ``quantize_encoder``).

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
