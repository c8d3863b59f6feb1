"""ViT image encoder, serving path (counterpart of ``manga_ocr_tpu/models/vit.py``).

Patch embedding as a reshape + matmul, CLS and position embeddings, then
per layer kernel A (``fused_attn_layer``) and kernel B (``fused_mlp_block``),
then the final LayerNorm.  The JAX serving config pads the sequence 197 ->
200 for TPU sublane alignment and masks the padded keys; the port runs the
197 real tokens unpadded, which gives the same real rows (every op is
row-local except attention, whose masked keys weigh exactly 0).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu.models.config import EncoderConfig
from manga_ocr_tpu_torch.ops.common import dense, layer_norm
from manga_ocr_tpu_torch.ops.flash_attention import fused_attn_layer, fused_attn_layer_reference
from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block, fused_mlp_block_reference


def patch_embed(params: dict, pixel_values: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, D]: patches flattened in (row, col, channel)
    order to match the HWIO conv kernel flattened the same way."""
    b, h, w, c = pixel_values.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    kernel = params["kernel"].reshape(p * p * c, cfg.hidden_size)
    return dense(x, kernel, params["bias"])


def encode(
    params: dict,
    pixel_values: torch.Tensor,
    cfg: EncoderConfig,
    dtype: torch.dtype | None = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """[B, H, W, C] normalized pixels -> [B, S, D] hidden states (S = patches
    + CLS).  Needs the serving config (``config.with_serving_kernels(...,
    quantized=True)``) and int8-quantized layers.  ``use_kernels=False``
    runs the kernels' plain versions on any device (for comparisons on the
    card); on CPU tensors both settings run the plain versions."""
    if cfg.attn_kernel != "fused_layer" or cfg.mlp_kernel != "fused":
        raise NotImplementedError(
            "encode: only the int8 serving path (attn_kernel='fused_layer', "
            "mlp_kernel='fused') is ported"
        )
    attn_fn = fused_attn_layer if use_kernels else fused_attn_layer_reference
    mlp_fn = fused_mlp_block if use_kernels else fused_mlp_block_reference
    dtype = dtype or pixel_values.dtype
    x = patch_embed(params["patch_embed"], pixel_values.to(dtype), cfg)
    b = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    s = x.shape[1]
    layers = params["layers"]
    for l in range(cfg.num_layers):
        attn = {k: {n: t[l] for n, t in v.items()} for k, v in layers["attn"].items()}
        x = attn_fn(
            x, attn, layers["ln1"]["scale"][l], layers["ln1"]["bias"][l], cfg.num_heads,
            eps=cfg.layer_norm_eps, valid_len=s,
        )
        fc1, fc2 = layers["mlp"]["fc1"], layers["mlp"]["fc2"]
        x = mlp_fn(
            x, layers["ln2"]["scale"][l], layers["ln2"]["bias"][l],
            (fc1["w_q"][l], fc1["scale"][l]), fc1["bias"][l],
            (fc2["w_q"][l], fc2["scale"][l]), fc2["bias"][l],
            eps=cfg.layer_norm_eps, gelu_mode=cfg.gelu_mode,
        )
    return layer_norm(
        x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps
    )
