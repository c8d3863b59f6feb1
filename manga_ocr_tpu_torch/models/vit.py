"""ViT image encoder (counterpart of ``manga_ocr_tpu/models/vit.py``).

Patch embedding as a reshape + matmul, CLS and position embeddings, the
pre-LN blocks, then the final LayerNorm.  A block dispatches on the config
as the JAX ``encoder_block`` does:

- ``attn_kernel="fused_layer"``: kernel A (``fused_attn_layer``, int8
  projections) for x + Attn(LN1(x));
- ``attn_kernel="packed"``: LN1, the bf16 projections around kernel E
  (``mha_packed``), and the residual;
- ``attn_kernel="xla"``: LN1, the reference ``mha`` and the residual;

then the MLP half: ``mlp_kernel="fused"`` runs ``fused_mlp_block`` (kernel
B for int8 weights, kernel D for bf16 ones), ``"xla"`` the reference LN ->
dense -> exact-erf GELU -> dense -> residual.  ``merged_layer`` and
``stacked`` (kernels H and I) are not ported and raise.

The JAX int8 serving config pads the sequence 197 -> 200 for TPU sublane
alignment and masks the padded keys; the port runs the 197 real tokens
unpadded, which gives the same real rows (every op is row-local except
attention, whose masked keys weigh exactly 0).
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.models.config import EncoderConfig
from manga_ocr_tpu_torch.models.params import layer_params
from manga_ocr_tpu_torch.ops.common import dense, dense_any, gelu, layer_norm, mha
from manga_ocr_tpu_torch.ops.flash_attention import (
    fused_attn_layer,
    fused_attn_layer_reference,
    mha_packed,
)
from manga_ocr_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_bf16_reference,
    fused_mlp_block_reference,
)

_ATTN_KERNELS = ("fused_layer", "packed", "xla")
_MLP_KERNELS = ("fused", "xla")


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


def _mlp(x: torch.Tensor, lp: dict, cfg: EncoderConfig, use_kernels: bool) -> torch.Tensor:
    """LN -> fc1 -> GELU -> fc2 -> + residual (the block's second half)."""
    fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
    if cfg.mlp_kernel == "fused":
        int8 = "w_q" in fc1
        w1 = (fc1["w_q"], fc1["scale"]) if int8 else fc1["kernel"]
        w2 = (fc2["w_q"], fc2["scale"]) if int8 else fc2["kernel"]
        if use_kernels:
            fn = fused_mlp_block
        else:
            fn = fused_mlp_block_reference if int8 else fused_mlp_block_bf16_reference
        return fn(x, lp["ln2"]["scale"], lp["ln2"]["bias"], w1, fc1["bias"], w2, fc2["bias"],
                  eps=cfg.layer_norm_eps, gelu_mode=cfg.gelu_mode)
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], cfg.layer_norm_eps)
    h = dense_any(gelu(dense_any(h, fc1)), fc2)
    return x + h


def encoder_block(x: torch.Tensor, lp: dict, cfg: EncoderConfig, use_kernels: bool = True):
    """One pre-LN ViT block."""
    if cfg.attn_kernel == "fused_layer":
        attn_fn = fused_attn_layer if use_kernels else fused_attn_layer_reference
        x = attn_fn(
            x, lp["attn"], lp["ln1"]["scale"], lp["ln1"]["bias"], cfg.num_heads,
            eps=cfg.layer_norm_eps, valid_len=min(cfg.seq_len, x.shape[1]),
        )
        return _mlp(x, lp, cfg, use_kernels)
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], cfg.layer_norm_eps)
    if cfg.attn_kernel == "packed":
        x = x + mha_packed(h, h, lp["attn"], cfg.num_heads, use_kernels=use_kernels)
    else:
        x = x + mha(h, h, lp["attn"], cfg.num_heads)
    return _mlp(x, lp, cfg, use_kernels)


def encode(
    params: dict,
    pixel_values: torch.Tensor,
    cfg: EncoderConfig,
    dtype: torch.dtype | None = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """[B, H, W, C] normalized pixels -> [B, S, D] hidden states (S = patches
    + CLS).  ``use_kernels=False`` runs the kernels' plain versions on any
    device (for comparisons on the card); on CPU tensors both settings run
    the plain versions."""
    if cfg.attn_kernel not in _ATTN_KERNELS or cfg.mlp_kernel not in _MLP_KERNELS:
        raise NotImplementedError(
            f"encode: attn_kernel={cfg.attn_kernel!r} / mlp_kernel={cfg.mlp_kernel!r} is not "
            f"ported (attn_kernel in {_ATTN_KERNELS}, mlp_kernel in {_MLP_KERNELS})"
        )
    dtype = dtype or pixel_values.dtype
    x = patch_embed(params["patch_embed"], pixel_values.to(dtype), cfg)
    b = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    for l in range(cfg.num_layers):
        x = encoder_block(x, layer_params(params["layers"], l), cfg, use_kernels)
    return layer_norm(
        x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps
    )
