"""ViT image encoder (counterpart of ``manga_ocr_tpu/models/vit.py``).

Patch embedding as a reshape + matmul, CLS and position embeddings, the
pre-LN blocks, then the final LayerNorm.  A block dispatches on the config
as the JAX ``encoder_block`` does:

- ``attn_kernel="merged_layer"``: kernel H (``fused_encoder_layer``) runs
  the whole block, int8 or bf16, with the GELU of ``gelu_mode``
  (``mlp_kernel`` is ignored);
- ``attn_kernel="fused_layer"``: kernel A (``fused_attn_layer``, int8 or
  float projections, with the config's variant flags) for
  x + Attn(LN1(x));
- ``attn_kernel="packed"``: LN1, the bf16 projections around kernel E
  (``mha_packed``), and the residual;
- ``attn_kernel="xla"``: LN1, the reference ``mha`` (or, with
  ``encode(fused_attention=True)``, the projections around kernel G,
  ``mha_fused``) and the residual;

then, except under ``merged_layer``, the MLP half: ``mlp_kernel="fused"``
runs ``fused_mlp_block`` (kernel B for int8 weights, kernel D for bf16
ones), ``"xla"`` the reference LN -> dense -> exact-erf GELU -> dense ->
residual.  ``attn_kernel="stacked"`` runs every block through kernel I
(``encoder_stack``, ``stack_lpc`` layers per call) instead.

On CUDA with the kernels on, the ``fused_layer`` and ``merged_layer``
blocks read their weights prepared once per params
(``ops.encoder_weights``), and ``merged_layer``'s blocks share one scratch
set allocated once per encode.

The JAX int8 serving config pads the sequence 197 -> 200 for TPU sublane
alignment (``seq_pad_to``, under ``fused_layer`` only) and masks the padded
keys; the port runs the 197 real tokens unpadded, which gives the same real
rows (every op is row-local except attention, whose masked keys weigh
exactly 0).

Tensor parallelism: ``encode`` also takes a list of a data row's model
columns (``parallel.mesh.shard_params``' encoder trees) on the plain route
(``attn_kernel``/``mlp_kernel`` "xla"): the patch embedding's hidden-dim
slices put together in column order, the blocks' ``mha`` and ``mlp`` over
the columns, the replicated work (CLS, positions, LNs, residuals) once on
column 0's device.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.kernels import launch
from manga_ocr_tpu_torch.models.config import EncoderConfig
from manga_ocr_tpu_torch.models.params import layer_params
from manga_ocr_tpu_torch.ops.common import (
    columns,
    dense,
    layer_norm,
    mha,
    mlp,
    spread,
    tree_device,
)
from manga_ocr_tpu_torch.ops.encoder_stack import encoder_stack, encoder_stack_reference
from manga_ocr_tpu_torch.ops.encoder_weights import LayerWeights, layer_view, prepare_layers
from manga_ocr_tpu_torch.ops.flash_attention import (
    fused_attn_layer,
    fused_attn_layer_reference,
    fused_encoder_layer,
    fused_encoder_layer_reference,
    mha_fused,
    mha_packed,
)
from manga_ocr_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_bf16_reference,
    fused_mlp_block_reference,
)

_ATTN_KERNELS = ("merged_layer", "fused_layer", "packed", "xla", "stacked")
_MLP_KERNELS = ("fused", "xla")
# the kernels whose CUDA path reads ops.encoder_weights
_PREPARED_KERNELS = ("fused_layer", "merged_layer")


def patches(pixel_values: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C]: patches flattened in (row, col,
    channel) order to match the HWIO conv kernel flattened the same way."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // p, w // p
    x = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def patch_embed(params, pixel_values: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, D]: ``patches`` times the flattened kernel.
    ``params`` may be a list of model columns' (each a slice of the hidden
    dim), whose outputs are put together in column order on column 0's
    device."""
    cols = columns(params)
    x = patches(pixel_values, cfg.patch_size)
    devices = [tree_device(c) for c in cols]
    parts = [dense(xc, c["kernel"].reshape(x.shape[-1], -1), c["bias"])
             for xc, c in zip(spread(x, devices), cols)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([t.to(devices[0]) for t in parts], dim=-1)


def _attention(h: torch.Tensor, cols: list, cfg: EncoderConfig, fused: bool, use_kernels: bool):
    if cfg.attn_kernel == "packed":
        return mha_packed(h, h, cols[0]["attn"], cfg.num_heads, use_kernels=use_kernels)
    if fused:
        return mha_fused(h, h, cols[0]["attn"], cfg.num_heads, use_kernels=use_kernels)
    return mha(h, h, [c["attn"] for c in cols], cfg.num_heads)


def _mlp(
    x: torch.Tensor, cols: list, cfg: EncoderConfig, use_kernels: bool,
    prepared: LayerWeights | None,
) -> torch.Tensor:
    """LN -> fc1 -> GELU -> fc2 -> + residual (the block's second half)."""
    lp = cols[0]
    fc1, fc2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
    if cfg.mlp_kernel == "fused":
        int8 = "w_q" in fc1
        w1 = (fc1["w_q"], fc1["scale"]) if int8 else fc1["kernel"]
        w2 = (fc2["w_q"], fc2["scale"]) if int8 else fc2["kernel"]
        if prepared is not None:
            w1, w2 = prepared.fc1.w, prepared.fc2.w
        if use_kernels:
            fn = fused_mlp_block
        else:
            fn = fused_mlp_block_reference if int8 else fused_mlp_block_bf16_reference
        return fn(x, lp["ln2"]["scale"], lp["ln2"]["bias"], w1, fc1["bias"], w2, fc2["bias"],
                  eps=cfg.layer_norm_eps, gelu_mode=cfg.gelu_mode)
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], cfg.layer_norm_eps)
    return x + mlp(h, [c["mlp"] for c in cols])


def encoder_block(
    x: torch.Tensor,
    lp,
    cfg: EncoderConfig,
    use_kernels: bool = True,
    fused: bool = False,
    prepared: LayerWeights | None = None,
    scratch: tuple | None = None,
) -> torch.Tensor:
    """One pre-LN ViT block.  ``prepared`` (this layer's
    ``ops.encoder_weights``) and ``scratch`` (kernel H's) are optional: the
    kernels make them on the call when they are not given.  ``lp`` may be a
    list of model columns' layer params (the plain route only)."""
    cols = columns(lp)
    lp = cols[0]
    eps = cfg.layer_norm_eps
    if cfg.attn_kernel == "merged_layer":
        if not use_kernels:
            return fused_encoder_layer_reference(x, lp, cfg.num_heads, eps, cfg.gelu_mode)
        return fused_encoder_layer(x, lp, cfg.num_heads, eps, cfg.gelu_mode, prepared, scratch)
    if cfg.attn_kernel == "fused_layer":
        flags = dict(
            fuse_qkv=cfg.attn_fuse_qkv, batched_sdpa=cfg.batched_sdpa,
            sdpa_int8=cfg.attn_sdpa_int8, sdpa_headpack=cfg.attn_sdpa_headpack,
            parallel_grid=cfg.parallel_grid,
        )
        args = (x, lp["attn"], lp["ln1"]["scale"], lp["ln1"]["bias"], cfg.num_heads, eps,
                min(cfg.seq_len, x.shape[1]))
        if use_kernels:
            attn = None if prepared is None else (prepared.qkv, prepared.o)
            x = fused_attn_layer(*args, prepared=attn, **flags)
        else:
            x = fused_attn_layer_reference(*args, **flags)
        return _mlp(x, cols, cfg, use_kernels, prepared)
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    x = x + _attention(h, cols, cfg, fused, use_kernels)
    return _mlp(x, cols, cfg, use_kernels, prepared)


def _default_fused() -> bool:
    """Whether ``encode`` runs kernel G by default under
    ``attn_kernel="xla"``: off, as in the JAX package; per call with
    ``encode(..., fused_attention=True)``."""
    return False


def encode(
    params,
    pixel_values: torch.Tensor,
    cfg: EncoderConfig,
    dtype: torch.dtype | None = None,
    use_kernels: bool = True,
    fused_attention: bool | None = None,
    raw_padded: bool = False,
) -> torch.Tensor:
    """[B, H, W, C] normalized pixels -> [B, S, D] hidden states (S = patches
    + CLS).  ``use_kernels=False`` runs the kernels' plain versions on any
    device (for comparisons on the card); on CPU tensors both settings run
    the plain versions.  ``fused_attention``: kernel G for the
    ``attn_kernel="xla"`` blocks (default ``_default_fused()``).

    ``raw_padded``: the stack's output BEFORE the final LayerNorm, for the
    decode's ``fuse_kv`` form (kernel C applies the final LN itself).  The
    JAX package returns its seq-padded rows there (200 under the int8
    serving config, the pads row-local garbage that the decode masks); the
    port never pads, so its raw output has the ``seq_len`` = 197 real rows
    only.

    ``params`` may be a list of a data row's model columns' encoder trees
    (tensor parallelism; the plain route only, else ``ValueError``); the
    output is then on column 0's device."""
    cols = columns(params)
    params = cols[0]
    fused = _default_fused() if fused_attention is None else fused_attention
    if len(cols) > 1 and (cfg.attn_kernel, cfg.mlp_kernel, fused) != ("xla", "xla", False):
        raise ValueError(f"encode: model columns run the plain route only, not attn_kernel="
                         f"{cfg.attn_kernel!r}, mlp_kernel={cfg.mlp_kernel!r}, fused_attention="
                         f"{fused}")
    if cfg.attn_kernel not in _ATTN_KERNELS or cfg.mlp_kernel not in _MLP_KERNELS:
        raise NotImplementedError(
            f"encode: attn_kernel={cfg.attn_kernel!r} / mlp_kernel={cfg.mlp_kernel!r} is not "
            f"ported (attn_kernel in {_ATTN_KERNELS}, mlp_kernel in {_MLP_KERNELS})"
        )
    dtype = dtype or pixel_values.dtype
    x = patch_embed([c["patch_embed"] for c in cols], pixel_values.to(dtype), cfg)
    b = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
    layers = params["layers"]
    if cfg.attn_kernel == "stacked":
        stack = encoder_stack if use_kernels else encoder_stack_reference
        x = stack(x, layers, cfg.num_heads, eps=cfg.layer_norm_eps, lpc=cfg.stack_lpc,
                  gelu_mode=cfg.gelu_mode)
    else:
        prepared = scratch = None
        if use_kernels and x.device.type == "cuda" and cfg.attn_kernel in _PREPARED_KERNELS:
            prepared = prepare_layers(layers, x.dtype)
            if cfg.attn_kernel == "merged_layer":
                scratch = launch.encoder_scratch(
                    b * x.shape[1], cfg.hidden_size, cfg.intermediate_size,
                    "w_q" in layers["attn"]["q"], x.device,
                )
        for l in range(cfg.num_layers):
            lw = None if prepared is None else layer_view(prepared, l)
            lps = [layer_params(c["layers"], l) for c in cols]
            x = encoder_block(x, lps, cfg, use_kernels, fused, lw, scratch)
    if raw_padded:
        return x
    return layer_norm(
        x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.layer_norm_eps
    )
