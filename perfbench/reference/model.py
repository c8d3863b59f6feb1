"""The plain reference of manga-ocr-base (``VisionEncoderDecoderModel``: a
ViT encoder and a BERT decoder with cross-attention), in float32 PyTorch.

Host preparation, as the published model's users feed it: the BGR crop to
gray (OpenCV's fixed-point weights), turned 90 degrees clockwise where the
orientation is vertical and the crop is wider than tall, resized to the
encoder's input with an antialiased triangle filter over the crop's own
extent, scaled to [-1, 1], repeated to three channels.

Encoder: the patch embedding as a product of flattened (row, column,
channel) patches, the CLS token and positions, pre-LN blocks (multi-head
self-attention, then fc1 -> GELU -> fc2), a final LayerNorm.  Decoder:
token, position and token-type embeddings with a LayerNorm, post-LN blocks
(causal self-attention, cross-attention over the encoder's output, fc1 ->
exact GELU -> fc2), and the LM head (dense -> exact GELU -> LayerNorm ->
vocabulary).

``mode`` sets the arithmetic of each block's projections: ``"f32"`` plain;
``"int8"`` / ``"int4"`` symmetric quantization to 127 / 7 levels, weights
per output column and inputs per row (the amax over the row), an exact
integer product (in float64, where it is exact), then both scales and the
bias; ``"fp8"`` the same scales onto float8 e4m3's largest value (448),
each element rounded to e4m3, the product in float64.  The serving form of the
int8 configuration states int8 for the encoder's projections; the control
lowers the stated precision by one step.

Callers turn TF32 off (``plain_float32``) so that float32 means float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.dims import Dims

QMAX = {"int8": 127, "int4": 7}
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def plain_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- host preparation ------------------------------------------------------------


def gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's BGR -> gray: (1868 b + 9617 g + 4899 r + 8192) >> 14."""
    c = bgr.astype(np.int64)
    return ((1868 * c[..., 0] + 9617 * c[..., 1] + 4899 * c[..., 2] + 8192) >> 14).astype(
        np.uint8)


def orient(img: np.ndarray, orientation: str) -> np.ndarray:
    h, w = img.shape[:2]
    if orientation == "vertical" and w > h:
        return np.rot90(img, k=-1)
    if orientation == "horizontal" and h > w:
        return np.rot90(img, k=1)
    return img


def triangle(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased linear (triangle) resize weights, rows
    summing to 1 (PIL's convention: the filter widens by the scale when
    shrinking)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    center = (np.arange(n_out) + 0.5)[:, None] * scale
    w = np.maximum(0.0, 1.0 - np.abs(np.arange(n_in)[None, :] + 0.5 - center) / support)
    return w / np.maximum(w.sum(1, keepdims=True), 1e-30)


def pixels(crops: list, orientation: str, size: int, device) -> torch.Tensor:
    """BGR uint8 crops -> [B, size, size, 3] float32 model inputs."""
    out = np.empty((len(crops), size, size), np.float64)
    for i, c in enumerate(crops):
        g = orient(gray(np.asarray(c)), orientation).astype(np.float64)
        out[i] = triangle(g.shape[0], size) @ g @ triangle(g.shape[1], size).T
    px = torch.from_numpy((out / 255.0 - 0.5) / 0.5).to(device=device, dtype=torch.float32)
    return px[..., None].expand(*px.shape, 3).contiguous()


# -- arithmetic --------------------------------------------------------------------


def layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _quant(t: torch.Tensor, levels: int, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-8) / levels
    return torch.round(t / scale).clamp(-levels, levels), scale


def _fp8(t: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-8) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float(), scale


def dense(x: torch.Tensor, p: dict, mode: str) -> torch.Tensor:
    w, b = p["kernel"], p["bias"]
    if mode == "f32":
        return x @ w + b
    if mode == "fp8":
        wq, sw = _fp8(w, 0)
        xq, sx = _fp8(x, -1)
        return ((xq.double() @ wq.double()) * sx.double() * sw.double()).float() + b
    levels = QMAX[mode]
    wq, sw = _quant(w, levels, 0)
    xq, sx = _quant(x, levels, -1)
    # float64 holds the integer product exactly (K * 127^2 << 2^53)
    return ((xq.double() @ wq.double()) * sx.double() * sw.double()).float() + b


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    if form == "sigmoid":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def attention(xq, xkv, p, heads: int, mode: str, mask=None) -> torch.Tensor:
    b, tq, d = xq.shape
    dh = d // heads

    def split(t):
        return t.reshape(b, -1, heads, dh).transpose(1, 2)

    q, k, v = split(dense(xq, p["q"], mode)), split(dense(xkv, p["k"], mode)), split(
        dense(xkv, p["v"], mode))
    s = (q @ k.transpose(-1, -2)) / dh**0.5
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    ctx = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(b, tq, d)
    return dense(ctx, p["o"], mode)


def _layer(tree: dict, l: int) -> dict:
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


# -- the model ---------------------------------------------------------------------


def encode(tree: dict, px: torch.Tensor, dims: Dims, mode: str, gelu_form: str) -> torch.Tensor:
    """[B, S, S, 3] pixels -> [B, seq, D] encoder output."""
    e = dims.encoder
    b, p = px.shape[0], e.patch_size
    g = e.image_size // p
    patches = px.reshape(b, g, p, g, p, e.channels).permute(0, 1, 3, 2, 4, 5).reshape(
        b, g * g, p * p * e.channels)
    pe = tree["patch_embed"]
    x = patches @ pe["kernel"].reshape(-1, e.hidden) + pe["bias"]
    x = torch.cat([tree["cls_token"].expand(b, 1, e.hidden), x], 1) + tree["pos_embed"]
    for l in range(e.layers):
        lp = _layer(tree["layers"], l)
        h = layer_norm(x, lp["ln1"], e.eps)
        x = x + attention(h, h, lp["attn"], e.heads, mode)
        h = layer_norm(x, lp["ln2"], e.eps)
        h = gelu(dense(h, lp["mlp"]["fc1"], mode), gelu_form)
        x = x + dense(h, lp["mlp"]["fc2"], mode)
    return layer_norm(x, tree["final_ln"], e.eps)


def decoder_logits(tree: dict, enc: torch.Tensor, ids: torch.Tensor, dims: Dims,
                   mode: str) -> torch.Tensor:
    """Teacher-forced logits [B, T, V] of the tokens ``ids`` [B, T] (BOS
    first): position t scores the token after ids[:, t]."""
    d = dims.decoder
    t = ids.shape[1]
    x = tree["tok_embed"][ids] + tree["pos_embed"][:t] + tree["tok_type"]
    x = layer_norm(x, tree["emb_ln"], d.eps)
    causal = torch.ones((t, t), dtype=torch.bool, device=ids.device).tril()
    for l in range(d.layers):
        lp = _layer(tree["layers"], l)
        x = layer_norm(x + attention(x, x, lp["self_attn"], d.heads, mode, causal),
                       lp["self_ln"], d.eps)
        x = layer_norm(x + attention(x, enc, lp["cross_attn"], d.heads, mode), lp["cross_ln"],
                       d.eps)
        h = gelu(dense(x, lp["mlp"]["fc1"], mode), "erf")
        x = layer_norm(x + dense(h, lp["mlp"]["fc2"], mode), lp["mlp_ln"], d.eps)
    hd = tree["head"]
    h = gelu(dense(x, hd["transform"]["dense"], "f32"), "erf")
    h = layer_norm(h, hd["transform"]["ln"], d.eps)
    return h @ hd["proj"]["kernel"] + hd["proj"]["bias"]


def logits(tree: dict, crops: list, ids: torch.Tensor, dims: Dims, orientation: str,
           precision: dict, gelu_form: str) -> torch.Tensor:
    """The whole model over raw crops and their token rows, in
    ``precision`` ({"encoder": mode, "decoder": mode})."""
    px = pixels(crops, orientation, dims.encoder.image_size, ids.device)
    enc = encode(tree["encoder"], px, dims, precision["encoder"], gelu_form)
    return decoder_logits(tree["decoder"], enc, ids, dims, precision["decoder"])


# -- the numbers compared -------------------------------------------------------------


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its position ([B, T] of [B, T, V] logits and [B, T] ids)."""
    return ref.max(-1).values - ref.gather(-1, tokens[..., None])[..., 0]
