"""int8 weight quantization (counterpart of ``manga_ocr_tpu/ops/quant.py``).

Scheme: symmetric per-output-channel int8 weights, dynamic per-row int8
activations, int32 accumulation, f32 dequantization:

    y[m, n] = (x_q[m, :] . w_q[:, n]) * sx[m] * sw[n] + bias[n]

The weight quantizer divides and clips; the activation quantizer of the
kernels is ``kernel_utils.quant_rows`` (reciprocal multiply, no clip).  The
two formulas are different on purpose and must not be mixed up.
"""

from __future__ import annotations

import torch

from manga_ocr_tpu_torch.ops.kernel_utils import div127, int8_matmul


def quantize_weight_per_col(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] float -> (int8 [..., K, N], f32 scales [..., N]); leading
    axes (stacked layers) are quantized independently."""
    w = w.float()
    amax = w.abs().amax(-2)
    scale = amax.clamp_min(1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return w_q, scale


def dense_int8(
    x: torch.Tensor,  # [..., K] bf16/f32
    w_q: torch.Tensor,  # [K, N] int8
    w_scale: torch.Tensor,  # [N] f32
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dynamic-activation int8 matmul with f32 dequantization, as the JAX
    ``dense_int8``: a reciprocal multiply and no clip for the values, but
    ``sx = amax / 127`` (a division, where ``kernel_utils.quant_rows``
    multiplies by 1/127)."""
    shape = x.shape
    x32 = x.float().reshape(-1, shape[-1])
    amax = x32.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    sx = amax / 127.0
    x_q = torch.round(x32 * div127(amax)).to(torch.int8)
    y = int8_matmul(x_q, w_q).float() * sx * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*shape[:-1], w_q.shape[1])
