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


def quantize_weight_per_col(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] float -> (int8 [..., K, N], f32 scales [..., N]); leading
    axes (stacked layers) are quantized independently."""
    w = w.float()
    amax = w.abs().amax(-2)
    scale = amax.clamp_min(1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return w_q, scale
