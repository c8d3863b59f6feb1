"""Shared numerics of the serving kernels, as plain PyTorch.

Counterpart of ``manga_ocr_tpu/ops/kernel_utils.py``.  Every kernel's plain
version is built from these functions, and the CUDA kernels compute the same
formulas in the same order (``csrc/common.cuh``), so a numerics question has
one answer in each language.
"""

from __future__ import annotations

import torch

# Large-negative mask value of the masked softmaxes (f32-safe:
# exp(NEG_INF - max) flushes to 0 without inf/nan arithmetic).
NEG_INF = -1e30


def ln32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; returns f32."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def quant_rows(h32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization: [..., K] f32 ->
    (int8 values, f32 row scales with keepdim).

    ``sx = amax * (1/127)``, ``inv = 127/amax``, ``round(h * inv)`` with no
    clip (``|h * inv| < 127.5`` always).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    amax = h32.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    sx = amax * (1.0 / 127.0)
    inv = 127.0 / amax
    return torch.round(h32 * inv).to(torch.int8), sx


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf polynomial (|err| <= 1.5e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * x.abs())
    y = 1.0 - (
        ((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t - 0.284496736) * t
        + 0.254829592
    ) * t * torch.exp(-x * x)
    return torch.sign(x) * y


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """GELU through the erf polynomial (not ``torch.erf``)."""
    return 0.5 * x * (1.0 + erf_poly(x * 0.7071067811865476))


def gelu_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``x / (1 + exp(-1.702 x))`` — a division, not ``x * sigmoid``."""
    return x / (1.0 + torch.exp(-1.702 * x))


def gelu_fn(mode: str):
    return gelu_sigmoid if mode == "sigmoid" else gelu_erf


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of [M, K] and [K, N].

    An f32 matmul of int8 values is not exact once K * 127^2 > 2^24, so the
    plain versions use ``torch._int_mm`` where it accepts the shape (always
    on the CPU; on CUDA it needs M > 16 and K, N multiples of 8) and an f64
    product otherwise (exact: K * 127^2 << 2^53)."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cpu" or (m > 16 and k % 8 == 0 and n % 8 == 0):
        return torch._int_mm(a.contiguous(), b.contiguous())
    return (a.double() @ b.double()).to(torch.int32)
