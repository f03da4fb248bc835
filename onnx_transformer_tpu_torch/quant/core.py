"""Symmetric absmax quantization primitives (port of ``onnx_transformer_tpu/quant/core.py``).

Numeric contract: symmetric int8 with qmax = 2^(bits-1) - 1 = 127, scales
clamped at 1e-5 *before* dividing by qmax, per-channel over the weight
out-feature dim, per-token (last-dim absmax) for activations.  Quantizing is
a true division ``x / s`` followed by ``torch.round``, which rounds half to
even as ``jnp.round`` does.

Every division by a constant goes through :func:`true_div`: PyTorch's CUDA
division by a Python scalar multiplies by the reciprocal instead, which can
land one ulp away from the IEEE quotient that the JAX reference and the
hand-written kernels compute.
"""

from __future__ import annotations

from functools import lru_cache

import torch

SCALE_FLOOR = 1e-5


@lru_cache(maxsize=64)
def _const(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (the divisor is a 0-dim
    tensor on x's device, never a CPU scalar)."""
    return x / _const(float(c), x.dtype, x.device)


def qmax_for(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def absmax_scale(x: torch.Tensor, dim: int, bits: int = 8,
                 keepdim: bool = True) -> torch.Tensor:
    """clamp(absmax over ``dim``, 1e-5) / qmax."""
    s = x.abs().amax(dim=dim, keepdim=keepdim)
    return true_div(s.clamp_min(SCALE_FLOOR), qmax_for(bits))


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round_half_even(x / scale) as int8 (absmax scales keep it in range)."""
    return torch.round(x / scale).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def quantize_weight_per_channel(w: torch.Tensor, bits: int = 8):
    """w stored (in, out); per-out-channel scales.
    Returns (int8 [in, out], scales [out])."""
    scale = absmax_scale(w, dim=0, bits=bits, keepdim=False)
    return quantize(w, scale[None, :]), scale


def act_scale_per_token(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """[..., d] -> [..., 1] scales."""
    return absmax_scale(x, dim=-1, bits=bits, keepdim=True)


def quantize_act_per_token(x: torch.Tensor, bits: int = 8):
    s = act_scale_per_token(x, bits)
    return quantize(x, s), s


def fake_quant_act_per_token(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    q, s = quantize_act_per_token(x, bits)
    return dequantize(q, s)
