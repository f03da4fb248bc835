"""Symmetric absmax quantization primitives (port of ``onnx_transformer_tpu/quant/core.py``).

Numeric contract: symmetric with qmax = 2^(bits-1) - 1 (127 for int8, 7 for
int4), scales clamped at 1e-5 *before* dividing by qmax, per-channel over the
weight out-feature dim, per-token (last-dim absmax) or per-tensor for
activations.  Quantizing is a true division ``x / s`` followed by
``torch.round``, which rounds half to even as ``jnp.round`` does; ``clip``
clamps to [-qmax, qmax] for scales that are not the absmax.

int4 payloads are packed two to a byte along axis 0 (``pack_int4``): the low
nibble holds row 2r, the high nibble row 2r+1, both sign-extended on unpack.
``ste_round`` / ``fake_quant_ste`` are the straight-through fake-quant of QAT:
the rounding passes the gradient unchanged, and the clamp splits it at the
bounds as ``jnp.clip`` does (half to each side at a tie).

Every division by a constant goes through :func:`true_div`: PyTorch's CUDA
division by a Python scalar multiplies by the reciprocal instead, which can
land one ulp away from the IEEE quotient that the JAX reference and the
hand-written kernels compute.
"""

from __future__ import annotations

from functools import lru_cache

import torch

SCALE_FLOOR = 1e-5


def outside_trace(make) -> torch.Tensor:
    """``make()``, run as plain eager code even while ``torch.export`` (or
    ``torch.compile``) traces the caller: the tensor it builds is a real one,
    not a traced (fake) one, so that a cache may keep it for later calls and
    later traces, which take it as a constant of their program."""
    if not torch.compiler.is_compiling():
        return make()
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        return make()


@lru_cache(maxsize=64)
def _const(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return outside_trace(lambda: torch.full((), value, dtype=dtype, device=device))


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (the divisor is a 0-dim
    tensor on x's device, never a CPU scalar)."""
    return x / _const(float(c), x.dtype, x.device)


def qmax_for(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def _floor_scale(s: torch.Tensor) -> torch.Tensor:
    """max(s, 1e-5) against a 0-dim tensor: at the tie its gradient splits
    in half as ``jnp.clip``'s does (``clamp_min`` would pass all of it)."""
    return torch.maximum(s, _const(SCALE_FLOOR, s.dtype, s.device))


def absmax_scale(x: torch.Tensor, axis, bits: int = 8, keepdims: bool = True) -> torch.Tensor:
    """max(absmax over ``axis``, 1e-5) / qmax."""
    s = x.abs().amax(dim=axis, keepdim=keepdims)
    return true_div(_floor_scale(s), qmax_for(bits))


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int = 8,
             clip: bool = False) -> torch.Tensor:
    """round_half_even(x / scale) as int8; absmax scales keep it in range,
    ``clip`` clamps to [-qmax, qmax] for other scales."""
    q = torch.round(x / scale)
    if clip:
        q = q.clamp(-qmax_for(bits), qmax_for(bits))
    return q.to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def quantize_weight_per_channel(w: torch.Tensor, bits: int = 8):
    """w stored (in, out); per-out-channel scales.
    Returns (int8 [in, out], scales [out])."""
    scale = absmax_scale(w, axis=0, bits=bits, keepdims=False)
    return quantize(w, scale[None, :], bits), scale


def quantize_weight_per_tensor(w: torch.Tensor, bits: int = 8):
    """One scale for the whole tensor: (int8, scale 0-dim)."""
    scale = true_div(_floor_scale(w.abs().amax()), qmax_for(bits))
    return quantize(w, scale, bits), scale


def fake_quant_weight_per_channel(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    q, s = quantize_weight_per_channel(w, bits)
    return dequantize(q, s[None, :])


def sharded_absmax(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """max |x| along ``dim``, kept as a size-1 dim.  With a tensor-parallel
    ``mesh``, ``x`` holds this rank's part of that axis, and the maximum is
    the whole axis's: a max over the model group, whose gradient under
    autograd splits at a tie across the group as ``jax.grad``'s does
    (``parallel.collectives.model_absmax``)."""
    grad = torch.is_grad_enabled() and x.requires_grad
    if mesh is None or (grad and mesh.model == 1):
        return x.abs().amax(dim=dim, keepdim=True)
    from onnx_transformer_tpu_torch.parallel.collectives import model_absmax, model_max

    if grad:
        return model_absmax(x, dim, mesh)
    return model_max(x.abs().amax(dim=dim, keepdim=True), mesh)


def token_absmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """[..., d] -> [..., 1] per-token max |x|; with a tensor-parallel
    ``mesh``, of the whole row (:func:`sharded_absmax`)."""
    return sharded_absmax(x, -1, mesh)


def sharded_absmax_scale(x: torch.Tensor, dim: int, bits: int = 8, mesh=None) -> torch.Tensor:
    """:func:`absmax_scale` along ``dim`` (kept) over the whole axis, of
    which ``x`` holds this rank's part under a ``mesh``."""
    return true_div(_floor_scale(sharded_absmax(x, dim, mesh)), qmax_for(bits))


def act_scale_per_token(x: torch.Tensor, bits: int = 8, mesh=None) -> torch.Tensor:
    """[..., d] -> [..., 1] scales (of the whole row, under a ``mesh``)."""
    return sharded_absmax_scale(x, -1, bits, mesh)


def quantize_act_per_token(x: torch.Tensor, bits: int = 8, mesh=None):
    s = act_scale_per_token(x, bits, mesh)
    return quantize(x, s, bits), s


def fake_quant_act_per_token(x: torch.Tensor, bits: int = 8, mesh=None) -> torch.Tensor:
    q, s = quantize_act_per_token(x, bits, mesh)
    return dequantize(q, s)


def quantize_act_per_tensor(x: torch.Tensor, bits: int = 8):
    return quantize_weight_per_tensor(x, bits)


def fake_quant_act_per_tensor(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    q, s = quantize_act_per_tensor(x, bits)
    return dequantize(q, s)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [in, ...] with an even in-dim -> uint8
    [in // 2, ...]: row 2r in the low nibble, row 2r+1 in the high one."""
    lo = (q[0::2] & 0xF).to(torch.uint8)
    hi = (q[1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> int8 [2 * rows, ...], sign-extended."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=1).reshape(packed.shape[0] * 2, *packed.shape[1:])


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round half to even, with the identity as its gradient."""
    return _SteRound.apply(x) if x.requires_grad else torch.round(x)


def fake_quant_ste(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quant with straight-through rounding (QAT).  The clamp is a
    maximum then a minimum against tensors, whose gradients split at a tie
    as ``jnp.clip``'s do (``torch.clamp`` would pass all of it)."""
    qm = _const(float(qmax_for(bits)), x.dtype, x.device)
    q = torch.minimum(torch.maximum(ste_round(x / scale), -qm), qm)
    return q * scale
