"""Bit-flip fault primitives on whole tensors (port of
``onnx_transformer_tpu/inject/bits.py``).

fp32/fp16 flips XOR the bit pattern (a ``view`` bit cast) and clamp a NaN
result to 0; int8 flips XOR the two's-complement byte; int4 flips (values
held in int8) wrap around within [-8, 7].  The RANDOM fault draws its index
and its bit pattern from a ``torch.Generator`` on the CPU, so a seed gives
the same fault on every device (the JAX package draws from ``jax.random``:
the same seed gives another index and value there).
"""

from __future__ import annotations

import numpy as np
import torch


def _signed(mask: int, bits: int) -> int:
    """The bit pattern ``mask`` of a ``bits``-wide word as a signed int."""
    return mask - (1 << bits) if mask >= 1 << (bits - 1) else mask


def flip_int8_bit(q: torch.Tensor, bit: int) -> torch.Tensor:
    """XOR bit (0..7) of int8 two's complement."""
    return (q.view(torch.uint8) ^ (1 << bit)).view(torch.int8)


def flip_int4_bit(q: torch.Tensor, bit: int) -> torch.Tensor:
    """XOR bit (0..3) of an int4 value held in int8, wrapping within [-8, 7]."""
    u = (q.to(torch.int32) & 0xF) ^ (1 << bit)
    return torch.where(u > 7, u - 16, u).to(torch.int8)


def flip_float32_bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    """XOR bit (0..31) of the fp32 pattern; NaN results clamp to 0."""
    u = x.to(torch.float32).contiguous().view(torch.int32) ^ _signed(1 << bit, 32)
    f = u.view(torch.float32)
    return torch.where(torch.isnan(f), 0.0, f)


def flip_float16_bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    """XOR bit (0..15) of the fp16 pattern; NaN results clamp to 0; the
    result in x's dtype."""
    u = x.to(torch.float16).contiguous().view(torch.int16) ^ _signed(1 << bit, 16)
    f = u.view(torch.float16)
    return torch.where(torch.isnan(f), 0.0, f).to(x.dtype)


FLIPS = {"int8": flip_int8_bit, "int4": flip_int4_bit,
         "float32": flip_float32_bit, "float16": flip_float16_bit}


def random_float32(rng: torch.Generator, shape=()) -> torch.Tensor:
    """Random fp32 bit patterns on the CPU, NaN clamped to 0."""
    u = torch.randint(-(1 << 31), 1 << 31, shape, generator=rng, dtype=torch.int64)
    f = u.to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(f), 0.0, f)


def flip_element_bit(x: torch.Tensor, flat_idx: int, bit: int, kind: str) -> torch.Tensor:
    """Flip one element's bit. kind: int8|int4|float32|float16."""
    flat = x.reshape(-1).clone()
    flat[flat_idx:flat_idx + 1] = FLIPS[kind](flat[flat_idx:flat_idx + 1], bit)
    return flat.reshape(x.shape)


def flip_row_segment(x: torch.Tensor, row: int, col_start: int, width: int, bit: int,
                     kind: str) -> torch.Tensor:
    """INPUT16 fault: ``width`` contiguous elements of one row (of every
    matrix over the last two dims) share a flipped bit, a systolic-array
    row fault."""
    out = x.clone()
    r, c = x.shape[-2], x.shape[-1]
    lo, hi = max(col_start, 0), min(col_start + width, c)
    if 0 <= row < r and lo < hi:
        out[..., row, lo:hi] = FLIPS[kind](x[..., row, lo:hi], bit)
    return out


def flip_col_segment(x: torch.Tensor, col: int, row_start: int, height: int, bit: int,
                     kind: str) -> torch.Tensor:
    """WEIGHT16 fault: up to ``height`` contiguous elements of one column
    share a flipped bit."""
    out = x.clone()
    r, c = x.shape[-2], x.shape[-1]
    lo, hi = max(row_start, 0), min(row_start + height, r)
    if 0 <= col < c and lo < hi:
        out[..., lo:hi, col] = FLIPS[kind](x[..., lo:hi, col], bit)
    return out


def set_random_value(x: torch.Tensor, rng: torch.Generator,
                     frame: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """RANDOM fault: one random fp32 value at one random flat index.  Both
    are drawn on the CPU, so the fault costs the device no sync.  ``frame``
    = (part, parts): ``x`` is part ``part`` of ``parts`` equal batch-major
    parts of a whole tensor; the index is drawn over the whole, and ``x``
    changes only where it holds it."""
    part, parts = frame
    idx = int(torch.randint(0, x.numel() * parts, (), generator=rng)) - part * x.numel()
    val = float(random_float32(rng))
    if not 0 <= idx < x.numel():
        return x
    flat = x.reshape(-1).clone()
    flat[idx] = val
    return flat.reshape(x.shape)


def flip_random_output_bit(x: torch.Tensor, rng: torch.Generator, bit: int) -> torch.Tensor:
    """RANDOM_BITFLIP at a random index: an fp32 bit flip."""
    idx = int(torch.randint(0, x.numel(), (), generator=rng))
    return flip_element_bit(x, idx, bit, "float32")


def count_mismatches(a, b) -> int:
    """Elements that differ (the reference's total_bits_diff oracle); arrays
    or tensors."""
    a, b = (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (a, b))
    return int(np.sum(a != b))
