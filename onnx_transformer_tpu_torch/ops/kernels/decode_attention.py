"""K3: single-query attention over an int8 merged-head K/V cache (port of
``decode_attention_int8`` in ``onnx_transformer_tpu/ops/pallas/attention.py``).

The kernel is the registered operator ``torch.ops.otk.decode_attention_int8``
(see ``w8a8_matmul``): its CUDA implementation launches the kernel of
``csrc/decode_attention.cu`` and counts the launch in
``decode_attention_int8.launches``, its CPU implementation is the plain
version ``decode_attention_int8_ref``, which
follows the kernel's contract step for step (scale after the dot,
probabilities rounded as ``round(p*127)/127``) and which the card check
holds the kernel against (rtol 1e-5, atol 1e-4: the sums run in another
order).  ``decode_attention_int8_oracle`` is the JAX package's oracle
(dequantize first, then attend), the reference of both in the tests.
:func:`plan_decode_attention` chooses how many heads one CTA of the kernel
takes (all of them at the serving shape: one CTA per sequence).
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_transformer_tpu_torch.ops.kernels.build import launch
from onnx_transformer_tpu_torch.ops.kernels.w8a8_matmul import OP_NAMESPACE
from onnx_transformer_tpu_torch.ops.layers import NEG_INF, quantize_probs
from onnx_transformer_tpu_torch.quant.core import true_div

MAX_DK = 128      # head width the kernel takes
MAX_T = 16384     # cache length: hg*T scores in shared memory per CTA
MAX_GROUP_BYTES = 512   # a CTA's slice of a cache row: one 16-byte load per lane
MAX_SMEM = 200 * 1024   # shared memory per CTA (csrc/decode_attention.cu kMaxSmem)
WARPS = 8               # per CTA


def plan_decode_attention(t: int, d: int, h: int) -> int:
    """K3's heads per CTA: the largest divisor ``hg`` of ``h`` whose slice of
    a row (hg * dk bytes) is at most ``MAX_GROUP_BYTES`` and whose scores
    (hg * T floats) and, for 16-byte loads, the 8 warps' partial context
    sums (8 * hg * dk floats) fit in ``MAX_SMEM``.  The grid is B x (h / hg)
    CTAs; at the serving shape (T=72, D=512, H=8) hg = 8, one CTA per
    sequence."""
    dk = d // h
    vec = dk in (16, 32, 64, 128)
    for hg in range(h, 0, -1):
        if h % hg or hg * dk > MAX_GROUP_BYTES:
            continue
        smem = 4 * (-(-hg * t // 4) * 4 + (WARPS * hg * dk if vec else 0))
        if smem <= MAX_SMEM:
            return hg
    raise ValueError(f"T={t} does not fit one head's scores in shared memory")


def _inv_sqrt_dk(dk: int) -> float:
    """1/sqrt(dk) rounded to f32, as the kernel receives it."""
    return float(np.float32(1.0 / np.sqrt(dk)))


def decode_attention_int8_ref(q, kq, ks, vq, vs, mask, num_heads: int,
                              quantize: bool = True) -> torch.Tensor:
    """Plain version of K3: q f32 [B, D], kq/vq int8 [B, T, D], ks/vs f32
    [B, T], mask bool [B, T] -> f32 [B, D].  Per head:
    ``s = (q . kq) * (ks / sqrt(dk))``, masked to -1e9, softmax over T,
    ``round(p*127)/127`` if ``quantize``, then ``sum_t p * (vq * vs)``."""
    b, t, d = kq.shape
    h = num_heads
    dk = d // h
    dots = torch.einsum("bhd,bthd->bht", q.view(b, h, dk), kq.float().view(b, t, h, dk))
    s = dots * (ks[:, None, :] * _inv_sqrt_dk(dk))
    s = s.masked_fill(~mask.bool()[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if quantize:
        p = quantize_probs(p)
    v = vq.float().view(b, t, h, dk) * vs[:, :, None, None]
    return torch.einsum("bht,bthd->bhd", p, v).reshape(b, d)


def decode_attention_int8_oracle(q, kq, ks, vq, vs, mask, num_heads: int,
                                 quantize: bool = True) -> torch.Tensor:
    """The JAX package's oracle (``attention.py:159-178``): dequantize the
    cache, split heads, attend, merge."""
    b, t, d = kq.shape
    h = num_heads
    dk = d // h

    def split(x):   # [B, T, D] -> [B, H, T, dk]
        return x.view(b, t, h, dk).transpose(1, 2)

    k = split(kq.float() * ks[:, :, None])
    v = split(vq.float() * vs[:, :, None])
    scores = true_div(torch.einsum("bhd,bhtd->bht", q.view(b, h, dk), k),
                      float(np.sqrt(dk)))
    scores = scores.masked_fill(~mask.bool()[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if quantize:
        p = quantize_probs(p)
    return torch.einsum("bht,bhtd->bhd", p, v).reshape(b, d)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          vq: torch.Tensor, vs: torch.Tensor, mask: torch.Tensor,
                          num_heads: int, quantize: bool = True) -> torch.Tensor:
    """K3: f32 [B, D] attention of one query per sequence over its int8
    cache (see :func:`decode_attention_int8_ref`).  Any B, T up to
    ``MAX_T``, D divisible by ``num_heads`` with D / num_heads <= 128."""
    if kq.ndim != 3 or kq.dtype != torch.int8:
        raise ValueError(f"kq must be int8 [B, T, D], got {kq.dtype} {tuple(kq.shape)}")
    b, t, d = kq.shape
    if d % num_heads or d // num_heads > MAX_DK:
        raise ValueError(f"D={d} must split into {num_heads} heads of at most {MAX_DK}")
    if t > MAX_T:
        raise ValueError(f"T={t} is over {MAX_T}")
    want = {"q": ((b, d), torch.float32), "vq": ((b, t, d), torch.int8),
            "ks": ((b, t), torch.float32), "vs": ((b, t), torch.float32)}
    for name, tensor in (("q", q), ("vq", vq), ("ks", ks), ("vs", vs)):
        shape, dtype = want[name]
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, "
                             f"got {tensor.dtype} {tuple(tensor.shape)}")
    if tuple(mask.shape) != (b, t):
        raise ValueError(f"mask must be [{b}, {t}], got {tuple(mask.shape)}")
    for name, tensor in (("q", q), ("vq", vq), ("ks", ks), ("vs", vs), ("mask", mask)):
        if tensor.device != kq.device:
            raise ValueError(f"{name} is on {tensor.device}, kq on {kq.device}")
    return _OP(q, kq, ks, vq, vs, mask, num_heads, quantize)


def _cuda(q, kq, ks, vq, vs, mask, num_heads: int, quantize: bool) -> torch.Tensor:
    """The CUDA implementation of K3's operator."""
    b, t, d = kq.shape
    ops = [x.contiguous() for x in (q, kq, ks, vq, vs)]
    m8 = mask.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((b, d), dtype=torch.float32, device=kq.device)
    if b:
        launch("decode_attention_int8", kq.device, *[x.data_ptr() for x in ops],
               m8.data_ptr(), out.data_ptr(), b, t, d, num_heads,
               plan_decode_attention(t, d, num_heads), _inv_sqrt_dk(d // num_heads),
               int(quantize))
        decode_attention_int8.launches += 1
    return out


_OP = torch.library.custom_op(
    f"{OP_NAMESPACE}::decode_attention_int8", decode_attention_int8_ref, mutates_args=(),
    device_types="cpu", schema="(Tensor q, Tensor kq, Tensor ks, Tensor vq, Tensor vs, "
    "Tensor mask, int num_heads, bool quantize) -> Tensor")
_OP.register_kernel("cuda")(_cuda)
_OP.register_fake(lambda q, kq, ks, vq, vs, mask, num_heads, quantize:
                  q.new_empty((kq.shape[0], kq.shape[2]), dtype=torch.float32))
decode_attention_int8.launches = 0
