"""Functional transformer primitives (port of ``onnx_transformer_tpu/ops/layers.py``).

The numerics follow the reference model's modules:

- ``layer_norm``: normalises by the *sample* std (ddof=1) and adds eps to
  the std, not to the variance.
- ``attention_probs``: scores masked with -1e9 (not -inf), softmax, then the
  attention-prob fake-quant ``round(p*127)/127``.
- ``embed``: ``lut[x] * sqrt(d_model)``; ``_pe_table``: the log-space
  sin/cos table, built in numpy exactly as the JAX package builds it.

Inference only: there is no dropout and no tap/inject seam here.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from onnx_transformer_tpu_torch.quant.core import true_div

NEG_INF = -1e9


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """a_2 * (x - mean) / (std + eps) + b_2 with the ddof=1 std; the moments
    are taken in f32."""
    dt = x.dtype
    x = x.float()
    d = x.shape[-1]
    mean = true_div(x.sum(-1, keepdim=True), d)
    var = true_div(((x - mean) ** 2).sum(-1, keepdim=True), d - 1)
    std = torch.sqrt(var)
    return (scale.float() * (x - mean) / (std + eps) + bias.float()).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w + b with w stored (in_features, out_features)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def embed(ids: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    d_model = lut.shape[-1]
    return lut[ids] * float(np.sqrt(d_model).astype(np.float32))


@lru_cache(maxsize=8)
def _pe_table(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@lru_cache(maxsize=8)
def pe_rows(max_len: int, d_model: int, device: torch.device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The sinusoidal table as a tensor on ``device``, copied there once."""
    return torch.from_numpy(_pe_table(max_len, d_model)).to(device=device, dtype=dtype)


def positional_encoding(x: torch.Tensor, offset=0, max_len: int = 5000) -> torch.Tensor:
    """Additive sinusoidal PE over x [..., T, D]; ``offset`` is an int, or a
    [B] tensor of per-row positions for a single-token step."""
    pe = pe_rows(max_len, x.shape[-1], x.device, x.dtype)
    t = x.shape[-2]
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        return x + pe[offset][:, None, :]
    offset = int(offset)
    return x + pe[offset:offset + t]


def quantize_probs(p: torch.Tensor) -> torch.Tensor:
    """Attention probabilities snapped to the 1/127 grid."""
    return true_div(torch.round(p * 127.0), 127.0)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H]."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, dk] -> [B, T, D]."""
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def attention_probs(scores: torch.Tensor, mask: Optional[torch.Tensor],
                    quantize: bool) -> torch.Tensor:
    """softmax(mask_fill(scores, -1e9)) [+ 1/127 fake-quant]."""
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if quantize:
        p = quantize_probs(p)
    return p


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         quantize: bool = True) -> torch.Tensor:
    """q, k, v: [B, H, T, dk]; mask broadcastable to [B, H, Tq, Tk]."""
    d_k = q.shape[-1]
    scores = true_div(torch.matmul(q, k.transpose(-1, -2)),
                      float(np.sqrt(d_k).astype(np.float32)))
    p = attention_probs(scores, mask, quantize)
    return torch.matmul(p, v)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [1, size, size]."""
    return torch.tril(torch.ones((1, size, size), dtype=torch.bool, device=device))


def make_src_mask(src: torch.Tensor, pad: int = 2) -> torch.Tensor:
    return (src != pad)[:, None, :]


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)
