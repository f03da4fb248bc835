"""Functional transformer primitives (port of ``onnx_transformer_tpu/ops/layers.py``).

The numerics follow the reference model's modules:

- ``layer_norm``: normalises by the *sample* std (ddof=1) and adds eps to
  the std, not to the variance.
- ``attention_probs``: scores masked with -1e9 (not -inf), softmax, then the
  attention-prob fake-quant ``round(p*127)/127``.
- ``embed``: ``lut[x] * sqrt(d_model)``; ``_pe_table``: the log-space
  sin/cos table, built in numpy exactly as the JAX package builds it.

The int8-cache attentions (``int8_cache_attention*``) attend one query step
over the merged-head int8 K/V cache [B, T, D] with per-token scales, without
dequantizing the cache into an f32 [B, T, D] tensor first.

Tap/inject seam: an intermediate routed through :func:`tap` may be rewritten
by a function of an ``inject`` dict (fault injection) and then recorded into
a ``taps`` dict (calibration, observation), both keyed by the reference's
module names.  With both ``None`` the tensor passes untouched.

Dropout draws its masks from a ``torch.Generator`` (the JAX package draws
from ``jax.random``, so the masks differ; eval and rate 0 are the identity
in both).  Gradients flow as in the JAX package (straight through the
probability rounding).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from onnx_transformer_tpu_torch.quant.core import (_const, outside_trace, ste_round, token_absmax,
                                                   true_div)

TapDict = Optional[dict]
InjectDict = Optional[dict]

NEG_INF = -1e9


def tap(name: str, x: torch.Tensor, taps: TapDict = None, inject: InjectDict = None):
    """Route an intermediate through the observe/inject seam: rewrite it with
    ``inject[name]`` where that exists, then record it as ``taps[name]``."""
    if inject is not None and name in inject:
        x = inject[name](x)
    if taps is not None:
        taps[name] = x
    return x


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
    """``lut[ids] * sqrt(d_model)``, the factor rounded to the table's dtype
    first as in the JAX package (a Python float would be applied in f32 to
    a bf16 table).  The gather is ``F.embedding``, whose backward sums each
    row's gradients in a fixed order (the CPU's ``lut[ids]`` backward adds
    them atomically across threads), so a training step repeats bit for
    bit."""
    d_model = lut.shape[-1]
    return F.embedding(ids, lut) * _const(float(np.sqrt(d_model)), lut.dtype, lut.device)


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
    """The sinusoidal table as a tensor on ``device``, copied there once
    (outside any trace: a traced program takes it as a constant)."""
    return outside_trace(lambda: torch.from_numpy(_pe_table(max_len, d_model)).to(
        device=device, dtype=dtype))


def positional_encoding(x: torch.Tensor, offset=0, max_len: int = 5000) -> torch.Tensor:
    """Additive sinusoidal PE over x [..., T, D]; ``offset`` is an int, or a
    [B] tensor of per-row positions for a single-token step."""
    pe = pe_rows(max_len, x.shape[-1], x.device, x.dtype)
    t = x.shape[-2]
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        return x + pe[offset][:, None, :]
    offset = int(offset)
    return x + pe[offset:offset + t]


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
            train: bool, shard: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout: ``where(keep_mask, x / keep, 0)`` with keep = 1 - rate
    and the mask drawn from ``rng`` (a generator on x's device).  The
    identity when not training, at rate 0, or without a generator.

    ``shard`` = (dim, index, parts): ``x`` is block ``index`` of ``parts``
    equal blocks along ``dim`` of a whole tensor (a tensor-parallel rank's
    heads or columns).  The whole tensor's mask is drawn and this block of
    it kept, so every rank's generator advances alike and the masks are
    those of one device drawing for the whole tensor."""
    if not train or rate == 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        dim, index, parts = shard
        shape[dim] *= parts
    mask = torch.rand(shape, generator=rng, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(mask, true_div(x, keep), 0.0)


def quantize_probs(p: torch.Tensor) -> torch.Tensor:
    """Attention probabilities snapped to the 1/127 grid, with a
    straight-through gradient as in the JAX package (so that a QAT forward
    trains q and k through the probabilities)."""
    return true_div(ste_round(p * 127.0), 127.0)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H]."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, dk] -> [B, T, D]."""
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def attention_probs(scores: torch.Tensor, mask: Optional[torch.Tensor],
                    quantize: bool, drop_rate: float = 0.0,
                    rng: Optional[torch.Generator] = None,
                    train: bool = False,
                    drop_shard: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """softmax(mask_fill(scores, -1e9)) [+ dropout] [+ 1/127 fake-quant].
    ``drop_shard``: :func:`dropout`'s ``shard``."""
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p = dropout(p, drop_rate, rng, train, drop_shard)
    if quantize:
        p = quantize_probs(p)
    return p


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor], quantize: bool = True,
                         drop_rate: float = 0.0, rng: Optional[torch.Generator] = None,
                         train: bool = False, name: str = "attn", taps: TapDict = None,
                         inject: InjectDict = None,
                         drop_shard: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """q, k, v: [B, H, T, dk]; mask broadcastable to [B, H, Tq, Tk].  Taps
    ``{name}.scores``, ``{name}.probs`` and ``{name}.context``.
    ``drop_shard``: :func:`dropout`'s ``shard`` of the probabilities."""
    d_k = q.shape[-1]
    scores = true_div(torch.matmul(q, k.transpose(-1, -2)),
                      float(np.sqrt(d_k).astype(np.float32)))
    scores = tap(f"{name}.scores", scores, taps, inject)
    p = attention_probs(scores, mask, quantize, drop_rate, rng, train, drop_shard)
    p = tap(f"{name}.probs", p, taps, inject)
    return tap(f"{name}.context", torch.matmul(p, v), taps, inject)


def int8_cache_attention(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                         vq: torch.Tensor, vs: torch.Tensor,
                         mask: Optional[torch.Tensor], quantize: bool, name: str = "attn",
                         taps: TapDict = None, inject: InjectDict = None) -> torch.Tensor:
    """Scale-after-dot attention of q f32 [B, H, 1, dk] over the int8 cache
    kq/vq [B, T, D] with scales ks/vs [B, T, 1]; mask [B, 1, 1, T].

    The per-token scale is constant along dk, so it comes out of both dots:
    ``scores[t] = (q . kq[t]) * ks[t] / sqrt(dk)`` and
    ``ctx = sum_t (p[t] * vs[t]) * vq[t]``.  Returns [B, H, 1, dk].  Taps as
    :func:`scaled_dot_attention`."""
    b, t, d = kq.shape
    h = q.shape[1]
    dk = d // h
    kr = kq.view(b, t, h, dk).float()
    vr = vq.view(b, t, h, dk).float()
    scores = torch.einsum("bhqd,bthd->bhqt", q, kr)
    scores = scores * true_div(ks[:, :, 0][:, None, None, :],
                               float(np.sqrt(dk).astype(np.float32)))
    scores = tap(f"{name}.scores", scores, taps, inject)
    p = tap(f"{name}.probs", attention_probs(scores, mask, quantize), taps, inject)
    pv = p * vs[:, :, 0][:, None, None, :]
    return tap(f"{name}.context", torch.einsum("bhqt,bthd->bhqd", pv, vr), taps, inject)


def int8_cache_attention_qdot(q_full: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                              vq: torch.Tensor, vs: torch.Tensor,
                              mask: Optional[torch.Tensor], quantize: bool,
                              num_heads: int, mesh=None) -> torch.Tensor:
    """All-int8-operand attention of the merged-head query q_full f32
    [B, 1, D] over the int8 cache kq/vq [B, T, D], ks/vs [B, T, 1]; mask
    [B, 1, 1, T].  The query sits on the per-token int8 grid (the W8A8 q
    projection fake-quantizes its output), so ``round(q / sq)`` with
    ``sq = max(max|q| / 127, 1e-9)`` (not ``SCALE_FLOOR``) recovers its int8
    form exactly, and the score dot is an exact integer sum scaled by
    ``sq * ks / sqrt(dk)``.  Returns [B, 1, D].  Under a tensor-parallel
    ``mesh`` the rank's D columns hold its ``num_heads`` heads, and max|q|
    is the whole row's."""
    from onnx_transformer_tpu_torch.models.stacked_decode import _qdot_attn

    sq = true_div(token_absmax(q_full, mesh), 127.0).clamp_min(1e-9)   # [B,1,1]
    qi = torch.round(q_full / sq).to(torch.int8)[:, 0, :]
    vis = mask[:, 0, 0, :] if mask is not None else None
    ctx = _qdot_attn(qi, sq[:, 0, 0], kq, ks[..., 0], vq, vs[..., 0], vis,
                     num_heads, quantize)
    return ctx[:, None, :]


def int8_cache_attention_qdot_tm(q_full: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                                 mask: Optional[torch.Tensor], quantize: bool,
                                 num_heads: int, mesh=None) -> torch.Tensor:
    """:func:`int8_cache_attention_qdot` over a time-major cache: kq/vq
    [T, B, D], ks/vs [T, B, 1]."""
    return int8_cache_attention_qdot(q_full, kq.transpose(0, 1), ks.transpose(0, 1),
                                     vq.transpose(0, 1), vs.transpose(0, 1), mask,
                                     quantize, num_heads, mesh)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [1, size, size]."""
    return torch.tril(torch.ones((1, size, size), dtype=torch.bool, device=device))


def make_src_mask(src: torch.Tensor, pad: int = 2) -> torch.Tensor:
    return (src != pad)[:, None, :]


def make_tgt_mask(tgt_in: torch.Tensor, pad: int = 2) -> torch.Tensor:
    """Padding mask & causal mask: [B, T, T]."""
    t = tgt_in.shape[-1]
    return (tgt_in != pad)[:, None, :] & subsequent_mask(t, tgt_in.device)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def xavier_uniform(rng: torch.Generator, shape: tuple,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Glorot uniform U(-a, a), a = sqrt(6 / (fan_in + fan_out)), drawn from
    ``rng`` on its device; the two fans are the first two dims (their sum
    does not depend on which is which)."""
    a = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=rng, device=rng.device, dtype=dtype)
    return u * (2 * a) - a
