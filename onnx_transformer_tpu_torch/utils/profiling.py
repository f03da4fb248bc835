"""Observability: span timers, throughput meters, ``torch.profiler`` hooks
(port of ``onnx_transformer_tpu/utils/profiling.py``).

- ``span`` / ``Timer``: host wall-clock spans that wait for the card
  (``torch.cuda.synchronize``) where CUDA work may be in flight, since
  PyTorch returns before the device finishes;
- ``ThroughputMeter``: tokens/s over a stream, as ``run_epoch`` logs it;
- ``trace``: ``torch.profiler`` around a block, writing a TensorBoard /
  Chrome trace into a directory;
- ``transformer_flops_per_token`` + ``roofline_fraction``: the analytic
  matmul FLOPs of a decode step against a measured rate.  The default peak
  is the H100 SXM's dense int8 rate, 1979e12 operations/s (the JAX package
  defaults to a TPU v5e's 394e12).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from onnx_transformer_tpu_torch.ops.kernels.roofline import INT8_OPS_PER_S as H100_INT8_OPS_PER_S


def _sync() -> None:
    """Wait for the card, where one has been used in this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, sink: dict | None = None, sync: bool = True):
    """Wall-clock span, in seconds, appended to ``sink[name]`` where a sink
    is given; with ``sync`` the card's queued work counts inside it.  An
    error in the block, or in the synchronize, propagates."""
    t0 = time.perf_counter()
    yield
    if sync:
        _sync()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.setdefault(name, []).append(dt)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    there), its trace written into ``logdir`` for TensorBoard or Chrome."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        _sync()


@dataclass
class Timer:
    """Mean wall time of a callable over ``iters`` calls after ``warmup``,
    each waited for on the card."""

    warmup: int = 1
    iters: int = 5

    def measure(self, fn, *args) -> float:
        for _ in range(self.warmup):
            fn(*args)
        _sync()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn(*args)
        _sync()
        return (time.perf_counter() - t0) / self.iters


@dataclass
class ThroughputMeter:
    """Streaming tokens/s (``run_epoch``-style logging)."""

    t0: float = field(default_factory=time.perf_counter)
    tokens: int = 0

    def add(self, n: int) -> None:
        self.tokens += n

    def rate(self) -> float:
        _sync()
        return self.tokens / max(time.perf_counter() - self.t0, 1e-9)

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self.tokens = 0


def transformer_flops_per_token(d_model: int, d_ff: int, num_layers: int,
                                src_len: int, tgt_len: int, vocab: int,
                                decode: bool = True) -> float:
    """Analytic decode-step FLOPs/token: linears + attention + generator."""
    attn_lin = 4 * d_model * d_model
    ffn = 2 * d_model * d_ff
    # decoder: self+cross attention
    dec_per_layer = 2 * attn_lin + ffn
    attn_scores = 2 * d_model * (tgt_len + src_len) if decode else 0
    gen = d_model * vocab
    return 2.0 * (num_layers * (dec_per_layer + attn_scores) + gen)


def roofline_fraction(measured_tokens_per_sec: float, flops_per_token: float,
                      peak_flops: float = H100_INT8_OPS_PER_S) -> float:
    """Fraction of the card's peak (the H100 SXM's dense int8 rate by
    default) that a measured token rate reaches."""
    return measured_tokens_per_sec * flops_per_token / peak_flops
