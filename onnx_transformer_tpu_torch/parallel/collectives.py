"""The collectives that GSPMD inserts in the JAX package, written out.

- :func:`model_sum`: the row-parallel SUM.  A rank holding rows of a weight
  (its columns of the input) computes a partial product; the sum over the
  ``model`` group is the whole product.  Training's backward (the Megatron
  f/g pair) wraps this function in a ``torch.autograd.Function``.
- :func:`model_max`: the per-token maximum over the ``model`` group, for
  every per-token reduction over a feature axis whose columns are spread
  over the group (the activation scales of the quantizers).
- :func:`data_gather`: the batch rows of every ``data`` rank, in order.

Each counts its calls and the host seconds spent in them (``calls``,
``seconds``), which ``chip_smoke.py`` reads per decode step.  On gloo the
call returns once the result is in place, so the seconds include the wait
for the work queued before it.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _counted(fn):
    fn.calls = 0
    fn.seconds = 0.0
    return fn


@_counted
def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the model group (in place where ``t`` is contiguous);
    returns the sum.  An int32 sum is exact, so the int8 products reduce
    without rounding."""
    t0 = time.perf_counter()
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.model_group)
    model_sum.calls += 1
    model_sum.seconds += time.perf_counter() - t0
    return t


@_counted
def model_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """Maximum of ``t`` over the model group (in place where ``t`` is
    contiguous); returns the maximum."""
    t0 = time.perf_counter()
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.model_group)
    model_max.calls += 1
    model_max.seconds += time.perf_counter() - t0
    return t


@_counted
def data_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """The data group's ``t`` (equal shapes) concatenated along dim 0 in
    data-rank order."""
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t, group=mesh.data_group)
    data_gather.calls += 1
    data_gather.seconds += time.perf_counter() - t0
    return torch.cat(parts, dim=0)


COLLECTIVES = (model_sum, model_max, data_gather)
