"""The collectives that GSPMD inserts in the JAX package, written out.

- :func:`model_sum`: the row-parallel SUM, Megatron's ``g``.  A rank holding
  rows of a weight (its columns of the input) computes a partial product;
  the sum over the ``model`` group is the whole product.  Under autograd
  its backward is the identity: every rank holds the whole output, so the
  gradient reaching each partial product is already whole.
- :func:`model_copy`: Megatron's ``f``, where a replicated activation
  enters column-parallel linears.  The forward is the identity; the
  backward sums the gradient over the ``model`` group, since each rank's
  columns contribute only their part of the input's gradient.  Without
  autograd it is no call at all.
- :func:`model_max`: the per-token maximum over the ``model`` group, for
  every per-token reduction over a feature axis whose columns are spread
  over the group (the activation scales of the quantizers);
  :func:`model_absmax` is its differentiable form for training, whose
  gradient splits at a tie as ``jax.grad`` of a max does.
- :func:`data_sum`: the data-parallel SUM of a list of tensors over the
  ``data`` group, through one flat buffer (one collective, not one a
  leaf): the gradients of a data-sharded batch, its loss and token count.
- :func:`data_gather`: the batch rows of every ``data`` rank, in order.

Each counts its calls and the host seconds spent in them (``calls``,
``seconds``), which ``chip_smoke.py`` reads per decode step and per train
step; ``model_copy`` and ``model_absmax`` count the collectives of their
backward.  On gloo the call returns once the result is in place, so the
seconds include the wait for the work queued before it.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _counted(fn):
    fn.calls = 0
    fn.seconds = 0.0
    return fn


def _reduce(counter, t: torch.Tensor, op, group) -> torch.Tensor:
    """All-reduce the contiguous ``t`` in place, counted on ``counter``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    counter.calls += 1
    counter.seconds += time.perf_counter() - t0
    return t


def _grad_wanted(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ModelSum(torch.autograd.Function):
    """g: the sum over the model group forward, the identity backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        out = t.clone(memory_format=torch.contiguous_format)
        return _reduce(model_sum, out, dist.ReduceOp.SUM, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    """f: the identity forward, the sum over the model group backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        return _reduce(model_copy, out, dist.ReduceOp.SUM, ctx.mesh.model_group), None


class _ModelAbsMax(torch.autograd.Function):
    """max |x| along ``dim`` over the whole (model-sharded) axis.  Each rank
    uses the maximum on its own part of the axis only (a scale of its
    columns or rows), so the gradient arriving at it is that part's: it is
    summed over the group first.  It then goes to every element that equals
    the maximum, split evenly among all of them across the group (the count
    is a sum over the group too; one collective carries both), and through
    |x| as ``jax.grad`` takes it: (g / count) * hit, negated where x < 0."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        m = x.abs().amax(dim=dim, keepdim=True).contiguous()
        _reduce(model_max, m, dist.ReduceOp.MAX, mesh.model_group)
        ctx.save_for_backward(x, m)
        ctx.dim, ctx.mesh = dim, mesh
        return m

    @staticmethod
    def backward(ctx, grad):
        x, m = ctx.saved_tensors
        hit = x.abs() == m
        # the gradient and the tie count side by side (a count is exact in
        # f32), summed over the group in one call
        both = torch.cat([grad.float(), hit.sum(dim=ctx.dim, keepdim=True,
                                                dtype=torch.float32)], dim=ctx.dim)
        _reduce(model_absmax, both, dist.ReduceOp.SUM, ctx.mesh.model_group)
        total, count = both.split(1, dim=ctx.dim)
        share = (total / count).to(grad.dtype) * hit.to(grad.dtype)
        # |x|'s gradient as JAX's: +1 at x >= 0 (0 included), -1 below
        return torch.where(x >= 0, share, -share), None, None


@_counted
def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the model group; returns the sum.  Without autograd in
    place (where ``t`` is contiguous); with it, Megatron's ``g`` (module
    docstring), ``t`` itself and no call at model = 1.  An int32 sum is
    exact, so the int8 products reduce without rounding."""
    if _grad_wanted(t):
        return t if mesh.model == 1 else _ModelSum.apply(t, mesh)
    return _reduce(model_sum, t.contiguous(), dist.ReduceOp.SUM, mesh.model_group)


@_counted
def model_copy(t: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's ``f`` on a replicated activation that enters
    column-parallel linears: ``t`` itself, whose gradient is summed over
    the model group.  ``t`` unchanged, and no call, without autograd or at
    model = 1."""
    if mesh.model == 1 or not _grad_wanted(t):
        return t
    return _ModelCopy.apply(t, mesh)


@_counted
def model_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """Maximum of ``t`` over the model group (in place where ``t`` is
    contiguous); returns the maximum."""
    return _reduce(model_max, t.contiguous(), dist.ReduceOp.MAX, mesh.model_group)


@_counted
def model_absmax(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """max |x| along ``dim`` (kept as a size-1 dim), whose columns along
    ``dim`` are spread over the model group: the forward's maximum counts
    on :func:`model_max`, the backward's tie count on this function."""
    return _ModelAbsMax.apply(x, dim, mesh)


@_counted
def data_sum(tensors: list, mesh) -> list:
    """The sum over the data group of each tensor of ``tensors`` (one
    dtype), through one flat buffer: one collective.  New tensors; the
    inputs are left as they are.  At data = 1 the inputs, and no call."""
    if mesh.data == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _reduce(data_sum, flat, dist.ReduceOp.SUM, mesh.data_group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                              tensors)]


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


COLLECTIVES = (model_sum, model_copy, model_max, model_absmax, data_sum, data_gather)
