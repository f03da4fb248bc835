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
- :func:`pipe_exchange`: pipeline parallelism's stage-to-stage traffic
  (JAX's ``ppermute`` over ``pipe``): a rank's send to one stage and its
  receive from another, posted together as an isend/irecv pair and waited
  for together, so that no ring of blocking sends can deadlock.  On nccl
  the CUDA tensors go as they are (``batch_isend_irecv``); gloo has no
  send or receive of a CUDA tensor, so on a gloo group a CUDA tensor is
  staged through pinned host memory, by the group's backend and never as
  a quiet fallback.  It counts its sends and receives (``sends``,
  ``recvs``) beside its calls.
- :func:`pipe_broadcast`: the last stage's result handed to every stage
  (one broadcast where JAX doubles recursively); :func:`pipe_sum`: the sum
  over ``pipe`` of a list of tensors through one flat buffer.
- :func:`seq_split` and :func:`seq_gather`: sequence parallelism's pair
  over ``model`` (``pipeline.sp_constrain``): this rank's block of dim 1
  (the length padded up to a multiple of ``model``), whose backward
  gathers the gradient's blocks; and the blocks gathered along dim 1 (the
  padding cut), whose backward keeps the rank's block.

Each counts its calls and the host seconds spent in them (``calls``,
``seconds``), which ``chip_smoke.py`` reads per decode step and per train
step; ``model_copy`` and ``model_absmax`` count the collectives of their
backward.  On gloo the call returns once the result is in place, so the
seconds include the wait for the work queued before it.
"""

from __future__ import annotations

import time
from typing import Optional

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


def _timed(counter, fn):
    """``fn()``, its host seconds and one call counted on ``counter``."""
    t0 = time.perf_counter()
    out = fn()
    counter.calls += 1
    counter.seconds += time.perf_counter() - t0
    return out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


@_counted
def pipe_exchange(send: Optional[torch.Tensor], send_to: Optional[int],
                  recv_like: Optional[torch.Tensor], recv_from: Optional[int],
                  mesh) -> Optional[torch.Tensor]:
    """Send ``send`` to pipe rank ``send_to`` and receive a tensor shaped
    like ``recv_like`` from pipe rank ``recv_from``, posted together and
    waited for together (either may be None); returns the received tensor
    on ``recv_like``'s device, or None.  See the module docstring for the
    backends."""
    group = mesh.pipe_group
    staged = dist.get_backend(group) == "gloo"
    ops, out, host = [], None, None
    if send is not None:
        buf = send.contiguous()
        if staged and buf.is_cuda:
            buf = _pinned(buf).copy_(buf)
        ops.append((dist.isend, buf, send_to))
        pipe_exchange.sends += 1
    if recv_like is not None:
        host = _pinned(recv_like) if staged and recv_like.is_cuda else None
        out = torch.empty_like(recv_like) if host is None else host
        ops.append((dist.irecv, out, recv_from))
        pipe_exchange.recvs += 1
    if not ops:
        return None

    def post():
        peers = [(op, t, dist.get_global_rank(group, peer)) for op, t, peer in ops]
        if staged:
            works = [op(t, peer, group=group) for op, t, peer in peers]
        else:
            works = dist.batch_isend_irecv([dist.P2POp(op, t, peer, group=group)
                                            for op, t, peer in peers])
        for w in works:
            w.wait()

    _timed(pipe_exchange, post)
    if host is not None:
        out = host.to(recv_like.device)
    return out


pipe_exchange.sends = pipe_exchange.recvs = 0


@_counted
def pipe_broadcast(t: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """Pipe rank ``src``'s ``t`` on every rank of the pipe group, in place
    (``t`` contiguous); returns it.  ``t`` itself, and no call, at pipe =
    1."""
    if mesh.pipe == 1:
        return t
    group = mesh.pipe_group
    _timed(pipe_broadcast, lambda: dist.broadcast(t, src=dist.get_global_rank(group, src),
                                                  group=group))
    return t


@_counted
def pipe_sum(tensors: list, mesh) -> list:
    """The sum over the pipe group of each tensor of ``tensors`` (one
    dtype), through one flat buffer; the inputs at pipe = 1."""
    if mesh.pipe == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _reduce(pipe_sum, flat, dist.ReduceOp.SUM, mesh.pipe_group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                              tensors)]


def _gather_dim1(counter, x: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's blocks of ``x`` (equal shapes) along dim 1, in
    model-rank order, counted on ``counter``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    _timed(counter, lambda: dist.all_gather(parts, x, group=mesh.model_group))
    return torch.cat(parts, dim=1)


def _block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of dim 1, the length padded with zeros up to a
    multiple of ``model`` (as GSPMD pads an uneven split)."""
    t = x.shape[1]
    n = -(-t // mesh.model)
    if n * mesh.model != t:
        pad = x.new_zeros((x.shape[0], n * mesh.model - t, *x.shape[2:]))
        x = torch.cat([x, pad], dim=1)
    return x.narrow(1, mesh.model_rank * n, n)


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.t = mesh, x.shape[1]
        return _block(x, mesh).clone()

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim1(seq_split, grad, ctx.mesh).narrow(1, 0, ctx.t), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, mesh):
        ctx.mesh = mesh
        return _gather_dim1(seq_gather, x, mesh).narrow(1, 0, t).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.mesh).contiguous(), None, None


@_counted
def seq_split(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of dim 1 of ``x`` (whole and the same on every
    rank of the model group), the length padded up to a multiple of
    ``model``.  Under autograd the backward gathers the blocks' gradients
    over the model group (each rank's is its block's part): one collective,
    counted here."""
    return _SeqSplit.apply(x, mesh)


@_counted
def seq_gather(x: torch.Tensor, t: int, mesh) -> torch.Tensor:
    """The model group's blocks of dim 1 (:func:`seq_split`'s) gathered in
    model-rank order and cut to length ``t``: one collective.  Its
    backward keeps this rank's block of the gradient, which is whole on
    every rank."""
    return _SeqGather.apply(x, t, mesh)


COLLECTIVES = (model_sum, model_copy, model_max, model_absmax, data_sum, data_gather,
               pipe_exchange, pipe_broadcast, pipe_sum, seq_split, seq_gather)


def reset_counts() -> None:
    """Every collective's counts set to 0."""
    for c in COLLECTIVES:
        c.calls, c.seconds = 0, 0.0
    pipe_exchange.sends = pipe_exchange.recvs = 0
