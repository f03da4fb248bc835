"""Training loop (port of ``onnx_transformer_tpu/train/trainer.py``).

- One train step: forward, label-smoothed KL loss, ``torch.autograd``
  backward and the Adam + Noam update, with gradient accumulation over
  microbatches as a Python loop (the JAX package scans them).
- The optimizer is optax's ``chain(scale_by_adam(0.9, 0.98, eps=1e-9),
  scale_by_schedule(-noam))`` written out with ``torch._foreach_*`` over the
  parameter leaves: the same arithmetic in the same order, and the same
  state layout (``ScaleByAdamState(count, mu, nu)``,
  ``ScaleByScheduleState(count)``), which the checkpoint keys follow.
  ``torch.optim.Adam`` orders its bias corrections differently and keeps
  its own state.
- ``compute_dtype=torch.bfloat16`` casts every f32 leaf to bf16 inside the
  loss, as the JAX package does: the forward and backward run in bf16,
  autograd returns f32 gradients for the master weights through the cast,
  and the log-softmax and KL run in f32.  (``torch.autocast`` would keep
  LayerNorm and softmax in f32 and give other numbers than JAX's.)
- The step keeps its counts and metrics on the device, so nothing in a step
  waits for the device; ``run_epoch`` reads the metrics back at its log
  points and at the end.

Data and tensor parallelism over a (data, model) mesh
(``parallel.make_mesh``): ``shard_state`` places the parameters and Adam's
moments by ``param_pspecs`` (the counts and ``step`` replicated),
``shard_batch`` gives this rank's rows (``parallel.global_batch`` takes a
loader shard's), and ``make_train_step(..., mesh=mesh)`` runs the
tensor-parallel view ``Transformer(cfg, mesh)``, whose Megatron f/g pair
carries the gradients across the model group.  As in the JAX package's
jitted step, the loss of a microbatch is its KL sum over the token count
of the whole data-sharded microbatch: each rank sums its count over
``data`` before the division, and the step sums its gradients (and the
KL, for the metrics) over ``data`` in one flat all-reduce
(``parallel.collectives.data_sum``).  ``gather_state`` gives the whole
state back, as fetching global arrays does in JAX.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Iterable, NamedTuple, Optional

import numpy as np
import torch

from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.parallel.collectives import data_sum
from onnx_transformer_tpu_torch.parallel.mesh import local_rows
from onnx_transformer_tpu_torch.parallel.sharding import gather_params, shard_params
from onnx_transformer_tpu_torch.params import tree_leaves, tree_map, tree_unflatten
from onnx_transformer_tpu_torch.quant.w8a8 import shard_linear_impl
from onnx_transformer_tpu_torch.train.loss import loss_and_ntokens
from onnx_transformer_tpu_torch.train.schedule import noam_schedule


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32, 0-dim
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor   # int32, 0-dim


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}


class AdamNoam:
    """Adam(0.9, 0.98, eps 1e-9) scaled by ``sched``, updating in place."""

    B1, B2, EPS = 0.9, 0.98, 1e-9

    def __init__(self, sched):
        self.sched = sched

    def init(self, params) -> tuple:
        dev = tree_leaves(params)[0].device

        def count():
            return torch.zeros((), dtype=torch.int32, device=dev)

        return (ScaleByAdamState(count(), tree_map(torch.zeros_like, params),
                                 tree_map(torch.zeros_like, params)),
                ScaleByScheduleState(count()))

    @torch.no_grad()
    def update_(self, params: list, grads: list, opt_state: tuple) -> None:
        """One step over the leaf lists ``params`` and ``grads``: the
        moments, the counts and ``params`` are updated in place."""
        adam, sched = opt_state
        mu, nu = tree_leaves(adam.mu), tree_leaves(adam.nu)
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        adam.count.add_(1)
        # optax's bias corrections: 1 - b ** count in f32, with the count
        # already incremented; mu_hat / (sqrt(nu_hat) + eps)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - torch.pow(b2, adam.count)))
        torch._foreach_add_(denom, self.EPS)
        u = torch._foreach_div(torch._foreach_div(mu, 1 - torch.pow(b1, adam.count)), denom)
        # scale_by_schedule takes the schedule's count before its increment
        torch._foreach_mul_(u, -self.sched(sched.count))
        torch._foreach_add_(params, u)
        sched.count.add_(1)


def make_optimizer(d_model: int, base_lr: float = 1.0, warmup: int = 3000) -> AdamNoam:
    """Adam(0.9, 0.98, eps 1e-9) + Noam, as the JAX package's."""
    return AdamNoam(noam_schedule(d_model, factor=base_lr, warmup=warmup))


def init_state(model: Transformer, tx: AdamNoam, seed: int = 0, device=None) -> TrainState:
    params = model.init(seed, device)
    return TrainState(params, tx.init(params),
                      torch.zeros((), dtype=torch.int32, device=resolve_device(device)))


def _loss_fn(model, params, src, tgt_in, tgt_y, src_mask, tgt_mask, rng, smoothing,
             lin=default_linear, compute_dtype=None, taps=None, inject=None, forward=None):
    """Forward + label-smoothing KL -> (loss / ntok, loss, ntok) with ntok
    at least 1.  Under ``compute_dtype`` every f32 leaf is cast inside the
    loss; the log-softmax and KL run in f32.  Under a mesh (``model.mesh``)
    ``ntok`` is the whole data-sharded batch's, summed over ``data`` before
    the floor at 1; ``loss`` stays this rank's KL sum.  ``taps`` and
    ``inject`` reach the model's seam (``ops.layers.tap``).  ``forward``,
    where given, computes the logits in place of the model's forward and
    generator (:func:`make_train_step`)."""
    if compute_dtype is not None:
        params = tree_map(lambda p: p.to(compute_dtype) if p.dtype == torch.float32 else p,
                          params)
    if forward is not None:
        if taps is not None or inject is not None:
            raise ValueError("taps and inject reach the model's own forward; give a "
                             "custom forward a linear impl that carries them")
        logits = forward(params, src, tgt_in, src_mask, tgt_mask, rng=rng)
    else:
        h = model.forward(params, src, tgt_in, src_mask, tgt_mask, rng=rng, train=True,
                          taps=taps, inject=inject, lin=lin)
        logits = model.generate(params, h, taps=taps, inject=inject, lin=lin, log_probs=False)
    return token_loss(logits, tgt_y, model.cfg.pad_id, smoothing, model.mesh)


def token_loss(logits, tgt_y, pad_id: int, smoothing: float, mesh=None) -> tuple:
    """(loss / ntok, loss, ntok) of ``logits``: the label-smoothing KL of
    their f32 log-softmax, over the token count at least 1; under a
    ``mesh`` the count is the whole data-sharded batch's, summed over
    ``data`` before the floor, and ``loss`` stays this rank's KL sum."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss, ntok = loss_and_ntokens(logp, tgt_y, pad_id, smoothing)
    if mesh is not None:
        ntok = data_sum([ntok], mesh)[0]
    ntok = ntok.clamp_min(1)
    return loss / ntok, loss, ntok


def _local_grads(model: Transformer, params, micro: tuple, rng, smoothing: float, lin,
                 compute_dtype, taps=None, inject=None, forward=None) -> tuple[tuple, list]:
    """((loss / ntok, loss, ntok), gradients) of this rank's part of the
    loss, detached; under a mesh not yet summed over ``data``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss_mean, loss, ntok = _loss_fn(model, tree_unflatten(params, leaves), *micro, rng,
                                     smoothing, lin, compute_dtype, taps, inject, forward)
    grads = torch.autograd.grad(loss_mean, leaves, materialize_grads=True)
    return (loss_mean.detach(), loss.detach(), ntok), list(grads)


def _data_summed(grads: list, loss: torch.Tensor, mesh) -> tuple[list, torch.Tensor]:
    """The gradients and the KL sum over ``data``, in one flat all-reduce."""
    if mesh is None or mesh.data == 1:
        return grads, loss
    *grads, loss = data_sum(grads + [loss.reshape(1)], mesh)
    return grads, loss[0]


def value_and_grad(model: Transformer, params, micro: tuple, rng=None, smoothing: float = 0.1,
                   lin=default_linear, compute_dtype=None, taps=None,
                   inject=None, forward=None) -> tuple[tuple, list]:
    """((loss / ntok, loss, ntok), gradients) of the training loss on one
    microbatch, the gradients a list in ``params.tree_leaves`` order.  The
    loss tensors are detached.  Under a mesh (``model.mesh``, over this
    rank's parameter slices and batch rows) those of the whole
    data-sharded microbatch: the gradients this rank's slices of the whole
    batch's, the loss and count the whole batch's.  ``taps`` and ``inject``
    reach the model's seam (``ops.layers.tap``); ``forward`` as in
    :func:`make_train_step`."""
    (_, loss, ntok), grads = _local_grads(model, params, micro, rng, smoothing, lin,
                                          compute_dtype, taps, inject, forward)
    grads, loss = _data_summed(grads, loss, model.mesh)
    return (loss / ntok, loss, ntok), grads


def make_train_step(model: Transformer, tx: AdamNoam, mesh=None, accum: int = 1,
                    smoothing: float = 0.1, donate: bool = True, lin=default_linear,
                    compute_dtype=None, forward=None):
    """Build the train step ``fn(state_tree, batch, rng) -> (state_tree,
    metrics)``.

    ``batch`` is the 5-tuple of :func:`batch_to_arrays` (src, tgt_in,
    tgt_y, src_mask, tgt_mask), [accum, B / accum, ...] when ``accum > 1``;
    ``rng`` a ``torch.Generator`` on the parameters' device (or None) whose
    draws the microbatches' dropout sites take in call order.  The gradients
    of the microbatches are summed and divided by ``accum``; the metrics
    (summed KL ``loss`` and ``ntokens``) stay on the device.  With
    ``donate`` the state's tensors are updated in place and returned (the
    counterpart of JAX's buffer donation); without it the given state is
    left as it was.  ``lin`` swaps the linear impl, e.g. the QAT fake-quant
    ``quant.int4.make_qat_linear_impl``.  ``forward(params, src, tgt_in,
    src_mask, tgt_mask, rng=)``, where given, returns the logits in place of
    the model's forward and generator, with its own linear impl bound (the
    pipelined forward, ``parallel.pipeline.make_pipeline_train_step``).

    With a ``mesh``, the step of one rank: ``state_tree`` from
    :func:`shard_state`, ``batch`` this rank's rows (:func:`shard_batch`,
    dim 1 under ``accum``), ``rng`` from ``parallel.mesh_generator``; the
    model runs as ``Transformer(model.cfg, mesh)`` and ``lin`` as its
    tensor-parallel counterpart (``quant.w8a8.shard_linear_impl``).  The
    metrics are the whole batch's on every rank (module docstring)."""
    if mesh is not None:
        if model.mesh is not mesh:
            model = Transformer(model.cfg, mesh)
        lin = shard_linear_impl(lin, mesh)

    def grads_of(params, micro, rng):
        (_, loss, ntok), grads = _local_grads(model, params, micro, rng, smoothing, lin,
                                              compute_dtype, forward=forward)
        return grads, loss, ntok

    def step_fn(state: dict, batch: tuple, rng: Optional[torch.Generator]):
        if not donate:
            state = tree_map(torch.clone, state)
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = tuple(torch.as_tensor(a, device=dev) for a in batch)
        if accum == 1:
            grads, loss, ntok = grads_of(params, batch, rng)
        else:
            grads, loss, ntok = grads_of(params, tuple(a[0] for a in batch), rng)
            for i in range(1, accum):
                g, l_i, n_i = grads_of(params, tuple(a[i] for a in batch), rng)
                torch._foreach_add_(grads, g)
                loss, ntok = loss + l_i, ntok + n_i
            # the mean of the microbatches' mean losses
            torch._foreach_div_(grads, float(accum))
        grads, loss = _data_summed(grads, loss, mesh)
        tx.update_(tree_leaves(params), grads, state["opt_state"])
        state["step"].add_(1)
        return state, {"loss": loss, "ntokens": ntok}

    return step_fn


def map_state(state_tree: dict, params_fn, other_fn) -> dict:
    """``params_fn`` on the parameters and Adam's moments, ``other_fn`` on
    the counts and the step."""
    adam, sched = state_tree["opt_state"]
    return {"params": params_fn(state_tree["params"]),
            "opt_state": (ScaleByAdamState(other_fn(adam.count), params_fn(adam.mu),
                                           params_fn(adam.nu)),
                          ScaleByScheduleState(other_fn(sched.count))),
            "step": other_fn(state_tree["step"])}


def shard_state(state_tree: dict, mesh) -> dict:
    """This rank's train state on the mesh's device: the parameters and
    Adam's moments sliced by ``param_pspecs`` (``parallel.shard_params``),
    the counts and the step replicated.  New tensors: the given state is
    left as it was."""
    return map_state(state_tree, lambda tree: tree_map(torch.clone, shard_params(tree, mesh)),
                      lambda x: x.to(mesh.device, copy=True))


def gather_state(state_tree: dict, mesh) -> dict:
    """The whole train state from this rank's slices (the inverse of
    :func:`shard_state`), the same on every rank of the model group."""
    return map_state(state_tree, lambda tree: gather_params(tree, mesh), lambda x: x)


def shard_batch(batch: tuple, mesh, accum: int = 1) -> tuple:
    """This rank's rows of a whole batch (dim 0, or dim 1 under ``accum``),
    on the mesh's device: the JAX package's ``P("data")`` or
    ``P(None, "data")`` placement."""
    dim = 0 if accum == 1 else 1
    return tuple(local_rows(torch.as_tensor(a), mesh, dim).to(mesh.device) for a in batch)


def batch_to_arrays(b, accum: int = 1, device=None) -> tuple:
    """A ``data.dataset.Batch`` -> the train step's tuple of tensors on
    ``device`` (the card when None), folded to [accum, B / accum, ...]
    microbatches when ``accum > 1``.  To a card the arrays go through pinned
    memory with a non-blocking copy."""
    dev = resolve_device(device)
    out = []
    for a in (b.src, b.tgt_in, b.tgt_y, b.src_mask, b.tgt_mask):
        a = np.ascontiguousarray(a)
        if accum > 1:
            if a.shape[0] % accum:
                raise ValueError(f"batch {a.shape[0]} not divisible by accum {accum}")
            a = a.reshape(accum, a.shape[0] // accum, *a.shape[1:])
        t = torch.from_numpy(a)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out.append(t)
    return tuple(out)


def prefetch(iterable: Iterable, depth: int = 2) -> Iterable:
    """Run ``iterable`` in a background thread, ``depth`` items ahead, so
    that collation and the copy to the card overlap the device's step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item


def run_epoch(step_fn, state_tree: dict, loader: Iterable, rng: Optional[torch.Generator],
              accum: int = 1, log_every: int = 40, log_fn=print,
              prefetch_depth: int = 2) -> tuple[dict, dict]:
    """One pass over ``loader`` (``Batch`` items) -> (state, epoch metrics).

    The batches go to the parameters' device.  The loss and token totals
    accumulate on the device: the host reads them back only at the log
    points (every ``log_every`` steps) and once at the end."""
    dev = tree_leaves(state_tree["params"])[0].device
    total_loss = total_tokens = None
    t0 = time.time()
    window_start_tokens = 0.0
    arrays = (batch_to_arrays(b, accum, dev) for b in loader)
    it = prefetch(arrays, prefetch_depth) if prefetch_depth else arrays
    for i, batch in enumerate(it):
        state_tree, metrics = step_fn(state_tree, batch, rng)
        if total_loss is None:
            total_loss, total_tokens = metrics["loss"], metrics["ntokens"]
        else:
            total_loss = total_loss + metrics["loss"]
            total_tokens = total_tokens + metrics["ntokens"]
        if log_every and i % log_every == 1:
            tot = float(total_tokens)
            dt = time.time() - t0
            log_fn(f"step {i:5d} loss/tok "
                   f"{float(metrics['loss']) / max(float(metrics['ntokens']), 1):.4f} "
                   f"tok/s {(tot - window_start_tokens) / max(dt, 1e-9):.1f}")
            t0, window_start_tokens = time.time(), tot
    if total_loss is None:
        return state_tree, {"loss_per_token": 0.0, "tokens": 0}
    return state_tree, {"loss_per_token": float(total_loss) / max(float(total_tokens), 1),
                        "tokens": int(total_tokens)}
