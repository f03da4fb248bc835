"""Pipeline parallelism (port of ``onnx_transformer_tpu/parallel/pipeline.py``):
GPipe microbatch pipelining over a ``pipe`` mesh axis, composed with tensor
parallelism over ``model`` and data parallelism over ``data``, and
Megatron sequence parallelism in the regions between the TP blocks.

- The encoder and decoder layers are stacked on a leading layer dim
  (:func:`stack_pipeline_params`), and a rank holds its stage's ``L /
  pipe`` contiguous layers, each sliced over ``model`` as
  ``param_pspecs`` says (:func:`shard_pipeline_state`;
  :func:`gather_pipeline_params` gives the whole arrays back).
- :func:`pipeline_apply` runs a stacked layer sequence as the GPipe
  schedule of ``n_micro + pipe - 1`` ticks: at tick ``t`` stage ``s``
  computes microbatch ``t - s`` and hands its output to stage ``s + 1``
  (``collectives.pipe_exchange``, a send and a receive posted together);
  the last stage's outputs are broadcast over ``pipe``, so every stage
  holds the whole result, as JAX's ``out_specs=P()``.  Inside a stage the
  model's tensor-parallel view and the data-parallel sums work as they do
  without a pipeline.
- Sequence parallelism (:func:`sp_constrain`): under ``model`` > 1 the
  embeddings' scale, positional encoding and dropout, and the final
  LayerNorms, run on the rank's ``T / model`` positions and are gathered
  before the next TP block and before the generator.

Where the JAX package's names went:

- ``jax.shard_map`` manual over ``pipe`` with ``check_vma=False``, its
  ``lax.scan`` of ticks and the transposed ``ppermute`` of its backward
  become the explicit schedules of ``_Pipeline``, one
  ``torch.autograd.Function`` over the stage's parameters, ``x`` and the
  tensors of ``extras``: its forward runs the ticks and keeps each
  microbatch's local graph; its backward runs the reverse ticks, taking a
  microbatch's cotangent from the next stage, calling
  ``torch.autograd.grad`` on the local graph and sending the input's
  cotangent to the previous stage.  (One autograd node per send would
  deadlock: the engine skips a node whose output got no gradient, and its
  partner then waits in its receive.)  Each cotangent is counted once: the
  output is the same on every rank, which computes the same loss from it,
  so the last stage's cotangent is whole and taken as it is; the input's
  exists on stage 0 and is broadcast over ``pipe``; the cotangents of
  ``extras`` (the encoder memory that every decoder stage reads) are
  partial and summed over ``pipe``, the transpose of JAX's
  ``in_specs=P()``; a stage's parameters keep their local gradients.
- The bubble: JAX computes discarded work on bubble ticks and seeds its
  buffer with real rows to keep those gradients finite; here a stage
  computes only the microbatches it owns.
- The recursive-doubling hand-out of the last stage's bank is one
  ``dist.broadcast`` (``collectives.pipe_broadcast``).
- ``_RngSource``'s key folding (``fold_in`` of the global layer index and
  the microbatch into ``base_key``) becomes a ``torch.Generator`` per stage
  and microbatch, seeded from ``base_key`` (an int), the pipe rank and the
  microbatch, from which the stage's layers draw in call order.  The
  replicated regions draw from the caller's ``rng``
  (``parallel.mesh_generator``: alike over ``pipe`` and ``model``), so
  every stage draws their masks alike and the replicated leaves'
  gradients stay equal.
- ``sp_constrain``'s ``with_sharding_constraint`` becomes the explicit
  pair ``collectives.seq_split`` / ``seq_gather`` around a region, a length
  that ``model`` does not divide padded as GSPMD pads it; the replicated
  parameters used in a region (embedding tables, final norms) enter it
  through ``model_copy``, so their gradients are summed over the group.

Layer names: as in the JAX package the pipelined layers run under the
names ``encoder.layers.pp`` and ``decoder.layers.pp``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from onnx_transformer_tpu_torch.models.transformer import Transformer, default_linear
from onnx_transformer_tpu_torch.ops import layers as L
from onnx_transformer_tpu_torch.parallel.collectives import (
    model_copy, pipe_broadcast, pipe_exchange, pipe_sum, seq_gather, seq_split,
)
from onnx_transformer_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, rank_device,
)
from onnx_transformer_tpu_torch.parallel.sharding import map_specs, param_pspecs
from onnx_transformer_tpu_torch.params import tree_leaves, tree_map, tree_unflatten
from onnx_transformer_tpu_torch.quant.core import true_div
from onnx_transformer_tpu_torch.quant.w8a8 import shard_linear_impl
from onnx_transformer_tpu_torch.train.trainer import (
    AdamNoam, make_train_step, map_state, value_and_grad,
)

# large odd multipliers folding the pipe rank and the microbatch into a
# stage's dropout seed
_STAGE_STRIDE = 0xD1B54A32D192ED03
_MICRO_STRIDE = 0x94D049BB133111EB


def make_pipeline_mesh(data: int = 1, pipe: int = 2, model: int = 1, device=None) -> Mesh:
    """This rank's (data, pipe, model) mesh over the whole world of the
    default process group, ``model`` innermost (its ranks adjacent) as in
    JAX.  Raises ``ValueError`` where the sizes do not cover the world.
    ``device`` as ``make_mesh``'s."""
    if not dist.is_initialized():
        raise RuntimeError("make_pipeline_mesh needs a process group: run under "
                           "parallel.launch, or call initialize_distributed first")
    n = dist.get_world_size()
    if data * pipe * model != n:
        raise ValueError(f"a mesh of {data} x {pipe} x {model} does not cover the {n} ranks")
    dev = rank_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, pipe, model),
                          mesh_dim_names=(DATA_AXIS, PIPE_AXIS, MODEL_AXIS))
    d_rank, p_rank, m_rank = dm.get_coordinate()
    mesh = Mesh(dm, data, model, d_rank, m_rank, dm.get_group(DATA_AXIS),
                dm.get_group(MODEL_AXIS), dev, pipe, p_rank, dm.get_group(PIPE_AXIS))
    if dev.type == "cuda" and pipe > 1:
        # every rank of the group in its first call, as nccl's point-to-point
        # operations ask
        pipe_sum([torch.zeros(1, device=dev)], mesh)
    return mesh


# ------------------------------------------------------- param (re)stacking

def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack(layers)


def stack_pipeline_params(params: Any) -> Any:
    """List-of-layer params -> stacked [L, ...] encoder and decoder stacks,
    the layout whose leading dim a pipeline splits into stages."""
    out = dict(params)
    for k in ("encoder", "decoder"):
        out[k] = {"layers": _stack(params[k]["layers"]), "ln": params[k]["ln"]}
    return out


def unstack_pipeline_params(params: Any) -> Any:
    """The inverse of :func:`stack_pipeline_params` (checkpoint interop)."""
    out = dict(params)
    for k in ("encoder", "decoder"):
        stacked = params[k]["layers"]
        n = tree_leaves(stacked)[0].shape[0]
        out[k] = {"layers": [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)],
                  "ln": params[k]["ln"]}
    return out


def _prepend_pipe(spec_tree: Any) -> Any:
    if isinstance(spec_tree, dict):
        return {k: _prepend_pipe(v) for k, v in spec_tree.items()}
    return (PIPE_AXIS, *spec_tree)


def pipeline_param_pspecs(stacked_params: Any) -> Any:
    """The spec tree of stacked params: the layer stacks ``("pipe",
    <TP spec>)``, everything else the tensor-parallel layout of
    ``sharding.param_pspecs``."""
    specs = param_pspecs({k: {"layers": [None]} for k in ("encoder", "decoder")})
    for k in ("encoder", "decoder"):
        specs[k]["layers"] = _prepend_pipe(specs[k]["layers"][0])
    return specs


def _stage_slice(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` laid out by ``spec``: its stage's block
    of a ``pipe`` dim, its part of a ``model`` dim."""
    for dim, axis in enumerate(spec):
        if axis == PIPE_AXIS:
            x = x.chunk(mesh.pipe, dim)[mesh.pipe_rank]
        elif axis == MODEL_AXIS:
            if x.shape[dim] % mesh.model:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                                 f"model={mesh.model}")
            x = x.chunk(mesh.model, dim)[mesh.model_rank]
    return x.to(mesh.device, copy=True)


def shard_pipeline_state(state_tree: dict, mesh) -> dict:
    """This rank's train state of stacked params: its stage's ``L / pipe``
    layers, each sliced over ``model``, Adam's moments mirroring them, the
    counts and the step replicated; new tensors on the mesh's device.
    Refuses a layer count that ``pipe`` does not divide."""
    params = state_tree["params"]
    for k in ("encoder", "decoder"):
        n = tree_leaves(params[k]["layers"])[0].shape[0]
        if n % mesh.pipe:
            raise ValueError(f"{n} {k} layers do not split into pipe={mesh.pipe} stages")
    specs = pipeline_param_pspecs(params)
    return map_state(state_tree,
                     lambda tree: map_specs(tree, specs, lambda x, s: _stage_slice(x, s, mesh)),
                     lambda x: x.to(mesh.device, copy=True))


def _gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_pipeline_params(params: Any, mesh) -> Any:
    """The whole stacked parameter tree from this rank's slices (the inverse
    of :func:`shard_pipeline_state`'s), the same on every rank: what
    fetching a global array gives in the JAX package.  For checkpoints and
    tests."""
    groups = {PIPE_AXIS: (mesh.pipe, mesh.pipe_group), MODEL_AXIS: (mesh.model, mesh.model_group)}

    def whole(x, spec):
        for dim, axis in enumerate(spec):
            n, group = groups.get(axis, (1, None))
            if n > 1:
                x = _gather(x, dim, n, group)
        return x

    return map_specs(params, pipeline_param_pspecs(params), whole)


# -------------------------------------------------- sequence parallelism

def _replicated(p: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated parameter entering a sequence-parallel region: its
    gradient, each rank's part of the positions, summed over ``model``."""
    return p if mesh is None or mesh.model == 1 else model_copy(p, mesh)


def sp_constrain(x: torch.Tensor, mesh: Optional[Mesh],
                 region: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Megatron-style sequence parallelism over the ``model`` axis.

    ``region(block, start)`` computes a region between TP blocks
    (embedding, final norm) on positions ``start ...`` of dim 1 (its output
    as long along dim 1 as its input); without it the region is the
    identity.  Without a mesh or at model = 1 this is ``region(x, 0)``.
    Under model > 1 each rank runs the region on its ``T / model``
    positions (the length padded up to a multiple of ``model``) and the
    blocks are gathered and cut back to ``T``: the same values as the
    whole region, with the sequence split over ``model`` inside it, JAX's
    contract.  A region must enter replicated parameters through
    ``model_copy`` and draw its dropout masks for the whole sequence (see
    the pipelined forward)."""
    if mesh is None or mesh.model == 1:
        return x if region is None else region(x, 0)
    t = x.shape[1]
    block = seq_split(x, mesh)
    if region is not None:
        block = region(block, mesh.model_rank * block.shape[1])
    return seq_gather(block, t, mesh)


def _region_dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
                    train: bool, start: int, t: int) -> torch.Tensor:
    """Dropout of positions ``start ...`` of dim 1 of a length-``t``
    sequence: the whole sequence's mask is drawn (as ``L.dropout`` draws
    it) and the block's part kept, padding positions kept."""
    if not train or rate == 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    whole = (x.shape[0], t, *x.shape[2:])
    mask = torch.rand(whole, generator=rng, device=x.device) < keep
    n = x.shape[1]
    if start + n > t:
        mask = torch.cat([mask, mask.new_ones((x.shape[0], start + n - t, *x.shape[2:]))], 1)
    return torch.where(mask.narrow(1, start, n), true_div(x, keep), 0.0)


# ----------------------------------------------------------- the pipeline

def _fold_seed(base: int, pipe_rank: int, micro: int) -> int:
    return (base + _STAGE_STRIDE * (pipe_rank + 1) + _MICRO_STRIDE * (micro + 1)) % (1 << 63)


class _Schedule:
    """One pipeline call's stage: its layers, the microbatching, the
    forward and the backward ticks (the module docstring)."""

    def __init__(self, layer_fn, stacked_lp, extras: dict, n_micro: int, mesh,
                 base_key: Optional[int], rows: int):
        self.layer_fn, self.stacked_lp, self.mesh = layer_fn, stacked_lp, mesh
        self.keys = [k for k, v in extras.items() if v is not None]
        self.extras = extras
        self.m, self.b = n_micro, rows // n_micro
        self.base_key = base_key
        self.graphs: dict = {}

    def rows(self, t: torch.Tensor, m: int) -> torch.Tensor:
        return t[m * self.b:(m + 1) * self.b]

    def stage(self, leaves: list, h: torch.Tensor, ex_m: dict, m: int) -> torch.Tensor:
        """This stage's layers on microbatch ``m``."""
        lp = tree_unflatten(self.stacked_lp, leaves)
        gen = None
        if self.base_key is not None:
            gen = torch.Generator(device=h.device).manual_seed(
                _fold_seed(self.base_key, self.mesh.pipe_rank, m))
        for i in range(leaves[0].shape[0]):
            h = self.layer_fn(tree_map(lambda x: x[i], lp), h, ex_m, gen)
        return h

    def forward(self, x: torch.Tensor, leaves: list, ex: list, keep: bool,
                x_grad: bool = False) -> torch.Tensor:
        """The forward ticks -> the whole output on every stage.  With
        ``keep`` each microbatch's local graph is kept for
        :meth:`backward`, over ``leaves`` (detached, requiring grad where
        the parameters do) and this microbatch's rows of ``ex``."""
        mesh = self.mesh
        n_st, s, mm = mesh.pipe, mesh.pipe_rank, self.m
        x = x.detach()
        bank, recv = [None] * mm, None
        for t in range(mm + n_st - 1):
            m, out = t - s, None
            if 0 <= m < mm:
                h = self.rows(x, m) if s == 0 else recv
                ex_m = dict(self.extras)
                ex_m.update((k, self.rows(e, m).detach()) for k, e in zip(self.keys, ex))
                if keep:
                    h = h.detach().requires_grad_(s > 0 or x_grad)
                    grads_of = {k: ex_m[k].requires_grad_() for k, e in zip(self.keys, ex)
                                if e.requires_grad}
                    with torch.enable_grad():
                        y = self.stage(leaves, h, ex_m, m)
                    self.graphs[m] = (h, y, grads_of)
                else:
                    y = self.stage(leaves, h, ex_m, m)
                out = y.detach()
                if s == n_st - 1:
                    bank[m] = out
            wanted = s > 0 and 0 <= t + 1 - s < mm
            recv = pipe_exchange(out if s < n_st - 1 else None, s + 1,
                                 self.rows(x, 0) if wanted else None, s - 1, mesh)
        out = torch.cat(bank) if s == n_st - 1 else torch.empty_like(x)
        return pipe_broadcast(out, n_st - 1, mesh)

    def backward(self, g_out: torch.Tensor, leaves: list, ex: list,
                 x_grad: bool) -> tuple[Optional[torch.Tensor], list, list]:
        """The reverse ticks over the kept graphs -> (the input's cotangent
        on every stage, the stage's parameter gradients, the extras'
        gradients summed over ``pipe``)."""
        mesh = self.mesh
        n_st, s, mm = mesh.pipe, mesh.pipe_rank, self.m
        wants = [p for p in leaves if p.requires_grad]
        g_params: list = [None] * len(wants)
        g_ex = {k: torch.zeros_like(e) for k, e in zip(self.keys, ex) if e.requires_grad}
        g_x = torch.zeros_like(g_out) if x_grad else None
        recv = None
        for t in range(mm + n_st - 1):
            m, d_in = t - (n_st - 1 - s), None
            if 0 <= m < mm:
                h, y, ex_leaves = self.graphs.pop(m)
                cot = self.rows(g_out, m) if s == n_st - 1 else recv
                inputs = ([h] if h.requires_grad else []) + wants + list(ex_leaves.values())
                grads = list(torch.autograd.grad(y, inputs, cot, allow_unused=True,
                                                 materialize_grads=True))
                if h.requires_grad:
                    d_in = grads.pop(0)
                    if s == 0:
                        self.rows(g_x, m).copy_(d_in)
                for j, g in enumerate(grads[:len(wants)]):
                    g_params[j] = g if g_params[j] is None else g_params[j] + g
                for k, g in zip(ex_leaves, grads[len(wants):]):
                    self.rows(g_ex[k], m).add_(g)
                del h, y, grads
            wanted = s < n_st - 1 and 0 <= t + 2 - n_st + s < mm
            recv = pipe_exchange(d_in if s > 0 else None, s - 1,
                                 self.rows(g_out, 0) if wanted else None, s + 1, mesh)
        if g_x is not None:
            pipe_broadcast(g_x, 0, mesh)
        summed = dict(zip(g_ex, pipe_sum(list(g_ex.values()), mesh)))
        it = iter(g_params)
        return (g_x, [next(it) if p.requires_grad else None for p in leaves],
                [summed.get(k) for k in self.keys])


class _Pipeline(torch.autograd.Function):
    """The pipeline over the stage's parameter leaves, ``x`` and the
    tensors of ``extras`` (the module docstring)."""

    @staticmethod
    def forward(ctx, run: _Schedule, x, n_leaves: int, *tensors):
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in tensors[:n_leaves]]
        ex = list(tensors[n_leaves:])
        ctx.run, ctx.leaves, ctx.ex = run, leaves, ex
        return run.forward(x, leaves, ex, keep=True, x_grad=ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, g_out):
        g_x, g_params, g_ex = ctx.run.backward(g_out.contiguous(), ctx.leaves, ctx.ex,
                                               ctx.needs_input_grad[1])
        del ctx.run, ctx.leaves, ctx.ex
        return (None, g_x, None, *g_params, *g_ex)


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor, dict, Optional[torch.Generator]],
                                      torch.Tensor],
                   stacked_lp: Any, x: torch.Tensor, extras: dict, *, n_micro: int, mesh,
                   base_key: Optional[int] = None) -> torch.Tensor:
    """Run a stacked layer sequence as a GPipe pipeline over ``pipe``.

    ``layer_fn(lp, h, extras_m, gen)`` applies ONE layer to activations
    ``h`` [b, T, D] with that microbatch's ``extras_m`` (masks, memory) and
    a dropout generator (None without ``base_key``).  ``stacked_lp`` is
    this rank's stage's layers (``[L / pipe, ...]`` leaves), ``x`` this
    rank's data rows [B, T, D] (the same on every stage), ``extras`` a dict
    of batch-major tensors (or None) microbatched alongside ``x``.  Raises
    ``ValueError`` where ``n_micro`` does not divide B.  Returns the whole
    output [B, T, D] on every stage; under autograd, differentiable in the
    stage's parameters, ``x`` and the tensors of ``extras`` (the module
    docstring)."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro {n_micro}")
    leaves = tree_leaves(stacked_lp)
    run = _Schedule(layer_fn, stacked_lp, extras, n_micro, mesh, base_key, x.shape[0])
    ex = [extras[k] for k in run.keys]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in [x, *leaves, *ex])):
        return run.forward(x, leaves, ex, keep=False)
    return _Pipeline.apply(run, x, len(leaves), *leaves, *ex)


# ------------------------------------------------- full pipelined forward

def _seed_of(rng: Optional[torch.Generator]) -> Optional[int]:
    """A pipeline's dropout seed drawn from ``rng`` (None without one)."""
    if rng is None:
        return None
    return int(torch.randint(0, 1 << 62, (1,), generator=rng, device=rng.device))


def pipelined_forward_logits(model: Transformer, params: Any, src, tgt_in, src_mask,
                             tgt_mask, *, mesh, n_micro: int,
                             rng: Optional[torch.Generator] = None, train: bool = False,
                             lin=default_linear, log_probs: bool = True) -> torch.Tensor:
    """Teacher-forced log-probs [B, T, V] of this rank's rows, with the
    encoder and decoder stacks each run as a pipeline (``params`` this
    rank's, from :func:`shard_pipeline_state`).  The embeddings, final
    norms and generator are replicated over ``pipe``; the embeddings and
    final norms run sequence-parallel over ``model`` (:func:`sp_constrain`).
    The encoder memory is every decoder stage's extra.  ``rng`` (from
    ``parallel.mesh_generator``) feeds the replicated regions' dropout and
    the two pipelines' seeds.  ``log_probs=False`` gives the logits."""
    cfg = model.cfg
    tm = model if model.mesh is mesh else Transformer(cfg, mesh)
    lin = shard_linear_impl(lin, mesh)
    rng = rng if train else None
    smask4 = src_mask[:, None, :, :] if src_mask is not None else None
    tmask4 = tgt_mask[:, None, :, :] if tgt_mask is not None else None

    def embed(table, t):
        def region(ids, start):
            x = L.embed(ids, _replicated(table, mesh))
            x = L.positional_encoding(x, start, cfg.max_len)
            return _region_dropout(x, cfg.dropout, rng, train, start, t)
        return region

    def norm(ln):
        return lambda h, start: L.layer_norm(h, _replicated(ln["scale"], mesh),
                                             _replicated(ln["bias"], mesh))

    x = sp_constrain(src, mesh, embed(params["src_embed"]["lut"], src.shape[1]))

    def enc_layer(lp, h, ex, gen):
        return tm._encoder_layer(lp, h, ex["mask"], gen, train, None, None, lin,
                                 "encoder.layers.pp")

    x = pipeline_apply(enc_layer, params["encoder"]["layers"], x, {"mask": smask4},
                       n_micro=n_micro, mesh=mesh, base_key=_seed_of(rng))
    memory = sp_constrain(x, mesh, norm(params["encoder"]["ln"]))

    y = sp_constrain(tgt_in, mesh, embed(params["tgt_embed"]["lut"], tgt_in.shape[1]))

    def dec_layer(lp, h, ex, gen):
        # f: the memory feeds the layer's column-parallel cross k/v
        return tm._decoder_layer(lp, h, model_copy(ex["memory"], mesh), ex["tmask"],
                                 ex["smask"], gen, train, None, None, lin,
                                 "decoder.layers.pp")

    y = pipeline_apply(dec_layer, params["decoder"]["layers"], y,
                       {"memory": memory, "tmask": tmask4, "smask": smask4},
                       n_micro=n_micro, mesh=mesh, base_key=_seed_of(rng))
    y = sp_constrain(y, mesh, norm(params["decoder"]["ln"]))
    return tm.generate(params, y, lin=lin, log_probs=log_probs)


def _pipelined(model: Transformer, mesh, n_micro: int, lin) -> Callable:
    """The pipelined training forward as ``trainer``'s ``forward``."""
    return partial(pipelined_forward_logits, model, mesh=mesh, n_micro=n_micro, train=True,
                   lin=shard_linear_impl(lin, mesh), log_probs=False)


def pipeline_value_and_grad(model: Transformer, params: Any, batch: tuple, *, mesh,
                            n_micro: int, rng: Optional[torch.Generator] = None,
                            smoothing: float = 0.1, lin=default_linear) -> tuple[tuple, list]:
    """``trainer.value_and_grad`` of the pipelined forward on this rank's
    rows ``batch`` (the 5-tuple of ``batch_to_arrays``): the whole batch's
    KL over the whole batch's token count, the gradients of this rank's
    parameters (a list in ``tree_leaves`` order) summed over ``data``."""
    model = model if model.mesh is mesh else Transformer(model.cfg, mesh)
    return value_and_grad(model, params, batch, rng, smoothing,
                          forward=_pipelined(model, mesh, n_micro, lin))


def make_pipeline_train_step(model: Transformer, tx: AdamNoam, mesh, n_micro: int,
                             smoothing: float = 0.1, donate: bool = True, lin=default_linear):
    """The DP x PP x TP (+ SP) train step over stacked params: ``fn(state_tree,
    batch, rng) -> (state_tree, {"loss", "ntokens"})`` of one rank, with
    ``state_tree`` from :func:`shard_pipeline_state`, ``batch`` this rank's
    rows (``trainer.shard_batch``) and ``rng`` from
    ``parallel.mesh_generator`` (or None): ``trainer.make_train_step`` over
    ``mesh`` with the pipelined forward (its loss, its token count summed
    over ``data``, its one flat ``data_sum`` and ``AdamNoam.update_`` on the
    rank's slices)."""
    model = model if model.mesh is mesh else Transformer(model.cfg, mesh)
    return make_train_step(model, tx, mesh=mesh, smoothing=smoothing, donate=donate,
                           forward=_pipelined(model, mesh, n_micro, lin))
