"""Megatron tensor-parallel layout of the parameters and the W8A8/W4A8
payloads (port of ``onnx_transformer_tpu/parallel/sharding.py``).

Attention heads and the FFN's hidden units split over the ``model`` axis,
so a rank holds h/TP heads and d_ff/TP hidden units (weights stored (in,
out)):

- q/k/v projections and ffn w1: column-parallel, ``(None, "model")``, bias
  ``("model",)``;
- attention out-projection and ffn w2: row-parallel, ``("model", None)``,
  bias replicated (added once, after the sum over the group);
- embeddings, LayerNorms and the generator: replicated.

A spec is a tuple of axis names per dimension, ``()`` for replicated (JAX's
``PartitionSpec`` as a tuple).  Where JAX places a whole array on the mesh,
:func:`shard_params` and :func:`shard_payloads` return this rank's slices
(packed int4 weights by whole row pairs), and :func:`gather_params` gives
the whole arrays back, as fetching a global array does; the collectives
that GSPMD then inserts are the model's and the linear impls' own calls
(``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Any

import torch

from onnx_transformer_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

COLUMN = {"w": (None, MODEL_AXIS), "b": (MODEL_AXIS,)}
ROW = {"w": (MODEL_AXIS, None), "b": ()}


def _ln_pspec() -> dict:
    return {"scale": (), "bias": ()}


def _attn_pspec() -> dict:
    return {"q": COLUMN, "k": COLUMN, "v": COLUMN, "o": ROW}


def _ffn_pspec() -> dict:
    return {"w1": COLUMN, "w2": ROW}


def param_pspecs(params: Any) -> Any:
    """The spec tree matching the Transformer parameter tree."""
    enc = [{"self_attn": _attn_pspec(), "ffn": _ffn_pspec(), "ln0": _ln_pspec(),
            "ln1": _ln_pspec()} for _ in params["encoder"]["layers"]]
    dec = [{"self_attn": _attn_pspec(), "src_attn": _attn_pspec(), "ffn": _ffn_pspec(),
            "ln0": _ln_pspec(), "ln1": _ln_pspec(), "ln2": _ln_pspec()}
           for _ in params["decoder"]["layers"]]
    return {"src_embed": {"lut": ()}, "tgt_embed": {"lut": ()},
            "encoder": {"layers": enc, "ln": _ln_pspec()},
            "decoder": {"layers": dec, "ln": _ln_pspec()},
            "generator": {"w": (), "b": ()}}


def check_divisible(num_heads: int, d_ff: int, model: int) -> None:
    """Heads and FFN hidden units must split evenly over ``model`` ranks."""
    if num_heads % model or d_ff % model:
        raise ValueError(f"num_heads {num_heads} and d_ff {d_ff} must both be divisible "
                         f"by the model axis, {model}")


def _local(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` laid out by ``spec``."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            if x.shape[dim] % mesh.model:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                                 f"model={mesh.model}")
            return x.chunk(mesh.model, dim)[mesh.model_rank].clone()
    return x


def map_specs(params: Any, specs: Any, fn) -> Any:
    """The tree of ``params`` with ``fn(leaf, spec)`` at every leaf, ``spec``
    the leaf's entry in the matching spec tree ``specs``."""
    if isinstance(params, dict):
        return {k: map_specs(v, specs[k], fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_specs(v, s, fn) for v, s in zip(params, specs)]
    return fn(params, specs)


def replicated_mask(params: Any) -> Any:
    """A tree of bools matching ``params``: True where a leaf is replicated
    over ``model`` (every rank holds it whole)."""
    return map_specs(params, param_pspecs(params), lambda _, spec: MODEL_AXIS not in spec)


def shard_params(params: Any, mesh) -> Any:
    """This rank's slices of a full parameter tree, on the mesh's device."""
    dev = mesh.device
    return map_specs(params, param_pspecs(params),
                     lambda x, spec: _local(x, spec, mesh).to(dev))


def param_shardings(params: Any) -> Any:
    """Each leaf's DTensor placements over a (data, model) mesh:
    ``Shard(dim)`` on ``model`` where the spec names it, ``Replicate()``
    elsewhere (JAX's ``NamedSharding`` binds a mesh too; a placement holds
    for any mesh, and ``distribute_tensor(x, mesh.device_mesh, placements)``
    holds :func:`shard_params`'s slice on each rank)."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(spec: tuple) -> tuple:
        return tuple(next((Shard(d) for d, a in enumerate(spec) if a == axis), Replicate())
                     for axis in (DATA_AXIS, MODEL_AXIS))

    return map_specs(params, param_pspecs(params), lambda _, spec: placements(spec))


def linear_kind(name: str) -> str:
    """"column", "row" or "replicated" for a linear's reference name."""
    last = name.rsplit(".", 1)[-1]
    if name.endswith("w_1") or (".linears." in name and last in ("0", "1", "2")):
        return "column"
    if name.endswith("w_2") or (".linears." in name and last == "3"):
        return "row"
    return "replicated"


PAYLOAD_SPECS = {
    "column": {"wq": (None, MODEL_AXIS), "wq_packed": (None, MODEL_AXIS), "sw": (MODEL_AXIS,),
               "b": (MODEL_AXIS,)},
    "row": {"wq": (MODEL_AXIS, None), "wq_packed": (MODEL_AXIS, None), "sw": (), "b": ()},
    "replicated": {"wq": (), "wq_packed": (), "sw": (), "b": ()},
}


def shard_payloads(payloads: dict, mesh) -> dict:
    """This rank's slices of W8A8 payloads ({name: {wq, sw, b}}) or W4A8
    ones ({name: {wq_packed, sw, b}}, two int4 rows a byte) in the layout
    of :func:`param_pspecs`: column-parallel ``wq[:, cols]``, ``sw[cols]``,
    ``b[cols]``; row-parallel ``wq[rows, :]`` with ``sw`` and ``b`` whole
    (packed: whole row pairs, so K / model must be even); the rest as they
    are."""
    out = {}
    for name, p in payloads.items():
        if set(p) not in ({"wq", "sw", "b"}, {"wq_packed", "sw", "b"}):
            raise ValueError(f"{name}: only W8A8 payloads (wq, sw, b) and W4A8 ones "
                             f"(wq_packed, sw, b) shard, not {sorted(p)}")
        kind = linear_kind(name)
        if kind == "row" and "wq_packed" in p and p["wq_packed"].shape[0] % mesh.model:
            raise ValueError(f"{name}: K = {2 * p['wq_packed'].shape[0]} rows of packed int4 "
                             f"do not split into whole row pairs over model={mesh.model} "
                             "(K / model must be even)")
        out[name] = {k: _local(v, PAYLOAD_SPECS[kind][k], mesh).to(mesh.device)
                     for k, v in p.items()}
    return out


def _whole(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole array of which ``x`` is this rank's slice laid out by
    ``spec``: the model group's slices gathered in rank order."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            import torch.distributed as dist

            parts = [torch.empty_like(x) for _ in range(mesh.model)]
            dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
            return torch.cat(parts, dim=dim)
    return x


def gather_params(params: Any, mesh) -> Any:
    """The whole parameter tree from this rank's slices (the inverse of
    :func:`shard_params`), the same on every rank of the model group: what
    fetching a sharded global array gives in the JAX package."""
    return map_specs(params, param_pspecs(params), lambda x, spec: _whole(x, spec, mesh))
