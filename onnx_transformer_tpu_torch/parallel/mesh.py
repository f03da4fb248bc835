"""The (data, model) device mesh on ``torch.distributed`` (port of
``onnx_transformer_tpu/parallel/mesh.py``), and the (data, pipe, model)
mesh of pipeline parallelism (``parallel/pipeline.py``) as the same view.

The JAX package runs one controller over every device and lets GSPMD insert
the collectives.  Here each rank is a process of one process group
(``parallel/launch.py`` starts the ranks of one host; ``initialize_distributed``
joins the ranks of several), ``make_mesh`` lays the world out as data x
model with ``init_device_mesh``, and every collective is an explicit call on
one of the rank's two groups (``parallel/collectives.py``): the ``model``
group of the ranks that share a batch row and hold the shards of one weight,
the ``data`` group of the ranks that hold the same shard of different rows.
A pipeline mesh adds the ``pipe`` group of the ranks that hold the stages
of one model replica; its ``data`` group is then the ranks that share
(pipe, model) coordinates and its ``model`` group those that share (data,
pipe), so the tensor-parallel view and the data-parallel sums work inside a
stage as they do without one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from onnx_transformer_tpu_torch.device import resolve_device
from onnx_transformer_tpu_torch.parallel.collectives import data_gather

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def default_backend(device) -> str:
    """nccl for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to a world of ``num_processes`` ranks, rendezvous at
    ``coordinator_address`` ("host:port", or any ``init_method`` URL), as
    rank ``process_id`` (the reference's ``dist.init_process_group``).  The
    backend is ``backend``, else nccl where a card is present and gloo
    without one.  A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    url = coordinator_address or ""
    if "://" not in url:
        url = f"tcp://{url}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the data x model mesh: the ``DeviceMesh``, the
    mesh's sizes, this rank's coordinates in it, the process groups of its
    two axes and the device its tensors live on; on a pipeline mesh also
    the ``pipe`` axis's size, coordinate and group (1, 0 and None
    elsewhere)."""

    device_mesh: object
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    device: torch.device
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: object = None


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """This rank's (data, model) mesh over the whole world of the default
    process group; ``data=-1`` takes all the ranks that ``model`` leaves.
    ``device`` is where this rank's tensors live (the card by default; it
    becomes the process's current card before the groups are made)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under parallel.launch, "
                           "or call initialize_distributed first")
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks are not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a mesh of {data} x {model} does not cover the {n} ranks")
    dev = rank_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    d_rank, m_rank = dm.get_coordinate()
    return Mesh(dm, data, model, d_rank, m_rank, dm.get_group(DATA_AXIS),
                dm.get_group(MODEL_AXIS), dev)


def rank_device(device=None) -> torch.device:
    """The device of this rank's tensors (the card by default), made the
    process's current card before any group is made."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    return dev


def local_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch ``x`` along ``dim``: the batch split over
    ``data``, which JAX's ``data_sharding`` (a ``P("data")`` placement, or
    ``P(None, "data")`` for ``dim=1``) asks GSPMD for."""
    if mesh is None or mesh.data == 1:
        return x
    if x.shape[dim] % mesh.data:
        raise ValueError(f"a batch of {x.shape[dim]} rows does not split over data={mesh.data}")
    n = x.shape[dim] // mesh.data
    return x.narrow(dim, mesh.data_rank * n, n)


# a large odd multiplier, so that the seeds of nearby data ranks and steps
# do not coincide
_DATA_SEED_STRIDE = 0x9E3779B97F4A7C15


def mesh_generator(seed: int, mesh: Optional[Mesh], device=None) -> torch.Generator:
    """A ``torch.Generator`` for this rank's dropout: seeded alike on every
    rank of a model group and of a pipe group, so that the replicated
    activations draw the same masks there (and the sharded ones, each rank
    keeping its block of one whole-tensor draw, one device's masks), and
    differently on each data rank, whose rows differ."""
    dev = resolve_device(device) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.data_rank
    return torch.Generator(device=dev).manual_seed((seed + _DATA_SEED_STRIDE * rank) % (1 << 63))


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The rows of every data rank gathered back in order, the same on every
    rank: what JAX's ``replicated`` (a ``P()`` placement of a result) asks
    GSPMD for."""
    if mesh is None or mesh.data == 1:
        return x
    return data_gather(x, mesh)
