"""Multi-process data-parallel training (port of
``onnx_transformer_tpu/parallel/multihost.py``).

The JAX package splits a multi-host run into rendezvous
(``initialize_distributed``), data (each process loads only its shard,
``BucketedLoader(num_shards=N, shard_index=i)``, and stitches it into a
global data-sharded array) and compute (the same jitted step as one
process).  Here every rank is a process already (``parallel.launch`` on one
host, ``initialize_distributed`` across hosts), so a rank's loader shard is
its rows of the data-sharded batch as they are: :func:`global_batch` puts
them on the rank's device and checks that the ranks of the data group step
through the same shapes, which JAX's global array assembly requires.  The
step is ``make_train_step(..., mesh=mesh)``: its gradient sum over
``data`` is the cross-host all-reduce that XLA inserts in the JAX package.

The loader shard of a rank is its data rank's: ``BucketedLoader(...,
num_shards=mesh.data, shard_index=mesh.data_rank)``, the same on every rank
of a model group.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from onnx_transformer_tpu_torch.params import tree_leaves, tree_unflatten


def global_batch(batch: tuple, mesh) -> tuple:
    """This rank's loader shard (numpy arrays or tensors, [B_local, ...],
    or [accum, B_local, ...] under accumulation) as its rows of the
    data-sharded batch, on the mesh's device.  Raises ``ValueError`` where
    the ranks of the data group hold different shapes (their steps would
    not line up)."""
    out = tuple(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
                .to(mesh.device) for a in batch)
    if mesh.data > 1:
        shapes = torch.tensor([d for a in out for d in a.shape], dtype=torch.int64)
        seen = [torch.empty_like(shapes) for _ in range(mesh.data)]
        dist.all_gather(seen, shapes, group=mesh.data_group)
        if any(not torch.equal(s, shapes) for s in seen):
            raise ValueError(f"the data ranks' batches differ in shape: "
                             f"{[s.tolist() for s in seen]}")
    return out


def replicate_tree(tree: Any, mesh) -> Any:
    """The tree of rank 0 of the world on every rank, on the mesh's device:
    each rank's leaves are replaced by rank 0's, broadcast through one flat
    buffer a dtype.  (The JAX package requires the processes to hold equal
    values and does not check them; broadcasting makes them equal, from
    the same seed or checkpoint or not.)"""
    leaves = [x.to(mesh.device) for x in tree_leaves(tree)]
    out = list(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=0)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i]).clone()
    return tree_unflatten(tree, out)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor (every rank holds it whole) as host numpy."""
    return x.detach().cpu().numpy()
