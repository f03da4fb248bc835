"""Tensor and data parallelism (port of ``onnx_transformer_tpu/parallel/``).

One process per rank (``launch`` on one host, ``initialize_distributed``
across hosts), a (data, model) mesh of them (``make_mesh``), Megatron
column/row shardings of the parameters and the W8A8/W4A8 payloads over
``model`` (``shard_params``, ``shard_payloads``, ``param_shardings`` as
DTensor placements, ``gather_params`` back), and the collectives that GSPMD
inserts in the JAX package written out (``collectives``): the row-parallel
sum ``model_sum`` and its partner ``model_copy`` (Megatron's g and f under
autograd), the per-token maximum over ``model``, the data-parallel sum of
the gradients, the gather of batch rows over ``data``.  The model takes the
mesh as a view (``Transformer(cfg, mesh=mesh)``), the linear impls as an
argument (``make_w8a8_linear_impl(..., mesh=mesh)``); the decodes split
their batch over ``data``; the trainer takes ``mesh=``
(``train.trainer.make_train_step``, ``shard_state``, ``shard_batch``), and
``multihost`` feeds it from per-rank loader shards (``global_batch``,
``replicate_tree``, ``fetch_replicated``).  Pipeline parallelism is not
ported yet.
"""

from onnx_transformer_tpu_torch.parallel.collectives import (
    data_gather, data_sum, model_copy, model_max, model_sum,
)
from onnx_transformer_tpu_torch.parallel.launch import launch
from onnx_transformer_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, initialize_distributed, local_rows, make_mesh,
    mesh_generator,
)
from onnx_transformer_tpu_torch.parallel.multihost import (
    fetch_replicated, global_batch, replicate_tree,
)
from onnx_transformer_tpu_torch.parallel.sharding import (
    gather_params, param_pspecs, param_shardings, shard_params, shard_payloads,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "initialize_distributed", "local_rows",
    "gather_rows", "mesh_generator", "launch", "model_sum", "model_copy", "model_max",
    "data_sum", "data_gather", "param_pspecs", "param_shardings", "shard_params",
    "gather_params", "shard_payloads", "global_batch", "replicate_tree", "fetch_replicated",
]
