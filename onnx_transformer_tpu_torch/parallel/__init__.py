"""Tensor parallelism for serving (port of ``onnx_transformer_tpu/parallel/``).

One process per rank (``launch``), a (data, model) mesh of them
(``make_mesh``), Megatron column/row shardings of the parameters and the
W8A8 payloads over ``model`` (``shard_params``, ``shard_payloads``), and the
collectives that GSPMD inserts in the JAX package written out
(``collectives``): the row-parallel sum and the per-token maximum over
``model``, the gather of batch rows over ``data``.  The model takes the mesh
as a view (``Transformer(cfg, mesh=mesh)``), the W8A8 linears as an
argument (``make_w8a8_linear_impl(..., mesh=mesh)``); the decodes split
their batch over ``data``.  Pipeline parallelism, multi-host training and
the trainer's mesh are not ported yet; ``mesh.initialize_distributed``
(several hosts) and ``sharding.param_shardings`` (DTensor placements) are
ported for them and not exported.
"""

from onnx_transformer_tpu_torch.parallel.collectives import data_gather, model_max, model_sum
from onnx_transformer_tpu_torch.parallel.launch import launch
from onnx_transformer_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, local_rows, make_mesh,
)
from onnx_transformer_tpu_torch.parallel.sharding import param_pspecs, shard_params, shard_payloads

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "local_rows", "gather_rows", "launch",
    "model_sum", "model_max", "data_gather", "param_pspecs", "shard_params",
    "shard_payloads",
]
