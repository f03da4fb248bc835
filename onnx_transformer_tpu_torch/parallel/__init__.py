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
``replicate_tree``, ``fetch_replicated``).  Pipeline parallelism
(``pipeline``) adds a ``pipe`` axis: a (data, pipe, model) mesh
(``make_pipeline_mesh``), the stacked layers split into stages
(``stack_pipeline_params``, ``shard_pipeline_state``), the GPipe schedule
over stage-to-stage sends (``pipeline_apply``), sequence parallelism
(``sp_constrain``) and the DP x PP x TP train step
(``make_pipeline_train_step``); ``dryrun`` drives them all, as the JAX
package's ``dryrun_multichip``.  (The pipeline's names load with their
module on first use: it builds on the model and the trainer, which import
this package.)
"""

from onnx_transformer_tpu_torch.parallel.collectives import (
    data_gather, data_sum, model_copy, model_max, model_sum, pipe_broadcast, pipe_exchange,
    pipe_sum, seq_gather, seq_split,
)
from onnx_transformer_tpu_torch.parallel.launch import launch
from onnx_transformer_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, gather_rows, initialize_distributed, local_rows,
    make_mesh, mesh_generator,
)
from onnx_transformer_tpu_torch.parallel.multihost import (
    fetch_replicated, global_batch, replicate_tree,
)
from onnx_transformer_tpu_torch.parallel.sharding import (
    gather_params, param_pspecs, param_shardings, shard_params, shard_payloads,
)

_PIPELINE = (
    "make_pipeline_mesh", "stack_pipeline_params", "unstack_pipeline_params",
    "pipeline_param_pspecs", "shard_pipeline_state", "gather_pipeline_params", "sp_constrain",
    "pipeline_apply", "pipelined_forward_logits", "pipeline_value_and_grad",
    "make_pipeline_train_step",
)


def __getattr__(name):
    if name in _PIPELINE:
        from onnx_transformer_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Mesh", "make_mesh", "initialize_distributed",
    "local_rows", "gather_rows", "mesh_generator", "launch", "model_sum", "model_copy",
    "model_max", "data_sum", "data_gather", "pipe_exchange", "pipe_broadcast", "pipe_sum",
    "seq_split", "seq_gather", "param_pspecs", "param_shardings", "shard_params",
    "gather_params", "shard_payloads", "global_batch", "replicate_tree", "fetch_replicated",
    *_PIPELINE,
]
