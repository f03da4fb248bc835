"""PyTorch/CUDA port of ``onnx_transformer_tpu``.

Imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package.  It covers four serving paths of the IWSLT14 model:

- the W8A8 int8-KV chunk-staged greedy decode (``greedy_decode_chunked``):
  encoder, cross-K/V producer, SmoothQuant, W8A8 linears and the decode
  loop, with the fused quantize-matmul kernels K1/K2;
- the same decode with packed-int4 weights and int8 activations (W4A8:
  ``quantize_model_params_int4``, ``make_w4a8_linear_impl``), whose prefill
  runs the packed-int4 kernels K6/K7; ``make_qat_linear_impl`` is its
  differentiable fake-quant counterpart for training;
- the KV-cached decode of ``serving.decode`` (``greedy_decode``, its early
  exit, the no-cache oracle, ``beam_decode``) over an fp32 or int8 cache,
  with the int8-cache attention kernel K3 (``fused_attn=True``) and the
  W8A8 matmul kernel K5 (W8A8 mode ``pallas``);
- the continuous-batching serving engine (``serving.engine``:
  ``TranslationEngine``, ``BucketedEngineFleet``) over those decodes: its
  staged prefill runs K1/K2 (or K6/K7, or K5), its chunks the chunk-staged
  step or ``decode_step`` (K3, K5), and slot-group beam search.

Tensor and data parallelism (``parallel``): one process per rank
(``launch``), a (data, model) mesh over ``torch.distributed``
(``make_mesh``), Megatron shardings of the parameters and the W8A8/W4A8
payloads (``shard_params``, ``shard_payloads``) and the collectives GSPMD
inserts in the JAX package written out; the model's tensor-parallel view
(``Transformer(cfg, mesh=mesh)``), the W8A8 and W4A8 linears, the
KV-cached decodes and the engine (``mesh=``, and the serve command line's
``--tp``) run over it, K5 in the column-parallel W8A8 linears; so does
training (``make_train_step(..., mesh=mesh)`` over ``shard_state`` and
``shard_batch``, or per-rank loader shards through ``global_batch``), and
pipeline parallelism over a (data, pipe, model) mesh
(``make_pipeline_mesh``, ``make_pipeline_train_step``: GPipe over
stage-to-stage sends, with sequence parallelism; ``parallel.dryrun``
drives every parallel path as the JAX package's ``dryrun_multichip``).

Every model method and linear impl takes the reference's ``taps``/``inject``
seam (``ops.layers.tap``), through which ``quant.calibrate`` records
activation scales and ``inject.campaign`` runs fault-injection campaigns
(bit flips in ``inject.bits``, sentence BLEU from ``evaluation.bleu``);
under taps or inject the linears and attentions route around the kernels.

Training (``train``): ``make_train_step`` (forward, the label-smoothed KL
of ``train.loss``, ``torch.autograd`` backward, optax's Adam + Noam written
out with ``torch._foreach_*``; gradient accumulation, bf16 compute over f32
master weights, the QAT linear as ``lin``), ``run_epoch`` over the data
layer's ``BucketedLoader`` (``data``: vocabularies, collation, masks,
length and token-budget buckets, the native batch encoder, corpus
loaders), and ``train.checkpoint``, whose ``.npz`` keys are the JAX
package's, so a train state saved by either package resumes in the other.
Training runs no kernel: its products are plain ``torch.matmul``, as the
JAX package's are XLA's.

Export (``export``): ``export_model`` traces the encoder, the greedy
decode, the prefill and the decode step per batch bucket with
``torch.export`` into a bundle that ``load_exported`` loads without the
model code, and ``export_qdq_onnx`` writes the QDQ ONNX graphs;
``utils.torch_compat`` converts the reference's ``state_dict`` both ways,
``utils.profiling`` holds span timers and ``torch.profiler`` hooks.

Command lines, the counterparts of the JAX package's scripts: ``python -m
onnx_transformer_tpu_torch.train`` (with ``--pipeline`` and
``--num-processes``), ``.quant`` (calibration), ``.evaluation`` (test-set
BLEU), ``.inject`` (the fault campaign), ``.export``, ``.serving`` and
``.ops.kernels.roofline`` (K4's and K5's share of the card's int8 peak,
and the timer and bounds of the card check).

K4 and K8 (the per-token quantize fused into K5's product, over int8 or
packed-int4 weights) have no caller on these paths, as in the JAX package.
All eight are CUDA kernels hand-written for Hopper, each a registered
operator (``torch.ops.otk.*``), so that exported programs carry them; on
CPU tensors each operator runs its plain PyTorch version.
"""

import torch

# The int8 score dots of the decode attention run as f32 matmuls on int8
# values, which is exact only in full f32; TF32 would round them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from onnx_transformer_tpu_torch.data.dataset import (  # noqa: E402
    Batch,
    BucketedLoader,
    collate,
    load_pairs,
    load_split,
    unbpe,
)
from onnx_transformer_tpu_torch.data.vocab import (  # noqa: E402
    BOS_ID,
    EOS_ID,
    PAD_ID,
    UNK_ID,
    Vocab,
    build_vocab,
    load_iwslt14_vocab,
    load_vocab,
    save_vocab,
)
from onnx_transformer_tpu_torch.device import resolve_device  # noqa: E402
from onnx_transformer_tpu_torch.export.onnx_qdq import export_qdq_onnx  # noqa: E402
from onnx_transformer_tpu_torch.export.serialize import (  # noqa: E402
    export_model,
    load_exported,
    load_manifest,
)
from onnx_transformer_tpu_torch.models.stacked_decode import (  # noqa: E402
    build_stacked,
    greedy_decode_chunked,
)
from onnx_transformer_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
    default_linear,
)
from onnx_transformer_tpu_torch.ops.kernels.decode_attention import (  # noqa: E402
    decode_attention_int8,
)
from onnx_transformer_tpu_torch.ops.kernels.w8a8_matmul import (  # noqa: E402
    quant_w4a8_matmul,
    quant_w4a8_matmul_q8,
    quant_w4a8_matmul_qout,
    quant_w8a8_matmul,
    quant_w8a8_matmul_q8,
    quant_w8a8_matmul_qout,
    w8a8_matmul,
)
from onnx_transformer_tpu_torch.parallel import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    global_batch,
    launch,
    make_mesh,
    mesh_generator,
    param_pspecs,
    replicate_tree,
    shard_params,
    shard_payloads,
)
from onnx_transformer_tpu_torch.params import (  # noqa: E402
    load_checkpoint_params,
    params_from_jax,
)
from onnx_transformer_tpu_torch.quant.int4 import (  # noqa: E402
    make_qat_linear_impl,
    make_w4a8_linear_impl,
    quantize_model_params_int4,
)
from onnx_transformer_tpu_torch.quant.smoothquant import (  # noqa: E402
    load_reference_scales,
    smooth_params,
)
from onnx_transformer_tpu_torch.quant.w8a8 import (  # noqa: E402
    make_w8a8_linear_impl,
    quantize_transformer,
    shard_linear_impl,
)
from onnx_transformer_tpu_torch.serving.decode import (  # noqa: E402
    beam_decode,
    greedy_decode,
    greedy_decode_early_exit,
    greedy_decode_nocache,
    ids_to_tokens,
)
from onnx_transformer_tpu_torch.serving.engine import (  # noqa: E402
    BucketedEngineFleet,
    EngineStalledError,
    Request,
    TranslationEngine,
)
from onnx_transformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    batch_to_arrays,
    gather_state,
    init_state,
    make_optimizer,
    make_train_step,
    run_epoch,
    shard_batch,
    shard_state,
)
from onnx_transformer_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipeline_mesh,
    make_pipeline_train_step,
    pipelined_forward_logits,
    shard_pipeline_state,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from onnx_transformer_tpu_torch.utils.torch_compat import (  # noqa: E402
    from_torch_state_dict,
    load_reference_checkpoint,
    to_torch_state_dict,
)

__all__ = [
    "Transformer", "TransformerConfig", "default_linear", "build_stacked",
    "greedy_decode_chunked", "quant_w8a8_matmul_qout", "quant_w8a8_matmul_q8",
    "w8a8_matmul", "quant_w8a8_matmul", "quant_w4a8_matmul_qout", "quant_w4a8_matmul_q8",
    "quant_w4a8_matmul", "decode_attention_int8", "greedy_decode", "greedy_decode_early_exit",
    "greedy_decode_nocache", "beam_decode", "ids_to_tokens",
    "params_from_jax", "load_checkpoint_params", "load_reference_scales",
    "smooth_params", "make_w8a8_linear_impl", "quantize_transformer",
    "quantize_model_params_int4", "make_w4a8_linear_impl", "make_qat_linear_impl",
    "resolve_device", "TranslationEngine", "BucketedEngineFleet", "Request",
    "EngineStalledError", "Batch", "BucketedLoader", "collate", "load_pairs", "load_split",
    "unbpe", "BOS_ID", "EOS_ID", "PAD_ID", "UNK_ID", "Vocab", "build_vocab",
    "load_iwslt14_vocab", "load_vocab", "save_vocab", "TrainState", "batch_to_arrays",
    "init_state", "make_optimizer", "make_train_step", "run_epoch", "export_model",
    "load_exported", "load_manifest", "export_qdq_onnx", "from_torch_state_dict",
    "to_torch_state_dict", "load_reference_checkpoint", "DATA_AXIS", "MODEL_AXIS", "Mesh",
    "launch", "make_mesh", "param_pspecs", "shard_params", "shard_payloads",
    "shard_linear_impl", "mesh_generator", "global_batch", "replicate_tree", "shard_state",
    "shard_batch", "gather_state", "make_pipeline_mesh", "make_pipeline_train_step",
    "pipelined_forward_logits", "shard_pipeline_state", "stack_pipeline_params",
    "unstack_pipeline_params",
]
