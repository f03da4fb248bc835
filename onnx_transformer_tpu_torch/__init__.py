"""PyTorch/CUDA port of ``onnx_transformer_tpu``.

Imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package.  This slice covers the W8A8 int8-KV chunk-staged greedy decode:
encoder, cross-K/V producer, SmoothQuant, W8A8 linears and the decode loop,
with the fused quantize-matmul kernels K1/K2 hand-written in CUDA for Hopper.
"""

import torch

# The int8 score dots of the decode attention run as f32 matmuls on int8
# values, which is exact only in full f32; TF32 would round them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from onnx_transformer_tpu_torch.device import resolve_device  # noqa: E402
from onnx_transformer_tpu_torch.models.stacked_decode import (  # noqa: E402
    build_stacked,
    greedy_decode_chunked,
)
from onnx_transformer_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
    default_linear,
)
from onnx_transformer_tpu_torch.ops.kernels.w8a8_matmul import (  # noqa: E402
    quant_w8a8_matmul_q8,
    quant_w8a8_matmul_qout,
)
from onnx_transformer_tpu_torch.params import (  # noqa: E402
    load_checkpoint_params,
    params_from_jax,
)
from onnx_transformer_tpu_torch.quant.smoothquant import (  # noqa: E402
    load_reference_scales,
    smooth_params,
)
from onnx_transformer_tpu_torch.quant.w8a8 import (  # noqa: E402
    make_w8a8_linear_impl,
    quantize_transformer,
)

__all__ = [
    "Transformer", "TransformerConfig", "default_linear", "build_stacked",
    "greedy_decode_chunked", "quant_w8a8_matmul_qout", "quant_w8a8_matmul_q8",
    "params_from_jax", "load_checkpoint_params", "load_reference_scales",
    "smooth_params", "make_w8a8_linear_impl", "quantize_transformer",
    "resolve_device",
]
