from onnx_transformer_tpu_torch.serving.decode import (  # noqa: F401
    beam_decode,
    greedy_decode,
    greedy_decode_early_exit,
    greedy_decode_nocache,
    ids_to_tokens,
)
from onnx_transformer_tpu_torch.serving.engine import (  # noqa: F401
    BucketedEngineFleet,
    EngineStalledError,
    Request,
    TranslationEngine,
)
