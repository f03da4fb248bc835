"""Noam learning-rate schedule (port of ``onnx_transformer_tpu/train/schedule.py``).

rate(step) = factor * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5),
with step 0 taken as 1.  The arithmetic is float32 as in the JAX package;
``step`` may be a Python int or a tensor (the optimizer's count, kept on
its device so that no step reads it back to the host).
"""

from __future__ import annotations

import torch


def noam_schedule(d_model: int, factor: float = 1.0, warmup: int = 3000):
    def rate(step) -> torch.Tensor:
        step = torch.as_tensor(step).clamp_min(1).float()
        return factor * (d_model ** (-0.5)
                         * torch.minimum(step ** (-0.5), step * warmup ** (-1.5)))

    return rate
