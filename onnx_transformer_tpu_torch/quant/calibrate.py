"""Activation-scale calibration (port of ``onnx_transformer_tpu/quant/calibrate.py``).

The forward pass runs with a ``taps`` dict that records every linear's
input under its module name; the per-channel absmax of each is kept as a
running maximum across batches, on the parameters' device, and fetched once
at the end.  Calibration drives ``Transformer.forward`` (hidden states),
which never reaches the generator, so there are 96 tensors at N=6.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from onnx_transformer_tpu_torch.models.transformer import Transformer


def _linear_input_names(model: Transformer) -> list[str]:
    names = []
    n = model.cfg.num_layers
    for i in range(n):
        for j in range(4):
            names.append(f"encoder.layers.{i}.self_attn.linears.{j}")
        names.append(f"encoder.layers.{i}.feed_forward.w_1")
        names.append(f"encoder.layers.{i}.feed_forward.w_2")
    for i in range(n):
        for att in ("self_attn", "src_attn"):
            for j in range(4):
                names.append(f"decoder.layers.{i}.{att}.linears.{j}")
        names.append(f"decoder.layers.{i}.feed_forward.w_1")
        names.append(f"decoder.layers.{i}.feed_forward.w_2")
    return names


@torch.no_grad()
def calibration_step(model: Transformer, params, src, tgt_in, src_mask,
                     tgt_mask) -> dict[str, torch.Tensor]:
    """One batch -> name -> per-channel absmax [d], on the parameters'
    device.  Array inputs move there first."""
    dev = params["src_embed"]["lut"].device
    src, tgt_in, src_mask, tgt_mask = (torch.as_tensor(np.array(a), device=dev)
                                       if not isinstance(a, torch.Tensor) else a.to(dev)
                                       for a in (src, tgt_in, src_mask, tgt_mask))
    taps: dict = {}
    model.forward(params, src, tgt_in, src_mask, tgt_mask, taps=taps)
    return {name: taps[name].reshape(-1, taps[name].shape[-1]).abs().amax(dim=0)
            for name in _linear_input_names(model)}


def get_act_scales(model: Transformer, params, batches: Iterable, num_samples: int = 512,
                   jit: bool = True) -> dict[str, np.ndarray]:
    """Per-channel absmax of every linear input, the running maximum over
    the batches (each with ``src``, ``tgt_in``, ``src_mask``, ``tgt_mask``).
    As in the reference, the loop stops at a count above ``num_samples``,
    so it takes up to ``num_samples + 1`` batches.  ``jit`` is accepted for
    the reference's signature and has no effect."""
    acc = None
    for count, b in enumerate(batches):
        if count > num_samples:
            break
        scales = calibration_step(model, params, b.src, b.tgt_in, b.src_mask, b.tgt_mask)
        acc = scales if acc is None else {k: torch.maximum(acc[k], v)
                                          for k, v in scales.items()}
    return {} if acc is None else {k: v.cpu().numpy() for k, v in acc.items()}


def save_scales(scales: dict[str, np.ndarray], path: str) -> None:
    """An ``.npz`` of the scales, as ``smoothquant.load_reference_scales``
    reads them."""
    np.savez(path, **scales)
