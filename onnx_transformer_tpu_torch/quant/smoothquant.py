"""SmoothQuant scale migration as a parameter-tree transform (port of
``onnx_transformer_tpu/quant/smoothquant.py``).

Per LayerNorm -> linears pattern, with alpha = 0.5:
s_j = clamp(act_j^a / w_j^(1-a), 1e-5) where
w_j = clamp(max over the fcs and their outputs of |W[j, out]|, 1e-5); the
LN scale and bias are divided by s and each fc's in-features multiplied by s.
By default the decoder's cross-attention migrates only into q, the one
projection that consumes the smoothed LN output; ``faithful_cross_attn``
migrates into its k and v too, as the reference model's SmoothQuant does
(their input, the encoder memory, never gets the inverse scaling).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from onnx_transformer_tpu_torch.data.vocab import ARTIFACTS_DIR
from onnx_transformer_tpu_torch.quant.core import SCALE_FLOOR

SCALES_PATH = os.path.join(ARTIFACTS_DIR, "transformer_scales.npz")


def smooth_ln_fcs(ln: dict, fcs: list, act_scales, alpha: float = 0.5):
    """Return (new_ln, new_fcs); fc weights stored (in, out)."""
    w0 = fcs[0]["w"]
    act = torch.as_tensor(np.asarray(act_scales, np.float32)).to(w0.device)
    weight_scales = torch.stack([fc["w"].abs().amax(dim=1) for fc in fcs])
    weight_scales = weight_scales.amax(dim=0).clamp_min(SCALE_FLOOR)
    scales = (act ** alpha / weight_scales ** (1 - alpha)).clamp_min(SCALE_FLOOR)
    new_ln = {"scale": ln["scale"] / scales, "bias": ln["bias"] / scales}
    new_fcs = [{"w": fc["w"] * scales[:, None], "b": fc["b"]} for fc in fcs]
    return new_ln, new_fcs


def _copy_tree(node):
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


def smooth_params(params: dict, act_scales: Mapping[str, np.ndarray],
                  alpha: float = 0.5, faithful_cross_attn: bool = False) -> dict:
    """SmoothQuant-migrate a Transformer parameter tree into a new tree (the
    input and its tensors are untouched)."""
    params = _copy_tree(params)

    def apply(ln, block, fc_keys, scale_key):
        new_ln, new_fcs = smooth_ln_fcs(
            ln, [block[k] for k in fc_keys], act_scales[scale_key], alpha)
        for k, fc in zip(fc_keys, new_fcs):
            block[k] = fc
        return new_ln

    for i, lp in enumerate(params["encoder"]["layers"]):
        nm = f"encoder.layers.{i}"
        lp["ln0"] = apply(lp["ln0"], lp["self_attn"], ["q", "k", "v"],
                          f"{nm}.self_attn.linears.0")
        lp["ln1"] = apply(lp["ln1"], lp["ffn"], ["w1"], f"{nm}.feed_forward.w_1")

    cross_keys = ["q", "k", "v"] if faithful_cross_attn else ["q"]
    for i, lp in enumerate(params["decoder"]["layers"]):
        nm = f"decoder.layers.{i}"
        lp["ln0"] = apply(lp["ln0"], lp["self_attn"], ["q", "k", "v"],
                          f"{nm}.self_attn.linears.0")
        lp["ln1"] = apply(lp["ln1"], lp["src_attn"], cross_keys,
                          f"{nm}.src_attn.linears.0")
        lp["ln2"] = apply(lp["ln2"], lp["ffn"], ["w1"], f"{nm}.feed_forward.w_1")
    return params


def load_reference_scales(path: str = SCALES_PATH) -> dict[str, np.ndarray]:
    """The 96 per-channel activation absmax tensors of the scales artifact."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
