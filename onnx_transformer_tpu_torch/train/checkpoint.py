"""Train-state checkpoints (port of ``onnx_transformer_tpu/train/checkpoint.py``).

The whole train state (params, optimizer moments and counts, step) goes to
one ``.npz`` under the JAX package's keys: ``params/<path>``, ``step``,
``opt_state/0/.count``, ``opt_state/0/.mu/<path>``, ``opt_state/0/.nu/<path>``
and ``opt_state/1/.count`` (``params.tree_paths`` names the leaves as JAX's
``tree_flatten_with_path`` does), with each leaf's dtype.  So a checkpoint
written by either package restores in the other, and training resumes
exactly.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from onnx_transformer_tpu_torch.params import tree_paths, tree_unflatten


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                  else np.asarray(leaf))
            for key, leaf in tree_paths(tree)}


def save(path: str, tree: Any) -> None:
    """Write a tree of tensors to ``path`` (.npz) atomically: into a
    temporary file beside it, then renamed over it."""
    flat = _flatten(tree)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(path: str, template: Any) -> Any:
    """Load into the structure of ``template``: new tensors with each
    template leaf's dtype and device."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    leaves = []
    for key, leaf in tree_paths(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: ckpt {arr.shape} vs template "
                             f"{tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(arr).to(dtype=leaf.dtype, device=leaf.device))
    return tree_unflatten(template, leaves)


def save_params_with_meta(path: str, params: Any, meta: dict) -> None:
    save(path, params)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)


def load_meta(path: str) -> dict:
    with open(path + ".meta.json", "r") as f:
        return json.load(f)
