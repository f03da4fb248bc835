"""Parameter conversion and loading.

The JAX package's parameters are a pytree of nested dicts and lists of
arrays (``Transformer.init``; ``train/checkpoint.py`` flattens it into
``params/<path>`` keys of one ``.npz``).  Both convert here with numpy alone.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from onnx_transformer_tpu_torch.device import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dicts / lists / tuples of arrays (numpy, JAX, or CPU tensors)
    -> the same structure of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)


def _unflatten(flat: dict) -> Any:
    """{"a/layers/0/w": arr, ...} -> nested dicts, with lists where every
    key of a level is a decimal index."""
    root: dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint_params(path: str, device=None) -> Any:
    """Read the ``params/...`` arrays of a train-state ``.npz`` (the JAX
    package's checkpoint format) into the parameter structure on ``device``.
    Optimizer state in the same file is skipped."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
    if not flat:
        raise KeyError(f"{path} holds no params/ arrays")
    return params_from_jax(_unflatten(flat), device)
