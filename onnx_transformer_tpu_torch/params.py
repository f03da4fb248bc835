"""Parameter conversion and loading, and the tree walks of the trainer.

The JAX package's parameters are a pytree of nested dicts and lists of
arrays (``Transformer.init``; ``train/checkpoint.py`` flattens it into
``params/<path>`` keys of one ``.npz``).  Both convert here with numpy alone.

:func:`tree_leaves`, :func:`tree_map` and :func:`tree_paths` walk nested
dicts, lists, tuples and named tuples in JAX's order (dict keys sorted) and
name each leaf as JAX's ``tree_flatten_with_path`` does: a dict key or a
sequence index, and ``.field`` for a named tuple's field.
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


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf), ...] in JAX's flattening order, paths joined by "/"."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_paths(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in tree_paths(getattr(tree, f), join("." + f))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_paths(v, join(i))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree: Any) -> Any:
    """The same structure with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


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
