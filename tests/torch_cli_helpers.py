"""Shared by the ``tests/test_torch_cli_*.py`` files (not collected): the
small configuration patched into the JAX scripts and the port's command
lines, a seeded corpus, and in-process runs of both.

- The configuration: 2 layers, d_model 32, d_ff 64, 4 heads, dropout 0,
  over the small vocabularies of ``tests/test_torch_cli.py``.
- The corpus: ``{valid,test}.{de,en}.bpe`` of seeded numpy draws, each
  target the source's tokens mapped one to one (``de<i>`` -> ``en<i % 27>``,
  ``ge@@ hen`` -> ``wa@@ lk``), so that a few epochs learn something.
- A JAX script is loaded from ``scripts/`` with
  ``importlib.util.spec_from_file_location`` (never edited) and its
  ``main()`` run with ``sys.argv`` set, its ``TransformerConfig`` and
  ``load_iwslt14_vocab`` replaced in its namespace, and
  ``jax.config.update`` a no-op for the call (the scripts set a compilation
  cache directory and the platform, which would change the worker's JAX for
  every later test).  Its standard output is returned.

This module imports no ``jax`` at its top: spawned ranks import it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np

SPECIALS = ["<s>", "</s>", "<blank>", "<unk>"]
SRC_WORDS = [f"de{i}" for i in range(37)] + ["ge@@", "hen"]
TGT_WORDS = [f"en{i}" for i in range(27)] + ["wa@@", "lk"]
SMALL = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4, dropout=0.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_thread():
    """A generator for a module-scoped autouse fixture: torch on one
    thread while the module's tests run (their models are tiny, and the
    suite's workers share the host's cores), the count restored after."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def port_vocabs():
    from onnx_transformer_tpu_torch.data.vocab import Vocab

    return Vocab(SPECIALS + SRC_WORDS), Vocab(SPECIALS + TGT_WORDS)


def jax_vocabs():
    from onnx_transformer_tpu.data.vocab import Vocab

    return Vocab(SPECIALS + SRC_WORDS), Vocab(SPECIALS + TGT_WORDS)


def port_config(vs, vt, layers: int = SMALL["num_layers"]):
    from onnx_transformer_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(len(vs), len(vt), **{**SMALL, "num_layers": layers})


def _target(word: str) -> str:
    if word.startswith("de"):
        return f"en{int(word[2:]) % 27}"
    return {"ge@@": "wa@@", "hen": "lk"}[word]


def write_corpus(folder: str, sizes: dict, seed: int = 0, max_words: int = 6) -> str:
    """``{split}.{de,en}.bpe`` for each split: count in ``sizes``."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for split, n in sizes.items():
        src, tgt = [], []
        for _ in range(n):
            words = list(rng.choice(SRC_WORDS[:37], int(rng.integers(2, max_words))))
            if rng.random() < 0.3:
                words.insert(int(rng.integers(0, len(words) + 1)), "ge@@ hen")
            line = " ".join(words)
            src.append(line)
            tgt.append(" ".join(_target(w) for w in line.split()))
        for lang, lines in (("de", src), ("en", tgt)):
            with open(os.path.join(folder, f"{split}.{lang}.bpe"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return folder


def load_script(name: str):
    """``scripts/<name>.py`` as a module, executed once with
    ``jax.config.update`` a no-op."""
    import jax

    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", path)
    module = importlib.util.module_from_spec(spec)
    real = jax.config.update
    jax.config.update = lambda *a, **k: None
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update = real
    return module


def run_script(module, argv: list, layers: int = SMALL["num_layers"]) -> str:
    """``module.main()`` with ``argv``, the small configuration (at
    ``layers`` layers) and vocabularies in its namespace, its standard
    output returned."""
    import jax

    from onnx_transformer_tpu import TransformerConfig

    vocabs = jax_vocabs()
    small = {**SMALL, "num_layers": layers}
    patches = {"TransformerConfig": lambda *a, **k: TransformerConfig(*a, **{**k, **small}),
               "load_iwslt14_vocab": lambda: vocabs}
    saved = {k: getattr(module, k) for k in patches if hasattr(module, k)}
    real_update, real_argv = jax.config.update, sys.argv
    out = io.StringIO()
    try:
        for k, v in patches.items():
            setattr(module, k, v)
        jax.config.update = lambda *a, **k: None
        sys.argv = [module.__file__] + list(argv)
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        jax.config.update, sys.argv = real_update, real_argv
        for k, v in saved.items():
            setattr(module, k, v)
    return out.getvalue()


def run_port(cli, argv: list, layers: int = SMALL["num_layers"]) -> str:
    """The port's ``cli.main(argv)`` with the small configuration (at
    ``layers`` layers) and vocabularies patched into its module, its
    standard output returned."""
    vocabs = port_vocabs()
    saved = cli.model_config, cli.load_iwslt14_vocab
    out = io.StringIO()
    try:
        cli.model_config = lambda vs, vt: port_config(vs, vt, layers)
        cli.load_iwslt14_vocab = lambda: vocabs
        with contextlib.redirect_stdout(out):
            assert cli.main(argv) == 0
    finally:
        cli.model_config, cli.load_iwslt14_vocab = saved
    return out.getvalue()


def json_lines(text: str) -> list:
    import json

    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def cli_rank(rank: int, cli_module: str, argv: list, out_dir: str) -> None:
    """Process ``rank`` of a multi-process command line (a function for
    ``torch.multiprocessing.start_processes``): ``cli_module``'s ``main``
    with ``argv`` and ``--process-id rank``, the small configuration
    patched in, its standard output written to ``out_dir/rank<rank>.txt``."""
    import importlib

    import torch

    torch.set_num_threads(2)
    cli = importlib.import_module(cli_module)
    text = run_port(cli, list(argv) + ["--process-id", str(rank)])
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(text)
