"""The IWSLT14 vocabularies (port of the reading half of
``onnx_transformer_tpu/data/vocab.py``).

The JSON artifact is opened by path; nothing of the JAX package is imported.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

BOS_ID = 0  # "<s>"
EOS_ID = 1  # "</s>"
PAD_ID = 2  # "<blank>"
UNK_ID = 3  # "<unk>"

ARTIFACTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "onnx_transformer_tpu", "artifacts")
VOCAB_PATH = os.path.join(ARTIFACTS_DIR, "vocab_iwslt14.json")


class Vocab:
    """Token <-> id mapping with a default (unk) index."""

    def __init__(self, itos: Sequence[str], default_index: int = UNK_ID):
        self.itos = list(itos)
        self.stoi = {tok: i for i, tok in enumerate(self.itos)}
        self.default_index = default_index

    def __len__(self) -> int:
        return len(self.itos)

    def __getitem__(self, token: str) -> int:
        return self.stoi.get(token, self.default_index)

    def lookup_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.itos[i] for i in ids]


def load_iwslt14_vocab(path: str = VOCAB_PATH) -> tuple[Vocab, Vocab]:
    """(src=de, tgt=en) IWSLT14 BPE vocabularies: 5337 / 4444 tokens."""
    with open(path, "r") as f:
        obj = json.load(f)
    return Vocab(obj["src"]), Vocab(obj["tgt"])
