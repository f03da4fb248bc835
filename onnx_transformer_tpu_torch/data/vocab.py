"""Vocabularies (port of ``onnx_transformer_tpu/data/vocab.py``).

A token <-> id mapping with a default (unk) index, as the reference's
torchtext vocab (specials ``<s> </s> <blank> <unk>``, unk as default), plain
and JSON-backed.  The IWSLT14 artifact is opened by path; nothing of the JAX
package is imported.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterable, Iterator, Sequence

BOS_ID = 0  # "<s>"
EOS_ID = 1  # "</s>"
PAD_ID = 2  # "<blank>"
UNK_ID = 3  # "<unk>"
SPECIALS = ["<s>", "</s>", "<blank>", "<unk>"]

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

    def __contains__(self, token: str) -> bool:
        return token in self.stoi

    def __call__(self, tokens: Iterable[str]) -> list[int]:
        return [self[t] for t in tokens]

    def lookup_tokens(self, ids: Iterable[int]) -> list[str]:
        return [self.itos[i] for i in ids]

    def to_json(self) -> dict:
        return {"itos": self.itos, "default_index": self.default_index}

    @classmethod
    def from_json(cls, obj: dict) -> "Vocab":
        return cls(obj["itos"], obj.get("default_index", UNK_ID))


def build_vocab(token_streams: Iterator[Sequence[str]], min_freq: int = 2,
                specials: Sequence[str] = SPECIALS) -> Vocab:
    """Specials first, then the tokens seen at least ``min_freq`` times, by
    falling count, ties in first-seen order (torchtext's order)."""
    counter: Counter = Counter()
    order: dict[str, int] = {}
    for toks in token_streams:
        for t in toks:
            counter[t] += 1
            if t not in order:
                order[t] = len(order)
    itos = list(specials)
    kept = [t for t, c in counter.items() if c >= min_freq and t not in set(specials)]
    kept.sort(key=lambda t: (-counter[t], order[t]))
    itos.extend(kept)
    return Vocab(itos)


def load_iwslt14_vocab(path: str = VOCAB_PATH) -> tuple[Vocab, Vocab]:
    """(src=de, tgt=en) IWSLT14 BPE vocabularies: 5337 / 4444 tokens."""
    return load_vocab(path)


def save_vocab(vocab_src: Vocab, vocab_tgt: Vocab, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"src": vocab_src.itos, "tgt": vocab_tgt.itos}, f, ensure_ascii=False)


def load_vocab(path: str) -> tuple[Vocab, Vocab]:
    with open(path, "r") as f:
        obj = json.load(f)
    return Vocab(obj["src"]), Vocab(obj["tgt"])
