"""Parallel BPE datasets and shape-static batching (port of
``onnx_transformer_tpu/data/dataset.py``).

The arrays stay numpy on the host; the trainer moves them to the device
(``train.trainer.batch_to_arrays``).  Semantics, as the JAX package's:
- line pairs from ``{split}.{de,en}.bpe`` with the trailing newline stripped,
- whitespace tokenization of pre-BPE'd text,
- ``<s>``/``</s>`` wrapping with ids 0/1 and ``<blank>``=2 padding to
  ``max_padding`` (truncation keeps ``</s>``),
- the source pad mask and the shifted target's causal+pad mask,
- length bucketing to cut padding: fixed-size batches of a sorted pool, or
  token-budget batches over a fixed set of length buckets; for the same
  seed the batches equal the JAX loader's, array for array, in order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from onnx_transformer_tpu_torch.data import native as N
from onnx_transformer_tpu_torch.data.vocab import BOS_ID, EOS_ID, PAD_ID, Vocab


def load_pairs(src_path: str, tgt_path: str) -> list[tuple[str, str]]:
    with open(src_path, "r") as f:
        src_lines = f.readlines()
    with open(tgt_path, "r") as f:
        tgt_lines = f.readlines()
    return [(s.rstrip("\n"), t.rstrip("\n")) for s, t in zip(src_lines, tgt_lines)]


def load_split(data_dir: str, split: str, src_lang: str = "de", tgt_lang: str = "en"):
    return load_pairs(
        os.path.join(data_dir, f"{split}.{src_lang}.bpe"),
        os.path.join(data_dir, f"{split}.{tgt_lang}.bpe"),
    )


def tokenize(line: str) -> list[str]:
    return line.split()


def encode_sentence(line: str, vocab: Vocab, max_padding: int) -> np.ndarray:
    """<s> + tokens + </s>, padded (or truncated, keeping </s>) to max_padding."""
    ids = [BOS_ID] + vocab(tokenize(line)) + [EOS_ID]
    if len(ids) > max_padding:
        ids = ids[: max_padding - 1] + [EOS_ID]
    out = np.full((max_padding,), PAD_ID, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def collate(
    batch: Sequence[tuple[str, str]],
    vocab_src: Vocab,
    vocab_tgt: Vocab,
    max_padding: int = 72,
    native=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pairs of raw BPE lines -> (src, tgt) int32 arrays [B, max_padding].

    ``native``: optional (NativeVocab, NativeVocab) pair — encodes the whole
    batch in C++ (native/dataio.cpp) instead of per-sentence python."""
    if native is not None:
        nv_src, nv_tgt = native
        src = nv_src.encode_batch([s for s, _ in batch], max_padding)
        tgt = nv_tgt.encode_batch([t for _, t in batch], max_padding)
        return src, tgt
    src = np.stack([encode_sentence(s, vocab_src, max_padding) for s, _ in batch])
    tgt = np.stack([encode_sentence(t, vocab_tgt, max_padding) for _, t in batch])
    return src, tgt


def make_masks(src: np.ndarray, tgt: np.ndarray, pad: int = PAD_ID):
    """Reference ``batch.py:4-30``: src pad mask [B,1,S]; decoder input is
    tgt[:, :-1], labels tgt[:, 1:]; tgt mask = pad-mask AND causal [B,T-1,T-1]."""
    src_mask = (src != pad)[:, None, :]
    tgt_in = tgt[:, :-1]
    tgt_y = tgt[:, 1:]
    t = tgt_in.shape[1]
    causal = np.tril(np.ones((t, t), dtype=bool))
    tgt_mask = (tgt_in != pad)[:, None, :] & causal[None, :, :]
    ntokens = int((tgt_y != pad).sum())
    return src_mask, tgt_in, tgt_y, tgt_mask, ntokens


@dataclass
class Batch:
    """Materialised training batch (all numpy, static shapes)."""

    src: np.ndarray        # [B, S] int32
    tgt: np.ndarray        # [B, T] int32 (full, unshifted)
    src_mask: np.ndarray   # [B, 1, S] bool
    tgt_in: np.ndarray     # [B, T-1]
    tgt_y: np.ndarray      # [B, T-1]
    tgt_mask: np.ndarray   # [B, T-1, T-1] bool
    ntokens: int

    @classmethod
    def make(cls, src: np.ndarray, tgt: np.ndarray, pad: int = PAD_ID) -> "Batch":
        src_mask, tgt_in, tgt_y, tgt_mask, ntokens = make_masks(src, tgt, pad)
        return cls(src, tgt, src_mask, tgt_in, tgt_y, tgt_mask, ntokens)


class BucketedLoader:
    """Token-bucketing batch iterator.

    Pools ``pool_factor * batch_size`` examples, sorts by (src_len, tgt_len)
    like the reference's torchtext Iterator (``batch_iterator.py:9-19``),
    cuts fixed-size batches, then shuffles batch order.  Every batch has the
    same [B, max_padding] shape; short final batches are dropped when
    ``drop_last`` (default, to keep the step's shapes static).

    ``token_budget`` switches to the reference's token-count batching
    (``batch_size_fn`` counts max-padded tokens, 12000/batch,
    ``train.py:48-58``) in shape-static form: sequence lengths are rounded
    up to a small set of ``length_buckets`` and each bucket gets a fixed
    batch size ``~ token_budget / bucket_len``, so short sentences ride in
    large batches, long ones in small batches, and the step sees at most
    ``len(length_buckets)`` shapes instead of one per dynamic batch.
    """

    def __init__(
        self,
        pairs: Sequence[tuple[str, str]],
        vocab_src: Vocab,
        vocab_tgt: Vocab,
        batch_size: int = 128,
        max_padding: int = 72,
        shuffle: bool = True,
        pool_factor: int = 100,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        use_native: bool = True,
        token_budget: Optional[int] = None,
        length_buckets: Sequence[int] = (16, 24, 32, 48, 72),
    ):
        self.pairs = list(pairs)
        self.vocab_src = vocab_src
        self.vocab_tgt = vocab_tgt
        self.batch_size = batch_size
        self.max_padding = max_padding
        self.shuffle = shuffle
        self.pool_factor = pool_factor
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        # Multi-host data sharding (replaces the reference's
        # DistributedSampler, distributed/iwslt14_train.py:334).
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.token_budget = token_budget
        self.length_buckets = sorted(
            min(l, max_padding) for l in set(length_buckets))
        # C++ batch encoder (native/dataio.cpp) when buildable
        self._native = None
        if use_native:
            try:
                if N.available():
                    self._native = (
                        N.NativeVocab(vocab_src.itos, vocab_src.default_index),
                        N.NativeVocab(vocab_tgt.itos, vocab_tgt.default_index),
                    )
            except (OSError, RuntimeError):   # the library would not load
                self._native = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.token_budget is not None:
            # token-budget mode: estimate step count by bucketing lengths
            # (exact up to pool-boundary effects; tail batches under
            # drop_last=False add a few more)
            counts: dict[int, int] = {l: 0 for l in self.length_buckets}
            for pair in self.pairs:
                counts[self._bucket_len(pair)] += 1
            total = 0
            for l, c in counts.items():
                nb = c // self._bucket_bsz(l)
                if self.num_shards > 1:
                    total += nb // self.num_shards
                else:
                    total += nb
                    # _iter_token_budget yields one ragged tail batch per
                    # non-empty pending bucket when drop_last is off
                    if not self.drop_last and c % self._bucket_bsz(l):
                        total += 1
            return total
        n = len(self.pairs) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _bucket_len(self, pair: tuple[str, str]) -> int:
        """Smallest length bucket that fits the pair after BOS/EOS (+2)."""
        need = max(len(pair[0].split()), len(pair[1].split())) + 2
        for l in self.length_buckets:
            if need <= l:
                return l
        return self.length_buckets[-1]  # collate truncates to max_padding

    def _bucket_bsz(self, bucket_len: int) -> int:
        """Fixed batch size for a bucket ~ token_budget / bucket_len,
        rounded to a multiple of 8 (as the JAX loader rounds them)."""
        bsz = max(1, self.token_budget // bucket_len)
        return bsz // 8 * 8 if bsz >= 16 else bsz

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = np.arange(len(self.pairs))
        if self.shuffle:
            rng.shuffle(idx)

        if self.token_budget is not None:
            # Token-budget mode buckets/batches GLOBALLY and shards at batch
            # granularity (below), so every shard sees the same number of
            # steps with the same bucket shape each step — required for
            # lockstep multi-host DP with per-bucket compiled shapes.
            yield from self._iter_token_budget(rng, idx)
            return
        idx = idx[self.shard_index :: self.num_shards]

        batches = []
        pool = self.pool_factor * self.batch_size
        for start in range(0, len(idx), pool):
            chunk = idx[start : start + pool]
            keyed = sorted(
                chunk,
                key=lambda i: (
                    len(self.pairs[i][0].split()),
                    len(self.pairs[i][1].split()),
                ),
            )
            for b in range(0, len(keyed), self.batch_size):
                group = keyed[b : b + self.batch_size]
                if self.drop_last and len(group) < self.batch_size:
                    continue
                batches.append(group)
        if self.shuffle:
            rng.shuffle(batches)
        for group in batches:
            src, tgt = collate(
                [self.pairs[i] for i in group],
                self.vocab_src,
                self.vocab_tgt,
                self.max_padding,
                native=self._native,
            )
            yield Batch.make(src, tgt)

    def _iter_token_budget(self, rng, idx) -> Iterator[Batch]:
        """Token-count batching (reference ``batch_size_fn``, train.py:48-58)
        with static shapes: one (bucket_len, bucket_bsz) shape per bucket."""
        pending: dict[int, list[int]] = {l: [] for l in self.length_buckets}
        batches: list[tuple[int, list[int]]] = []
        pool = self.pool_factor * self.batch_size
        for start in range(0, len(idx), pool):
            chunk = sorted(
                idx[start : start + pool],
                key=lambda i: (
                    len(self.pairs[i][0].split()),
                    len(self.pairs[i][1].split()),
                ),
            )
            for i in chunk:
                l = self._bucket_len(self.pairs[i])
                pending[l].append(int(i))
                if len(pending[l]) == self._bucket_bsz(l):
                    batches.append((l, pending[l]))
                    pending[l] = []
        if not self.drop_last and self.num_shards == 1:
            # tail batches are ragged-sized; only safe single-host
            for l, group in pending.items():
                if group:
                    batches.append((l, group))
        if self.num_shards > 1:
            # Shard at batch granularity with bucket-matched steps: for each
            # bucket, cut batch count to a multiple of num_shards, then give
            # step k of shard s batch k*num_shards+s of that bucket.  All
            # shards iterate the same (bucket-shape, step) sequence.
            by_bucket: dict[int, list[list[int]]] = {}
            for l, group in batches:
                by_bucket.setdefault(l, []).append(group)
            steps: list[tuple[int, int]] = []
            for l in self.length_buckets:
                n = len(by_bucket.get(l, [])) // self.num_shards
                steps.extend((l, k) for k in range(n))
            if self.shuffle:
                rng.shuffle(steps)
            batches = [
                (l, by_bucket[l][k * self.num_shards + self.shard_index])
                for l, k in steps
            ]
        elif self.shuffle:
            rng.shuffle(batches)
        for l, group in batches:
            src, tgt = collate(
                [self.pairs[i] for i in group],
                self.vocab_src,
                self.vocab_tgt,
                l,
                native=self._native,
            )
            yield Batch.make(src, tgt)


def unbpe(tokens: Sequence[str]) -> str:
    """Merge BPE subwords back to words ("@@ " continuation marker), the text
    fixup the reference applies before BLEU
    (``parallelized_inject_onnx_transformer.py:297-303``)."""
    text = " ".join(tokens)
    return text.replace("@@ ", "").replace("@@", "")
