"""BLEU scoring, NLTK-compatible, dependency-free (a copy of
``onnx_transformer_tpu/evaluation/bleu.py``, which the port cannot import:
that package's ``__init__`` imports JAX).

The reference scores with ``nltk.translate.bleu_score`` — sentence BLEU with
``SmoothingFunction().method1``/``method4`` (``verify.py:17-18``,
``parallelized_inject_onnx_transformer.py:393-396``) and corpus BLEU over the
validation set (``batch_output.py:601``).  This module re-implements the same
math (modified n-gram precision with clipping, closest-ref-length brevity
penalty, smoothing methods 0/1/4 with epsilon=0.1 / k=5) so scores are
comparable without an nltk dependency.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

Tokens = Sequence[str]


class Fraction:
    """Unnormalised fraction (numerator/denominator preserved, like the
    nltk-era ``fractions.Fraction(_normalize=False)``)."""

    __slots__ = ("numerator", "denominator")

    def __init__(self, numerator: int, denominator: int):
        self.numerator = numerator
        self.denominator = denominator

    def __float__(self) -> float:
        return self.numerator / self.denominator


def _ngrams(tokens: Tokens, n: int):
    return zip(*(tokens[i:] for i in range(n)))


def modified_precision(
    references: Sequence[Tokens], hypothesis: Tokens, n: int
) -> Fraction:
    counts = Counter(_ngrams(hypothesis, n)) if len(hypothesis) >= n else Counter()
    max_counts: dict = {}
    for ref in references:
        ref_counts = Counter(_ngrams(ref, n)) if len(ref) >= n else Counter()
        for ng in counts:
            max_counts[ng] = max(max_counts.get(ng, 0), ref_counts[ng])
    clipped = {ng: min(c, max_counts.get(ng, 0)) for ng, c in counts.items()}
    return Fraction(sum(clipped.values()), max(1, sum(counts.values())))


def closest_ref_length(references: Sequence[Tokens], hyp_len: int) -> int:
    return min(
        (len(ref) for ref in references),
        key=lambda ref_len: (abs(ref_len - hyp_len), ref_len),
    )


def brevity_penalty(closest_ref_len: int, hyp_len: int) -> float:
    if hyp_len > closest_ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - closest_ref_len / hyp_len)


def _smooth(
    p_n: list[Fraction],
    hyp_len: int,
    method: str,
    epsilon: float = 0.1,
    k: int = 5,
) -> list[float]:
    out: list[float] = []
    if method == "method0":
        tiny = 2.220446049250313e-308  # sys.float_info.min, as nltk uses
        return [float(p) if p.numerator != 0 else tiny for p in p_n]
    if method == "method1":
        return [
            (p.numerator + epsilon) / p.denominator if p.numerator == 0 else float(p)
            for p in p_n
        ]
    if method == "method4":
        incvnt = 1
        for p in p_n:
            if p.numerator == 0 and hyp_len > 1:
                numerator = 1.0 / (2**incvnt * k / math.log(hyp_len))
                out.append(numerator / p.denominator)
                incvnt += 1
            else:
                out.append(float(p))
        return out
    raise ValueError(f"unknown smoothing method: {method}")


def corpus_bleu(
    list_of_references: Sequence[Sequence[Tokens]],
    hypotheses: Sequence[Tokens],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    smoothing: str = "method0",
) -> float:
    assert len(list_of_references) == len(hypotheses)
    p_numerators: Counter = Counter()
    p_denominators: Counter = Counter()
    hyp_lengths = 0
    ref_lengths = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for i, _ in enumerate(weights, start=1):
            p_i = modified_precision(references, hypothesis, i)
            p_numerators[i] += p_i.numerator
            p_denominators[i] += p_i.denominator
        hyp_len = len(hypothesis)
        hyp_lengths += hyp_len
        ref_lengths += closest_ref_length(references, hyp_len)

    bp = brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [
        Fraction(p_numerators[i], p_denominators[i])
        for i, _ in enumerate(weights, start=1)
    ]
    if p_n[0].numerator == 0:
        return 0.0
    p_f = _smooth(p_n, hyp_lengths, smoothing)
    s = sum(w * math.log(p) for w, p in zip(weights, p_f) if p > 0 or w == 0)
    return bp * math.exp(s)


def sentence_bleu(
    references: Sequence[Tokens],
    hypothesis: Tokens,
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    smoothing: str = "method0",
) -> float:
    return corpus_bleu([references], [hypothesis], weights, smoothing)
