"""The port's copy of ``evaluation/bleu.py`` against the JAX package's: corpus
and sentence BLEU under every smoothing method, and the pieces they are made
of, bit-equal on random token lists (short hypotheses, empty ones, several
references)."""

import numpy as np
import pytest

from onnx_transformer_tpu.evaluation import bleu as JB
from onnx_transformer_tpu_torch.evaluation import bleu as TB

METHODS = ("method0", "method1", "method4")


def _corpus(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(8)]

    def sent(lo, hi):
        return [words[i] for i in rng.integers(0, len(words), rng.integers(lo, hi))]

    refs = [[sent(1, 15) for _ in range(rng.integers(1, 4))] for _ in range(n)]
    hyps = [sent(0, 15) for _ in range(n)]
    hyps[0] = list(refs[0][0])         # a perfect match
    hyps[1] = []                       # an empty hypothesis
    return refs, hyps


@pytest.mark.parametrize("smoothing", METHODS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_bleu_bit_equal(smoothing, seed):
    refs, hyps = _corpus(seed)
    assert TB.corpus_bleu(refs, hyps, smoothing=smoothing) == JB.corpus_bleu(
        refs, hyps, smoothing=smoothing)
    w = (0.5, 0.3, 0.2)
    assert TB.corpus_bleu(refs, hyps, w, smoothing) == JB.corpus_bleu(refs, hyps, w, smoothing)


@pytest.mark.parametrize("smoothing", METHODS)
@pytest.mark.parametrize("seed", [3, 4])
def test_sentence_bleu_bit_equal(smoothing, seed):
    refs, hyps = _corpus(seed)
    for r, h in zip(refs, hyps):
        assert TB.sentence_bleu(r, h, smoothing=smoothing) == JB.sentence_bleu(
            r, h, smoothing=smoothing)


def test_pieces_bit_equal():
    refs, hyps = _corpus(5)
    for r, h in zip(refs, hyps):
        for n in range(1, 5):
            a, b = TB.modified_precision(r, h, n), JB.modified_precision(r, h, n)
            assert (a.numerator, a.denominator) == (b.numerator, b.denominator)
            assert float(a) == float(b)
        assert TB.closest_ref_length(r, len(h)) == JB.closest_ref_length(r, len(h))
        c = JB.closest_ref_length(r, len(h))
        assert TB.brevity_penalty(c, len(h)) == JB.brevity_penalty(c, len(h))


def test_unknown_smoothing_raises():
    with pytest.raises(ValueError):
        TB.corpus_bleu([[["a", "b"]]], [["a", "c"]], smoothing="method9")
    assert TB.sentence_bleu([["a", "b", "c", "d"]], ["a", "b", "c", "d"]) == 1.0
