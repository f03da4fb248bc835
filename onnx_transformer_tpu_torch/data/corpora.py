"""WMT14 / Multi30k / IWSLT corpus loaders (port of
``onnx_transformer_tpu/data/corpora.py``).

Pair extraction from HF wmt14 rows (with the reference's introspection of
the nested ``{"translation": {"de": ..., "en": ...}}`` records), Multi30k's
parallel-file layout, the raw IWSLT preprocess and TSV pairs, and the
reference's vocab recipe through :func:`data.vocab.build_vocab`.
Tokenisation is pluggable: spacy models when installed, whitespace
otherwise.  Nothing is downloaded: ``load_wmt14_pairs`` takes its rows
from ``dataset=`` or from an already populated HF cache.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

from onnx_transformer_tpu_torch.data.vocab import SPECIALS, Vocab, build_vocab

Pair = tuple[str, str]


def get_tokenizers(lang_src: str = "de", lang_tgt: str = "en"):
    """(tok_src, tok_fn_tgt); spacy when available for that language,
    whitespace otherwise (per language, so cs-en/fr-en configs never get a
    German tokenizer by accident)."""

    def one(lang):
        try:  # pragma: no cover - spacy is not installed in every image
            import spacy

            models = {"de": "de_core_news_sm", "en": "en_core_web_sm",
                      "fr": "fr_core_news_sm", "cs": "cs_core_news_sm"}
            sp = spacy.load(models[lang])
            return lambda s: [t.text for t in sp.tokenizer(s)]
        except (ImportError, OSError, KeyError):   # no spacy, or no model for lang
            return lambda s: s.split()

    return one(lang_src), one(lang_tgt)


def _extract_pair(row, lang_src: str, lang_tgt: str) -> Pair:
    """HF wmt14 rows are ``{"translation": {"de": ..., "en": ...}}``; the
    reference introspects the nested keys rather than hard-coding them
    (``wmt14_train.py:197-205``) — do the same so cs-en/fr-en configs work."""
    outer = row[next(iter(row.keys()))] if "translation" not in row else row["translation"]
    if lang_src in outer and lang_tgt in outer:
        return outer[lang_src], outer[lang_tgt]
    keys = list(outer.keys())
    return outer[keys[0]], outer[keys[1]]


def load_wmt14_pairs(
    split: str = "train",
    config: str = "de-en",
    limit: Optional[int] = None,
    dataset: Optional[Iterable] = None,
) -> list[Pair]:
    """(src, tgt) sentence pairs from HF wmt14 (``wmt14_train.py:221-223``).

    ``dataset`` injects pre-loaded rows (tests, offline machines); otherwise
    ``datasets.load_dataset`` is used, which needs the HF cache populated.
    """
    lang_src, lang_tgt = config.split("-")
    if dataset is None:
        try:
            from datasets import load_dataset
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "HF `datasets` not installed; pass `dataset=` with rows or "
                "use the generic file-pair loader") from e
        dataset = load_dataset("wmt14", config, split=split)
    pairs = []
    for i, row in enumerate(dataset):
        if limit is not None and i >= limit:
            break
        pairs.append(_extract_pair(row, lang_src, lang_tgt))
    return pairs


def build_wmt14_vocab(
    pairs: Sequence[Pair],
    min_freq: int = 2,
    tokenize_src: Optional[Callable] = None,
    tokenize_tgt: Optional[Callable] = None,
    lang_src: str = "de",
    lang_tgt: str = "en",
) -> tuple[Vocab, Vocab]:
    """The reference vocab recipe (``wmt14_train.py:239-253``): min_freq=2,
    specials ``<s> </s> <blank> <unk>``, unk as default index."""
    ts, tt = tokenize_src, tokenize_tgt
    if ts is None or tt is None:
        dts, dtt = get_tokenizers(lang_src, lang_tgt)
        ts, tt = ts or dts, tt or dtt
    vs = build_vocab((ts(s) for s, _ in pairs), min_freq=min_freq,
                     specials=list(SPECIALS))
    vt = build_vocab((tt(t) for _, t in pairs), min_freq=min_freq,
                     specials=list(SPECIALS))
    return vs, vt


def tokenize_pairs(pairs: Sequence[Pair],
                   tokenize_src: Optional[Callable] = None,
                   tokenize_tgt: Optional[Callable] = None,
                   lang_src: str = "de",
                   lang_tgt: str = "en") -> list[Pair]:
    """Pre-tokenise raw sentence pairs into space-joined token strings so the
    corpus rides the standard whitespace-splitting BucketedLoader."""
    ts, tt = tokenize_src, tokenize_tgt
    if ts is None or tt is None:
        dts, dtt = get_tokenizers(lang_src, lang_tgt)
        ts, tt = ts or dts, tt or dtt
    return [(" ".join(ts(s)), " ".join(tt(t))) for s, t in pairs]


def load_multi30k_pairs(root: str, split: str = "train",
                        lang_src: str = "de", lang_tgt: str = "en") -> list[Pair]:
    """Multi30k's parallel-file layout (``{split}.{lang}`` next to each
    other), the corpus of the reference's ``main_train.py`` trainer."""
    import os

    def read(lang):
        with open(os.path.join(root, f"{split}.{lang}"), encoding="utf-8") as f:
            return [l.rstrip("\n") for l in f]

    src, tgt = read(lang_src), read(lang_tgt)
    assert len(src) == len(tgt), f"unaligned Multi30k files: {len(src)} vs {len(tgt)}"
    return list(zip(src, tgt))


# --------------------------------------------------- IWSLT15 en-vi (legacy)

def preprocess_iwslt_raw(source_file: str, target_file: str, out_file: str) -> int:
    """Raw IWSLT release -> TSV, reproducing ``preprocess.py:24-31``: keep
    aligned lines whose source is non-empty and not an XML/meta tag line
    (``<url>``, ``<talkid>``, ...).  Returns kept-pair count."""
    kept = 0
    with open(source_file, encoding="utf-8") as src, \
            open(target_file, encoding="utf-8") as tgt, \
            open(out_file, "w", encoding="utf-8") as out:
        for src_line, tgt_line in zip(src, tgt):
            src_line, tgt_line = src_line.strip(), tgt_line.strip()
            if not src_line.startswith("<") and len(src_line) > 0:
                out.write(f"{src_line}\t{tgt_line}\n")
                kept += 1
    return kept


def load_tsv_pairs(path: str, max_len: Optional[int] = 100) -> list[Pair]:
    """IWSLT15 en-vi TSV splits (``dataloader.py:30-39``): one
    ``src\\ttgt`` pair per line, pairs longer than ``max_len`` tokens on
    either side dropped (the reference's ``myfilter``; pass ``None`` to keep
    all, as its test loader does)."""
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            s, t = parts
            if max_len is not None and (
                    len(s.split()) > max_len or len(t.split()) > max_len):
                continue
            pairs.append((s, t))
    return pairs
