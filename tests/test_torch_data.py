"""The port's data layer (``onnx_transformer_tpu_torch.data``) against the
JAX package's on synthetic corpora: vocabularies, encoding, collation and
masks, the bucketed loader in its batch-size and token-budget modes (with
shuffling, ``drop_last`` and shards), the native batch encoder, and the
corpus loaders.  Every output must equal the JAX module's exactly: the
same arrays, in the same order, for the same seed."""

import json

import numpy as np
import pytest

from onnx_transformer_tpu.data import corpora as JCO
from onnx_transformer_tpu.data import dataset as JDS
from onnx_transformer_tpu.data import native as JN
from onnx_transformer_tpu.data import vocab as JV
from onnx_transformer_tpu_torch.data import corpora as CO
from onnx_transformer_tpu_torch.data import dataset as DS
from onnx_transformer_tpu_torch.data import native as N
from onnx_transformer_tpu_torch.data import vocab as V

BATCH_FIELDS = ("src", "tgt", "src_mask", "tgt_in", "tgt_y", "tgt_mask", "ntokens")


def _corpus(n=600, seed=0):
    """Pairs of 1-40 tokens from a 60-token alphabet (some outside the
    vocabulary), BPE continuation marks included."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(50)] + [f"p{i}@@" for i in range(10)]

    def line():
        return " ".join(rng.choice(words, rng.integers(1, 41)))

    return [(line(), line()) for _ in range(n)]


def _vocab():
    return V.Vocab(V.SPECIALS + [f"w{i}" for i in range(45)] + [f"p{i}@@" for i in range(10)])


def _jvocab():
    return JV.Vocab(JV.SPECIALS + [f"w{i}" for i in range(45)] + [f"p{i}@@" for i in range(10)])


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
            assert np.asarray(getattr(g, f)).dtype == np.asarray(getattr(w, f)).dtype


# ------------------------------------------------------------------- vocab

def test_vocab_artifact_and_specials_match_jax():
    (vs, vt), (js, jt) = V.load_iwslt14_vocab(), JV.load_iwslt14_vocab()
    assert (len(vs), len(vt)) == (5337, 4444)
    assert vs.itos == js.itos and vt.itos == jt.itos
    assert V.SPECIALS == JV.SPECIALS
    assert (V.BOS_ID, V.EOS_ID, V.PAD_ID, V.UNK_ID) == (JV.BOS_ID, JV.EOS_ID, JV.PAD_ID,
                                                         JV.UNK_ID)
    assert vs["definitely-not-a-token-xyz"] == V.UNK_ID


@pytest.mark.parametrize("min_freq", [1, 2, 3])
def test_build_vocab_matches_jax(min_freq):
    rng = np.random.default_rng(min_freq)
    streams = [list(rng.choice(list("abcdefghij"), rng.integers(1, 9))) for _ in range(40)]
    got = V.build_vocab(iter(streams), min_freq=min_freq)
    want = JV.build_vocab(iter(streams), min_freq=min_freq)
    assert got.itos == want.itos and got.default_index == want.default_index
    small = V.build_vocab(iter([["b", "a", "b", "c"], ["b", "a"]]), min_freq=2)
    assert small.itos == V.SPECIALS + ["b", "a"]


def test_vocab_lookup_json_and_files(tmp_path):
    v, jv = _vocab(), _jvocab()
    toks = ["w3", "zz", "p2@@", "<blank>"]
    assert v(toks) == jv(toks) and v.lookup_tokens([0, 5]) == jv.lookup_tokens([0, 5])
    assert ("w3" in v, "zz" in v) == ("w3" in jv, "zz" in jv) == (True, False)
    assert v.to_json() == jv.to_json()
    assert V.Vocab.from_json(jv.to_json()).itos == v.itos
    assert V.Vocab.from_json({"itos": ["a"]}).default_index == V.UNK_ID
    V.save_vocab(v, v, str(tmp_path / "port.json"))
    JV.save_vocab(jv, jv, str(tmp_path / "jax.json"))
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))
    assert JV.load_vocab(str(tmp_path / "port.json"))[0].itos == V.load_vocab(
        str(tmp_path / "jax.json"))[1].itos == v.itos


# ------------------------------------------------------- encoding, batches

@pytest.mark.parametrize("line, max_padding", [("w1 w2", 8), ("w1 " * 9, 5), ("", 4),
                                                ("zz w3 p1@@ w4", 6)])
def test_encode_sentence_matches_jax(line, max_padding):
    got = DS.encode_sentence(line, _vocab(), max_padding)
    want = JDS.encode_sentence(line, _jvocab(), max_padding)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    assert DS.tokenize(line) == JDS.tokenize(line)


def test_collate_masks_and_batch_match_jax():
    pairs = _corpus(12, seed=1)
    got = DS.collate(pairs, _vocab(), _vocab(), max_padding=20)
    want = JDS.collate(pairs, _jvocab(), _jvocab(), max_padding=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _assert_batches_equal([DS.Batch.make(*got)], [JDS.Batch.make(*want)])
    for g, w in zip(DS.make_masks(*got), JDS.make_masks(*want)):
        np.testing.assert_array_equal(g, w)


def test_load_pairs_and_split_match_jax(tmp_path):
    (tmp_path / "valid.de.bpe").write_text("ein hund\nzwei@@ katzen\n")
    (tmp_path / "valid.en.bpe").write_text("a dog\ntwo cats\n")
    got = DS.load_split(str(tmp_path), "valid")
    assert got == JDS.load_split(str(tmp_path), "valid") == [("ein hund", "a dog"),
                                                            ("zwei@@ katzen", "two cats")]
    assert DS.load_pairs(str(tmp_path / "valid.de.bpe"), str(tmp_path / "valid.en.bpe")) == got


@pytest.mark.parametrize("tokens", [["wir@@", "klich", "gut"], ["sta@@", "un@@", "en"], [],
                                    ["a@@"]])
def test_unbpe_matches_jax(tokens):
    assert DS.unbpe(tokens) == JDS.unbpe(tokens)


# ------------------------------------------------------------------- loader

LOADERS = {
    "batch size": dict(batch_size=16, max_padding=24, seed=1),
    "batch size, small pools, no shuffle": dict(batch_size=16, max_padding=24, pool_factor=3,
                                                shuffle=False),
    "batch size, ragged tail": dict(batch_size=48, max_padding=24, drop_last=False, seed=2),
    "batch size, shard 1 of 3": dict(batch_size=16, max_padding=24, num_shards=3,
                                     shard_index=1, seed=3),
    "token budget": dict(max_padding=24, token_budget=256, length_buckets=(8, 12, 16, 24),
                         seed=4),
    "token budget, keep tails": dict(max_padding=24, token_budget=256,
                                     length_buckets=(8, 12, 16, 24), drop_last=False, seed=5),
    "token budget, shard 0 of 2": dict(max_padding=24, token_budget=200,
                                       length_buckets=(12, 24), num_shards=2, shard_index=0,
                                       seed=6),
    "token budget, shard 1 of 2": dict(max_padding=24, token_budget=200,
                                       length_buckets=(12, 24), num_shards=2, shard_index=1,
                                       seed=6),
}


@pytest.mark.parametrize("kw", list(LOADERS.values()), ids=list(LOADERS))
def test_bucketed_loader_matches_jax(kw):
    """Array for array, in order, for two epochs; the lengths equal."""
    pairs = _corpus()
    got = DS.BucketedLoader(pairs, _vocab(), _vocab(), use_native=False, **kw)
    want = JDS.BucketedLoader(pairs, _jvocab(), _jvocab(), use_native=False, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        _assert_batches_equal(got, want)


def test_loader_static_shapes_and_reshuffle():
    """tests/test_data.py's shape and reshuffle checks on the port."""
    v = V.Vocab(V.SPECIALS + ["a", "b"])
    pairs = [("a " * (i % 7 + 1), "b " * (i % 5 + 1)) for i in range(64)]
    loader = DS.BucketedLoader(pairs, v, v, batch_size=8, max_padding=16, seed=1)
    batches = list(loader)
    assert len(batches) == 8 and all(b.src.shape == (8, 16) for b in batches)
    loader.set_epoch(1)
    assert any(not np.array_equal(x.src, y.src) for x, y in zip(batches, loader))


def test_token_budget_buckets():
    """tests/test_data.py's token-budget checks on the port: every shape a
    (bucket batch size, bucket length) pair within the budget, every pair
    consumed without drop_last, and the full-size batches dominate."""
    v = V.Vocab(V.SPECIALS + ["a", "b"])
    pairs = [("a " * (i % 14 + 1), "b " * (i % 9 + 1)) for i in range(256)]
    loader = DS.BucketedLoader(pairs, v, v, max_padding=16, seed=1, token_budget=256,
                               length_buckets=(8, 12, 16), drop_last=False)
    batches = list(loader)
    total = 0
    for b in batches:
        bsz, length = b.src.shape
        assert length in (8, 12, 16) and bsz <= loader._bucket_bsz(length)
        assert loader._bucket_bsz(length) * length <= 256 + 8 * length
        total += bsz
    assert total == len(pairs) and len({b.src.shape for b in batches}) >= 2
    full = sum(b.src.shape[0] == loader._bucket_bsz(b.src.shape[1]) for b in batches)
    assert full >= len(batches) - len(loader.length_buckets)
    # the card's recipe: 12,288 tokens over buckets 16/24/32/48/72
    big = DS.BucketedLoader(pairs, v, v, token_budget=12288)
    assert [big._bucket_bsz(length) for length in big.length_buckets] == [768, 512, 384, 256,
                                                                          168]


def test_shards_partition_and_lockstep():
    """Batch-size shards split the pairs evenly; token-budget shards take
    the same number of steps with the same shape at each step, on disjoint
    data, and __len__ is exact there."""
    v = V.Vocab(V.SPECIALS + ["a"])
    pairs = [("a", "a") for _ in range(32)]
    shards = [DS.BucketedLoader(pairs, v, v, batch_size=4, shuffle=False, num_shards=2,
                                shard_index=s) for s in range(2)]
    assert len(shards[0]) == len(shards[1]) == 4
    v = V.Vocab(V.SPECIALS + ["b"] + [f"w{i}" for i in range(512)])
    pairs = [(f"w{i} " * (i % 14 + 1), "b " * (i % 9 + 1)) for i in range(512)]
    loaders = [DS.BucketedLoader(pairs, v, v, max_padding=16, seed=3, token_budget=128,
                                 length_buckets=(8, 12, 16), num_shards=2, shard_index=s)
               for s in range(2)]
    b0, b1 = list(loaders[0]), list(loaders[1])
    assert len(b0) == len(b1) == len(loaders[0]) > 0
    for x, y in zip(b0, b1):
        assert x.src.shape == y.src.shape and not np.array_equal(x.src, y.src)


# ------------------------------------------------------------------- native

def test_native_builds_into_the_port_build_dir():
    assert N.available()
    assert N._LIB.endswith("onnx_transformer_tpu_torch/_build/libotxdataio.so")
    assert N._SRC == JN._SRC


def test_native_lookup_encode_and_lengths():
    """The C++ encoder against the pure-Python path (truncation, unknown
    tokens, an empty line) and against the JAX package's binding."""
    v = V.Vocab(V.SPECIALS + [f"t{i}" for i in range(20)] + ["ü@@", "ß", "wörld"])
    nv = N.NativeVocab(v.itos, v.default_index)
    assert nv.size == len(v)
    for tok in ["t3", "wörld", "ü@@", "<s>", "missing-token"]:
        assert nv.lookup(tok) == v[tok]
    pairs = [("t1 t2 t3", "t4 t5"), ("ü@@ ß t19", "t0"), ("unknown tokens here", "t1 " * 30),
             ("", "t2")]
    py = DS.collate(pairs, v, v, max_padding=12)
    nat = DS.collate(pairs, v, v, max_padding=12, native=(nv, nv))
    jnv = JN.NativeVocab(v.itos, v.default_index)
    jax_nat = JDS.collate(pairs, v, v, max_padding=12, native=(jnv, jnv))
    for a, b, c in zip(nat, py, jax_nat):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    lines = ["a b c", "", "  x  ", "one two   three four", "tab\tsplit"]
    np.testing.assert_array_equal(N.line_lengths(lines), JN.line_lengths(lines))
    np.testing.assert_array_equal(N.line_lengths(lines), [3, 0, 1, 4, 2])


@pytest.mark.parametrize("kw", [dict(batch_size=16, max_padding=24, seed=3),
                                dict(max_padding=24, token_budget=256,
                                     length_buckets=(8, 16, 24), seed=3)])
def test_loader_native_matches_pure_python(kw):
    pairs = _corpus(200, seed=7)
    native = DS.BucketedLoader(pairs, _vocab(), _vocab(), use_native=True, **kw)
    python = DS.BucketedLoader(pairs, _vocab(), _vocab(), use_native=False, **kw)
    assert native._native is not None and python._native is None
    _assert_batches_equal(native, python)


# ------------------------------------------------------------------ corpora

def _rows(n=40):
    return [{"translation": {"de": f"der satz nummer {i} ist hier",
                             "en": f"the sentence number {i} is here"}} for i in range(n)]


def test_wmt14_rows_vocab_and_tokens_match_jax():
    pairs = CO.load_wmt14_pairs(dataset=_rows(), limit=10)
    assert pairs == JCO.load_wmt14_pairs(dataset=_rows(), limit=10)
    assert pairs[3] == ("der satz nummer 3 ist hier", "the sentence number 3 is here")
    for row, langs in (({"translation": {"cs": "ahoj svete", "en": "hello world"}}, ("cs", "en")),
                       ({"translation": {"cs": "ahoj svete", "en": "hello world"}}, ("de", "fr")),
                       ({"other": {"de": "x", "en": "y"}}, ("de", "en"))):
        assert CO._extract_pair(row, *langs) == JCO._extract_pair(row, *langs)
    full = CO.load_wmt14_pairs(dataset=_rows(30))
    (vs, vt), (js, jt) = CO.build_wmt14_vocab(full), JCO.build_wmt14_vocab(full)
    assert vs.itos == js.itos and vt.itos == jt.itos
    assert "satz" in vs.itos and "7" not in vs.itos and vs["never-seen"] == vs["<unk>"]
    assert CO.tokenize_pairs(full) == JCO.tokenize_pairs(full)
    tok = [(s, t) for s, t in CO.tokenize_pairs(CO.load_wmt14_pairs(dataset=_rows(32)))]
    vs, vt = CO.build_wmt14_vocab(tok)
    batches = list(DS.BucketedLoader(tok, vs, vt, batch_size=8, max_padding=16, shuffle=False))
    assert len(batches) == 4 and batches[0].src.shape == (8, 16)
    assert (batches[0].src[:, 0] == V.BOS_ID).all()


def test_multi30k_layout_matches_jax(tmp_path):
    (tmp_path / "train.de").write_text("ein hund läuft\nzwei katzen\n")
    (tmp_path / "train.en").write_text("a dog runs\ntwo cats\n")
    got = CO.load_multi30k_pairs(str(tmp_path), "train")
    assert got == JCO.load_multi30k_pairs(str(tmp_path), "train") == [
        ("ein hund läuft", "a dog runs"), ("zwei katzen", "two cats")]
    with pytest.raises(FileNotFoundError):
        CO.load_multi30k_pairs(str(tmp_path), "val")


def test_iwslt_raw_preprocess_and_tsv_match_jax(tmp_path):
    (tmp_path / "raw.vi").write_text(
        "<url>http://x</url>\nxin chào thế giới\n\ndài " + "a " * 120 + "\n")
    (tmp_path / "raw.en").write_text(
        "<url>http://x</url>\nhello world\n\nlong " + "a " * 120 + "\n")
    kept = CO.preprocess_iwslt_raw(str(tmp_path / "raw.vi"), str(tmp_path / "raw.en"),
                                   str(tmp_path / "port.tsv"))
    JCO.preprocess_iwslt_raw(str(tmp_path / "raw.vi"), str(tmp_path / "raw.en"),
                             str(tmp_path / "jax.tsv"))
    assert kept == 2
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    for max_len in (100, None):
        got = CO.load_tsv_pairs(str(tmp_path / "port.tsv"), max_len=max_len)
        assert got == JCO.load_tsv_pairs(str(tmp_path / "port.tsv"), max_len=max_len)
    assert CO.load_tsv_pairs(str(tmp_path / "port.tsv")) == [("xin chào thế giới",
                                                              "hello world")]


def test_tokenizers_fall_back_to_whitespace():
    """Without spacy (or its models), each language gets str.split, as the
    JAX package's guard gives."""
    ts, tt = CO.get_tokenizers("de", "xx")
    js, jt = JCO.get_tokenizers("de", "xx")
    for s in ("ein  hund", "a\tdog runs"):
        assert ts(s) == js(s) and tt(s) == jt(s)
