"""The port's word2vec text stack against the JAX package's, on the CPU.

Everything here is host-side and deterministic, so the bar is equality:

  * tokenizer, preprocessor and sentence iterators give the same tokens;
  * the vocabulary has the same words, counts, index order (descending
    count, ties by word) and ``min_word_frequency`` filter;
  * Huffman codes and points are the same, bit for bit, also with the
    depth cap;
  * the unigram table, a fresh ``InMemoryLookupTable`` (syn0, syn1,
    syn1neg) and the padded Huffman tensors are bit-equal;
  * ``_make_pairs`` and ``_make_cbow_batches`` give the same arrays from
    the same numpy seed, with and without subsampling;
  * the lookup table's queries give the same answers on the same syn0
    (similarities to 1e-6: the same f32 arithmetic in numpy).
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.nlp import huffman as jhuff  # noqa: E402
from deeplearning4j_tpu.nlp import lookup as jlookup  # noqa: E402
from deeplearning4j_tpu.nlp import text as jtext  # noqa: E402
from deeplearning4j_tpu.nlp import vocab as jvocab  # noqa: E402
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxWord2Vec  # noqa: E402

from deeplearning4j_tpu_torch.nlp import huffman as phuff  # noqa: E402
from deeplearning4j_tpu_torch.nlp import lookup as plookup  # noqa: E402
from deeplearning4j_tpu_torch.nlp import text as ptext  # noqa: E402
from deeplearning4j_tpu_torch.nlp import vocab as pvocab  # noqa: E402
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: E402

TEXT = ["The quick, brown fox -- jumps over the lazy dog!",
        "  Dogs and FOXES: 3 friends?  ",
        "",
        "naïve café au lait; the end."]


def zipf_corpus(seed=0, n_sent=120, vocab=80, a=1.4):
    """Tokenized sentences of Zipf-distributed words w0..w{vocab-1}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sent):
        ids = rng.zipf(a, size=int(rng.integers(2, 25)))
        toks = [f"w{int(x) - 1}" for x in ids if x <= vocab]
        if toks:
            out.append(toks)
    return out


def vocab_pair(corpus, min_freq=1, huffman=True):
    return (jvocab.VocabConstructor(min_freq, huffman).build(corpus),
            pvocab.VocabConstructor(min_freq, huffman).build(corpus))


class TestText:
    @pytest.mark.parametrize("pre", [None, "common"])
    def test_tokenizer_factory(self, pre):
        jf = jtext.DefaultTokenizerFactory(
            jtext.common_preprocessor if pre else None)
        pf = ptext.DefaultTokenizerFactory(
            ptext.common_preprocessor if pre else None)
        for s in TEXT:
            assert pf.tokenize(s) == jf.tokenize(s)
            jt, pt = jf.create(s), pf.create(s)
            assert pt.count_tokens() == jt.count_tokens()
            got = []
            while pt.has_more_tokens():
                got.append(pt.next_token())
            assert got == jt.get_tokens()

    def test_preprocessor(self):
        for tok in ("Hello,", "ÉCOLE!", "a-b_c", "--", "x2y"):
            assert ptext.common_preprocessor(tok) == \
                jtext.common_preprocessor(tok)

    def test_sentence_iterators(self, tmp_path):
        path = tmp_path / "corpus.txt"
        path.write_text("\n".join(TEXT) + "\n", encoding="utf-8")
        up = str.upper
        for j, p in (
                (jtext.CollectionSentenceIterator(TEXT),
                 ptext.CollectionSentenceIterator(TEXT)),
                (jtext.CollectionSentenceIterator(TEXT, up),
                 ptext.CollectionSentenceIterator(TEXT, up)),
                (jtext.LineSentenceIterator(str(path)),
                 ptext.LineSentenceIterator(str(path))),
                (jtext.LineSentenceIterator(str(path), up),
                 ptext.LineSentenceIterator(str(path), up))):
            assert list(p) == list(j)
            p.reset()
            assert list(p) == list(j)


class TestVocab:
    @pytest.mark.parametrize("min_freq", [1, 2, 5])
    def test_order_counts_and_filter(self, min_freq):
        jv, pv = vocab_pair(zipf_corpus(), min_freq)
        assert [(w.word, w.count, w.index) for w in pv.vocab_words()] == \
            [(w.word, w.count, w.index) for w in jv.vocab_words()]
        assert pv.total_word_occurrences == jv.total_word_occurrences
        assert len(pv) == pv.num_words() == jv.num_words()
        for w in ("w0", "w3", "nope"):
            assert pv.index_of(w) == jv.index_of(w)
            assert pv.word_frequency(w) == jv.word_frequency(w)
            assert (w in pv) == (w in jv)

    def test_ties_break_by_word(self):
        corpus = [["b", "a", "c", "a", "b", "c", "d"]]
        jv, pv = vocab_pair(corpus)
        assert [w.word for w in pv.vocab_words()] == ["a", "b", "c", "d"]
        assert [w.word for w in jv.vocab_words()] == ["a", "b", "c", "d"]


class TestHuffman:
    @pytest.mark.parametrize("corpus", [
        zipf_corpus(1), zipf_corpus(2, n_sent=400, vocab=300, a=1.2),
        [["x"] * 4 + ["y"] * 4 + ["z"] * 4 + ["q"] * 4],  # all tied
        [["solo", "solo"]], [["a", "b", "b"]]],
        ids=["zipf80", "zipf300", "ties", "one-word", "two-words"])
    def test_codes_and_points_bit_equal(self, corpus):
        jv, pv = vocab_pair(corpus)
        for a, b in zip(jv.vocab_words(), pv.vocab_words()):
            assert (b.codes, b.points) == (a.codes, a.points), a.word
            assert b.code_length == a.code_length

    def test_depth_cap(self):
        jv, pv = vocab_pair(zipf_corpus(3), huffman=False)
        jw, pw = jv.vocab_words(), pv.vocab_words()
        jhuff.build_huffman(jw, max_code_length=3)
        phuff.build_huffman(pw, max_code_length=3)
        assert max(len(w.codes) for w in pw) == 3
        assert [(w.codes, w.points) for w in pw] == \
            [(w.codes, w.points) for w in jw]
        assert phuff.MAX_CODE_LENGTH == jhuff.MAX_CODE_LENGTH == 40


class TestLookupTable:
    @pytest.mark.parametrize("negative", [0, 5])
    @pytest.mark.parametrize("seed", [0, 123])
    def test_fresh_tables_bit_equal(self, negative, seed):
        jv, pv = vocab_pair(zipf_corpus(seed))
        jt = jlookup.InMemoryLookupTable(jv, 24, seed=seed, negative=negative,
                                         table_size=1000)
        pt = plookup.InMemoryLookupTable(pv, 24, seed=seed, negative=negative,
                                         table_size=1000)
        np.testing.assert_array_equal(pt.syn0, jt.syn0)
        np.testing.assert_array_equal(pt.syn1, jt.syn1)
        assert pt.syn0.dtype == np.float32
        if negative:
            np.testing.assert_array_equal(pt.syn1neg, jt.syn1neg)
            np.testing.assert_array_equal(pt.table, jt.table)
            assert pt.table.dtype == np.int32
        else:
            assert pt.syn1neg is None and pt.table is None

    def test_unigram_table_full_size(self):
        jv, pv = vocab_pair(zipf_corpus(4, n_sent=300, vocab=200))
        jt = jlookup.InMemoryLookupTable(jv, 8, negative=1)
        pt = plookup.InMemoryLookupTable(pv, 8, negative=1)
        assert pt.table.shape == (100_000,)
        np.testing.assert_array_equal(pt.table, jt.table)

    def test_huffman_tensors(self):
        jv, pv = vocab_pair(zipf_corpus(5))
        for a, b in zip(jlookup.InMemoryLookupTable(jv, 8).huffman_tensors(),
                        plookup.InMemoryLookupTable(pv, 8).huffman_tensors()):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype

    def test_queries(self):
        jv, pv = vocab_pair(zipf_corpus(6))
        jt = jlookup.InMemoryLookupTable(jv, 16, seed=9)
        pt = plookup.InMemoryLookupTable(pv, 16, seed=9)
        np.testing.assert_array_equal(pt.vector("w0"), jt.vector("w0"))
        assert pt.vector("nope") is None
        np.testing.assert_array_equal(pt.vectors([2, 0, 1]),
                                      jt.vectors([2, 0, 1]))
        assert abs(pt.similarity("w0", "w1") - jt.similarity("w0", "w1")) \
            < 1e-6
        assert np.isnan(pt.similarity("w0", "nope"))
        for w in ("w0", "w2", "nope"):
            assert pt.words_nearest(w, 7) == jt.words_nearest(w, 7)
        assert pt.words_nearest(pt.syn0[3], 5) == \
            jt.words_nearest(jt.syn0[3], 5)
        assert pt.words_nearest_sum(["w0", "w1"], ["w2"], 4) == \
            jt.words_nearest_sum(["w0", "w1"], ["w2"], 4)


class TestPairs:
    def _pair(self, **kw):
        corpus = zipf_corpus(7, n_sent=60)
        j = JaxWord2Vec(layer_size=8, **kw)
        p = Word2Vec(layer_size=8, device="cpu", **kw)
        j.build_vocab(corpus)
        p.build_vocab(corpus)
        for m in (j, p):
            m._counts = np.array([w.count for w in m.vocab.vocab_words()],
                                 np.float64)
        js, ps = j._sequences_as_indices(corpus), p._sequences_as_indices(
            corpus)
        assert len(js) == len(ps)
        for a, b in zip(js, ps):
            np.testing.assert_array_equal(b, a)
        return j, p, js, ps

    @pytest.mark.parametrize("window,sampling", [(1, 0.0), (3, 0.0),
                                                 (5, 0.0), (4, 1e-2)])
    def test_make_pairs(self, window, sampling):
        j, p, js, ps = self._pair(window=window, sampling=sampling)
        a = j._make_pairs(js, np.random.default_rng(11))
        b = p._make_pairs(ps, np.random.default_rng(11))
        assert len(a[0]) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
            assert y.dtype == x.dtype

    @pytest.mark.parametrize("window,sampling", [(1, 0.0), (3, 0.0),
                                                 (4, 1e-2)])
    def test_make_cbow_batches(self, window, sampling):
        j, p, js, ps = self._pair(window=window, sampling=sampling)
        a = j._make_cbow_batches(js, np.random.default_rng(12))
        b = p._make_cbow_batches(ps, np.random.default_rng(12))
        assert len(a[0]) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
            assert y.dtype == x.dtype

    def test_empty_corpus_pairs(self):
        p = Word2Vec(layer_size=8, device="cpu")
        p.build_vocab([["a"]])
        c, x = p._make_pairs([np.array([0], np.int32)],
                             np.random.default_rng(0))
        assert c.shape == x.shape == (0,)
        c, x, m = p._make_cbow_batches([], np.random.default_rng(0))
        assert c.shape == (0,) and x.shape == m.shape == (0, 10)
