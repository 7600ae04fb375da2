"""The port's host text tools against the JAX package's, on the CPU:
``nlp/treeparser.py``, ``nlp/vectorizers.py``, ``nlp/invertedindex.py``,
``nlp/movingwindow.py``, ``nlp/text_pipeline.py`` and
``PosFilterTokenizerFactory`` (``nlp/text.py``).

  * The tree parser: every case of ``tests/test_treeparser.py`` runs on
    the port, and its trees (as s-expressions), tags, heads, grammar and
    labels equal JAX's on the same sentences, trained taggers and
    treebanks included (the perceptron's weights and the grammar's
    tables are dicts filled in the same order).
  * The vectorizers: bag-of-words and TF-IDF matrices bit-equal to JAX's,
    their ``DataSet``s too.
  * The inverted index, the moving windows, ``strip_context_labels`` and
    the window converter equal JAX's.
  * ``TextPipeline``: counts, vocab and Huffman codes equal JAX's and a
    serial ``VocabConstructor`` build, at 1 and 8 partitions; the
    ``tests/test_nlp_distributed.py::TestTextPipeline`` cases.
  * ``PosFilterTokenizerFactory`` equals JAX's, dropping or keeping.
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.nlp import invertedindex as jii  # noqa: E402
from deeplearning4j_tpu.nlp import movingwindow as jmw  # noqa: E402
from deeplearning4j_tpu.nlp import text as jtext  # noqa: E402
from deeplearning4j_tpu.nlp import text_pipeline as jtp  # noqa: E402
from deeplearning4j_tpu.nlp import treeparser as jtree  # noqa: E402
from deeplearning4j_tpu.nlp import vectorizers as jvec  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nlp import invertedindex as pii  # noqa: E402
from deeplearning4j_tpu_torch.nlp import movingwindow as pmw  # noqa: E402
from deeplearning4j_tpu_torch.nlp import text as ptext  # noqa: E402
from deeplearning4j_tpu_torch.nlp import text_pipeline as ptp  # noqa: E402
from deeplearning4j_tpu_torch.nlp import treeparser as ptree  # noqa: E402
from deeplearning4j_tpu_torch.nlp import vectorizers as pvec  # noqa: E402
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor  # noqa: E402

SEXPR = "(S (NP (DT the) (NN dog)) (VP (VBZ chases) (NP (DT the) (NN cat))))"
BANK = [
    "(S (NP (DT the) (NN dog)) (VP (VBZ chases) (NP (DT the) (NN cat))))",
    "(S (NP (DT a) (NN cat)) (VP (VBZ sees) (NP (DT a) (NN bird))))",
    "(S (NP (DT the) (NN bird)) (VP (VBZ sings)))",
]
TAGGED = [
    [("the", "DT"), ("dog", "NN"), ("barks", "VBZ")],
    [("a", "DT"), ("cat", "NN"), ("sleeps", "VBZ")],
    [("the", "DT"), ("cat", "NN"), ("barks", "VBZ")],
    [("dogs", "NNS"), ("bark", "VBP")],
    [("cats", "NNS"), ("sleep", "VBP")],
    [("the", "DT"), ("big", "JJ"), ("dog", "NN"), ("sleeps", "VBZ")],
    [("a", "DT"), ("small", "JJ"), ("cat", "NN"), ("runs", "VBZ")],
] * 3
TEXTS = [
    "The big dog chased the cat. A bird sings.",
    "the dog sees the bird.",
    "Dogs bark loudly at 3 cats, and the cat runs away!",
    "A small cat sleeps under the big red table.",
]


@pytest.fixture(params=["jax", "port"])
def tp(request):
    return jtree if request.param == "jax" else ptree


def _sx(trees):
    return [t.to_sexpr() for t in trees]


class TestTreeParserCases:
    """``tests/test_treeparser.py``, run on both packages."""

    def test_sexpr_roundtrip(self, tp):
        t = tp.parse_sexpr(SEXPR)
        assert t.to_sexpr() == SEXPR
        assert t.yield_() == ["the", "dog", "chases", "the", "cat"]
        assert t.tokens == t.yield_()

    def test_tree_structure_queries(self, tp):
        t = tp.parse_sexpr(SEXPR)
        assert t.label == "S" and not t.is_leaf() and t.depth() == 4
        np_node = t.first_child()
        dt = np_node.first_child()
        assert dt.is_preterminal() and dt.first_child().is_leaf()
        assert len(t.leaves()) == 5 and len(t.preterminals()) == 5
        assert dt.parent is np_node and dt.ancestor(2) is t
        c = t.clone()
        assert c == t and c is not t
        c.first_child().label = "XP"
        assert c != t

    def test_error_sum(self, tp):
        t = tp.parse_sexpr("(A (B b) (C c))")
        t.error = 1.0
        t.children[0].error = 2.0
        t.children[1].error = 0.5
        assert t.error_sum() == pytest.approx(3.5)

    def test_binarize_and_unbinarize(self, tp):
        t = tp.parse_sexpr("(NP (DT the) (JJ big) (JJ red) (NN dog))")
        b = tp.BinarizeTreeTransformer()
        bt = b.transform(t)
        assert all(len(n.children) <= 2 for n in bt.subtrees())
        assert bt.yield_() == t.yield_() and b.unbinarize(bt) == t

    def test_collapse_unaries(self, tp):
        t = tp.parse_sexpr("(S (NP (NX (NN dog))) (VP (VBZ runs)))")
        assert tp.CollapseUnaries().transform(t).to_sexpr() == \
            "(S (NP (NN dog)) (VP (VBZ runs)))"

    def test_head_word_finder(self, tp):
        t = tp.parse_sexpr(SEXPR)
        h = tp.HeadWordFinder()
        assert h.find_head(t).label == "VP"
        assert h.find_head(t.first_child()).label == "NN"
        assert h.head_word(t) == "chases"
        h.annotate(t)
        assert t.head_word == "chases"

    def test_rule_tagger_untrained(self, tp):
        tags = tp.AveragedPerceptronTagger().tag(
            ["The", "dog", "quickly", "jumped", "over", "3", "fences"])
        assert [tags[i] for i in (0, 2, 3, 5, 6)] == [
            "DT", "RB", "VBD", "CD", "NNS"]

    def test_perceptron_tagger_learns(self, tp):
        tagger = tp.AveragedPerceptronTagger().train(TAGGED, iterations=8,
                                                     seed=1)
        assert tagger.tag(["the", "dog", "sleeps"]) == ["DT", "NN", "VBZ"]
        assert tagger.tag(["a", "big", "cat", "barks"]) == [
            "DT", "JJ", "NN", "VBZ"]

    def test_pcfg_cky_recovers_bracketing(self, tp):
        g = tp.Pcfg.from_trees([tp.parse_sexpr(s) for s in BANK])
        tree = g.parse(["DT", "NN", "VBZ", "DT", "NN"],
                       ["the", "fox", "chases", "a", "hen"])
        assert tree.to_sexpr() == ("(S (NP (DT the) (NN fox)) (VP (VBZ "
                                   "chases) (NP (DT a) (NN hen))))")
        t2 = g.parse(["DT", "NN", "VBZ"], ["a", "dog", "sings"])
        assert t2 is not None and t2.label == "S"

    def test_treeparser_chunker_fallback(self, tp):
        trees = tp.TreeParser().get_trees(TEXTS[0])
        assert len(trees) == 2 and trees[0].label == "S"
        labels = [c.label for c in trees[0].children]
        assert "NP" in labels and "VP" in labels
        assert trees[0].yield_()[:3] == ["The", "big", "dog"]

    def test_treeparser_with_grammar(self, tp):
        corpus = [[("the", "DT"), ("dog", "NN"), ("chases", "VBZ"),
                   ("the", "DT"), ("cat", "NN")],
                  [("a", "DT"), ("cat", "NN"), ("sees", "VBZ"),
                   ("a", "DT"), ("bird", "NN")]] * 4
        tagger = tp.AveragedPerceptronTagger().train(corpus, iterations=6)
        parser = tp.TreeParser(tagger=tagger).fit_grammar(
            [tp.parse_sexpr(s) for s in BANK[:2]])
        trees = parser.get_trees(TEXTS[1])
        assert len(trees) == 1 and trees[0].label == "S"
        assert trees[0].first_child().label == "NP"

    def test_tree_vectorizer_labels(self, tp):
        trees = tp.TreeVectorizer().get_trees_with_labels(
            "The dog runs.", "pos", ["NEG", "POS"])
        assert len(trees) == 1
        assert all(n.gold_label == 1 for n in trees[0].subtrees())

    def test_tree_iterator_batches(self, tp):
        docs = [("The dog runs. The cat sleeps.", "POS"),
                ("A bird sings.", "NEG")]
        batches = list(tp.TreeIterator(docs, ["NEG", "POS"], batch_size=2))
        assert sum(len(b) for b in batches) == 3
        assert all(len(b) <= 2 for b in batches)
        assert batches[0][0].gold_label == 1

    def test_pos_filter_tokenizer(self, tp):
        text = jtext if tp is jtree else ptext
        tf = text.PosFilterTokenizerFactory(["NN", "NNS"])
        assert tf.tokenize("the dog chased cats") == [
            "NONE", "dog", "NONE", "cats"]
        drop = text.PosFilterTokenizerFactory(["NN", "NNS"], drop=True)
        assert drop.tokenize("the dog chased cats") == ["dog", "cats"]


class TestTreeParserEqualsJax:
    def test_untrained_trees_tags_and_heads(self):
        jp, pp = jtree.TreeParser(), ptree.TreeParser()
        for text in TEXTS:
            jt, pt = jp.get_trees(text), pp.get_trees(text)
            assert _sx(pt) == _sx(jt)
            jh, ph = jtree.HeadWordFinder(), ptree.HeadWordFinder()
            for a, b in zip(jt, pt):
                jh.annotate(a)
                ph.annotate(b)
                assert [getattr(n, "head_word", None) for n in b.subtrees()] \
                    == [getattr(n, "head_word", None) for n in a.subtrees()]

    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_trained_tagger_weights_and_tags(self, seed):
        j = jtree.AveragedPerceptronTagger().train(TAGGED, iterations=5,
                                                   seed=seed)
        p = ptree.AveragedPerceptronTagger().train(TAGGED, iterations=5,
                                                   seed=seed)
        assert list(p.weights) == list(j.weights)
        assert p.weights == j.weights
        for text in TEXTS:
            words = jtext.DefaultTokenizerFactory().tokenize(text)
            assert p.tag(words) == j.tag(words)

    def test_grammar_tables_and_parses(self):
        bank = [jtree.parse_sexpr(s) for s in BANK]
        jg = jtree.Pcfg.from_trees(bank)
        pg = ptree.Pcfg.from_trees([ptree.parse_sexpr(s) for s in BANK])
        for attr in vars(jg):
            a, b = getattr(jg, attr), getattr(pg, attr)
            if isinstance(a, dict):
                assert list(b) == list(a) and b == a, attr
        sents = [(["DT", "NN", "VBZ", "DT", "NN"],
                  ["the", "fox", "chases", "a", "hen"]),
                 (["DT", "NN", "VBZ"], ["a", "dog", "sings"]),
                 (["NN", "VBZ"], ["dogs", "run"])]
        for tags, words in sents:
            a, b = jg.parse(tags, words), pg.parse(tags, words)
            assert (a is None) == (b is None)
            if a is not None:
                assert b.to_sexpr() == a.to_sexpr()

    def test_binarize_collapse_and_labels_on_parsed_trees(self):
        for text in TEXTS:
            jt = jtree.TreeParser().get_trees(text)
            pt = ptree.TreeParser().get_trees(text)
            assert _sx([jtree.BinarizeTreeTransformer().transform(t)
                        for t in jt]) == _sx(
                [ptree.BinarizeTreeTransformer().transform(t) for t in pt])
            assert _sx([jtree.CollapseUnaries().transform(t) for t in jt]) \
                == _sx([ptree.CollapseUnaries().transform(t) for t in pt])
        jv = jtree.TreeVectorizer().get_trees_with_labels(
            TEXTS[2], "neg", ["NEG", "POS"])
        pv = ptree.TreeVectorizer().get_trees_with_labels(
            TEXTS[2], "neg", ["NEG", "POS"])
        assert _sx(pv) == _sx(jv)
        assert [n.gold_label for t in pv for n in t.subtrees()] == \
            [n.gold_label for t in jv for n in t.subtrees()]

    @pytest.mark.parametrize("drop", [False, True])
    def test_pos_filter_equals_jax(self, drop):
        j = jtext.PosFilterTokenizerFactory(["NN", "NNS", "JJ"], drop=drop)
        p = ptext.PosFilterTokenizerFactory(["NN", "NNS", "JJ"], drop=drop)
        for text in TEXTS:
            assert p.tokenize(text) == j.tokenize(text)
        jt = jtree.AveragedPerceptronTagger().train(TAGGED, iterations=4)
        pt = ptree.AveragedPerceptronTagger().train(TAGGED, iterations=4)
        j = jtext.PosFilterTokenizerFactory(["NN"], tagger=jt, drop=drop)
        p = ptext.PosFilterTokenizerFactory(["NN"], tagger=pt, drop=drop)
        for text in TEXTS:
            assert p.tokenize(text) == j.tokenize(text)


DOCS = [
    "the cat sat on the mat", "the dog ate my homework",
    "a cat and a dog are friends", "homework is hard",
    "the mat is red and the dog is brown",
]


class TestVectorizers:
    @pytest.mark.parametrize("cls", ["BagOfWordsVectorizer",
                                     "TfidfVectorizer"])
    @pytest.mark.parametrize("kw", [{}, {"min_word_frequency": 2},
                                    {"stop_words": ["the", "a"]}])
    def test_matrices_bit_equal(self, cls, kw):
        j = getattr(jvec, cls)(**kw).fit(DOCS)
        p = getattr(pvec, cls)(**kw).fit(DOCS)
        assert p.num_docs == j.num_docs
        assert np.array_equal(p._doc_freq, j._doc_freq)
        jm, pm = j.transform_all(DOCS + ["unseen words here"]), \
            p.transform_all(DOCS + ["unseen words here"])
        assert pm.dtype == jm.dtype and np.array_equal(pm, jm)

    def test_dataset_bit_equal(self):
        labels = ["pets", "school", "pets", "school", "pets"]
        jd = jvec.TfidfVectorizer().fit(DOCS).vectorize(DOCS, labels)
        pd = pvec.TfidfVectorizer().fit(DOCS).vectorize(DOCS, labels)
        assert isinstance(pd, DataSet)
        assert np.array_equal(pd.features, jd.features)
        assert np.array_equal(pd.labels, jd.labels)


class TestInvertedIndex:
    def test_equals_jax(self):
        j, p = jii.InvertedIndex(), pii.InvertedIndex()
        for i, d in enumerate(DOCS):
            toks = d.split()
            assert p.add_words_to_doc(toks, label=f"l{i}") == \
                j.add_words_to_doc(toks, label=f"l{i}")
        p.finish()
        assert p.num_documents() == j.num_documents() == len(DOCS)
        for w in ("the", "cat", "homework", "zzz"):
            assert p.documents(w) == j.documents(w)
            assert p.doc_frequency(w) == j.doc_frequency(w)
        assert p.document(2) == j.document(2)
        assert p.document_label(3) == j.document_label(3) == "l3"
        assert list(p.all_docs()) == list(j.all_docs())
        assert p.sample(7, seed=3) == j.sample(7, seed=3)
        seen = []
        p.eachDoc(seen.append)
        assert seen == list(j.all_docs())
        assert pii.InvertedIndex().sample(3) == []

    def test_lookups_equal_a_scan(self):
        p = pii.InvertedIndex()
        for d in DOCS:
            p.add_words_to_doc(d.split())
        for w in {t for d in DOCS for t in d.split()}:
            assert p.documents(w) == [i for i, d in enumerate(DOCS)
                                      if w in d.split()]


class TestMovingWindows:
    @pytest.mark.parametrize("size", [1, 3, 5])
    def test_windows_equal_jax(self, size):
        toks = "the quick brown fox jumps".split()
        jw, pw = jmw.windows(toks, size), pmw.windows(toks, size)
        assert [(w.words, w.begin, w.end, w.focus_word, w.is_begin_label(),
                 w.is_end_label(), w.as_tokens(), repr(w)) for w in pw] == \
            [(w.words, w.begin, w.end, w.focus_word, w.is_begin_label(),
              w.is_end_label(), w.as_tokens(), repr(w)) for w in jw]

    def test_window_converter(self):
        rng = np.random.default_rng(0)
        vecs = {w: rng.normal(size=4).astype(np.float32)
                for w in ["quick", "brown", "fox"]}
        for jw, pw in zip(jmw.windows("the quick brown fox".split(), 3),
                          pmw.windows("the quick brown fox".split(), 3)):
            assert np.array_equal(
                pmw.WindowConverter.as_example(pw, vecs, 4),
                jmw.WindowConverter.as_example(jw, vecs, 4))

    @pytest.mark.parametrize("text", [
        "<PER> John Smith </PER> went to <LOC>Paris</LOC> today",
        "no markup   here", "<A>x</A><B> y z </B>",
        "<X> unclosed <Y>y</Y>"])
    def test_strip_context_labels(self, text):
        assert pmw.strip_context_labels(text) == \
            jmw.strip_context_labels(text)


class TestTextPipeline:
    def _corpus(self, n=200, seed=7):
        from tests.test_nlp import make_corpus

        return make_corpus(n=n, seed=seed)

    @pytest.mark.parametrize("parts", [1, 3, 8])
    def test_vocab_and_huffman_equal_jax_and_serial(self, parts):
        corpus = self._corpus()
        j = jtp.TextPipeline(min_word_frequency=2,
                             num_partitions=parts).fit(corpus)
        p = ptp.TextPipeline(min_word_frequency=2,
                             num_partitions=parts).fit(corpus)
        assert p.word_counts == j.word_counts
        assert p.token_sequences == j.token_sequences
        key = lambda v: [(w.word, w.count, w.index, list(w.codes),
                          list(w.points)) for w in v.vocab_words()]
        assert key(p.vocab) == key(j.vocab)
        serial = VocabConstructor(2).build(p.token_sequences)
        assert key(p.vocab) == key(serial)
        assert p.filtered_counts() == j.filtered_counts()

    def test_counts_match_serial(self):
        corpus = self._corpus()
        assert ptp.TextPipeline(num_partitions=8).fit(corpus).word_counts \
            == ptp.TextPipeline(num_partitions=1).fit(corpus).word_counts

    def test_vocab_matches_word2vec_build(self):
        from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

        corpus = self._corpus()
        tp = ptp.TextPipeline(min_word_frequency=2,
                              num_partitions=8).fit(corpus)
        w2v = Word2Vec(layer_size=8, min_word_frequency=2, device="cpu")
        w2v.build_vocab(w2v._tokenize_corpus(corpus))
        assert [(w.word, w.codes) for w in tp.vocab.vocab_words()] == \
            [(w.word, w.codes) for w in w2v.vocab.vocab_words()]

    def test_min_frequency_filter(self):
        tp = ptp.TextPipeline(min_word_frequency=3, num_partitions=4).fit(
            ["a a a b b c"])
        assert set(tp.filtered_counts()) == {"a"}
