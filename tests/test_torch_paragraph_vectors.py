"""The port's ParagraphVectors and its text inputs against the JAX
package's, on the CPU.

  * ``dbow_step``, ``dm_step`` and ``infer_dbow_step`` against the JAX
    ``_dbow_step``, ``_dm_step`` and ``_infer_dbow_step`` in f64 at 1e-10
    abs, with repeated rows, dead path entries, an empty context window
    and a padded row; ``infer_dbow_step`` leaves syn1 as it was.
  * Whole ``fit_documents`` runs, DBOW and DM (with one document under two
    labels), with the JAX negatives of the word co-training replayed
    through ``draw``: in f64 (both modules' host arrays lifted, the word
    tables lifted after ``build_vocab``, JAX's steps run uncompiled, see
    ``uncompiled_jax``) every table at 1e-10, and the default f32 run
    against JAX's compiled fit at 1e-5; the labels, the vocabulary and
    the examples' order are the JAX package's.
  * ``infer_vector`` and ``nearest_labels`` on JAX's trained state
    carried across with ``ParagraphVectors.from_arrays``, at 1e-5 (f32).
  * ``LabelledDocument``, ``BasicLabelAwareIterator``,
    ``NGramTokenizerFactory``, ``FileSentenceIterator`` and
    ``AggregatingSentenceIterator`` give the JAX package's outputs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nlp import paragraph_vectors as jpv  # noqa: E402
from deeplearning4j_tpu.nlp import text as jtext  # noqa: E402

from deeplearning4j_tpu_torch.nlp import paragraph_vectors as ppv  # noqa: E402
from deeplearning4j_tpu_torch.nlp import text as ptext  # noqa: E402

from test_torch_word2vec import corpus, jax_replay_draw  # noqa: E402

TOL_F64 = 1e-10
TOL_F32 = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


class F64Numpy:
    """numpy with ``float32`` meaning ``float64``: set as a module's ``np``
    it lifts the host arrays that module makes in f32 to f64."""

    def __getattr__(self, name):
        return np.float64 if name == "float32" else getattr(np, name)


def _path_case(seed, v=30, vh=29, nd=7, d=10, b=12, l=5, c=4, scale=0.3):
    rng = np.random.default_rng(seed)
    syn0 = rng.standard_normal((v, d)) * scale
    syn1 = rng.standard_normal((vh, d)) * scale
    docvecs = rng.standard_normal((nd, d)) * scale
    doc_ids = rng.integers(0, nd, size=(b,))
    doc_ids[3] = doc_ids[2]
    points = rng.integers(0, vh, size=(b, l))
    points[6] = points[5]
    codes = rng.integers(0, 2, size=(b, l)).astype(np.float64)
    mask = (rng.random((b, l)) > 0.2).astype(np.float64)
    mask[4] = 0.0
    ctx = rng.integers(0, v, size=(b, c))
    cmask = (rng.random((b, c)) > 0.3).astype(np.float64)
    cmask[8] = 0.0  # an empty window: the document row alone
    return syn0, syn1, docvecs, doc_ids, points, codes, mask, ctx, cmask


class TestStepsAgainstJax:
    @pytest.mark.parametrize("seed,scale", [(0, 0.3), (1, 3.0)],
                             ids=["plain", "saturated"])
    def test_dbow_step_f64(self, seed, scale):
        syn0, syn1, dv, di, pts, codes, mask, _, _ = _path_case(seed,
                                                               scale=scale)
        rd, r1 = jpv._dbow_step(*(jnp.asarray(a) for a in (
            dv, syn1, di, pts, codes, mask)), jnp.float32(0.025))
        pd, p1 = _t(dv.copy()), _t(syn1.copy())
        ppv.dbow_step(pd, p1, _t(di), _t(pts), _t(codes), _t(mask),
                      float(np.float32(0.025)))
        for got, want in ((pd, rd), (p1, r1)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL_F64)
        assert np.abs(pd.numpy() - dv).max() > 1e-4  # it moved

    @pytest.mark.parametrize("seed,scale", [(2, 0.3), (3, 3.0)],
                             ids=["plain", "saturated"])
    def test_dm_step_f64(self, seed, scale):
        syn0, syn1, dv, di, pts, codes, mask, cx, cm = _path_case(
            seed, scale=scale)
        r0, r1, rd = jpv._dm_step(*(jnp.asarray(a) for a in (
            syn0, syn1, dv, di, cx, cm, pts, codes, mask)),
            jnp.float32(0.025))
        p0, p1, pd = _t(syn0.copy()), _t(syn1.copy()), _t(dv.copy())
        ppv.dm_step(p0, p1, pd, _t(di), _t(cx), _t(cm), _t(pts), _t(codes),
                    _t(mask), float(np.float32(0.025)))
        for got, want in ((p0, r0), (p1, r1), (pd, rd)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL_F64)

    @pytest.mark.parametrize("n_live", [64, 9, 0], ids=["full", "padded",
                                                        "dead"])
    def test_infer_dbow_step_f64(self, n_live):
        rng = np.random.default_rng(4)
        syn1 = rng.standard_normal((29, 10)) * 0.5
        pts = rng.integers(0, 29, size=(64, 5))
        codes = rng.integers(0, 2, size=(64, 5)).astype(np.float64)
        mask = (rng.random((64, 5)) > 0.2).astype(np.float64)
        mask *= (np.arange(64) < n_live)[:, None]
        vec = rng.standard_normal((1, 10)) * 0.5
        want = jpv._infer_dbow_step(*(jnp.asarray(a) for a in (
            vec, syn1, pts, codes, mask)), jnp.float32(0.02))
        pv, p1 = _t(vec.copy()), _t(syn1.copy())
        ppv.infer_dbow_step(pv, p1, _t(pts), _t(codes), _t(mask),
                            float(np.float32(0.02)))
        np.testing.assert_allclose(pv.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL_F64)
        assert torch.equal(p1, _t(syn1))  # frozen


def documents(seed=0, n_sent=60, two_labels=True):
    """(JAX documents, port documents): the word2vec tests' corpus as text,
    labelled by topic ``T<i % 4>``; document 3 carries a second label."""
    docs = []
    for i, toks in enumerate(corpus(seed, n_sent=n_sent)):
        labels = [f"T{i % 4}"] + (["EXTRA"] if two_labels and i == 3
                                  else [])
        docs.append((" ".join(toks), labels))
    return ([jtext.LabelledDocument(c, list(l)) for c, l in docs],
            [ptext.LabelledDocument(c, list(l)) for c, l in docs])


KW = dict(layer_size=12, window=3, batch_size=64, seed=5, negative=3,
          epochs=2)


def _lift(model):
    lt = model.lookup_table
    for n in ("syn0", "syn1", "syn1neg"):
        if getattr(lt, n) is not None:
            setattr(lt, n, getattr(lt, n).astype(np.float64))


def eager_skipgram_epoch(syn0, syn1, syn1neg, P, C, M, table, cens, cxs,
                         pair_live, keys, alphas, *, use_neg, negative_k,
                         sgns_kernel=False, sgns_interpret=False):
    """JAX's ``_skipgram_epoch`` with its scan body run batch by batch, not
    compiled: the same ``_hs_body`` and ``_neg_body`` on the same draws."""
    from deeplearning4j_tpu.nlp import word2vec as jw2v

    for j in range(cens.shape[0]):
        cen, cx, pl = cens[j], cxs[j], pair_live[j]
        syn0, syn1 = jw2v._hs_body(syn0, syn1, cx, P[cen], C[cen],
                                   M[cen] * pl[:, None], alphas[j])
        if use_neg:
            b = cen.shape[0]
            draws = table[jax.random.randint(keys[j], (b, negative_k), 0,
                                             table.shape[0])]
            tgt = jnp.concatenate([cen[:, None], draws], axis=1)
            lbl = jnp.zeros((b, negative_k + 1), jnp.float32).at[:, 0].set(
                1.0)
            nlive = jnp.concatenate([jnp.ones((b, 1), jnp.float32),
                                     (draws != cen[:, None]).astype(
                                         jnp.float32)], axis=1)
            syn0, syn1neg = jw2v._neg_body(syn0, syn1neg, cx, tgt, lbl,
                                           nlive * pl[:, None], alphas[j])
    return syn0, syn1, syn1neg


def uncompiled_jax(monkeypatch):
    """JAX's word2vec and ParagraphVectors steps run as their functions'
    ops, not as compiled XLA programs. In f64 a compiled program rounds
    the f32 collision scale's product once more: one DeepWalk batch's
    syn1 differs from the same function run op by op by 7e-8 of its
    largest entry, and a 100-batch scan by 1e-10 absolute; the port's
    steps equal the op-by-op runs to ~1e-17."""
    from deeplearning4j_tpu.nlp import word2vec as jw2v

    monkeypatch.setattr(jw2v, "_skipgram_epoch", eager_skipgram_epoch)
    monkeypatch.setattr(jw2v, "_skipgram_hs_step", jw2v._hs_body)
    for name in ("_dbow_step", "_dm_step", "_infer_dbow_step"):
        monkeypatch.setattr(jpv, name, getattr(jpv, name).__wrapped__)


def fit_pair(monkeypatch, dm: bool, f64: bool, **kw):
    """The same ParagraphVectors fitted by both packages (the port on the
    CPU, the JAX negatives replayed); in f64 both modules' host arrays
    and both lookup tables lifted, and JAX's steps run uncompiled
    (:func:`uncompiled_jax`)."""
    kw = dict(KW, **kw)
    jdocs, pdocs = documents()
    j = jpv.ParagraphVectors(dm=dm, **kw)
    p = ppv.ParagraphVectors(dm=dm, device="cpu", **kw)
    toks = p._tokenize_corpus([d.content for d in pdocs])
    j.build_vocab(j._tokenize_corpus([d.content for d in jdocs]))
    p.build_vocab(toks)
    if f64:
        monkeypatch.setattr(jpv, "np", F64Numpy())
        monkeypatch.setattr(ppv, "np", F64Numpy())
        uncompiled_jax(monkeypatch)
        _lift(j)
        _lift(p)
    j.fit_documents(jdocs)
    p.fit_documents(pdocs, draw=jax_replay_draw(p, kw["seed"],
                                                kw["batch_size"],
                                                kw["negative"]))
    return j, p


class TestFitAgainstJax:
    @pytest.mark.parametrize("dm,f64,kw", [
        (False, True, {}), (True, True, {}),
        (False, True, dict(sampling=5e-2, iterations=2)),
        (False, False, {}), (True, False, {})],
        ids=["dbow-f64", "dm-f64", "dbow-f64-subsampled", "dbow-f32",
             "dm-f32"])
    def test_tables_match(self, monkeypatch, dm, f64, kw):
        j, p = fit_pair(monkeypatch, dm, f64, **kw)
        tol = TOL_F64 if f64 else TOL_F32
        assert p.labels == j.labels and "EXTRA" in p.labels
        assert [w.word for w in p.vocab.vocab_words()] == \
            [w.word for w in j.vocab.vocab_words()]
        pairs = [(p.doc_vectors, j.doc_vectors)] + [
            (getattr(p.lookup_table, n), getattr(j.lookup_table, n))
            for n in ("syn0", "syn1", "syn1neg")]
        for got, want in pairs:
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        # the document phases moved the document vectors
        d = KW["layer_size"]
        fresh = (np.random.default_rng(KW["seed"]).random(
            (len(p.labels), d)) - 0.5) / d
        assert np.abs(p.doc_vectors - fresh).max() > 1e-3
        assert p.fit_stats["docs"]["batches"] > 1
        assert p.fit_stats["words"]["batches"] > 1

    def test_examples_in_the_jax_order(self):
        """The DBOW pairs and DM windows of one phase, drawn from the same
        stream, equal the JAX package's lists."""
        jdocs, pdocs = documents()
        j = jpv.ParagraphVectors(window=3, seed=1, sampling=5e-2)
        p = ppv.ParagraphVectors(window=3, seed=1, sampling=5e-2,
                                 device="cpu")
        for m, docs in ((j, jdocs), (p, pdocs)):
            m.build_vocab(m._tokenize_corpus([d.content for d in docs]))
            m._counts = np.array([w.count for w in m.vocab.vocab_words()],
                                 np.float64)
        labels = {l: i for i, l in enumerate(dict.fromkeys(
            l for d in jdocs for l in d.labels))}
        seqs = [(p._sequences_as_indices(p._tokenize_corpus([d.content]))[0],
                 [labels[l] for l in d.labels]) for d in pdocs]
        for jf, pf in ((j._dbow_pairs, p._dbow_pairs),
                       (j._dm_examples, p._dm_examples)):
            want = jf(jdocs, labels, np.random.default_rng(9))
            got = pf(seqs, np.random.default_rng(9))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


class TestCarriedState:
    def test_infer_vector_and_nearest_labels_on_jax_state(self):
        jdocs, _ = documents(two_labels=False)
        j = jpv.ParagraphVectors(**KW).fit_documents(jdocs)
        rows = [{"word": w.word, "count": w.count, "codes": w.codes,
                 "points": w.points} for w in j.vocab.vocab_words()]
        lt = j.lookup_table
        p = ppv.ParagraphVectors.from_arrays(
            j_conf(j), rows, {"syn0": lt.syn0, "syn1": lt.syn1,
                              "syn1neg": lt.syn1neg,
                              "doc_vectors": j.doc_vectors},
            device="cpu", labels=j.labels)
        texts = [d.content for d in jdocs[:6]] + [
            " ".join(["w1"] * 80), "none of these words", ""]
        for text in texts:
            np.testing.assert_allclose(p.infer_vector(text),
                                       j.infer_vector(text), rtol=0,
                                       atol=TOL_F32)
            got, want = p.nearest_labels(text, 4), j.nearest_labels(text, 4)
            assert set(got) == set(want)
        assert p.similarity_to_label("T0", "T1") == pytest.approx(
            j.similarity_to_label("T0", "T1"), abs=1e-6)
        assert np.isnan(p.similarity_to_label("T0", "nope"))


def j_conf(j):
    return {k: getattr(j, k) for k in (
        "layer_size", "window", "min_word_frequency", "learning_rate",
        "min_learning_rate", "epochs", "iterations", "negative", "sampling",
        "seed", "dm")}


class TestText:
    def test_labelled_documents(self):
        sents = ["a b", "c d e", "f"]
        for labels in (None, ["x", "y", "x"]):
            j = jtext.BasicLabelAwareIterator(sents, labels)
            p = ptext.BasicLabelAwareIterator(sents, labels)
            assert [(d.content, d.labels) for d in p] == \
                [(d.content, d.labels) for d in j]
            assert p.all_labels() == j.all_labels()
        assert ptext.LabelledDocument("t").labels == []

    def test_ngram_tokenizer(self):
        text = "The quick, brown fox jumps"
        for lo, hi in ((1, 1), (1, 3), (2, 2)):
            for base in (None, "pre"):
                jb = (jtext.DefaultTokenizerFactory(jtext.common_preprocessor)
                      if base else None)
                pb = (ptext.DefaultTokenizerFactory(ptext.common_preprocessor)
                      if base else None)
                assert ptext.NGramTokenizerFactory(pb, lo, hi).tokenize(
                    text) == jtext.NGramTokenizerFactory(jb, lo, hi).tokenize(
                    text)
        assert ptext.STOP_WORDS == jtext.STOP_WORDS

    def test_file_and_aggregating_iterators(self, tmp_path):
        (tmp_path / "sub").mkdir()
        (tmp_path / "b.txt").write_text("line b1\n\nline b2\n")
        (tmp_path / "a.txt").write_text("line a1\n")
        (tmp_path / "sub" / "c.txt").write_text("line c1\nline c2")
        up = str.upper
        for root in (str(tmp_path), str(tmp_path / "b.txt")):
            assert list(ptext.FileSentenceIterator(root, up)) == \
                list(jtext.FileSentenceIterator(root, up))
        pa = ptext.AggregatingSentenceIterator(
            [ptext.FileSentenceIterator(str(tmp_path)),
             ptext.CollectionSentenceIterator(["x", "y"])], up)
        ja = jtext.AggregatingSentenceIterator(
            [jtext.FileSentenceIterator(str(tmp_path)),
             jtext.CollectionSentenceIterator(["x", "y"])], up)
        assert list(pa) == list(ja) and len(list(pa)) == 7
