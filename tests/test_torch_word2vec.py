"""The port's word2vec training against the JAX package's, on the CPU.

  * ``ops/sgns.sgns_step_plain`` (the plain version of K3) against the
    JAX ``_neg_body`` in f64 at 1e-12 abs, with repeated contexts,
    colliding targets, dead negatives, a fully dead pair and saturated
    dots; ``mean_scale`` against ``_mean_scale``.
  * ``hs_body`` and ``cbow_body`` against ``_hs_body`` and ``_cbow_body``
    in f64 at 1e-12 abs.
  * A whole ``fit_tokens``, all three tables at 1e-5 abs in f32 (the same
    minibatches; sums taken in another order): HS only over 2 epochs, HS
    plus negatives with the JAX draws replayed through ``draw``, CBOW,
    and with subsampling; and in chunks with a shorter tail.
  * Port against port: one seed gives the same bits twice; ``fit`` on
    sentences equals ``fit_tokens`` on their tokens.
  * Data parallelism (``num_workers`` / ``mesh``) in 2 and 4 ``gloo``
    processes (one spawn per world size, ~15 s each): every rank's
    tables against JAX's mesh fit (``num_workers`` on the conftest's
    virtual devices, the JAX draws replayed) at 1e-5, HS plus negatives
    and CBOW; a group of one rank ``torch.equal`` to the serial fit.
  * Files: ``save_word2vec`` / ``load_word2vec`` and the text format, in
    both directions across the packages (bit-equal tables, same
    vocabulary and Huffman paths); ``Word2Vec.from_arrays``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nlp import serializer as jser  # noqa: E402
from deeplearning4j_tpu.nlp import word2vec as jw2v  # noqa: E402

from deeplearning4j_tpu_torch.nlp import serializer as pser  # noqa: E402
from deeplearning4j_tpu_torch.nlp import word2vec as pw2v  # noqa: E402
from deeplearning4j_tpu_torch.ops import sgns  # noqa: E402

TOL_F64 = 1e-12
TOL_FIT = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _case(seed=3, v=50, d=36, b=16, k1=6, scale=0.1):
    """A pair batch with forced collisions: contexts[5] == contexts[4],
    targets[3] == targets[2], a dead negative and a fully dead pair."""
    rng = np.random.default_rng(seed)
    syn0 = rng.standard_normal((v, d)) * scale
    syn1neg = rng.standard_normal((v, d)) * scale
    contexts = rng.integers(0, v, size=(b,))
    contexts[5] = contexts[4]
    targets = rng.integers(0, v, size=(b, k1))
    targets[3] = targets[2]
    labels = np.zeros((b, k1))
    labels[:, 0] = 1.0
    live = np.ones((b, k1))
    live[1, 2] = 0.0
    live[7, :] = 0.0
    return syn0, syn1neg, contexts, targets, labels, live


class TestSgnsPlainAgainstNegBody:
    @pytest.mark.parametrize("seed,scale", [(3, 0.1), (11, 4.0), (5, 0.5)],
                             ids=["small", "saturated", "mid"])
    def test_f64(self, seed, scale):
        syn0, syn1neg, cx, tgt, lbl, live = _case(seed, scale=scale)
        if scale > 1:
            dots = np.einsum("bd,bkd->bk", syn0[cx], syn1neg[tgt])
            assert (dots > 6).any() and (dots < -6).any()
        alpha = 0.025
        r0, r1 = jw2v._neg_body(jnp.asarray(syn0), jnp.asarray(syn1neg),
                                jnp.asarray(cx), jnp.asarray(tgt),
                                jnp.asarray(lbl), jnp.asarray(live), alpha)
        p0, p1 = _t(syn0.copy()), _t(syn1neg.copy())
        before = sgns.sgns_step_plain.launches
        out = sgns.sgns_step(p0, p1, _t(cx), _t(tgt), _t(lbl), _t(live),
                             alpha)
        assert out[0] is p0 and out[1] is p1  # updated in place
        assert sgns.sgns_step_plain.launches == before + 1
        assert p0.dtype == torch.float64
        np.testing.assert_allclose(p0.numpy(), np.asarray(r0), rtol=0,
                                   atol=TOL_F64)
        np.testing.assert_allclose(p1.numpy(), np.asarray(r1), rtol=0,
                                   atol=TOL_F64)
        # the dead pair's context row and no-live rows stay bit-equal
        touched = set(cx[live.sum(1) > 0].tolist())
        for r in set(range(len(syn0))) - touched:
            np.testing.assert_array_equal(p0.numpy()[r], syn0[r])

    def test_tensor_alpha(self):
        syn0, syn1neg, cx, tgt, lbl, live = _case(4)
        a0, a1 = _t(syn0.copy()), _t(syn1neg.copy())
        b0, b1 = _t(syn0.copy()), _t(syn1neg.copy())
        args = (_t(cx), _t(tgt), _t(lbl), _t(live))
        sgns.sgns_step(a0, a1, *args, 0.03)
        sgns.sgns_step(b0, b1, *args, torch.tensor(0.03, dtype=torch.float64))
        assert torch.equal(a0, b0) and torch.equal(a1, b1)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_mean_scale(self, seed):
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, 7, size=(12, 3))
        live = (rng.random((12, 3)) > 0.3).astype(np.float64)
        want = jw2v._mean_scale(7, jnp.asarray(idx), jnp.asarray(live))
        got = sgns.mean_scale(7, _t(idx), _t(live))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL_F64)


def _hs_case(seed, v=40, vh=39, d=12, b=10, l=5, c=4, scale=0.3):
    rng = np.random.default_rng(seed)
    syn0 = rng.standard_normal((v, d)) * scale
    syn1 = rng.standard_normal((vh, d)) * scale
    contexts = rng.integers(0, v, size=(b,))
    contexts[3] = contexts[2]
    points = rng.integers(0, vh, size=(b, l))
    points[6] = points[5]
    codes = rng.integers(0, 2, size=(b, l)).astype(np.float64)
    mask = (rng.random((b, l)) > 0.2).astype(np.float64)
    mask[4] = 0.0
    ctx_idx = rng.integers(0, v, size=(b, c))
    ctx_mask = (rng.random((b, c)) > 0.3).astype(np.float64)
    ctx_mask[8] = 0.0
    return syn0, syn1, contexts, points, codes, mask, ctx_idx, ctx_mask


class TestBodiesAgainstJax:
    @pytest.mark.parametrize("seed,scale", [(0, 0.3), (1, 3.0)],
                             ids=["plain", "saturated"])
    def test_hs_body_f64(self, seed, scale):
        syn0, syn1, cx, pts, codes, mask, _, _ = _hs_case(seed, scale=scale)
        r0, r1 = jw2v._hs_body(*(jnp.asarray(a) for a in (
            syn0, syn1, cx, pts, codes, mask)), 0.025)
        p0, p1 = _t(syn0.copy()), _t(syn1.copy())
        pw2v.hs_body(p0, p1, _t(cx), _t(pts), _t(codes), _t(mask), 0.025)
        np.testing.assert_allclose(p0.numpy(), np.asarray(r0), rtol=0,
                                   atol=TOL_F64)
        np.testing.assert_allclose(p1.numpy(), np.asarray(r1), rtol=0,
                                   atol=TOL_F64)

    @pytest.mark.parametrize("seed,scale", [(2, 0.3), (3, 3.0)],
                             ids=["plain", "saturated"])
    def test_cbow_body_f64(self, seed, scale):
        syn0, syn1, _, pts, codes, mask, ci, cm = _hs_case(seed, scale=scale)
        r0, r1 = jw2v._cbow_body(*(jnp.asarray(a) for a in (
            syn0, syn1, ci, cm, pts, codes, mask)), 0.025)
        p0, p1 = _t(syn0.copy()), _t(syn1.copy())
        pw2v.cbow_body(p0, p1, _t(ci), _t(cm), _t(pts), _t(codes), _t(mask),
                       0.025)
        np.testing.assert_allclose(p0.numpy(), np.asarray(r0), rtol=0,
                                   atol=TOL_F64)
        np.testing.assert_allclose(p1.numpy(), np.asarray(r1), rtol=0,
                                   atol=TOL_F64)


def corpus(seed=0, n_sent=150, vocab=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sent):
        ids = rng.zipf(1.3, size=int(rng.integers(3, 30)))
        toks = [f"w{int(x)}" for x in ids if x < vocab]
        if toks:
            out.append(toks)
    return out


def jax_replay_draw(model, seed, batch, negative):
    """The port's ``draw`` that replays the JAX fit's negatives: keys
    ``fold_in(PRNGKey(seed), i)``, ``randint(key, (B, K), 0, table_size)``,
    looked up in the unigram table."""
    table = torch.from_numpy(np.asarray(model.lookup_table.table, np.int64))
    base = jax.random.PRNGKey(seed)

    def draw(i):
        key = jax.vmap(lambda j: jax.random.fold_in(base, j))(
            jnp.arange(i, i + 1))[0]
        idx = np.asarray(jax.random.randint(key, (batch, negative), 0,
                                            table.shape[0]))
        return table[torch.from_numpy(idx.astype(np.int64))]
    return draw


def fit_pair(seed=3, batch=64, **kw):
    """The same configuration fitted by both packages (the port on the
    CPU, with the JAX negatives replayed)."""
    toks = corpus(seed)
    j = jw2v.Word2Vec(layer_size=16, window=3, batch_size=batch, seed=seed,
                      **kw)
    p = pw2v.Word2Vec(layer_size=16, window=3, batch_size=batch, seed=seed,
                      device="cpu", **kw)
    j.fit_tokens(toks)
    p.build_vocab(toks)
    draw = (jax_replay_draw(p, seed, batch, kw["negative"])
            if kw.get("negative") else None)
    p.fit_tokens(toks, draw=draw)
    return j, p


class TestFitAgainstJax:
    @pytest.mark.parametrize("kw", [
        dict(negative=0, epochs=2),
        dict(negative=3),
        dict(negative=2, epochs=2, sampling=1e-2),
        dict(use_cbow=True),
        dict(use_cbow=True, epochs=2, iterations=2),
    ], ids=["hs-2-epochs", "hs+ns", "hs+ns-subsampled", "cbow",
            "cbow-4-phases"])
    def test_tables_match(self, kw):
        j, p = fit_pair(**kw)
        assert [w.word for w in p.vocab.vocab_words()] == \
            [w.word for w in j.vocab.vocab_words()]
        names = ["syn0", "syn1"] + (["syn1neg"] if kw.get("negative") else [])
        for n in names:
            a = np.asarray(getattr(j.lookup_table, n))
            b = getattr(p.lookup_table, n)
            assert b.dtype == np.float32 and b.shape == a.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_FIT, err_msg=n)
        # training moved the tables (the comparison is not of fresh ones)
        assert np.abs(p.lookup_table.syn1).max() > 1e-3

    def test_chunks_with_a_shorter_tail_match_jax(self, monkeypatch):
        """Chunks of CHUNK_BATCHES (cut to 4 here) and a shorter tail, each
        batch through the one-batch function ``skipgram_step`` (what a
        card graph captures), against the JAX fit with its draws
        replayed, at the tolerance above."""
        monkeypatch.setattr(pw2v, "CHUNK_BATCHES", 4)
        j, p = fit_pair(negative=3, batch=32)
        nb = p.fit_stats["batches"]
        assert nb > 4 and nb % 4 != 0
        for n in ("syn0", "syn1", "syn1neg"):
            np.testing.assert_allclose(getattr(p.lookup_table, n),
                                       np.asarray(getattr(j.lookup_table, n)),
                                       rtol=0, atol=TOL_FIT, err_msg=n)

    def test_batches_of_a_chunk_counted_across_phases(self, monkeypatch):
        """``draw`` sees global batch indices phase * nb + b, chunk after
        chunk, the indices the JAX fit folds into its keys."""
        monkeypatch.setattr(pw2v, "CHUNK_BATCHES", 3)
        toks = corpus(1)
        p = pw2v.Word2Vec(layer_size=8, window=2, batch_size=32, negative=2,
                          epochs=2, seed=1, device="cpu")
        p.build_vocab(toks)
        seen = []
        table = torch.from_numpy(p.lookup_table.table.astype(np.int64))

        def draw(i):
            seen.append(i)
            return table[:64].reshape(32, 2)
        p.fit_tokens(toks, draw=draw)
        assert seen == list(range(len(seen))) and len(seen) % 2 == 0


class TestPortDeterminism:
    def test_same_seed_same_bits(self):
        toks = corpus(5)
        runs = []
        for _ in range(2):
            m = pw2v.Word2Vec(layer_size=12, window=3, batch_size=48,
                              negative=4, seed=7, device="cpu")
            m.fit_tokens(toks)
            runs.append(m.lookup_table)
        for n in ("syn0", "syn1", "syn1neg"):
            np.testing.assert_array_equal(getattr(runs[0], n),
                                          getattr(runs[1], n))

    def test_fit_on_sentences_equals_fit_tokens(self):
        toks = corpus(6)
        a = pw2v.Word2Vec(layer_size=8, negative=2, seed=2, device="cpu")
        b = pw2v.Word2Vec(layer_size=8, negative=2, seed=2, device="cpu")
        a.fit([" ".join(t) for t in toks])
        b.fit_tokens(toks)
        np.testing.assert_array_equal(a.lookup_table.syn0,
                                      b.lookup_table.syn0)
        w = a.vocab.word_at_index(0)
        assert a.words_nearest(w, 3) == b.words_nearest(w, 3)
        assert a.similarity(w, w) == pytest.approx(1.0)
        assert a.get_word_vector(w).shape == (8,)
        assert a.vocab_size() == b.vocab_size() > 0
        assert len(a.words_nearest_sum([w], [], 2)) == 2

    def test_mesh_is_not_ported(self):
        """Data parallelism is ported (``TestDataParallel``); what stays
        refused is a worker count with no process group to run it on,
        and a batch the ranks cannot split."""
        with pytest.raises(ValueError, match="initialised process group"):
            pw2v.Word2Vec(num_workers=2, device="cpu")
        assert pw2v.Word2Vec(num_workers=1, device="cpu").mesh is None


class TestFiles:
    def _trained(self):
        return fit_pair(seed=4, negative=2)

    def _same_model(self, a, b):
        assert a.config() if hasattr(a, "config") else True
        for n in ("syn0", "syn1", "syn1neg"):
            np.testing.assert_array_equal(np.asarray(getattr(b.lookup_table, n)),
                                          np.asarray(getattr(a.lookup_table, n)))
        assert [(w.word, w.count, w.codes, w.points)
                for w in b.vocab.vocab_words()] == \
            [(w.word, w.count, w.codes, w.points)
             for w in a.vocab.vocab_words()]
        for k in ("layer_size", "window", "negative", "seed", "use_cbow",
                  "learning_rate", "epochs"):
            assert getattr(b, k) == getattr(a, k)
        np.testing.assert_array_equal(b.lookup_table.table,
                                      a.lookup_table.table)

    def test_jax_zip_loads_in_the_port(self, tmp_path):
        j, _ = self._trained()
        path = str(tmp_path / "jax_w2v.zip")
        jser.save_word2vec(j, path)
        p = pser.load_word2vec(path, device="cpu")
        assert isinstance(p, pw2v.Word2Vec)
        self._same_model(j, p)

    def test_port_zip_loads_in_jax(self, tmp_path):
        _, p = self._trained()
        path = str(tmp_path / "port_w2v.zip")
        pser.save_word2vec(p, path)
        j = jser.load_word2vec(path)
        self._same_model(p, j)
        again = pser.load_word2vec(path, device="cpu")
        self._same_model(p, again)

    def test_loaded_model_keeps_training(self, tmp_path):
        _, p = self._trained()
        path = str(tmp_path / "w2v.zip")
        pser.save_word2vec(p, path)
        q = pser.load_word2vec(path, device="cpu")
        q.fit_tokens(corpus(4))
        assert np.isfinite(q.lookup_table.syn0).all()
        assert not np.array_equal(q.lookup_table.syn0, p.lookup_table.syn0)

    def test_text_format_both_directions(self, tmp_path):
        j, p = self._trained()
        jpath, ppath = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
        jser.write_word_vectors(j, jpath)
        pser.write_word_vectors(p, ppath)
        for path in (jpath, ppath):
            a, b = jser.read_word_vectors(path), pser.read_word_vectors(path)
            np.testing.assert_array_equal(b.syn0, a.syn0)
            assert [w.word for w in b.vocab.vocab_words()] == \
                [w.word for w in a.vocab.vocab_words()]
        # the port reads back what it wrote to the 8 digits written
        back = pser.read_word_vectors(ppath)
        np.testing.assert_allclose(back.syn0, p.lookup_table.syn0, rtol=1e-7,
                                   atol=1e-12)
        pser.write_word_vectors(p.lookup_table, ppath)  # a table works too
        assert pser.read_word_vectors(ppath).syn0.shape == \
            p.lookup_table.syn0.shape

    def test_from_arrays(self):
        j, _ = self._trained()
        conf = {k: getattr(j, k) for k in (
            "layer_size", "window", "min_word_frequency", "learning_rate",
            "min_learning_rate", "epochs", "iterations", "negative",
            "sampling", "seed", "use_cbow")}
        rows = [{"word": w.word, "count": w.count, "codes": w.codes,
                 "points": w.points} for w in j.vocab.vocab_words()]
        lt = j.lookup_table
        p = pw2v.Word2Vec.from_arrays(
            conf, rows, {"syn0": lt.syn0, "syn1": lt.syn1,
                         "syn1neg": lt.syn1neg}, device="cpu")
        self._same_model(j, p)
        assert p.config() == conf
        w = j.vocab.word_at_index(1)
        assert p.words_nearest(w, 5) == j.words_nearest(w, 5)


# ---------------------------------------------------------------------------
# data parallelism across processes
# ---------------------------------------------------------------------------

# one epoch of 80 sentences in batches of 128: every batch is a few
# collectives a table on each rank, and the spawn shares the machine with
# the rest of the suite
DP_CASES = {"hs+ns": dict(negative=3), "cbow": dict(use_cbow=True)}
DP_KW = dict(layer_size=16, window=3, batch_size=128, seed=3)
DP_SENTENCES = 80


def _dp_worker(rank, world, tmp):
    import datetime
    import os

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nlp import word2vec as w2v

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
    alone = [dist.new_group([r]) for r in range(world)]
    toks = corpus(3, n_sent=DP_SENTENCES)
    out = {}
    for name, kw in DP_CASES.items():
        draw = None
        if kw.get("negative"):
            draw = w2v.replay_draw(torch.from_numpy(
                np.load(os.path.join(tmp, f"negs_{name}.npy"))))
        for tag, mk in (("dp", dict(num_workers=world)),
                        ("one", dict(mesh=alone[rank], num_workers=1))):
            m = w2v.Word2Vec(device="cpu", **DP_KW, **kw, **mk)
            m.fit_tokens(toks, draw=draw)
            for n in ("syn0", "syn1", "syn1neg"):
                t = getattr(m.lookup_table, n)
                if t is not None:
                    out[f"{name}/{tag}/{n}"] = t
    try:
        w2v.Word2Vec(num_workers=world, batch_size=128 * world + 1,
                     device="cpu")
        out["refused"] = np.asarray(False)
    except ValueError:
        out["refused"] = np.asarray(True)
    np.savez(os.path.join(tmp, f"w2v{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def dp_run(request, tmp_path_factory):
    """(per-rank tables, JAX mesh tables, port serial tables)."""
    import os
    import time

    import torch.multiprocessing as mp

    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"w2v_dp{world}"))
    toks = corpus(3, n_sent=DP_SENTENCES)
    serial = {}
    for name, kw in DP_CASES.items():
        p = pw2v.Word2Vec(device="cpu", **DP_KW, **kw)
        p.build_vocab(toks)
        draw, drawn = None, []
        if kw.get("negative"):
            jdraw = jax_replay_draw(p, DP_KW["seed"], DP_KW["batch_size"],
                                    kw["negative"])

            def draw(i, jdraw=jdraw, drawn=drawn):
                drawn.append((i, jdraw(i)))
                return drawn[-1][1]
        p.fit_tokens(toks, draw=draw)
        if drawn:  # by global batch index (phases may share indices)
            negs = np.zeros((max(i for i, _ in drawn) + 1,)
                            + tuple(drawn[0][1].shape), np.int64)
            for i, x in drawn:
                negs[i] = x.numpy()
            np.save(os.path.join(tmp, f"negs_{name}.npy"), negs)
        serial[name] = p.lookup_table
    ctx = mp.start_processes(_dp_worker, args=(world, tmp), nprocs=world,
                             join=False, start_method="spawn")
    ref = {}
    for name, kw in DP_CASES.items():
        j = jw2v.Word2Vec(num_workers=world, **DP_KW, **kw)
        j.fit_tokens(toks)
        ref[name] = j.lookup_table
    deadline = time.monotonic() + 150.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the word2vec gloo spawn did not end in time")
    ranks = [dict(np.load(os.path.join(tmp, f"w2v{r}.npz")))
             for r in range(world)]
    return ranks, ref, serial


class TestDataParallel:
    @pytest.mark.parametrize("name", list(DP_CASES))
    def test_ranks_match_jax_mesh_fit(self, dp_run, name):
        ranks, ref, _ = dp_run
        names = ["syn0", "syn1"] + (["syn1neg"] if "ns" in name else [])
        for r in ranks:
            for n in names:
                np.testing.assert_allclose(
                    r[f"{name}/dp/{n}"], np.asarray(getattr(ref[name], n)),
                    rtol=0, atol=TOL_FIT, err_msg=n)
        for n in names:  # every rank holds the same tables
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[f"{name}/dp/{n}"],
                                              ranks[0][f"{name}/dp/{n}"])

    @pytest.mark.parametrize("name", list(DP_CASES))
    def test_group_of_one_equals_serial_fit(self, dp_run, name):
        ranks, _, serial = dp_run
        for r in ranks:
            for n in ("syn0", "syn1", "syn1neg"):
                want = getattr(serial[name], n)
                if want is None:
                    continue
                assert torch.equal(torch.from_numpy(r[f"{name}/one/{n}"]),
                                   torch.from_numpy(np.asarray(want)))

    def test_indivisible_batch_raises(self, dp_run):
        ranks, _, _ = dp_run
        assert all(bool(r["refused"]) for r in ranks)
