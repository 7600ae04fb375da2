"""The port's GloVe against the JAX package's, on the CPU.

  * The co-occurrence counts (vectorised in the port): keys, their order
    (the JAX dict's insertion order) and X bit-equal, symmetric and not,
    with repeated words and sequences shorter than the window.
  * ``glove_step`` against the JAX ``_glove_step`` in f64 at 1e-10, with
    duplicate indices inside the batch (accumulators first, then W and
    b from the accumulated values) and padded pairs.
  * A whole ``fit`` in f64 (both modules' host arrays lifted): W, bias
    and every epoch's loss at 1e-10; and the default f32 fit at 1e-5.
  * Data parallelism in 2 and 4 ``gloo`` processes (one spawn per world
    size): every rank's W and bias against JAX's ``num_workers`` mesh fit
    on the conftest's virtual devices at 1e-5 (the tolerance of the
    port's data-parallel Word2Vec test), every rank's tables equal, and a
    group of one rank ``torch.equal`` to the serial fit.
  * ``Glove.from_arrays`` carries JAX's trained state: the same vectors,
    similarities and nearest words.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nlp import glove as jglove  # noqa: E402

from deeplearning4j_tpu_torch.nlp import glove as pglove  # noqa: E402

from test_torch_paragraph_vectors import F64Numpy  # noqa: E402
from test_torch_word2vec import corpus  # noqa: E402

TOL_F64 = 1e-10
TOL_F32 = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def sentences(seed=0, n_sent=80):
    return [" ".join(t) for t in corpus(seed, n_sent=n_sent)]


class TestCooccurrences:
    @pytest.mark.parametrize("symmetric,window", [(True, 15), (False, 4),
                                                  (True, 1)])
    def test_keys_order_and_x_bit_equal(self, symmetric, window):
        rng = np.random.default_rng(2)
        seqs = [rng.integers(0, 12, size=int(rng.integers(1, 30))).astype(
            np.int32) for _ in range(40)]
        seqs.append(np.array([3, 3, 3, 5, 3], np.int32))
        j = jglove.Glove(window=window, symmetric=symmetric)
        p = pglove.Glove(window=window, symmetric=symmetric, device="cpu")
        want = j._count_cooccurrences(seqs)
        keys, x = p._count_cooccurrences(seqs)
        assert keys.dtype == np.int32 and x.dtype == np.float64
        assert [tuple(k) for k in keys.tolist()] == list(want.keys())
        np.testing.assert_array_equal(x, np.array(list(want.values())))

    def test_empty(self):
        keys, x = pglove.Glove(device="cpu")._count_cooccurrences([])
        assert keys.shape == (0, 2) and x.shape == (0,)
        with pytest.raises(ValueError, match="empty co-occurrence"):
            pglove.Glove(device="cpu").fit(["a"])


class TestStepAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_glove_step_f64_with_duplicates(self, seed):
        rng = np.random.default_rng(seed)
        v, d, b = 20, 8, 32
        W = (rng.random((v, d)) - 0.5) / d
        bias = rng.standard_normal(v) * 0.1
        hW = np.full((v, d), 1e-8) + rng.random((v, d))
        hb = np.full(v, 1e-8) + rng.random(v)
        wi = rng.integers(0, v, b)
        wj = rng.integers(0, v, b)
        wi[5] = wi[4]            # a row twice as wi
        wj[7] = wi[4]            # and once more as wj
        wi[9], wj[9] = wj[8], wi[8]
        logx = np.log(rng.random(b) * 10 + 0.5)
        fdiff = np.minimum(1.0, rng.random(b))
        live = (np.arange(b) < b - 3).astype(np.float64)  # 3 padded pairs
        want = jglove._glove_step(*(jnp.asarray(a) for a in (
            W, bias, hW, hb, wi, wj, logx, fdiff)), jnp.float32(0.05),
            jnp.asarray(live))
        got = [_t(a.copy()) for a in (W, bias, hW, hb)]
        loss = pglove.glove_step(*got, _t(wi), _t(wj), _t(logx),
                                 _t(fdiff), float(np.float32(0.05)),
                                 _t(live))
        for g, w in zip(got + [loss], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=TOL_F64)
        assert np.abs(got[0].numpy() - W).max() > 1e-4  # it moved


KW = dict(layer_size=10, epochs=3, batch_size=256, window=5, seed=7)


def fit_pair(monkeypatch, f64: bool, **kw):
    kw = dict(KW, **kw)
    if f64:
        monkeypatch.setattr(jglove, "np", F64Numpy())
        monkeypatch.setattr(pglove, "np", F64Numpy())
    sents = sentences()
    j = jglove.Glove(**kw).fit(sents)
    p = pglove.Glove(device="cpu", **kw).fit(sents)
    return j, p


class TestFitAgainstJax:
    @pytest.mark.parametrize("f64,kw", [
        (True, {}), (True, dict(symmetric=False, x_max=3.0)),
        (False, {})], ids=["f64", "f64-asymmetric", "f32"])
    def test_fit_matches(self, monkeypatch, f64, kw):
        j, p = fit_pair(monkeypatch, f64, **kw)
        tol = TOL_F64 if f64 else TOL_F32
        assert [w.word for w in p.vocab.vocab_words()] == \
            [w.word for w in j.vocab.vocab_words()]
        for got, want in ((p.W, j.W), (p.bias, j.bias)):
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(p.losses, j.losses, rtol=0, atol=tol)
        assert p.losses[-1] < p.losses[0]
        assert p.fit_stats["pairs"] > KW["batch_size"]
        assert p.fit_stats["batches"] == KW["epochs"] * -(
            -p.fit_stats["pairs"] // KW["batch_size"])

    def test_from_arrays_carries_jax_state(self):
        j = jglove.Glove(**KW).fit(sentences())
        rows = [{"word": w.word, "count": w.count}
                for w in j.vocab.vocab_words()]
        conf = {k: getattr(j, k) for k in pglove.Glove(
            device="cpu").config()}
        p = pglove.Glove.from_arrays(conf, rows, {"W": j.W, "bias": j.bias},
                                     device="cpu")
        words = [w.word for w in j.vocab.vocab_words()[:5]]
        for w in words:
            np.testing.assert_array_equal(p.vector(w), j.vector(w))
            assert p.words_nearest(w, 4) == j.words_nearest(w, 4)
        assert p.similarity(words[0], words[1]) == j.similarity(words[0],
                                                                words[1])
        assert np.isnan(p.similarity(words[0], "absent"))
        assert p.vector("absent") is None and p.words_nearest("absent") == []


DP_KW = dict(layer_size=10, epochs=2, batch_size=256, window=5, seed=5)
DP_SENTENCES = 100


def _dp_worker(rank, world, tmp):
    import datetime
    import os

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nlp import glove

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
    alone = [dist.new_group([r]) for r in range(world)]
    sents = sentences(3, DP_SENTENCES)
    out = {}
    for tag, mk in (("dp", dict(num_workers=world)),
                    ("one", dict(mesh=alone[rank], num_workers=1))):
        m = glove.Glove(device="cpu", **DP_KW, **mk).fit(sents)
        out[f"{tag}/W"], out[f"{tag}/bias"] = m.W, m.bias
        out[f"{tag}/losses"] = np.asarray(m.losses)
    try:
        glove.Glove(num_workers=world, batch_size=256 * world + 1,
                    device="cpu")
        out["refused"] = np.asarray(False)
    except ValueError:
        out["refused"] = np.asarray(True)
    np.savez(os.path.join(tmp, f"glove{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def dp_run(request, tmp_path_factory):
    """(per-rank results, JAX's mesh fit, the port's serial fit)."""
    import os
    import time

    import torch.multiprocessing as mp

    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"glove_dp{world}"))
    sents = sentences(3, DP_SENTENCES)
    ctx = mp.start_processes(_dp_worker, args=(world, tmp), nprocs=world,
                             join=False, start_method="spawn")
    serial = pglove.Glove(device="cpu", **DP_KW).fit(sents)
    ref = jglove.Glove(num_workers=world, **DP_KW).fit(sents)
    deadline = time.monotonic() + 150.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the GloVe gloo spawn did not end in time")
    ranks = [dict(np.load(os.path.join(tmp, f"glove{r}.npz")))
             for r in range(world)]
    return ranks, ref, serial


class TestDataParallel:
    def test_ranks_match_jax_mesh_fit(self, dp_run):
        ranks, ref, _ = dp_run
        for r in ranks:
            np.testing.assert_allclose(r["dp/W"], np.asarray(ref.W), rtol=0,
                                       atol=TOL_F32)
            np.testing.assert_allclose(r["dp/bias"], np.asarray(ref.bias),
                                       rtol=0, atol=TOL_F32)
            np.testing.assert_allclose(r["dp/losses"], ref.losses, rtol=1e-5)
        for r in ranks[1:]:  # every rank holds the same tables
            for k in ("dp/W", "dp/bias"):
                np.testing.assert_array_equal(r[k], ranks[0][k])

    def test_group_of_one_equals_serial_fit(self, dp_run):
        ranks, _, serial = dp_run
        for r in ranks:
            assert torch.equal(torch.from_numpy(r["one/W"]),
                               torch.from_numpy(serial.W))
            assert torch.equal(torch.from_numpy(r["one/bias"]),
                               torch.from_numpy(serial.bias))

    def test_indivisible_batch_raises(self, dp_run):
        ranks, _, _ = dp_run
        assert all(bool(r["refused"]) for r in ranks)
