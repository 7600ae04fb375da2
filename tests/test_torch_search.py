"""``/search`` in the port against the JAX package, on the CPU.

  * ``KMeansClustering`` (``clustering/kmeans.py``) against the JAX
    package's on the same rows: the k-means++ draws equal (the seeding's
    centers are the same rows), ``iterations_run`` and the assignments
    equal, the centers within 1e-5, ``predict`` equal, for euclidean,
    manhattan and cosine; ``apply_to`` of ``Point`` lists.
  * ``ExactIndex``, ``IVFIndex``, ``VectorStore`` and ``measure_recall``
    (``retrieval/``) against the JAX package's on the same upserts,
    deletes and queries: ids equal wherever the reference's k-th and
    (k+1)-th scores differ by at least 1e-5 (``torch.topk``'s order among
    ties is unspecified), id sets where fewer rows than k are live,
    scores within 1e-5; the IVF member table bit-equal, the centroids
    within 1e-5, ``measure_recall`` equal.
  * Every case of the JAX package's ``TestIndexes``, ``TestGenerationSwap``,
    ``TestDriftVeto`` and ``TestOnlineFeed`` (``tests/test_retrieval.py``),
    run on both packages.
  * An upsert of one id twice keeps the last row in the host master and
    in staging alike; ``IndexFullError``; a tensor on another device
    raises.
  * One HTTP scenario through the port's engine and the JAX engine: the
    same statuses and answer keys for a query, a batch, a missing query,
    an unknown index and a search while draining; ``/models``'
    ``indexes`` and ``hbm_report``'s, equal to the JAX engine's.
  * The knobs: ``DL4J_TPU_ANN_ROWS``, ``_CLUSTERS``, ``_NPROBE``, and
    ``ops/memory.ann_arena_rows`` against the JAX closed form.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.clustering import kmeans as jkmeans  # noqa: E402
from deeplearning4j_tpu.datasets.iterator import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.online import DriftMonitor as JDrift  # noqa: E402
from deeplearning4j_tpu.online import StreamSource as JStream  # noqa: E402
from deeplearning4j_tpu import retrieval as jret  # noqa: E402
from deeplearning4j_tpu.serving.engine import (  # noqa: E402
    ServingEngine as JEngine,
)
from deeplearning4j_tpu.serving.resilience import (  # noqa: E402
    ClientRequestError as JClientError,
)

from deeplearning4j_tpu_torch import retrieval as pret  # noqa: E402
from deeplearning4j_tpu_torch.clustering import (  # noqa: E402
    Point,
    kmeans as pkmeans,
)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: E402
    DataSet as PDataSet,
)
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as PNet,
)
from deeplearning4j_tpu_torch.online import (  # noqa: E402
    DriftMonitor as PDrift,
    StreamSource as PStream,
)
from deeplearning4j_tpu_torch.ops import memory as pmemory  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: E402
    ServingEngine as PEngine,
)
from deeplearning4j_tpu_torch.serving.resilience import (  # noqa: E402
    ClientRequestError as PClientError,
)

TOL = 1e-5     # scores, centers
MARGIN = 1e-5  # the top-k order is compared only past this score gap


def clustered_corpus(rng, n=512, dim=16, clusters=16, spread=0.05):
    """The JAX test's corpus: real cluster structure, the regime IVF
    probing is for."""
    centers = rng.normal(size=(clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    pts = centers[assign] + spread * rng.normal(size=(n, dim))
    return pts.astype(np.float32)


def assert_topk_match(got_ids, got_scores, ref_ids, ref_scores, k):
    """The port's top-k against the reference's top-(k+1): scores within
    TOL; each position's id equal where the reference's scores at that
    rank are MARGIN apart from both neighbours; the id SET equal where
    the k-th and (k+1)-th reference scores are MARGIN apart (or fewer
    than k+1 live rows)."""
    got_ids, ref_ids = np.asarray(got_ids), np.asarray(ref_ids)
    assert got_ids.shape == ref_ids[:, :k].shape
    fin = np.isfinite(ref_scores[:, :k])
    assert np.array_equal(np.isfinite(got_scores), fin)
    np.testing.assert_allclose(got_scores[fin], ref_scores[:, :k][fin],
                               atol=TOL, rtol=0)
    checked = 0
    for r in range(ref_ids.shape[0]):
        s = np.where(np.isfinite(ref_scores[r]), ref_scores[r], -1e30)
        tail = s[k] if s.shape[0] > k else -np.inf
        if s[k - 1] - tail >= MARGIN:
            assert set(got_ids[r]) == set(ref_ids[r, :k]), r
            checked += 1
        for i in range(k):
            lo = s[i - 1] - s[i] if i > 0 else np.inf
            hi = s[i] - (s[i + 1] if i + 1 < s.shape[0] else -np.inf)
            if min(lo, hi) >= MARGIN:
                assert got_ids[r, i] == ref_ids[r, i], (r, i)
    return checked


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", ["euclidean", "manhattan", "cosine"])
def test_kmeans_matches_jax(distance):
    rng = np.random.default_rng(3)
    x = clustered_corpus(rng, n=400, dim=16, clusters=8, spread=0.3)
    j = jkmeans.KMeansClustering(8, max_iterations=30, distance=distance,
                                 seed=5)
    p = pkmeans.KMeansClustering(8, max_iterations=30, distance=distance,
                                 seed=5, device="cpu")
    j.apply_to(x)
    p.apply_to(x)
    # the draws: JAX's seeding centers are rows of x, the port's too
    j_init = j._kmeanspp_init(x, np.random.default_rng(5))
    p_init = p._kmeanspp_init(torch.from_numpy(x), np.random.default_rng(5))
    np.testing.assert_array_equal(p_init.numpy(), j_init)
    np.testing.assert_array_equal(p_init.numpy(), x[p.seed_rows])
    assert p.iterations_run == j.iterations_run
    np.testing.assert_allclose(p.centers_, j.centers_, atol=TOL, rtol=0)
    np.testing.assert_array_equal(p.assignments_, j.assignments_)
    q = clustered_corpus(np.random.default_rng(4), n=64, dim=16, clusters=8)
    np.testing.assert_array_equal(p.predict(q), j.predict(q))


def test_kmeans_seeding_with_fewer_distinct_points_than_k():
    """A total D^2 of 0 draws uniformly (``integers``), as in JAX."""
    x = np.repeat(np.eye(4, dtype=np.float32)[:2], 10, axis=0)
    j = jkmeans.KMeansClustering(5, max_iterations=5, seed=2)
    p = pkmeans.KMeansClustering(5, max_iterations=5, seed=2, device="cpu")
    j_init = j._kmeanspp_init(x, np.random.default_rng(2))
    p_init = p._kmeanspp_init(torch.from_numpy(x), np.random.default_rng(2))
    np.testing.assert_array_equal(p_init.numpy(), j_init)
    j.apply_to(x)
    p.apply_to(x)
    np.testing.assert_array_equal(p.assignments_, j.assignments_)
    assert p.iterations_run == j.iterations_run


def test_kmeans_apply_to_points_and_cluster_set():
    rng = np.random.default_rng(9)
    x = clustered_corpus(rng, n=60, dim=4, clusters=3, spread=0.1)
    pts = [Point(x[i], point_id=f"p{i}") for i in range(len(x))]
    jpts = [jkmeans.Point(x[i], point_id=f"p{i}") for i in range(len(x))]
    cs = pkmeans.KMeansClustering.setup(3, 20, seed=1,
                                        device="cpu").apply_to(pts)
    jcs = jkmeans.KMeansClustering.setup(3, 20, seed=1).apply_to(jpts)
    assert len(cs) == len(jcs) == 3
    for c, jc in zip(cs.clusters, jcs.clusters):
        assert [p.point_id for p in c.points] == \
            [p.point_id for p in jc.points]
        np.testing.assert_allclose(c.center, jc.center, atol=TOL, rtol=0)
    assert cs.nearest_cluster(pts[0]).cluster_id == \
        jcs.nearest_cluster(jpts[0]).cluster_id


def test_kmeans_rows_on_another_device_raise():
    km = pkmeans.KMeansClustering(2, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        km.fit(torch.empty(4, 3, device="meta"))


# ---------------------------------------------------------------------------
# the index and the store against JAX's, on the same operations
# ---------------------------------------------------------------------------


def _stores(**kw):
    return (jret.VectorStore(name="j", **kw),
            pret.VectorStore(name="p", device="cpu", **kw))


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_exact_store_matches_jax(metric):
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(200, 16)).astype(np.float32)
    j, p = _stores(dim=16, capacity=256, kind="exact", metric=metric)
    for s in (j, p):
        s.upsert(np.arange(200), vecs)
        s.delete(np.arange(0, 200, 7))
        s.upsert(np.arange(300, 310), vecs[:10] * 2.0)
        s.publish()
    assert p.snapshot.n == j.snapshot.n and \
        p.snapshot.n_pad == j.snapshot.n_pad
    np.testing.assert_array_equal(p.snapshot.ids, j.snapshot.ids)
    np.testing.assert_array_equal(p.snapshot.vecs.numpy(),
                                  np.asarray(j.snapshot.vecs))
    q = rng.normal(size=(33, 16)).astype(np.float32)
    ref_ids, ref_scores = j.search(q, k=11)
    ids, scores = p.search(q, k=10)
    assert assert_topk_match(ids, scores, ref_ids, ref_scores, 10) > 20
    assert p.report() == j.report()


def test_ivf_store_matches_jax():
    rng = np.random.default_rng(11)
    vecs = clustered_corpus(rng, n=512, dim=16, clusters=16)
    j, p = _stores(dim=16, capacity=1024, kind="ivf", clusters=16,
                   nprobe=6)
    for s in (j, p):
        s.upsert(np.arange(512), vecs)
        s.delete(np.arange(0, 100, 3))
        s.publish()
    js, ps = j.snapshot, p.snapshot
    # the member table bit-equal, the sentinel n_pad - 1 included
    np.testing.assert_array_equal(ps.members.numpy(),
                                  np.asarray(js.members).astype(np.int64))
    assert ps.cap_per == np.asarray(js.members).shape[1]
    np.testing.assert_allclose(ps.centroids.numpy(),
                               np.asarray(js.centroids), atol=TOL, rtol=0)
    q = clustered_corpus(rng, n=64, dim=16, clusters=16)
    for nprobe in (None, 1, 3):
        ref_ids, ref_scores = j._ivf.search(js, q, k=11, nprobe=nprobe)
        ids, scores = p.search(q, k=10, nprobe=nprobe)
        assert_topk_match(ids, scores, ref_ids, ref_scores, 10)
    ivf_j, ivf_p = jret.IVFIndex(nprobe=2), pret.IVFIndex(nprobe=2)
    assert pret.measure_recall(ps, ivf_p, q, k=10) == \
        jret.measure_recall(js, ivf_j, q, k=10)
    assert p.probe_recall(q) == j.probe_recall(q)
    assert p.report() == j.report()


def test_fewer_live_rows_than_k_matches_jax():
    j, p = _stores(dim=8, capacity=16, kind="exact")
    for s in (j, p):
        s.upsert([5, 9, 11], np.eye(8, dtype=np.float32)[:3])
        s.publish()
    q = np.eye(8, dtype=np.float32)[:2]
    (jid, jsc), (pid, psc) = j.search(q, k=6), p.search(q, k=6)
    # k clamps to the padded arena (bucket_size(4) = 4 rows)
    assert pid.shape == jid.shape == (2, 4)
    for r in range(2):
        assert set(pid[r]) == set(jid[r]) == {5, 9, 11, -1}
        assert pid[r][0] == jid[r][0]
    assert np.isneginf(psc[pid == -1]).all()
    np.testing.assert_allclose(np.sort(psc, 1), np.sort(jsc, 1), atol=TOL)


def test_duplicate_ids_in_one_upsert_keep_the_last_row():
    """The host master keeps the last row of a repeated id (numpy
    assignment); staging must hold the same row."""
    rows = np.asarray([[1, 0, 0, 0], [0, 3, 0, 0]], np.float32)
    j, p = _stores(dim=4, capacity=8, kind="exact")
    for s in (j, p):
        assert s.upsert([7, 7], rows) == 2
        s.publish()
    slot = p._id2slot[7]
    assert p.rows == j.rows == 1
    np.testing.assert_array_equal(p._staging[slot].numpy(),
                                  p._host_vecs[slot])
    np.testing.assert_array_equal(p._host_vecs[slot], [0, 1, 0, 0])
    np.testing.assert_array_equal(p._host_vecs[slot],
                                  j._host_vecs[j._id2slot[7]])
    np.testing.assert_array_equal(p.snapshot.vecs.numpy(),
                                  np.asarray(j.snapshot.vecs))
    # the same from device rows (a tensor on the store's device)
    p.upsert([8, 8], torch.from_numpy(rows[::-1].copy()))
    slot = p._id2slot[8]
    np.testing.assert_array_equal(p._staging[slot].numpy(), [1, 0, 0, 0])
    np.testing.assert_array_equal(p._host_vecs[slot], [1, 0, 0, 0])


def test_tensors_on_another_device_raise():
    p = pret.VectorStore(4, capacity=8, kind="exact", device="cpu")
    meta = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        p.upsert([1, 2], meta)
    p.upsert([1], np.ones((1, 4), np.float32))
    p.publish()
    with pytest.raises(ValueError, match="meta"):
        p.search(meta)


# ---------------------------------------------------------------------------
# the JAX package's retrieval cases, on both packages
# ---------------------------------------------------------------------------


class _Pkg:
    """One package's /search surface, so each case runs on both."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.VectorStore = jret.VectorStore
            self.IVFIndex = jret.IVFIndex
            self.measure_recall = jret.measure_recall
            self.IndexFullError = jret.IndexFullError
            self.PublishVetoed = jret.PublishVetoed
            self.DriftMonitor = JDrift
            self.StreamSource = JStream
            self.DataSet = JDataSet
            self.ClientRequestError = JClientError
        else:
            self.VectorStore = functools.partial(pret.VectorStore,
                                                 device="cpu")
            self.IVFIndex = pret.IVFIndex
            self.measure_recall = pret.measure_recall
            self.IndexFullError = pret.IndexFullError
            self.PublishVetoed = pret.PublishVetoed
            self.DriftMonitor = PDrift
            self.StreamSource = PStream
            self.DataSet = PDataSet
            self.ClientRequestError = PClientError

    def tiny_net(self, seed=7, n_in=8, hidden=12, n_out=3):
        c = jconf if self.name == "jax" else pconf
        conf = (c.NeuralNetConfiguration.builder().seed(seed).list()
                .layer(0, c.DenseLayer(n_in=n_in, n_out=hidden,
                                       activation="relu"))
                .layer(1, c.OutputLayer(n_in=hidden, n_out=n_out,
                                        activation="softmax",
                                        loss_function="mcxent"))
                .build())
        if self.name == "jax":
            return JNet(conf).init()
        return PNet(conf, device="cpu").init()

    def engine(self, net, **kw):
        if self.name == "jax":
            return JEngine(model=net, input_shape=(8,), **kw)
        return PEngine(model=net, input_shape=(8,), device="cpu", **kw)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


class TestIndexes:
    def test_exact_matches_numpy_oracle(self, pkg):
        rng = np.random.default_rng(10)
        vecs = rng.normal(size=(100, 16)).astype(np.float32)
        store = pkg.VectorStore(16, capacity=128, kind="exact", name="ex")
        store.upsert(np.arange(100), vecs)
        store.publish()
        q = rng.normal(size=(7, 16)).astype(np.float32)
        ids, scores = store.search(q, k=5)
        vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        oracle = np.argsort(-(qn @ vn.T), axis=1)[:, :5]
        assert np.array_equal(ids, oracle)

    def test_ivf_recall_bar_measured(self, pkg):
        rng = np.random.default_rng(11)
        vecs = clustered_corpus(rng, n=512, dim=16, clusters=16)
        store = pkg.VectorStore(16, capacity=1024, kind="ivf", clusters=16,
                                nprobe=6, name="ivf")
        store.upsert(np.arange(512), vecs)
        store.publish()
        assert store.snapshot.centroids is not None
        q = clustered_corpus(rng, n=64, dim=16, clusters=16)
        recall = store.probe_recall(q, k=10)
        assert recall >= 0.95
        assert store.retrieval_stats.snapshot()["last_recall"] == recall

    def test_ivf_below_min_rows_serves_exact(self, pkg):
        store = pkg.VectorStore(8, capacity=64, kind="ivf", min_ivf_rows=32,
                                name="small")
        rng = np.random.default_rng(12)
        store.upsert(np.arange(4), rng.normal(size=(4, 8)))
        store.publish()
        assert store.snapshot.centroids is None  # exact fallback
        ids, _ = store.search(rng.normal(size=(1, 8)), k=2)
        assert set(ids[0]) <= set(range(4))

    def test_fewer_live_rows_than_k(self, pkg):
        store = pkg.VectorStore(8, capacity=16, kind="exact", name="few")
        store.upsert([5, 9], np.eye(8, dtype=np.float32)[:2])
        store.publish()
        ids, scores = store.search(np.eye(8, dtype=np.float32)[:1], k=4)
        assert ids[0][0] == 5
        assert set(ids[0]) == {5, 9, -1}

    def test_delete_never_returned(self, pkg):
        rng = np.random.default_rng(13)
        vecs = rng.normal(size=(40, 8)).astype(np.float32)
        store = pkg.VectorStore(8, capacity=64, kind="exact", name="del")
        store.upsert(np.arange(40), vecs)
        store.publish()
        store.delete(np.arange(0, 40, 2))
        store.publish()
        ids, _ = store.search(vecs, k=5)
        assert not np.any(ids % 2 == 0)

    def test_upsert_replaces_in_place(self, pkg):
        store = pkg.VectorStore(4, capacity=8, kind="exact", name="rep")
        store.upsert([1], [[1, 0, 0, 0]])
        store.upsert([1], [[0, 1, 0, 0]])
        store.publish()
        assert store.rows == 1
        ids, _ = store.search(np.asarray([[0, 1, 0, 0]], np.float32), k=1)
        assert ids[0][0] == 1

    def test_capacity_full_raises(self, pkg):
        store = pkg.VectorStore(4, capacity=2, kind="exact", name="full")
        store.upsert([0, 1], np.eye(4, dtype=np.float32)[:2])
        with pytest.raises(pkg.IndexFullError):
            store.upsert([2], np.eye(4, dtype=np.float32)[2:3])

    def test_measure_recall_direct(self, pkg):
        rng = np.random.default_rng(14)
        vecs = clustered_corpus(rng, n=256, dim=8, clusters=8)
        store = pkg.VectorStore(8, capacity=512, kind="ivf", clusters=8,
                                nprobe=8, name="mr")
        store.upsert(np.arange(256), vecs)
        store.publish()
        ivf = pkg.IVFIndex(clusters=8, nprobe=8)
        assert pkg.measure_recall(store.snapshot, ivf, vecs[:16],
                                  k=10) == 1.0


class TestGenerationSwap:
    def test_zero_failed_searches_across_publishes(self, pkg):
        rng = np.random.default_rng(20)
        dim = 8
        store = pkg.VectorStore(dim, capacity=512, kind="exact",
                                name="swap")
        store.upsert(np.arange(32), rng.normal(size=(32, dim)))
        store.publish()
        q = rng.normal(size=(4, dim)).astype(np.float32)
        stop = threading.Event()
        errs, answered = [], [0]

        def searcher():
            while not stop.is_set():
                try:
                    ids, scores = store.search(q, k=5)
                    assert ids.shape == (4, 5)
                    assert np.all(np.isfinite(scores[ids >= 0]))
                    answered[0] += 1
                except Exception as e:  # noqa: BLE001 — the contract
                    errs.append(e)
                    return

        threads = [threading.Thread(target=searcher) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for gen_round in range(8):
                base = 32 + gen_round * 16
                store.upsert(np.arange(base, base + 16),
                             rng.normal(size=(16, dim)))
                store.publish()
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert errs == []
        assert answered[0] > 0
        assert store.generation == 9

    def test_engine_search_across_swap(self, pkg):
        eng = pkg.engine(pkg.tiny_net()).start()
        try:
            rng = np.random.default_rng(21)
            store = pkg.VectorStore(12, capacity=256, kind="exact",
                                    name="es")
            corpus = eng.embed(rng.normal(size=(32, 8)).astype(np.float32))
            store.upsert(np.arange(32), corpus)
            store.publish()
            eng.register_index("es", store)
            q = corpus[0].tolist()
            stop = threading.Event()
            errs = []

            def client():
                while not stop.is_set():
                    try:
                        code, r = _post(eng.url, "/search",
                                        {"index": "es", "query": q, "k": 3})
                        assert code == 200 and len(r["ids"][0]) == 3
                    except Exception as e:  # noqa: BLE001
                        errs.append(e)
                        return

            t = threading.Thread(target=client)
            t.start()
            try:
                for i in range(5):
                    store.upsert([100 + i], rng.normal(size=(1, 12)))
                    store.publish()
            finally:
                stop.set()
                t.join()
            assert errs == []
        finally:
            eng.stop()


class TestDriftVeto:
    def _drifted_monitor(self, pkg, dim=8):
        drift = pkg.DriftMonitor((np.zeros(dim), np.ones(dim)), min_rows=16)
        drift.observe(np.full((32, dim), 50.0, np.float32))  # z = 50
        assert drift.check()["alarmed"]
        return drift

    def test_veto_blocks_publish(self, pkg):
        store = pkg.VectorStore(8, capacity=64, kind="exact", name="veto")
        store.upsert(np.arange(8), np.eye(8, dtype=np.float32))
        store.publish()
        assert store.generation == 1
        store.upsert([9], [np.ones(8, np.float32)])
        drift = self._drifted_monitor(pkg)
        with pytest.raises(pkg.PublishVetoed):
            store.publish(drift=drift)
        assert store.generation == 1
        assert store.retrieval_stats.snapshot()["publish_vetoes"] == 1
        store.publish(drift=drift, force=True)
        assert store.generation == 2
        ids, _ = store.search(np.ones((1, 8), np.float32), k=1)
        assert ids[0][0] == 9

    def test_feed_once_reports_veto(self, pkg):
        store = pkg.VectorStore(8, capacity=64, kind="exact",
                                name="feedveto")
        drift = self._drifted_monitor(pkg)
        src = pkg.StreamSource(watermark=8, idle_s=0.05)
        src.push(pkg.DataSet(np.eye(8, dtype=np.float32)[:4],
                             np.arange(4, dtype=np.float32)[:, None]))
        report = store.feed_once(src, drift=drift)
        assert report["vetoed"] and not report["published"]
        assert report["generation"] == 0
        src.close()


class TestOnlineFeed:
    def test_stream_fed_window_publishes(self, pkg):
        rng = np.random.default_rng(30)
        store = pkg.VectorStore(8, capacity=128, kind="exact", name="feed")
        src = pkg.StreamSource(watermark=16, idle_s=0.05)
        vecs = rng.normal(size=(12, 8)).astype(np.float32)
        src.push(pkg.DataSet(vecs[:8],
                             np.arange(8, dtype=np.float32)[:, None]))
        src.push(pkg.DataSet(vecs[8:], np.arange(
            8, 12, dtype=np.float32)[:, None]))
        report = store.feed_once(src)
        assert report["batches"] == 2
        assert report["upserted"] == 12
        assert report["published"] and report["generation"] == 1
        src.push(("delete", np.arange(6)))
        report = store.feed_once(src)
        assert report["deleted"] == 6 and report["generation"] == 2
        assert store.rows == 6
        src.close()
        snap = store.retrieval_stats.snapshot()
        assert snap["feed_windows"] == 2 and snap["feed_batches"] == 3

    def test_search_unknown_index_is_client_error(self, pkg):
        eng = pkg.engine(pkg.tiny_net())
        try:
            with pytest.raises(pkg.ClientRequestError):
                eng.search("nope", np.zeros((1, 4), np.float32))
        finally:
            eng.stop()


def test_drift_and_stream_match_jax():
    """The drift verdicts on the same windows, and the stream's offsets,
    backpressure and seek, in both packages."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(96, 6)).astype(np.float32)
    shifted = x + np.asarray([5, 0, 0, 0, 0, 0], np.float32)
    base = (x.mean(0), x.std(0))
    for data in (x, shifted):
        j = JDrift(base, min_rows=32, z_threshold=3.0)
        p = PDrift(base, min_rows=32, z_threshold=3.0)
        for i in range(0, 96, 8):
            j.observe(data[i:i + 8])
            p.observe(data[i:i + 8])
        assert p.check() == j.check()
    for Stream, DS in ((JStream, JDataSet), (PStream, PDataSet)):
        src = Stream(watermark=2, idle_s=0.05)
        offs = [src.push(DS(x[i:i + 8], x[i:i + 8])) for i in (0, 8)]
        assert offs == [0, 1]
        with pytest.raises(Exception) as e:
            src.push(DS(x[:8], x[:8]), timeout_s=0.1)
        assert type(e.value).__name__ == "StreamBackpressure"
        src.restore_state({"offset": 1})
        got = list(src)
        assert len(got) == 1 and src.state() == {"offset": 2}
        np.testing.assert_array_equal(np.asarray(got[0].features), x[8:16])
        src.close()
        with pytest.raises(Exception) as e:
            src.push(DS(x[:8], x[:8]))
        assert type(e.value).__name__ == "StreamClosed"


# ---------------------------------------------------------------------------
# the engine: HTTP against the JAX engine, reports
# ---------------------------------------------------------------------------


def _http_scenario(eng, store):
    eng.register_index("default", store)
    q = np.eye(8, dtype=np.float32)
    payloads = [
        {"query": q[0].tolist()},
        {"queries": q[:3].tolist(), "k": 2},
        {"index": "default", "query": q[1].tolist(), "k": 20},
        {"query": q[2].tolist(), "nprobe": 1},
        {"k": 3},
        {"index": "nope", "query": q[0].tolist()},
    ]
    out = []
    for body in payloads:
        code, r = _post(eng.url, "/search", body)
        out.append((code, sorted(r), r))
    eng.drain(1.0)
    code, r = _post(eng.url, "/search", {"query": q[0].tolist()})
    out.append((code, sorted(r), r))
    return out


def test_http_search_matches_the_jax_engine():
    rng = np.random.default_rng(40)
    vecs = rng.normal(size=(12, 8)).astype(np.float32)
    answers = {}
    for name in ("jax", "torch"):
        pkg = _Pkg(name)
        eng = pkg.engine(pkg.tiny_net()).start()
        try:
            store = pkg.VectorStore(8, capacity=16, kind="exact",
                                    name="default")
            store.upsert(np.arange(12), vecs)
            store.publish()
            answers[name] = _http_scenario(eng, store)
        finally:
            eng.stop()
    for (jc, jk, jr), (pc, pk, pr) in zip(answers["jax"], answers["torch"]):
        assert (pc, pk) == (jc, jk), (pr, jr)
        if pc == 200:
            assert pr["ids"] == jr["ids"]
            np.testing.assert_allclose(np.asarray(pr["scores"]),
                                       np.asarray(jr["scores"]), atol=TOL)
    codes = [c for c, _, _ in answers["torch"]]
    assert codes == [200, 200, 200, 200, 400, 400, 503]
    # k past the live rows: ids -1 with -Infinity scores on the wire
    wide = answers["torch"][2][2]
    assert wide["ids"][0][-1] == -1 and wide["scores"][0][-1] == -np.inf


def test_models_indexes_and_hbm_report_match_jax():
    reports = {}
    for name in ("jax", "torch"):
        pkg = _Pkg(name)
        eng = pkg.engine(pkg.tiny_net()).start()
        try:
            store = pkg.VectorStore(12, capacity=64, kind="exact",
                                    name="default")
            store.upsert([0], np.ones((1, 12), np.float32))
            store.publish()
            before = eng.hbm_report()["used_bytes"]
            eng.register_index("default", store)
            with urllib.request.urlopen(eng.url + "/models",
                                        timeout=30) as resp:
                m = json.load(resp)
            hbm = eng.hbm_report()
            reports[name] = (m["indexes"], hbm["indexes"],
                             hbm["used_bytes"] - before)
            assert eng.unregister_index("default") is store
            assert eng.index_report() == {}
        finally:
            eng.stop()
    assert reports["torch"] == reports["jax"]
    rep, hbm, rise = reports["torch"]
    assert rep["default"]["rows"] == 1 and rep["default"]["capacity"] == 64
    assert rep["default"]["arena_bytes"] == 65 * 12 * 4 == hbm["default"]
    assert rise == hbm["default"]


# ---------------------------------------------------------------------------
# knobs and sizing
# ---------------------------------------------------------------------------


def test_ann_knobs(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_ANN_ROWS", "77")
    assert pret.VectorStore(8, name="knob", device="cpu").capacity == 77
    monkeypatch.delenv("DL4J_TPU_ANN_ROWS")
    rng = np.random.default_rng(41)
    vecs = clustered_corpus(rng, n=300, dim=8, clusters=6)
    monkeypatch.setenv("DL4J_TPU_ANN_CLUSTERS", "6")
    monkeypatch.setenv("DL4J_TPU_ANN_NPROBE", "2")
    j, p = _stores(dim=8, capacity=512, kind="ivf")
    for s in (j, p):
        s.upsert(np.arange(300), vecs)
        s.publish()
    assert p.report()["clusters"] == j.report()["clusters"] == 6
    assert p.report()["nprobe"] == 2
    q = clustered_corpus(rng, n=16, dim=8, clusters=6)
    ref_ids, ref_scores = j.search(q, k=6)
    ids, scores = p.search(q, k=5)
    assert_topk_match(ids, scores, ref_ids, ref_scores, 5)
    monkeypatch.delenv("DL4J_TPU_ANN_CLUSTERS")
    assert pret.IVFIndex()._n_clusters(300) == 17  # int(sqrt(300))


@pytest.mark.parametrize("dim,hbm_gb", [(64, 16.0), (768, 80.0),
                                        (768, 0.001), (4096, 2.0)])
def test_ann_arena_rows_matches_jax(dim, hbm_gb):
    from deeplearning4j_tpu.ops import memory as jmemory

    params = {"w": np.zeros((1000, 1000), np.float32)}
    for p in (None, params):
        want = jmemory.ann_arena_rows(dim, params=p, hbm_gb=hbm_gb)
        got = pmemory.ann_arena_rows(
            dim, budget_bytes=int(hbm_gb * 2**30),
            params=None if p is None else {"w": torch.from_numpy(p["w"])})
        assert got == want
    assert pmemory.ann_row_bytes(dim) == jmemory.ann_row_bytes(dim)


def test_auto_capacity_from_the_device_memory(monkeypatch):
    monkeypatch.setattr(pmemory, "device_memory_bytes",
                        lambda device: 64 * 2**20)
    rows = pmemory.ann_arena_rows(64, device="cpu")
    assert rows == int(64 * 2**20 * 0.25 / (3 * 64 * 4))
    assert pret.VectorStore(64, name="auto", device="cpu").capacity == rows
    # the card's clamp: 80 GB at 768 wide sizes past the 1 << 20 cap
    monkeypatch.setattr(pmemory, "device_memory_bytes",
                        lambda device: 80 * 10**9)
    assert pmemory.ann_arena_rows(768, device="cpu") == 1 << 20
