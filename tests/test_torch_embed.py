"""``/embed`` in the port against the JAX package, on the CPU.

  * Each adapter (``retrieval/embed.py``) against the JAX package's on the
    same weights and the same rows, at equal batch shapes (XLA:CPU's f32
    products change their bytes with the batch size), within 1e-5: the
    feed-forward adapter over an MLN (default last hidden layer, an
    index, ``DL4J_TPU_EMBED_LAYER``) and over a graph (the vertex feeding
    the first output, a named vertex), BERT's mean/cls/max pooling over
    ``embed_tokens``, a word2vec table's rows. ``dim`` without running the
    model: the MLN's from its propagated shapes before any call (JAX's
    by ``jax.eval_shape``), a graph's unknown until its first call in
    both packages, BERT's ``d_model``.
  * The HTTP route: one scenario of payloads (record, batch, tokens, a
    layer, a bad payload, an unknown model, rows of the wrong width)
    through the port's engine and the JAX engine over the same MLN: the
    same statuses, the same answer keys, the embeddings within 1e-5.
  * The batcher's answer equal to the direct call (``_direct_embed``) on
    the same rows and the same bucket within 1e-5; the
    ``retrieval_stats`` counters and their Prometheus samples;
    ``embed_report`` at ``GET /models``.
  * ``registry.restore`` of a JAX graph zip and a JAX BERT zip, loaded
    through ``POST /models``, answering ``/predict`` (a graph's first
    output) and ``/embed``.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import bert as pb  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.graph import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
    params_from_numpy,
)
from deeplearning4j_tpu_torch.retrieval import embed as pembed  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.registry import restore  # noqa: E402

TOL = 1e-5
BERT_KW = dict(vocab_size=40, d_model=16, n_layers=2, n_heads=2, d_ff=32,
               max_len=12, mask_token_id=39, seed=2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def mln_pair():
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(0, DenseLayer(n_in=8, n_out=12, activation="relu"))
            .layer(1, DenseLayer(n_in=12, n_out=6, activation="tanh"))
            .layer(2, OutputLayer(n_in=6, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    jnet = JNet(conf).init()
    pnet = MultiLayerNetwork(pconf.MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.params = params_from_numpy(_np(jnet.params), device="cpu")
    return jnet, pnet


def graph_pair():
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    conf = (NeuralNetConfiguration.builder().seed(3).graph_builder()
            .add_inputs("in")
            .add_layer("a", DenseLayer(n_in=8, n_out=5, activation="relu"),
                       "in")
            .add_layer("b", DenseLayer(n_in=8, n_out=4, activation="tanh"),
                       "in")
            .add_vertex("m", MergeVertex(), "a", "b")
            .add_layer("out", OutputLayer(n_in=9, n_out=3,
                                          activation="softmax",
                                          loss_function="mcxent"), "m")
            .set_outputs("out").build())
    jnet = JGraph(conf).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    pnet.params = params_from_numpy(_np(jnet.params), device="cpu")
    return jnet, pnet


def bert_pair():
    from deeplearning4j_tpu.models import bert as jb

    jlm = jb.BertMLM(jb.BertConfig(**BERT_KW))
    plm = pb.BertMLM(pb.BertConfig(**BERT_KW), device="cpu",
                     params=pb._tree_like(
                         pb.init_params(pb.BertConfig(**BERT_KW),
                                        device="cpu"),
                         _np(jlm.params), torch.device("cpu")))
    return jlm, plm


def _rows(n=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 8)).astype(
        np.float32)


def _tokens(n=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 37, (n, 12))
    ids[0, 7:] = 0
    return ids


class TestAdapters:
    def test_mln_layers_and_dim_without_a_forward(self, monkeypatch):
        from deeplearning4j_tpu.retrieval import embed as jembed

        jnet, pnet = mln_pair()
        x = _rows()
        for layer in (None, 1, -1, 0):
            ja = jembed.FeedForwardEmbedding(jnet, layer=layer,
                                             input_shape=(8,))
            pa = pembed.FeedForwardEmbedding(pnet, layer=layer,
                                             input_shape=(8,))
            assert pa.dim == ja.dim  # before any call
            got, want = pa(x), ja(x)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert pembed.FeedForwardEmbedding(pnet, input_shape=(8,)).dim == 6
        assert pembed.FeedForwardEmbedding(pnet).dim is None
        monkeypatch.setenv("DL4J_TPU_EMBED_LAYER", "1")
        assert pembed.FeedForwardEmbedding(pnet).layer == 1 \
            == jembed.FeedForwardEmbedding(jnet).layer
        with pytest.raises(ValueError, match="out of range"):
            pembed.FeedForwardEmbedding(pnet, layer=9)(x)

    def test_graph_vertices(self):
        from deeplearning4j_tpu.retrieval import embed as jembed

        jnet, pnet = graph_pair()
        x = _rows(seed=1)
        for layer in (None, "a", "b"):
            ja = jembed.FeedForwardEmbedding(jnet, layer=layer)
            pa = pembed.FeedForwardEmbedding(pnet, layer=layer)
            assert pa.layer == ja.layer
            assert pa.dim is None and ja.dim is None
            np.testing.assert_allclose(pa(x), ja(x), rtol=0, atol=TOL)
            assert pa.dim == ja.dim
        ad = pembed.FeedForwardEmbedding(pnet)
        ad(x[:2])
        assert ad.dim == 9

    @pytest.mark.parametrize("pool", ["mean", "cls", "max"])
    def test_bert_pools(self, pool):
        from deeplearning4j_tpu.retrieval import embed as jembed

        jlm, plm = bert_pair()
        ids = _tokens()
        ja = jembed.BertEmbedding(jlm, pool=pool)
        pa = pembed.BertEmbedding(plm, pool=pool)
        assert pa.dim == ja.dim == 16
        got = pa(ids.astype(np.float32))  # a float envelope rounds back
        np.testing.assert_allclose(got, ja(ids), rtol=0, atol=TOL)
        with pytest.raises(ValueError, match="pool"):
            pembed.BertEmbedding(plm, pool="sum")

    def test_lookup_table_and_resolution(self):
        from deeplearning4j_tpu.retrieval import embed as jembed

        class Table:  # the lookup table's surface
            vector_length = 6
            syn0 = np.random.default_rng(3).normal(size=(10, 6)).astype(
                np.float32)

            def vectors(self, idx):
                return self.syn0[np.asarray(idx, np.int64)]

        table = Table()
        pa = pembed.resolve_adapter(table)
        ja = jembed.LookupEmbedding(table)
        assert isinstance(pa, pembed.LookupEmbedding) and pa.dim == 6
        ids = np.asarray([[2], [7], [0]])
        np.testing.assert_array_equal(pa(ids), ja(ids))
        np.testing.assert_array_equal(pa(ids), table.syn0[[2, 7, 0]])
        _, plm = bert_pair()
        assert isinstance(pembed.resolve_adapter(plm), pembed.BertEmbedding)
        with pytest.raises(TypeError):
            pembed.resolve_adapter(object())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.load(resp)


def _scenario(url):
    x = _rows(4, seed=5)
    payloads = [
        {"record": x[0].tolist()},
        {"batch": x.tolist()},
        {"batch": x[:2].tolist(), "layer": 1},
        {"tokens": x[:1].tolist()},
        {},
        {"batch": x.tolist(), "model": "nope"},
        {"batch": np.zeros((2, 5)).tolist()},
    ]
    return [_post(url, "/embed", p) for p in payloads]


def test_http_scenario_against_the_jax_engine():
    from deeplearning4j_tpu.serving.engine import ServingEngine as JEngine

    jnet, pnet = mln_pair()
    jeng = JEngine(model=jnet, input_shape=(8,)).start()
    peng = ServingEngine(model=pnet, input_shape=(8,), device="cpu").start()
    try:
        jres = _scenario(f"http://127.0.0.1:{jeng.port}")
        pres = _scenario(peng.url)
        assert [r[0] for r in pres] == [r[0] for r in jres] \
            == [200, 200, 200, 200, 400, 400, 400]
        for (_, jb), (_, pb_) in zip(jres, pres):
            assert set(pb_) == set(jb)
            for key in ("embedding", "embeddings"):
                if key in jb:
                    np.testing.assert_allclose(
                        np.asarray(pb_[key]), np.asarray(jb[key]), rtol=0,
                        atol=TOL)
            if "dim" in jb:
                assert pb_["dim"] == jb["dim"] == 6
        jm, pm = (_get(f"http://127.0.0.1:{jeng.port}", "/models"),
                  _get(peng.url, "/models"))
        assert pm["embed"] == jm["embed"] == {
            "default@v1": {"kind": "feedforward", "dim": 6}}
        assert pm["indexes"] == {}
        snap = peng.retrieval_stats.snapshot()
        assert snap["embed_requests"] == 4 and snap["embed_rows"] == 8
        assert snap == jeng.retrieval_stats.snapshot()
        req = urllib.request.Request(peng.url + "/metrics",
                                     headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            text = resp.read().decode()
        assert "embed_requests" in text
    finally:
        jeng.stop()
        peng.stop()


def test_batcher_equals_the_direct_call_on_the_same_bucket():
    _, pnet = mln_pair()
    eng = ServingEngine(model=pnet, input_shape=(8,), device="cpu")
    try:
        rec = eng.registry.get()
        for n in (1, 5, 8):
            x = _rows(n, seed=n)
            via = eng.embed(x)
            direct = eng._direct_embed(rec, x, None, None)
            assert via.shape == direct.shape == (n, 6)
            np.testing.assert_allclose(via, direct, rtol=0, atol=TOL)
        # pad rows are sliced off: 5 rows (bucket 8) against the same
        # rows in the bucket's first 5 places
        x = _rows(8, seed=9)
        np.testing.assert_allclose(eng.embed(x[:5]), eng.embed(x)[:5],
                                   rtol=0, atol=TOL)
    finally:
        eng.stop()


def test_direct_path_under_batching_off(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SERVE_BATCH", "0")
    jnet, pnet = mln_pair()
    eng = ServingEngine(model=pnet, input_shape=(8,), device="cpu")
    try:
        assert not eng.batching_enabled
        x = _rows(3)
        np.testing.assert_allclose(
            eng.embed(x), pembed.FeedForwardEmbedding(pnet)(x), rtol=0,
            atol=TOL)
        assert eng._embed_batchers == {}
    finally:
        eng.stop()


def test_graph_and_bert_zips_through_post_models(tmp_path):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    jnet, _ = graph_pair()
    gpath = str(tmp_path / "graph.zip")
    ModelSerializer.write_model(jnet, gpath)
    jlm, _ = bert_pair()
    bpath = str(tmp_path / "bert.zip")
    jlm.save(bpath)
    assert isinstance(restore(gpath, device="cpu"), ComputationGraph)
    assert isinstance(restore(bpath, device="cpu"), pb.BertMLM)
    eng = ServingEngine(device="cpu").start()
    try:
        for name, path in (("graph", gpath), ("bert", bpath)):
            code, body = _post(eng.url, "/models", {"action": "load",
                                                    "name": name,
                                                    "path": path})
            assert code == 200, body
        assert _post(eng.url, "/models", {"action": "serve",
                                          "name": "graph"})[0] == 200
        x = _rows(3, seed=4)
        code, body = _post(eng.url, "/predict", {"batch": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(
            np.asarray(body["outputs"]),
            np.asarray(jnet.output(jnp.asarray(x))[0]), rtol=0, atol=TOL)
        code, body = _post(eng.url, "/embed", {"batch": x.tolist()})
        assert code == 200 and body["dim"] == 9
        ids = _tokens()
        code, body = _post(eng.url, "/embed", {"tokens": ids.tolist(),
                                               "model": "bert"})
        assert code == 200 and body["dim"] == 16
        from deeplearning4j_tpu.retrieval import embed as jembed

        np.testing.assert_allclose(
            np.asarray(body["embeddings"]),
            jembed.BertEmbedding(jlm, pool="mean")(ids), rtol=0, atol=TOL)
        models = _get(eng.url, "/models")
        assert models["embed"] == {
            "bert@v1": {"kind": "bert", "dim": 16},
            "graph@v1": {"kind": "feedforward", "dim": 9}}
        metrics = eng.metrics()
        assert "flash_attention_block" in metrics["kernels"]
    finally:
        eng.stop()
