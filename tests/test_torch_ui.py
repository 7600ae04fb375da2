"""The port's training UI (``ui/``) against the JAX package's, on the CPU.

  * Components: every component's ``render``, ``to_json`` and
    ``component_from_dict`` round trip, and ``render_page``, are
    byte-equal to JAX's for the same inputs.
  * Server: a port ``UiServer(device="cpu")`` and a JAX ``UiServer`` take
    the same requests on every route (``/train/update``,
    ``/train/summary``, ``/``, ``/tsne/update``, ``/tsne/coords``,
    ``/tsne``, ``/word2vec/upload``, ``/word2vec/words``,
    ``/word2vec/nearest`` by word and by vector, the 400s and the 404)
    and answer the same JSON and pages. ``/tsne/upload``'s coordinates
    are ``torch.equal`` to the port's ``Tsne`` called directly, with JAX's
    shape. They are not held to JAX's coordinates: 50 f32 steps at
    learning rate 200 amplify the packages' rounding differences into
    other layouts (``tests/test_torch_tsne.py`` holds the fit to JAX's
    in f64).
  * Listeners: on parameters carried across from a JAX net, the
    histogram payload equals JAX's (bin counts exact, edges within 1e-6
    relative), the flow payload equals JAX's, and the convolutional
    payload of LeNet-5 (NHWC) has JAX's grids within the f32 forward's
    rounding; the mirror of ``tests/test_ui.py``'s listener cases, and a
    listener posting to the server.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu import ui as jui  # noqa: E402
from deeplearning4j_tpu_torch import ui as pui  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
    params_from_numpy,
)


def all_components(ui):
    line = ui.ChartLine(title="L").add_series("a", [0, 1, 2], [1.0, 0.5, 0.2])
    line.add_series("b", [0, 1, 2], [0.2, 0.3, 0.4])
    scatter = ui.ChartScatter(title="S").add_series("pts", [0, 1], [1, 0])
    hist = ui.ChartHistogram(title="H").add_bin(0, 1, 5).add_bin(1, 2, 3)
    stacked = ui.ChartStackedArea(title="SA")
    stacked.add_series("x", [0, 1, 2], [1, 1, 1])
    stacked.add_series("y", [0, 1, 2], [2, 1, 0.5])
    bars = ui.ChartHorizontalBar(title="B").add_bar("w", 3.0).add_bar(
        "b", 1.5)
    tl = ui.ChartTimeline(title="T").add_lane(
        "w0", [(0, 10, "fit"), (10, 12, "avg")])
    table = ui.ComponentTable(title="tab", header=["a", "b"],
                              rows=[["1", "<2>"]])
    text = ui.ComponentText(title="", text="hello & <bye>")
    img = ui.ComponentImage.from_array(
        np.linspace(0, 1, 16).reshape(4, 4), title="filters", scale=8)
    empty = ui.ChartLine(title="empty")
    styled = ui.ChartLine(title="styled",
                          style=ui.StyleChart(width=300, height=200))
    styled.add_series("s", [0, 5], [-1.0, 3.0])
    return [line, scatter, hist, stacked, bars, tl, table, text, img, empty,
            styled]


class TestComponents:
    @pytest.mark.parametrize("i", range(11))
    def test_render_and_json_equal_jax(self, i):
        j, p = all_components(jui)[i], all_components(pui)[i]
        assert type(j).__name__ == type(p).__name__
        assert p.render() == j.render()
        assert p.to_json() == j.to_json()
        back = pui.component_from_dict(json.loads(j.to_json()))
        assert back.to_dict() == p.to_dict()
        assert back.render() == j.render()

    def test_static_page_equals_jax(self):
        page = pui.render_page(all_components(pui), title="export test")
        assert page == jui.render_page(all_components(jui),
                                       title="export test")
        assert page.count("<svg") >= 6
        assert "<script" not in page and "<link" not in page
        assert 'src="http' not in page
        assert page.count('src="data:image/png;base64,') == 1


def _req(url, path, obj=None):
    """(status, content type, body) of a GET or a JSON POST."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(
        url + path, data=data, method="GET" if obj is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _embeddings(n=30, d=8, clusters=2):
    rng = np.random.default_rng(0)
    words, vecs = [], []
    for c in range(clusters):
        center = rng.standard_normal(d) * 5
        for i in range(n // clusters):
            words.append(f"c{c}_w{i}")
            vecs.append(center + 0.1 * rng.standard_normal(d))
    return words, np.asarray(vecs, np.float32).tolist()


@pytest.fixture()
def servers():
    j = jui.UiServer(port=0).start()
    p = pui.UiServer(port=0, device="cpu").start()
    yield j, p
    j.stop()
    p.stop()


class TestServerRoutesEqualJax:
    def test_training_routes(self, servers):
        words, vecs = _embeddings()
        steps = [
            ("/", None),
            ("/train/summary", None),
            ("/train/update", {"type": "score", "iteration": 0,
                               "score": 2.0}),
            ("/train/update", {"type": "score", "iteration": 1,
                               "score": 1.0}),
            ("/train/update", {"type": "histogram", "iteration": 1,
                               "score": 1.0, "params": {"0_W": {
                                   "lower": [0.0, 0.5], "upper": [0.5, 1.0],
                                   "counts": [3, 4], "mean": 0.4,
                                   "std": 0.1}}}),
            ("/train/update", {"type": "flow", "iteration": 1, "score": 1.0,
                               "layers": [{"name": "0",
                                           "layer_type": "DenseLayer",
                                           "n_params": 40, "inputs": []}]}),
            ("/train/update", {"iteration": 2}),
            ("/train/summary", None),
            ("/", None),
            ("/tsne", None),
            ("/tsne/coords", None),
            ("/tsne/update", {"words": ["x", "y"],
                              "coords": [[0, 1], [2, 3]]}),
            ("/tsne/update", {"words": ["x"], "coords": []}),
            ("/tsne/coords", None),
            ("/tsne", None),
            ("/word2vec/words", None),
            ("/word2vec/nearest", {"word": "c0_w0"}),
            ("/word2vec/upload", {"words": words, "vectors": vecs}),
            ("/word2vec/upload", {"words": ["a"], "vectors": [[1, 2],
                                                              [3, 4]]}),
            ("/word2vec/words", None),
            ("/word2vec/nearest", {"word": "c0_w0", "k": 5}),
            ("/word2vec/nearest", {"word": "c1_w3"}),
            ("/word2vec/nearest", {"vector": vecs[0], "k": 3}),
            ("/word2vec/nearest", {"word": "zzz"}),
            ("/nope", None),
            ("/nope", {"x": 1}),
        ]
        j, p = servers
        for path, obj in steps:
            want, got = _req(j.url, path, obj), _req(p.url, path, obj)
            assert got == want, (path, obj, got[:2], want[:2])
        status, _, body = _req(p.url, "/word2vec/nearest",
                               {"word": "c0_w0", "k": 5})
        names = [n["word"] for n in json.loads(body)["neighbors"]]
        assert status == 200 and len(names) == 5
        assert all(n.startswith("c0_") for n in names)
        assert "c0_w0" not in names

    def test_tsne_upload(self, servers):
        from deeplearning4j_tpu_torch.plot.tsne import Tsne

        j, p = servers
        words, vecs = _embeddings(n=24)
        body = {"words": words, "vectors": vecs, "iterations": 50}
        assert _req(p.url, "/tsne/upload", body)[2] == _req(
            j.url, "/tsne/upload", body)[2]
        got = json.loads(_req(p.url, "/tsne/coords")[2])
        want = json.loads(_req(j.url, "/tsne/coords")[2])
        assert got["words"] == want["words"] == words
        direct = Tsne(n_components=2, perplexity=min(30.0, 23 / 3.0),
                      max_iter=50, device="cpu").fit_transform(
                          np.asarray(vecs, np.float32))
        assert torch.equal(torch.tensor(got["coords"]),
                           torch.from_numpy(np.asarray(direct)).double())
        g, w = np.asarray(got["coords"]), np.asarray(want["coords"])
        assert g.shape == w.shape == (24, 2) and np.isfinite(g).all()
        assert "svg" in _req(p.url, "/tsne")[2].decode().lower()

    def test_device_is_the_card_unless_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pui.UiServer(port=0)
        s = pui.UiServer(port=0, device="cpu")
        assert s.device == torch.device("cpu")
        s._httpd.server_close()


def _jax_net():
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as J

    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .list()
            .layer(0, DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    return J(conf).init()


def _port_twin(jnet, input_shape=None):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    p = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init(input_shape)
    host = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t)
    p.params = params_from_numpy(host(jnet.params), device="cpu")
    p.states = params_from_numpy(host(jnet.states), device="cpu")
    return p


def _data(n=16):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


class TestListenersEqualJax:
    @pytest.mark.parametrize("bins", [20, 7])
    def test_histogram_payload(self, bins):
        jnet = _jax_net()
        pnet = _port_twin(jnet)
        jl = jui.HistogramIterationListener(frequency=1, num_bins=bins)
        pl = pui.HistogramIterationListener(frequency=1, num_bins=bins)
        jl.iteration_done(jnet, 3, 0.75)
        pl.iteration_done(pnet, 3, torch.tensor(0.75))
        jh, ph = jl.storage.latest("histogram"), pl.storage.latest(
            "histogram")
        assert list(ph["params"]) == list(jh["params"]) == [
            "0_W", "0_b", "1_W", "1_b"]
        for name, want in jh["params"].items():
            got = ph["params"][name]
            assert got["counts"] == want["counts"]
            for k in ("lower", "upper"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
            np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)
            np.testing.assert_allclose(got["std"], want["std"], rtol=1e-6)
        assert ph["score"] == jh["score"] and ph["iteration"] == 3
        assert pl.storage.latest("score") == jl.storage.latest("score")

    def test_flow_payload(self):
        jnet = _jax_net()
        pnet = _port_twin(jnet)
        jl = jui.FlowIterationListener(frequency=2)
        pl = pui.FlowIterationListener(frequency=2)
        for it in range(3):
            jl.iteration_done(jnet, it, 0.5)
            pl.iteration_done(pnet, it, 0.5)
        assert pl.storage.get("flow") == jl.storage.get("flow")
        assert [l["layer_type"] for l in
                pl.storage.latest("flow")["layers"]] == [
            "DenseLayer", "OutputLayer"]

    def test_flow_payload_of_a_graph(self):
        from deeplearning4j_tpu_torch.nn.conf import graph as pgraph
        from deeplearning4j_tpu_torch.nn import conf as pconf
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        conf = (pconf.NeuralNetConfiguration.builder().seed(1)
                .graph_builder().add_inputs("in")
                .add_layer("d", pconf.DenseLayer(n_in=4, n_out=5), "in")
                .add_layer("out", pconf.OutputLayer(n_in=5, n_out=3), "d")
                .set_outputs("out").build())
        assert isinstance(conf, pgraph.ComputationGraphConfiguration)
        net = ComputationGraph(conf, device="cpu").init()
        pl = pui.FlowIterationListener(frequency=1)
        pl.iteration_done(net, 0, 1.0)
        layers = pl.storage.latest("flow")["layers"]
        by = {l["name"]: l for l in layers}
        assert by["d"]["n_params"] == 25 and by["d"]["inputs"] == ["in"]
        assert by["out"]["n_params"] == 18

    def test_convolutional_payload_of_lenet(self):
        from deeplearning4j_tpu.models.lenet import build_lenet5 as jbuild

        jnet = jbuild(seed=5)
        pnet = _port_twin(jnet, (28, 28, 1))
        x = np.random.default_rng(1).random((2, 28, 28, 1)).astype(
            np.float32)
        jl = jui.ConvolutionalIterationListener(frequency=1, max_channels=3)
        pl = pui.ConvolutionalIterationListener(frequency=1, max_channels=3)
        pl.iteration_done(pnet, 0, 1.0)  # no input yet: nothing posted
        assert pl.storage.latest("activations") is None
        jl.set_input(x)
        pl.set_input(torch.from_numpy(x))
        jl.iteration_done(jnet, 0, 1.0)
        pl.iteration_done(pnet, 0, 1.0)
        jg = jl.storage.latest("activations")["grids"]
        pg = pl.storage.latest("activations")["grids"]
        assert list(pg) == list(jg) and len(pg) >= 9
        for k in jg:
            a, b = np.asarray(pg[k]), np.asarray(jg[k])
            assert a.shape == b.shape and np.isfinite(a).all()
            assert np.abs(a - b).max() <= 2e-4, k

    def test_listener_posts_to_the_server(self):
        server = pui.UiServer(port=0, device="cpu").start()
        try:
            pnet = _port_twin(_jax_net())
            pnet.set_listeners(pui.HistogramIterationListener(
                frequency=1, server_url=server.url),
                pui.FlowIterationListener(frequency=1,
                                          server_url=server.url))
            x, y = _data(8)
            pnet.fit(x, y)
            summary = json.loads(_req(server.url, "/train/summary")[2])
            assert {"histogram", "score", "flow"} <= set(summary)
            page = _req(server.url, "/")[2].decode()
            assert "<svg" in page and "Network topology" in page
        finally:
            server.stop()

    def test_post_failure_does_not_stop_training(self):
        pnet = _port_twin(_jax_net())
        lst = pui.HistogramIterationListener(
            frequency=1, server_url="http://127.0.0.1:9")
        pnet.set_listeners(lst)
        x, y = _data(8)
        pnet.fit(x, y)
        assert lst.storage is None

    def test_storage_is_bounded(self):
        s = pui.HistoryStorage(max_items_per_key=3)
        for i in range(5):
            s.put("k", i)
        assert s.get("k") == [2, 3, 4] and s.latest("k") == 4
        assert s.keys() == ["k"] and s.latest("none") is None
