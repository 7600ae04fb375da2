"""Rules of the PyTorch port as a package.

  * It never imports ``jax`` and nothing of ``deeplearning4j_tpu``: every
    module imports in a fresh interpreter with ``jax`` absent from
    ``sys.modules`` afterwards, and no ``import`` statement in the
    package, in ``chip_smoke.py`` or in the kernel timing scripts
    (``scripts/time_k*.py``) names either.
  * Its entry points (``TransformerLM`` and its ``ring_forward`` and
    sequence mode, ``BertMLM``, ``BertClassifier`` and their ``load``,
    ``PagedDecoder``, the decode planes (``ContinuousDecoder``,
    ``SpeculativeDecoder``, ``draft_lm``), ``MultiLayerNetwork`` and its
    ``load`` (a MultiHeadAttention network too), ``ComputationGraph``,
    ``build_resnet50``, ``build_googlenet`` and ``restore`` of a graph
    zip, ``ServingEngine`` (with
    no model, and over a quantized zip), ``/search``'s ``VectorStore``
    and ``KMeansClustering``, and
    the training
    ones: ``fit``, ``fit_iterator``, ``CharRnn.fit_text`` and
    ``load`` with the updater section; ``Word2Vec``, ``load_word2vec``
    and ``Word2Vec.from_arrays``) run on the card unless given
    ``device="cpu"``; with no card they raise instead of moving to the
    CPU. ``MetricsExporter`` is host-only and serves with no card.
  * Its knob table is a copy of the JAX table's entries the ported paths
    read (same names, same defaults), and it builds its kernels from
    ``csrc/``.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")


def _modules():
    out = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 20
    # the serving planes' subpackages are walked too
    assert {"deeplearning4j_tpu_torch.etl.normalize",
            "deeplearning4j_tpu_torch.etl.calibrate",
            "deeplearning4j_tpu_torch.obs.registry",
            "deeplearning4j_tpu_torch.streaming.conversion",
            "deeplearning4j_tpu_torch.nn.conf.graph",
            "deeplearning4j_tpu_torch.nn.graph",
            "deeplearning4j_tpu_torch.models.resnet",
            "deeplearning4j_tpu_torch.models.googlenet",
            "deeplearning4j_tpu_torch.retrieval",
            "deeplearning4j_tpu_torch.retrieval.embed",
            "deeplearning4j_tpu_torch.retrieval.stats",
            "deeplearning4j_tpu_torch.retrieval.index",
            "deeplearning4j_tpu_torch.retrieval.store",
            "deeplearning4j_tpu_torch.obs.trace",
            "deeplearning4j_tpu_torch.obs.journal",
            "deeplearning4j_tpu_torch.obs.exporter",
            "deeplearning4j_tpu_torch.clustering",
            "deeplearning4j_tpu_torch.clustering.cluster",
            "deeplearning4j_tpu_torch.clustering.kmeans",
            "deeplearning4j_tpu_torch.online",
            "deeplearning4j_tpu_torch.online.stats",
            "deeplearning4j_tpu_torch.online.drift",
            "deeplearning4j_tpu_torch.online.stream"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'deeplearning4j_tpu' "
            "or m.startswith('deeplearning4j_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    + [os.path.join(REPO, "scripts", f)
       for f in os.listdir(os.path.join(REPO, "scripts"))
       if f.startswith("time_k") and f.endswith(".py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "deeplearning4j_tpu"), \
            f"{path} imports {name}"


class TestEntryPointsNeedACardOrCpu:
    @pytest.fixture
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_transformer_lm(self, no_card):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )

        cfg = TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_len=32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(cfg, device="cuda")
        assert TransformerLM(cfg, device="cpu").params["embed"].device \
            == torch.device("cpu")

    def test_decoder_and_engine(self, no_card):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.paged import PagedDecoder

        lm = TransformerLM(TransformerConfig(
            vocab_size=16, d_model=16, n_layers=1, n_heads=2, d_ff=32,
            max_len=32), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedDecoder(lm, n_blocks=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(lm, kv_blocks=8)
        eng = ServingEngine(lm, device="cpu")
        try:  # the arena auto-sizes from the host's memory on the CPU
            assert eng.decoder.n_blocks == 4096
        finally:
            eng.stop()

    def test_cnn_models_pretraining_and_solver(self, no_card):
        """``build_lenet5``, the other CNN and pretraining builders, and a
        network under the Solver raise with no card unless given the CPU;
        on the CPU a LeNet-5 step and an LBFGS fit run there."""
        import numpy as np

        from deeplearning4j_tpu_torch.models.alexnet import build_alexnet
        from deeplearning4j_tpu_torch.models.dbn import (
            build_dbn,
            build_stacked_autoencoder,
        )
        from deeplearning4j_tpu_torch.models.lenet import build_lenet5
        from deeplearning4j_tpu_torch.models.vgg import build_vgg16
        from deeplearning4j_tpu_torch.nn import conf as pconf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.optimize.solvers import Solver

        for build in (build_lenet5, build_alexnet, build_vgg16, build_dbn,
                      build_stacked_autoencoder):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
        conf = (pconf.NeuralNetConfiguration.builder()
                .optimization_algo("lbfgs").list()
                .layer(0, pconf.OutputLayer(n_in=3, n_out=2)).build())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Solver(MultiLayerNetwork(conf))
        net = build_lenet5(device="cpu")
        x = np.zeros((2, 28, 28, 1), np.float32)
        y = np.eye(10, dtype=np.float32)[[1, 2]]
        assert net.fit(x, y).device == torch.device("cpu")
        solved = MultiLayerNetwork(conf, device="cpu").init()
        Solver(solved).optimize(np.ones((2, 3), np.float32),
                                np.eye(2, dtype=np.float32))
        assert solved.params[0]["W"].device == torch.device("cpu")

    def test_decode_planes(self, no_card, monkeypatch):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from deeplearning4j_tpu_torch.ops.lowprec import draft_lm
        from deeplearning4j_tpu_torch.serving.decode import (
            ContinuousDecoder,
        )
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.speculate import (
            SpeculativeDecoder,
        )

        lm = TransformerLM(TransformerConfig(
            vocab_size=16, d_model=16, n_layers=2, n_heads=2, d_ff=32,
            max_len=32), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousDecoder(lm, slots=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            draft_lm(lm, "int8")
        draft = draft_lm(lm, "layers:1", device="cpu")
        assert draft.params["embed"].device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpeculativeDecoder(lm, draft=draft, n_blocks=8)
        ContinuousDecoder(lm, slots=2, device="cpu").stop()
        SpeculativeDecoder(lm, draft=draft, n_blocks=8, device="cpu").stop()
        # the engine's new decoders: fixed-slot and speculative
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(lm, kv_block=0)
        monkeypatch.setenv("DL4J_TPU_SERVE_SPEC", "layers:1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(lm, kv_blocks=8)
        for kw in (dict(kv_block=0), dict(kv_blocks=8)):
            eng = ServingEngine(lm, device="cpu", **kw)
            try:
                assert isinstance(eng.decoder, (ContinuousDecoder,
                                                SpeculativeDecoder))
            finally:
                eng.stop()


    def test_serving_planes(self, no_card, tmp_path):
        import numpy as np

        from deeplearning4j_tpu_torch.etl.calibrate import QuantCalibrator
        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops import lowprec
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.utils.serialization import write_model

        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine()
        net = MultiLayerNetwork(char_rnn_conf(6, lstm_size=4, num_layers=1),
                                device="cpu").init()
        spec = QuantCalibrator().fit(net, np.eye(6, dtype=np.float32)[
            np.zeros((2, 8), np.int64)]).spec(net)
        path = str(tmp_path / "q.zip")
        write_model(net, path, quant=spec)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model_path=path)
        eng = ServingEngine(model_path=path, device="cpu")
        try:
            model = eng.registry.get().model
            assert isinstance(model, lowprec.QuantizedNet)
            assert model.device == torch.device("cpu")
        finally:
            eng.stop()

    def test_multilayer_network_and_its_engine(self, no_card, tmp_path):
        from deeplearning4j_tpu.models.char_rnn import (
            char_rnn_conf as jax_conf,
        )
        from deeplearning4j_tpu.nn.multilayer import (
            MultiLayerNetwork as JaxNet,
        )
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        conf = char_rnn_conf(6, lstm_size=4, num_layers=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork(conf)
        jnet = JaxNet(jax_conf(6, lstm_size=4, num_layers=1)).init()
        path = str(tmp_path / "net.zip")
        ModelSerializer.write_model(jnet, path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork.load(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model_path=path)
        net = MultiLayerNetwork.load(path, device="cpu")
        assert net.params[0]["W"].device == torch.device("cpu")
        ServingEngine(model=net, device="cpu").stop()

    def test_training_entry_points(self, no_card, tmp_path):
        import numpy as np

        from deeplearning4j_tpu.models.char_rnn import CharRnn as JaxCharRnn
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        from deeplearning4j_tpu_torch.datasets.iterator import (
            ListDataSetIterator,
        )
        from deeplearning4j_tpu_torch.models.char_rnn import CharRnn
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        text = "abcab" * 20
        kw = dict(lstm_size=4, num_layers=1, tbptt_length=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CharRnn(text, **kw)
        cr = CharRnn(text, device="cpu", **kw)
        assert len(cr.fit_text(text, batch=2, seq_len=8)) == 6
        x, y = next(cr.batches(text, 2, 8))
        assert float(cr.net.fit(x, y)) > 0
        cr.net.fit_iterator(ListDataSetIterator(x, y, batch=1))
        cache = cr.net.updater_state[0]["cache"]["W"]
        assert cache.device == torch.device("cpu")
        assert float(cache.abs().max()) > 0
        jc = JaxCharRnn(text, **kw)
        jc.fit_text(text, batch=2, seq_len=8)
        path = str(tmp_path / "trained.zip")
        ModelSerializer.write_model(jc.net, path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork.load(path)
        net = MultiLayerNetwork.load(path, device="cpu")
        np.testing.assert_array_equal(
            net.updater_state[0]["cache"]["W"].numpy(),
            np.asarray(jc.net.updater_state[0]["cache"]["W"]))


    def test_ring_forward_and_attention_network(self, no_card, tmp_path):
        import numpy as np

        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
            ring_forward,
        )
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.conf import layers as L
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.parallel.mesh import init_seq_group
        from deeplearning4j_tpu_torch.utils.serialization import write_model

        cfg = TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_len=32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransformerLM(cfg)
        lm = TransformerLM(cfg, device="cpu")
        import torch.distributed as dist

        group = init_seq_group(str(tmp_path / "store"), 0, 1)
        try:
            assert dist.get_backend(group) == "gloo"  # no card: gloo
            toks = torch.randint(0, 16, (1, 24))
            got = ring_forward(lm.compute_params, toks, cfg, group)
            assert got.device == torch.device("cpu")
            assert torch.allclose(got, lm.logits(toks), atol=1e-5)
        finally:
            dist.destroy_process_group()
        conf = (NeuralNetConfiguration.builder().list()
                .layer(0, L.MultiHeadAttention(n_in=4, n_out=8, num_heads=2))
                .layer(1, L.RnnOutputLayer(n_in=8, n_out=3,
                                           activation="softmax"))
                .build())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork(conf)
        net = MultiLayerNetwork(conf, device="cpu").init()
        path = str(tmp_path / "mha.zip")
        write_model(net, path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork.load(path)
        x = np.ones((2, 5, 4), np.float32)
        loaded = MultiLayerNetwork.load(path, device="cpu")
        assert loaded.params[0]["Wq"].device == torch.device("cpu")
        assert torch.equal(loaded.output(x), net.output(x))

    def test_bert_entry_points(self, no_card, tmp_path):
        import numpy as np

        from deeplearning4j_tpu_torch.models.bert import (
            BertClassifier,
            BertConfig,
            BertMLM,
            init_classifier_head,
            init_params,
        )

        cfg = BertConfig(vocab_size=16, d_model=16, n_layers=1, n_heads=2,
                         d_ff=32, max_len=8, mask_token_id=15)
        for make in (lambda: BertMLM(cfg), lambda: init_params(cfg),
                     lambda: init_classifier_head(cfg, 2)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        mlm = BertMLM(cfg, device="cpu")
        assert mlm.params["embed"].device == torch.device("cpu")
        ids = np.array([[1, 2, 3, 0], [4, 5, 6, 7]])
        mlm.fit(ids)
        path = str(tmp_path / "mlm.zip")
        mlm.save(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertMLM.load(path)
        assert np.array_equal(BertMLM.load(path, device="cpu")
                              .embed_tokens(ids), mlm.embed_tokens(ids))
        clf = BertClassifier(mlm, 2)
        clf.fit(ids, np.array([0, 1]))
        path = str(tmp_path / "clf.zip")
        clf.save(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BertClassifier.load(path)
        assert np.array_equal(BertClassifier.load(path, device="cpu")
                              .predict(ids), clf.predict(ids))

    def test_sequence_mode_transformer_lm(self, no_card, tmp_path):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from deeplearning4j_tpu_torch.parallel.mesh import init_seq_group
        import torch.distributed as dist

        cfg = TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_len=16)
        group = init_seq_group(str(tmp_path / "store"), 0, 1)
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TransformerLM(cfg, group=group)
            lm = TransformerLM(cfg, device="cpu", group=group)
            toks = torch.randint(0, 16, (2, 17))
            loss = lm.fit(toks[:, :-1], toks[:, 1:])
            assert loss.device == torch.device("cpu") and lm.iteration == 1
        finally:
            dist.destroy_process_group()

    def test_word2vec_entry_points(self, no_card, tmp_path):
        import numpy as np

        from deeplearning4j_tpu.nlp.serializer import save_word2vec as jsave
        from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxWord2Vec

        from deeplearning4j_tpu_torch.nlp import Word2Vec, load_word2vec

        toks = [["a", "b", "c", "a"], ["b", "a", "d"]]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Word2Vec(layer_size=4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Word2Vec(layer_size=4, device="cuda")
        m = Word2Vec(layer_size=4, negative=2, device="cpu").fit_tokens(toks)
        assert m.device == torch.device("cpu")
        assert np.isfinite(m.lookup_table.syn1neg).all()
        j = JaxWord2Vec(layer_size=4, negative=2).fit_tokens(toks)
        path = str(tmp_path / "w2v.zip")
        jsave(j, path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_word2vec(path)
        rows = [{"word": w.word, "count": w.count, "codes": w.codes,
                 "points": w.points} for w in j.vocab.vocab_words()]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Word2Vec.from_arrays(m.config(), rows,
                                 {"syn0": j.lookup_table.syn0,
                                  "syn1": j.lookup_table.syn1})
        assert load_word2vec(path, device="cpu").device == \
            torch.device("cpu")

    def test_computation_graph_models_and_embed(self, no_card, tmp_path):
        """The graph, its model builders and ``restore`` of a graph zip
        raise with no card unless given the CPU; on the CPU a graph fits,
        round-trips a zip and answers ``/embed``."""
        import numpy as np

        from deeplearning4j_tpu_torch.models.googlenet import build_googlenet
        from deeplearning4j_tpu_torch.models.resnet import build_resnet50
        from deeplearning4j_tpu_torch.nn import conf as pconf
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.utils.serialization import (
            restore,
            write_model,
        )

        conf = (pconf.NeuralNetConfiguration.builder().graph_builder()
                .add_inputs("in")
                .add_layer("d", pconf.DenseLayer(n_in=3, n_out=4), "in")
                .add_layer("out", pconf.OutputLayer(n_in=4, n_out=2), "d")
                .set_outputs("out").build())
        for make in (lambda: ComputationGraph(conf), build_resnet50,
                     build_googlenet):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        net = ComputationGraph(conf, device="cpu").init()
        x = np.ones((2, 3), np.float32)
        assert net.fit(x, np.eye(2, dtype=np.float32)).device \
            == torch.device("cpu")
        path = str(tmp_path / "g.zip")
        write_model(net, path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore(path)
        back = restore(path, device="cpu")
        assert back.params["d"]["W"].device == torch.device("cpu")
        eng = ServingEngine(model=back, device="cpu")
        try:
            assert eng.embed(x).shape == (2, 4)
        finally:
            eng.stop()

    def test_search_entry_points(self, no_card):
        """``VectorStore`` and ``KMeansClustering`` raise with no card
        unless given the CPU, and run there; the ``MetricsExporter`` is
        host-only and serves its four endpoints with no card."""
        import json
        import urllib.request

        import numpy as np

        from deeplearning4j_tpu_torch.clustering import KMeansClustering
        from deeplearning4j_tpu_torch.obs import MetricsExporter
        from deeplearning4j_tpu_torch.retrieval import VectorStore

        with pytest.raises(RuntimeError, match="device='cpu'"):
            VectorStore(4, capacity=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KMeansClustering(2)
        store = VectorStore(4, capacity=8, kind="exact", device="cpu")
        store.upsert([1, 2], np.eye(4, dtype=np.float32)[:2])
        snap = store.publish()
        assert snap.vecs.device == torch.device("cpu")
        ids, _ = store.search(np.eye(4, dtype=np.float32)[:1], k=1)
        assert ids[0][0] == 1
        km = KMeansClustering(2, device="cpu").fit(np.eye(4)[:3])
        assert km.device_centers.device == torch.device("cpu")
        exp = MetricsExporter().start()
        try:
            for path in ("/metrics", "/metrics.json", "/journal", "/health"):
                with urllib.request.urlopen(exp.url + path, timeout=10) as r:
                    assert r.status == 200, path
            with urllib.request.urlopen(exp.url + "/health",
                                        timeout=10) as r:
                assert json.loads(r.read()) == {"ok": True}
        finally:
            exp.stop()


def test_knob_table_copies_the_jax_entries(monkeypatch):
    from deeplearning4j_tpu.ops import env as jenv

    from deeplearning4j_tpu_torch.ops import env as penv

    assert set(penv.KNOBS) == {
        "DL4J_TPU_SERVE_KV_BLOCK", "DL4J_TPU_SERVE_KV_BLOCKS",
        "DL4J_TPU_SERVE_SLOTS", "DL4J_TPU_SERVE_QUEUE_CAP",
        "DL4J_TPU_SERVE_TIMEOUT_S", "DL4J_TPU_SERVE_MAX_BATCH",
        "DL4J_TPU_SERVE_MAX_WAIT_MS", "DL4J_TPU_SERVE_BATCH",
        "DL4J_TPU_BUCKET_BATCHES", "DL4J_TPU_REMAT", "DL4J_TPU_BF16",
        "DL4J_TPU_LOSS_SCALE", "DL4J_TPU_SERVE_TICK_K",
        "DL4J_TPU_SERVE_SPEC", "DL4J_TPU_SERVE_SPEC_K",
        "DL4J_TPU_SERVE_KV_DTYPE", "DL4J_TPU_QUANT",
        "DL4J_TPU_QUANT_MAX_DELTA", "DL4J_TPU_SERVE_CONTINUOUS",
        "DL4J_TPU_SERVE_BREAKER_FAILS", "DL4J_TPU_SERVE_WATCHDOG_S",
        "DL4J_TPU_SERVE_DRAIN_S", "DL4J_TPU_SERVE_SLO_CLASSES",
        "DL4J_TPU_SERVE_TENANT_QUOTAS", "DL4J_TPU_DATA_DIR",
        "DL4J_TPU_EMBED_LAYER", "DL4J_TPU_EMBED_POOL",
        # /search, the obs plane and the online feed
        "DL4J_TPU_ANN_ROWS", "DL4J_TPU_ANN_CLUSTERS", "DL4J_TPU_ANN_NPROBE",
        "DL4J_TPU_OBS", "DL4J_TPU_OBS_SPANS", "DL4J_TPU_OBS_JOURNAL",
        "DL4J_TPU_OBS_JOURNAL_N", "DL4J_TPU_OBS_FLUSH_S",
        "DL4J_TPU_OBS_PORT", "DL4J_TPU_PROCESS_ID",
        "DL4J_TPU_ONLINE_WATERMARK", "DL4J_TPU_ONLINE_IDLE_S",
        "DL4J_TPU_ONLINE_DRIFT_Z", "DL4J_TPU_ONLINE_DRIFT_MIN"}
    for name, k in penv.KNOBS.items():
        assert k.default == jenv.KNOBS[name].default, name
        assert k.kind == jenv.KNOBS[name].kind, name
    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCK", "8")
    monkeypatch.setenv("DL4J_TPU_SERVE_TIMEOUT_S", "junk")
    assert penv.get_int("DL4J_TPU_SERVE_KV_BLOCK") == 8
    assert penv.get_float("DL4J_TPU_SERVE_TIMEOUT_S") == 60.0
    with pytest.raises(penv.KnobError):
        penv.raw("DL4J_TPU_SERVE_KV_BLOK")
    for v in ("", " ", "0", "off", "No", "1", "yes", "x"):
        monkeypatch.setenv("DL4J_TPU_BF16", v)
        assert penv.get_bool("DL4J_TPU_BF16") == \
            jenv.get_bool("DL4J_TPU_BF16"), v
    monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:2")
    assert penv.raw("DL4J_TPU_LOSS_SCALE") == "8:2"


def test_engine_reads_the_knobs(monkeypatch):
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCK", "8")
    monkeypatch.setenv("DL4J_TPU_SERVE_KV_BLOCKS", "11")
    monkeypatch.setenv("DL4J_TPU_SERVE_SLOTS", "13")
    monkeypatch.setenv("DL4J_TPU_SERVE_QUEUE_CAP", "3")
    lm = TransformerLM(TransformerConfig(vocab_size=16, d_model=16,
                                         n_layers=1, n_heads=2, d_ff=32,
                                         max_len=32), device="cpu")
    eng = ServingEngine(lm, device="cpu", queue_capacity=5)
    try:
        d = eng.decoder
        assert (d.block_tokens, d.n_blocks, d.lanes, d.queue_cap) == \
            (8, 11, 13, 5)
        assert eng.request_timeout_s == 60.0
    finally:
        eng.stop()


def test_kernel_sources_ship_and_build_flags():
    from deeplearning4j_tpu_torch.ops import build

    for name in ("flash_attention", "paged_attention", "lstm_scan",
                 "lstm_scan_bwd", "sgns", "flash_bwd"):
        texts = [src.read_text() for src in build.sources(name)]
        assert all('extern "C"' in text for text in texts)
        assert any("cudaGetLastError" in text for text in texts)
        # plain C interface
        assert not any("torch/extension.h" in text for text in texts)
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "flash_attention_ext.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
