"""The port's MultiLayerNetwork training path against the JAX package, on
the CPU.

Both packages start from the same weights (JAX init, then
``params_from_numpy``) and see the same batches, made from a seed with
numpy. Where both run it, the comparison is in f64 (the JAX package's
gradient-check mode: its params cast to f64, x64 enabled by
``tests/conftest.py``), at 1e-10 abs on every loss, parameter and updater
state leaf — except Adam, whose bias correction both packages compute in
f32 with their own ``pow`` (XLA's and the C library's differ by up to an
ulp, which ``1 - b2**t`` amplifies): 1e-5 there. Checkpoints are f32, as
the zips hold them; continued f32 training after a cross-package load is
held at 1e-5 abs (the same f32 math, summed in another order).

  * ``fit`` of the char-RNN (``char_rnn_conf(6, lstm_size=8,
    num_layers=2, tbptt_length=8)``, batch 3, T=24: three windows per
    fit, each with T >= 8 so the LSTM layers run through ``LstmScanFn``),
    five fits for each of the 7 updaters: the loss of every window, the
    final params and the updater state.
  * Routing: an unmasked fit raises the plain K1 (with the cell sequence)
    and plain K2 counters by exactly layers x windows; a masked fit runs
    the per-step loop and moves neither.
  * TBPTT with ``tbptt_back_length`` < ``tbptt_fwd_length`` (the first
    steps of a window get no gradient), unmasked and masked.
  * ``fit_iterator`` over a ragged ``ListDataSetIterator`` (the tail
    padded to its bucket, pad rows masked out of the loss) and
    ``fit_batches`` == K serial fits; ``score``.
  * Checkpoints: a port zip restored by the JAX package gives the same
    ``output``, updater state and iteration; a JAX zip written after 2
    fits, loaded by the port, trains on in step with the JAX net; port
    against port, fit 4 == fit 2, save, load, fit 2, bit for bit, with
    dropout on.
  * ``CharRnn.fit_text``: the same losses as the JAX package's.
  * What once raised as not ported runs: the Solver, pretraining, remat.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.models import char_rnn as pcr  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.common import tbptt_backprop_window  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pL  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
    updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm  # noqa: E402
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

V, HID, B, T = 6, 8, 3, 24
UPDATERS = ["sgd", "none", "nesterovs", "adagrad", "rmsprop", "adadelta",
            "adam"]
TOL_F64 = 1e-10
TOL_ADAM = 1e-5
TOL_F32 = 1e-5


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _to_port(jnet, pnet, dtype=np.float64):
    """The JAX net's params, in ``dtype``, into the port net, with a
    fresh updater state of that dtype."""
    pnet.params = [{k: torch.from_numpy(np.array(v, dtype))
                    for k, v in p.items()} for p in jnet.params]
    pnet.updater_state = pnet.updater.init(pnet.params)


def _char_pair(updater="rmsprop", f64=True, **kw):
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    kw = dict(lstm_size=HID, num_layers=2, tbptt_length=8, updater=updater,
              **kw)
    jnet = JNet(char_rnn_conf(V, **kw)).init(input_shape=(1, V))
    pnet = MultiLayerNetwork(pcr.char_rnn_conf(V, **kw), device="cpu")
    pnet.init(input_shape=(1, V))
    if f64:
        jnet.params = _f64(jnet.params)
        jnet.updater_state = jnet.updater.init(jnet.params)
    _to_port(jnet, pnet, np.float64 if f64 else np.float32)
    return jnet, pnet


def _batches(seed, k, t=T, n=B, dtype=np.float64):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=dtype)
    out = []
    for _ in range(k):
        ids = rng.integers(0, V, (n, t + 1))
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _collect(net):
    from deeplearning4j_tpu.optimize.listeners import (
        CollectScoresIterationListener as JCollect,
    )

    col = (JCollect() if not isinstance(net, MultiLayerNetwork)
           else CollectScoresIterationListener())
    net.set_listeners(col)
    return col


def _flat_tree(tree, prefix=""):
    """(path, numpy array) for every leaf of nested lists/dicts."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flat_tree(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _flat_tree(v, f"{prefix}[{i}]")
    else:
        a = tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree
        out.append((prefix, np.asarray(a)))
    return out


def _assert_trees_close(jtree, ptree, tol, what):
    jflat, pflat = _flat_tree(jtree), _flat_tree(ptree)
    assert [k for k, _ in jflat] == [k for k, _ in pflat], what
    for (k, a), (_, b) in zip(jflat, pflat):
        assert a.shape == b.shape, f"{what}{k}"
        err = float(np.abs(a.astype(np.float64) - b.astype(np.float64))
                    .max()) if a.size else 0.0
        assert err <= tol, f"{what}{k}: {err}"


class TestFitAgainstJax:
    @pytest.mark.parametrize("updater", UPDATERS)
    def test_char_rnn_tbptt_fit(self, updater):
        jnet, pnet = _char_pair(updater)
        jcol, pcol = _collect(jnet), _collect(pnet)
        for x, y in _batches(1, 5):
            jloss = jnet.fit(x, y)
            ploss = pnet.fit(x, y)
            assert ploss.dtype == torch.float64
        tol = TOL_ADAM if updater == "adam" else TOL_F64
        assert len(pcol.scores) == len(jcol.scores) == 15  # 5 fits x 3
        for (ji, js), (pi, ps) in zip(jcol.scores, pcol.scores):
            assert ji == pi and abs(js - ps) < tol
        assert abs(float(jloss) - float(ploss)) < tol
        assert pnet.iteration == jnet.iteration == 15
        _assert_trees_close(jnet.params, pnet.params, tol, "params")
        _assert_trees_close(jnet.updater_state, pnet.updater_state, tol,
                            "updater")
        _assert_trees_close(jnet.states, pnet.states, tol, "states")

    def test_routing_counts_plain_k1_and_k2_per_layer_and_window(self):
        _, pnet = _char_pair()
        x, y = _batches(2, 1)[0]
        fwd, bwd = (port_lstm.lstm_scan_plain.launches,
                    port_lstm.lstm_scan_bwd_plain.launches)
        kern = (port_lstm.lstm_scan.launches,
                port_lstm.lstm_scan_bwd.launches)
        pnet.fit(x, y)
        assert port_lstm.lstm_scan_plain.launches == fwd + 2 * 3
        assert port_lstm.lstm_scan_bwd_plain.launches == bwd + 2 * 3
        assert (port_lstm.lstm_scan.launches,
                port_lstm.lstm_scan_bwd.launches) == kern
        mask = np.ones((B, T))
        mask[0, 20:] = 0
        fwd, bwd = (port_lstm.lstm_scan_plain.launches,
                    port_lstm.lstm_scan_bwd_plain.launches)
        pnet.fit(x, y, mask)
        assert (port_lstm.lstm_scan_plain.launches,
                port_lstm.lstm_scan_bwd_plain.launches) == (fwd, bwd)

    @pytest.mark.parametrize("masked", [False, True])
    def test_tbptt_back_length_shorter_than_forward(self, masked):
        """fwd 16, back 8 over T=32: two windows; in each, 8 steps run
        with no gradient, then 8 with it."""
        from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
        from deeplearning4j_tpu.nn.conf import layers as jL
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

        def conf(builder, L):
            return (builder.builder().seed(5).learning_rate(0.1)
                    .updater("rmsprop").weight_init("xavier").list()
                    .layer(0, L.GravesLSTM(n_in=V, n_out=HID,
                                           activation="tanh"))
                    .layer(1, L.GravesLSTM(n_in=HID, n_out=HID,
                                           activation="tanh"))
                    .layer(2, L.RnnOutputLayer(n_in=HID, n_out=V,
                                               activation="softmax",
                                               loss_function="mcxent"))
                    .backprop_type("truncated_bptt")
                    .t_bptt_forward_length(16).t_bptt_backward_length(8)
                    .build())

        jnet = JNet(conf(JB, jL)).init(input_shape=(1, V))
        jnet.params = _f64(jnet.params)
        jnet.updater_state = jnet.updater.init(jnet.params)
        pnet = MultiLayerNetwork(conf(pconf.NeuralNetConfiguration, pL),
                                 device="cpu").init(input_shape=(1, V))
        _to_port(jnet, pnet)
        assert tbptt_backprop_window(pnet.conf) == 8
        jcol, pcol = _collect(jnet), _collect(pnet)
        counters = (port_lstm.lstm_scan_plain.launches,
                    port_lstm.lstm_scan_bwd_plain.launches)
        for i, (x, y) in enumerate(_batches(3, 2, t=32)):
            mask = None
            if masked:
                mask = np.ones((B, 32))
                mask[i, 25:] = 0
            jnet.fit(x, y, mask)
            pnet.fit(x, y, mask)
        after = (port_lstm.lstm_scan_plain.launches,
                 port_lstm.lstm_scan_bwd_plain.launches)
        if masked:  # the per-step loop, no kernel
            assert after == counters
        else:  # 2 fits x 2 windows x 2 layers, each: K1 twice (the no-grad
            # head and the tail), K2 once
            assert after == (counters[0] + 2 * 2 * 2 * 2,
                             counters[1] + 2 * 2 * 2)
        for (_, js), (_, ps) in zip(jcol.scores, pcol.scores):
            assert abs(js - ps) < TOL_F64
        _assert_trees_close(jnet.params, pnet.params, TOL_F64, "params")

    def test_fit_iterator_buckets_the_ragged_tail(self):
        """A dense MLP over a 10-row iterator in batches of 4: the tail of
        2 is padded to its bucket... of 2 (no pad), so use batches of 3:
        3, 3, 3, 1 -> the last stays 1; batches of 7: 7 -> 8, 3 -> 3."""
        from deeplearning4j_tpu.datasets.iterator import (
            ListDataSetIterator as JIter,
        )
        from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
        from deeplearning4j_tpu.nn.conf import layers as jL
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

        def conf(builder, L):
            return (builder.builder().seed(3).learning_rate(0.05)
                    .updater("adagrad").l2(1e-3).l1(1e-4).list()
                    .layer(0, L.DenseLayer(n_in=4, n_out=5,
                                           activation="tanh"))
                    .layer(1, L.OutputLayer(n_in=5, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"))
                    .build())

        jnet = JNet(conf(JB, jL)).init()
        jnet.params = _f64(jnet.params)
        jnet.updater_state = jnet.updater.init(jnet.params)
        pnet = MultiLayerNetwork(conf(pconf.NeuralNetConfiguration, pL),
                                 device="cpu").init()
        _to_port(jnet, pnet)
        rng = np.random.default_rng(8)
        x = rng.standard_normal((10, 4))
        y = np.eye(3)[rng.integers(0, 3, 10)]
        jnet.fit_iterator(JIter(x, y, batch=7), num_epochs=2)
        pnet.fit_iterator(ListDataSetIterator(x, y, batch=7), num_epochs=2)
        assert pnet.iteration == jnet.iteration == 4
        _assert_trees_close(jnet.params, pnet.params, TOL_F64, "params")
        assert abs(jnet.score(x, y) - pnet.score(x, y)) < TOL_F64

    def test_fit_batches_equals_serial_fits(self):
        def mlp():
            conf = (pconf.NeuralNetConfiguration.builder().seed(3)
                    .learning_rate(0.05).updater("adam").iterations(2).list()
                    .layer(0, pL.DenseLayer(n_in=4, n_out=5,
                                            activation="relu"))
                    .layer(1, pL.OutputLayer(n_in=5, n_out=3,
                                             activation="softmax"))
                    .build())
            return MultiLayerNetwork(conf, device="cpu").init()

        rng = np.random.default_rng(2)
        xs = rng.standard_normal((3, 6, 4)).astype(np.float32)
        ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 6))]
        a, b = mlp(), mlp()
        losses = a.fit_batches(xs, ys)
        col = _collect(b)
        for k in range(3):
            b.fit(xs[k], ys[k])
        assert losses.shape == (6,)
        np.testing.assert_array_equal(losses, [s for _, s in col.scores])
        for pa, pb in zip(a.params, b.params):
            for k in pa:
                assert torch.equal(pa[k], pb[k])


class TestCheckpoints:
    def test_port_zip_restores_in_jax(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet, pnet = _char_pair(f64=False)
        for x, y in _batches(4, 2, dtype=np.float32):
            pnet.fit(x, y)
        path = str(tmp_path / "port.zip")
        pser.write_model(pnet, path)
        restored = ModelSerializer.restore_multi_layer_network(path)
        assert restored.iteration == pnet.iteration == 6
        _assert_trees_close(restored.updater_state, pnet.updater_state, 0.0,
                            "updater")
        x = _batches(5, 1, dtype=np.float32)[0][0]
        ref = np.asarray(restored.output(jnp.asarray(x)))
        got = pnet.output(x).numpy()
        assert np.abs(got - ref).max() < TOL_F32

    def test_jax_zip_mid_training_resumes_in_the_port(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet, _ = _char_pair(f64=False)
        data = _batches(6, 5, dtype=np.float32)
        for x, y in data[:2]:
            jnet.fit(x, y)
        path = str(tmp_path / "jax.zip")
        ModelSerializer.write_model(jnet, path,
                                    training_state=jnet.training_state())
        pnet = MultiLayerNetwork.load(path, device="cpu")
        assert pnet.iteration == jnet.iteration == 6
        _assert_trees_close(jnet.updater_state, pnet.updater_state, 0.0,
                            "updater")
        jcol, pcol = _collect(jnet), _collect(pnet)
        for x, y in data[2:]:
            jnet.fit(x, y)
            pnet.fit(x, y)
        for (ji, js), (pi, ps) in zip(jcol.scores, pcol.scores):
            assert ji == pi and abs(js - ps) < TOL_F32
        _assert_trees_close(jnet.params, pnet.params, TOL_F32, "params")

    def test_load_without_the_updater_section(self, tmp_path):
        _, pnet = _char_pair(f64=False)
        pnet.fit(*_batches(7, 1, dtype=np.float32)[0])
        path = str(tmp_path / "p.zip")
        pser.write_model(pnet, path)
        fresh = MultiLayerNetwork.load(path, device="cpu",
                                       load_updater=False)
        assert all(float(v.abs().max()) == 0.0
                   for v in fresh.updater_state[0]["cache"].values())
        pser.write_model(pnet, path, save_updater=False)
        assert float(MultiLayerNetwork.load(path, device="cpu")
                     .updater_state[0]["cache"]["W"].abs().max()) == 0.0

    def test_updater_layout_mismatch_raises(self, tmp_path):
        import io
        import zipfile

        _, pnet = _char_pair(f64=False)
        path = str(tmp_path / "p.zip")
        pser.write_model(pnet, path)
        with zipfile.ZipFile(path) as z:
            parts = {n: z.read(n) for n in z.namelist()}
        with np.load(io.BytesIO(parts["updater.npz"])) as npz:
            arrays = {k: npz[k] for k in npz.files if "['U']" not in k}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        parts["updater.npz"] = buf.getvalue()
        cut = str(tmp_path / "cut.zip")
        with zipfile.ZipFile(cut, "w") as z:
            for n, b in parts.items():
                z.writestr(n, b)
        with pytest.raises(ValueError, match="updater"):
            MultiLayerNetwork.load(cut, device="cpu")

    def test_exact_resume_port_against_port_with_dropout(self, tmp_path):
        """fit 4 == fit 2, save, load, fit 2, bit for bit: dropout on every
        layer, its streams fixed by (seed, iteration, layer)."""
        def net():
            conf = (pconf.NeuralNetConfiguration.builder().seed(11)
                    .learning_rate(0.1).updater("rmsprop").drop_out(0.3)
                    .weight_init("xavier").list()
                    .layer(0, pL.GravesLSTM(n_in=V, n_out=HID,
                                            activation="tanh"))
                    .layer(1, pL.RnnOutputLayer(n_in=HID, n_out=V,
                                                activation="softmax",
                                                loss_function="mcxent"))
                    .backprop_type("truncated_bptt")
                    .t_bptt_forward_length(8).t_bptt_backward_length(8)
                    .build())
            return MultiLayerNetwork(conf, device="cpu").init(
                input_shape=(1, V))

        data = _batches(9, 4, dtype=np.float32)
        a = net()
        for x, y in data:
            a.fit(x, y)
        b = net()
        for x, y in data[:2]:
            b.fit(x, y)
        path = str(tmp_path / "half.zip")
        pser.write_model(b, path)
        c = MultiLayerNetwork.load(path, device="cpu")
        for x, y in data[2:]:
            c.fit(x, y)
        assert c.iteration == a.iteration == 12
        for pa, pc in zip(a.params, c.params):
            for k in pa:
                assert torch.equal(pa[k], pc[k]), k
        _assert_trees_close(a.updater_state, c.updater_state, 0.0, "updater")
        # dropout was on: another seed gives other params
        d = net()
        d.conf.seed = 12
        for x, y in data:
            d.fit(x, y)
        assert not torch.equal(a.params[0]["W"], d.params[0]["W"])

    def test_updater_state_from_numpy_is_bit_for_bit(self):
        jnet, _ = _char_pair(f64=False)
        jnet.fit(*_batches(10, 1, dtype=np.float32)[0])
        got = updater_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jnet.updater_state),
            device="cpu")
        _assert_trees_close(jnet.updater_state, got, 0.0, "updater")


def test_char_rnn_fit_text_matches_jax():
    """In f32: ``fit_text`` feeds f32 one-hot batches, which the JAX LSTM
    scan does not take beside f64 params."""
    from deeplearning4j_tpu.models.char_rnn import CharRnn as JCharRnn

    text = ("the quick brown fox jumps over the lazy dog. " * 12)
    kw = dict(lstm_size=HID, num_layers=2, tbptt_length=8)
    jc = JCharRnn(text, **kw)
    pc = pcr.CharRnn(text, device="cpu", **kw)
    _to_port(jc.net, pc.net, np.float32)
    jl = jc.fit_text(text, batch=4, seq_len=16)
    pl = pc.fit_text(text, batch=4, seq_len=16)
    assert len(jl) == len(pl) == 8
    assert np.abs(np.asarray(jl) - np.asarray(pl)).max() < TOL_F32
    batches = list(pc.batches(text, 4, 16))
    assert batches[0][0].shape == (4, 16, pc.vocab_size)
    assert np.array_equal(batches[0][0][:, 1:], batches[0][1][:, :-1])


class TestNotPortedRaises:
    """What once raised as not ported: the Solver and pretraining now run
    (their equivalence with the JAX package is in
    tests/test_torch_solvers.py and tests/test_torch_layer_zoo.py)."""

    def test_solver_algorithms(self):
        conf = (pconf.NeuralNetConfiguration.builder()
                .optimization_algo("lbfgs").iterations(3).list()
                .layer(0, pL.OutputLayer(n_in=2, n_out=2)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        x = np.array([[1, 0], [0, 1]], np.float32)
        y = np.eye(2, dtype=np.float32)
        before = net.score(x, y)
        loss = net.fit(x, y)
        assert float(loss) < before and net.iteration >= 1
        with pytest.raises(ValueError, match="SGD-family"):
            net.fit_batches(x[None], y[None])

    def test_pretrain(self):
        """A pretrain conf with no AutoEncoder or RBM pretrains nothing
        and fits as before; one with an AutoEncoder moves its weights
        before the fit."""
        conf = (pconf.NeuralNetConfiguration.builder().list()
                .layer(0, pL.OutputLayer(n_in=2, n_out=2)).pretrain(True)
                .build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        it = ListDataSetIterator(np.zeros((2, 2)), np.eye(2), batch=2)
        net.fit_iterator(it)
        assert net.iteration == 1
        conf = (pconf.NeuralNetConfiguration.builder().seed(4).list()
                .layer(0, pL.AutoEncoder(n_in=2, n_out=3,
                                         activation="sigmoid"))
                .layer(1, pL.OutputLayer(n_in=3, n_out=2)).pretrain(True)
                .build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        w0 = net.params[0]["W"].clone()
        net.pretrain(np.full((2, 2), 0.5, np.float32))
        assert net.iteration == 0
        assert not torch.equal(w0, net.params[0]["W"])

    def test_remat(self, monkeypatch):
        """Remat, once refused here, now trains: under DL4J_TPU_REMAT
        dots and block, and under conf.gradient_checkpointing, three f64
        fits (with dropout, replayed in the recompute) give the params of
        the same fits without remat within 1e-10, and an unknown policy
        raises."""
        rng = np.random.default_rng(0)
        x = rng.standard_normal((6, 4))
        y = np.eye(3)[rng.integers(0, 3, 6)]

        def fitted(policy, checkpointing=False):
            monkeypatch.setenv("DL4J_TPU_REMAT", policy)
            conf = (pconf.NeuralNetConfiguration.builder().seed(3)
                    .drop_out(0.5).list()
                    .layer(0, pL.DenseLayer(n_in=4, n_out=5,
                                            activation="tanh"))
                    .layer(1, pL.OutputLayer(n_in=5, n_out=3)).build())
            conf.gradient_checkpointing = checkpointing
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.params = [{k: v.double() for k, v in p.items()}
                          for p in net.params]
            net.updater_state = net.updater.init(net.params)
            for _ in range(3):
                net.fit(x, y)
            return _flat_tree(net.params)

        want = fitted("none")
        for got in (fitted("dots"), fitted("block"), fitted("none", True)):
            for (ka, a), (kb, b) in zip(got, want):
                assert ka == kb
                assert np.abs(a - b).max() <= TOL_F64, ka
        monkeypatch.setenv("DL4J_TPU_REMAT", "sideways")
        with pytest.raises(ValueError, match="remat"):
            fitted("sideways")


def test_feed_forward_train_draws_the_iteration_stream():
    conf = (pconf.NeuralNetConfiguration.builder().seed(4).drop_out(0.5)
            .list()
            .layer(0, pL.DenseLayer(n_in=6, n_out=6, activation="identity"))
            .layer(1, pL.OutputLayer(n_in=6, n_out=2)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.ones((4, 6), np.float32)
    a = net.feed_forward(x, train=True)[1]
    b = net.feed_forward(x, train=True)[1]
    assert torch.equal(a, b)
    net.iteration += 1
    assert not torch.equal(a, net.feed_forward(x, train=True)[1])
    assert torch.equal(net.feed_forward(x)[1], net.feed_forward(x)[1])
