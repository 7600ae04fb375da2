"""The port's layer zoo, pretraining, gradient checks and evaluation
against the JAX package, on the CPU.

Inputs come from a numpy seed and params from the JAX init, carried over
by value; comparisons in f64 at 1e-10 abs unless they say otherwise.

  * Layers, forward and gradients: Embedding (an [N, 1] float index
    column and [N, T] integer indices), Activation, GRU and the
    bidirectional LSTM (with and without a mask; the GRU's TBPTT state
    and back window), the AutoEncoder's and the RBM's forward.
  * Networks: the Embedding -> GravesLSTM(tanh) -> RnnOutputLayer net
    (two fits; the plain K1 and K2 count one launch per fit, the net's
    only LSTM layer), a CNN zoo (conv, BN on NHWC, LRN, avg pooling,
    dense, BN on dense, Activation) and an RNN zoo (GRU, bidirectional
    LSTM with a mask): fits, states and ``output``; a GRU net's
    ``rnn_time_step``, step by step and as a block.
  * Pretraining, deterministic units: stacked AutoEncoders with
    ``corruption_level=0`` and RBMs with ``rectified`` hidden and
    ``linear`` visible units against the JAX package's ``pretrain`` and
    ``fit_iterator`` (pretrain, then fine-tune).
  * Binary and gaussian CD-k with injected draws: the port's
    ``cd_grads`` against the JAX package's with ``jax.random.bernoulli``
    and ``normal`` replaced by the same uniforms and normals (threefry and
    Philox give other bits); the port's seeded pretraining of a DBN is
    repeatable and lowers the reconstruction loss.
  * ``check_network_gradients`` passes on a net of each new layer and
    gives the JAX package's verdict.
  * ``Evaluation`` (top 1 and 3, masked time series, merge),
    ``RegressionEvaluation`` and ``ROC``: the same stats on the same
    arrays.
  * Zips both ways: the JAX package's DBN zip loads in the port and the
    port's in the JAX package; ``output`` in f32 within 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.eval import evaluation as peval  # noqa: E402
from deeplearning4j_tpu_torch.models import dbn as pdbn  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402
from deeplearning4j_tpu_torch.utils.gradient_check import (  # noqa: E402
    check_network_gradients,
)

from test_torch_cnn import (  # noqa: E402
    TOL,
    TOL_F32,
    assert_layer_matches,
    assert_nets_match,
    jax_net_f64,
    layer_pair,
    max_diff,
    port_twin,
)


def _L():
    from deeplearning4j_tpu.nn.conf import layers as L

    return L


def _builder(seed=3, updater="sgd", lr=0.05):
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration

    return (NeuralNetConfiguration.builder().seed(seed).learning_rate(lr)
            .updater(updater).momentum(0.9))


def _jnet(conf, input_shape):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    return jax_net_f64(JNet(conf).init(input_shape=input_shape))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class TestZooLayersAgainstJax:
    @pytest.mark.parametrize("col", [True, False])
    def test_embedding(self, col):
        jl, jp, js, pl, pp, ps = layer_pair(
            _L().EmbeddingLayer(n_in=11, n_out=6, activation="tanh"), (1,))
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 11, (5, 1) if col else (4, 7))
        x = idx.astype(np.float64) if col else idx
        g = rng.normal(size=idx.shape[:1 if col else 2] + (6,))

        def jloss(p):
            return jnp.sum(jl.apply(p, js, jnp.asarray(x))[0] * g)

        jy = np.asarray(jl.apply(jp, js, jnp.asarray(x))[0])
        jg = jax.grad(jloss)(jp)
        tp = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
        ty = pl.apply(tp, ps, torch.from_numpy(x))[0]
        tg = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                 list(tp.values()))
        assert max_diff(jy, ty.detach().numpy()) < TOL
        for k, t in zip(tp, tg):
            assert max_diff(np.asarray(jg[k]), t.numpy()) < TOL

    @pytest.mark.parametrize("act", ["elu", "relu", "softmax", "cube"])
    def test_activation(self, act):
        pair = layer_pair(_L().ActivationLayer(activation=act), (3, 5))
        x = np.random.default_rng(1).normal(size=(2, 3, 5))
        assert_layer_matches(*pair, x)

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("which", ["gru", "bilstm"])
    def test_recurrent(self, which, masked):
        L = _L()
        conf = (L.GRU(n_in=4, n_out=5, activation="tanh") if which == "gru"
                else L.GravesBidirectionalLSTM(n_in=4, n_out=5,
                                               activation="tanh"))
        pair = layer_pair(conf, (9, 4), perturb=("b", "p"))
        x = np.random.default_rng(2).normal(size=(3, 9, 4))
        mask = None
        if masked:
            mask = np.ones((3, 9))
            mask[0, 5:] = 0
            mask[2, 2:] = 0
        plain = port_lstm.lstm_scan_plain.launches
        assert_layer_matches(*pair, x, mask=mask)
        # neither runs the fused scan (JAX routes both to lax.scan)
        assert port_lstm.lstm_scan_plain.launches == plain

    def test_gru_carried_state_and_back_window(self):
        jl, jp, js, pl, pp, ps = layer_pair(
            _L().GRU(n_in=3, n_out=4, activation="tanh"), (6, 3))
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 6, 3))
        h = rng.normal(size=(2, 4))
        g = rng.normal(size=(2, 6, 4))

        def jloss(p):
            y, _ = jl.apply(p, {"h": jnp.asarray(h)}, jnp.asarray(x),
                            carry_state=True, backprop_window=2)
            return jnp.sum(y * g)

        jg = jax.grad(jloss)(jp)
        tp = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
        ty, st = pl.apply(tp, {"h": torch.from_numpy(h)},
                          torch.from_numpy(x), carry_state=True,
                          backprop_window=2)
        tg = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                 list(tp.values()))
        _, jst = jl.apply(jp, {"h": jnp.asarray(h)}, jnp.asarray(x),
                          carry_state=True)
        assert max_diff(np.asarray(jst["h"]), st["h"].detach().numpy()) < TOL
        for k, t in zip(tp, tg):
            assert max_diff(np.asarray(jg[k]), t.numpy()) < TOL

    @pytest.mark.parametrize("which", ["autoencoder", "rbm"])
    def test_pretrain_layers_forward(self, which):
        L = _L()
        conf = (L.AutoEncoder(n_in=6, n_out=4, activation="sigmoid",
                              corruption_level=0.0)
                if which == "autoencoder" else
                L.RBM(n_in=6, n_out=4, hidden_unit="binary"))
        pair = layer_pair(conf, (6,), perturb=("b", "vb"))
        x = np.random.default_rng(4).random((5, 6))
        assert_layer_matches(*pair, x)
        jl, jp, _, pl, pp, _ = pair
        ref = float(jl.pretrain_loss(jp, jnp.asarray(x),
                                     jax.random.PRNGKey(0)))
        got = float(pl.pretrain_loss(pp, torch.from_numpy(x),
                                     torch.Generator().manual_seed(0)))
        assert abs(ref - got) < TOL


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def embedding_lstm_conf(vocab, width, t, seed=5):
    """The Embedding -> GravesLSTM(tanh) -> RnnOutputLayer net; a reshape
    preprocessor gives the LSTM its [T, width] input shape at init."""
    from deeplearning4j_tpu.nn.conf.preprocessors import ReshapePreProcessor

    L = _L()
    return (_builder(seed, "rmsprop", 0.01).list()
            .layer(0, L.EmbeddingLayer(n_in=vocab, n_out=width,
                                       activation="identity"))
            .layer(1, L.GravesLSTM(n_in=width, n_out=width,
                                   activation="tanh"))
            .layer(2, L.RnnOutputLayer(n_in=width, n_out=vocab,
                                       activation="softmax",
                                       loss_function="mcxent"))
            .input_preprocessor(1, ReshapePreProcessor((t, width)))
            .build())


def cnn_zoo_conf(seed=6):
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )

    L = _L()
    return (_builder(seed, "nesterovs").list()
            .layer(0, L.ConvolutionLayer(n_in=2, n_out=4, kernel_size=(3, 3),
                                         padding=(1, 1),
                                         activation="identity"))
            .layer(1, L.BatchNormalization(n_out=4))
            .layer(2, L.ActivationLayer(activation="relu"))
            .layer(3, L.LocalResponseNormalization(n=3))
            .layer(4, L.SubsamplingLayer(pooling_type="avg",
                                         kernel_size=(2, 2), stride=(2, 2)))
            .layer(5, L.DenseLayer(n_in=4 * 3 * 4, n_out=8,
                                   activation="identity"))
            .layer(6, L.BatchNormalization(n_out=8))
            .layer(7, L.ActivationLayer(activation="tanh"))
            .layer(8, L.OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .input_preprocessor(5, CnnToFeedForwardPreProcessor(4, 3, 4))
            .build())


def rnn_zoo_conf(seed=7):
    L = _L()
    return (_builder(seed, "adagrad").list()
            .layer(0, L.GRU(n_in=3, n_out=5, activation="tanh"))
            .layer(1, L.GravesBidirectionalLSTM(n_in=5, n_out=4,
                                                activation="tanh"))
            .layer(2, L.RnnOutputLayer(n_in=4, n_out=3,
                                       activation="softmax"))
            .build())


class TestZooNetworksAgainstJax:
    def test_embedding_lstm_net_through_the_fused_scan(self):
        vocab, width, t = 9, 6, 10
        jnet = _jnet(embedding_lstm_conf(vocab, width, t), (t,))
        pnet = port_twin(jnet)
        rng = np.random.default_rng(0)
        idx = rng.integers(0, vocab, (4, t))
        y = np.eye(vocab)[rng.integers(0, vocab, (4, t))]
        k1 = port_lstm.lstm_scan_plain.launches
        k2 = port_lstm.lstm_scan_bwd_plain.launches
        for _ in range(2):
            jl = float(jnet.fit(jnp.asarray(idx), jnp.asarray(y)))
            pl = float(pnet.fit(idx, y))
            assert abs(jl - pl) < TOL
        assert port_lstm.lstm_scan_plain.launches - k1 == 2
        assert port_lstm.lstm_scan_bwd_plain.launches - k2 == 2
        assert_nets_match(jnet, pnet)
        assert max_diff(np.asarray(jnet.output(jnp.asarray(idx))),
                        pnet.output(idx).numpy()) < TOL

    def test_gru_net_streams_like_jax(self):
        """``rnn_time_step`` of a GRU net, one step at a time and as a
        [N, T, F] block, after a fit: the JAX package's outputs and
        carried state."""
        L = _L()
        conf = (_builder(4).list()
                .layer(0, L.GRU(n_in=3, n_out=5, activation="tanh"))
                .layer(1, L.RnnOutputLayer(n_in=5, n_out=3,
                                           activation="softmax"))
                .build())
        jnet = _jnet(conf, (6, 3))
        pnet = port_twin(jnet)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 6, 3))
        y = np.eye(3)[rng.integers(0, 3, (2, 6))]
        jnet.fit(jnp.asarray(x), jnp.asarray(y))
        pnet.fit(x, y)
        for net in (jnet, pnet):
            net.rnn_clear_previous_state()
        for t in range(3):
            assert max_diff(np.asarray(jnet.rnn_time_step(
                jnp.asarray(x[:, t]))), pnet.rnn_time_step(
                x[:, t]).numpy()) < TOL
        assert max_diff(np.asarray(jnet.rnn_time_step(jnp.asarray(
            x[:, 3:]))), pnet.rnn_time_step(x[:, 3:]).numpy()) < TOL
        assert max_diff(np.asarray(jnet.states[0]["h"]),
                        pnet.states[0]["h"].numpy()) < TOL

    @pytest.mark.parametrize("which", ["cnn", "rnn"])
    def test_zoo_net_fits_and_output(self, which):
        rng = np.random.default_rng(1)
        if which == "cnn":
            jnet = _jnet(cnn_zoo_conf(), (8, 6, 2))
            x = rng.normal(size=(5, 8, 6, 2))
            y = np.eye(3)[rng.integers(0, 3, 5)]
            mask = None
        else:
            jnet = _jnet(rnn_zoo_conf(), (7, 3))
            x = rng.normal(size=(4, 7, 3))
            y = np.eye(3)[rng.integers(0, 3, (4, 7))]
            mask = np.ones((4, 7))
            mask[1, 4:] = 0
        pnet = port_twin(jnet)
        for _ in range(3):
            jl = float(jnet.fit(jnp.asarray(x), jnp.asarray(y),
                                None if mask is None else jnp.asarray(mask)))
            pl = float(pnet.fit(x, y, mask))
            assert abs(jl - pl) < TOL
        assert_nets_match(jnet, pnet)
        assert max_diff(np.asarray(jnet.output(jnp.asarray(x))),
                        pnet.output(x).numpy()) < TOL


# ---------------------------------------------------------------------------
# pretraining
# ---------------------------------------------------------------------------


def _stack_conf(kind):
    L = _L()
    if kind == "autoencoder":
        layer = lambda i, o: L.AutoEncoder(n_in=i, n_out=o,
                                           corruption_level=0.0,
                                           activation="sigmoid")
    else:
        layer = lambda i, o: L.RBM(n_in=i, n_out=o, hidden_unit="rectified",
                                   visible_unit="linear",
                                   activation="relu")
    return (_builder(8, "nesterovs", 0.05).list().pretrain(True)
            .layer(0, layer(12, 8)).layer(1, layer(8, 5))
            .layer(2, L.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                    loss_function="negativeloglikelihood"))
            .build())


@pytest.mark.parametrize("kind", ["autoencoder", "rbm"])
def test_deterministic_pretraining_against_jax(kind):
    """``pretrain`` over 3 batches, then ``fit_iterator`` (which
    pretrains again, then fits each batch): params, states and the net's
    updater state after both."""
    from deeplearning4j_tpu.datasets.iterator import (
        ListDataSetIterator as JList,
    )

    jnet = _jnet(_stack_conf(kind), (12,))
    pnet = port_twin(jnet)
    rng = np.random.default_rng(2)
    x = rng.random((9, 12))
    y = np.eye(3)[rng.integers(0, 3, 9)]
    jnet.pretrain(JList(x, y, batch=3))
    pnet.pretrain(ListDataSetIterator(x, y, batch=3))
    assert_nets_match(jnet, pnet)
    assert pnet.iteration == 0
    jnet.fit_iterator(JList(x, y, batch=3))
    pnet.fit_iterator(ListDataSetIterator(x, y, batch=3))
    assert jnet.iteration == pnet.iteration == 3
    assert_nets_match(jnet, pnet)


class _Draws:
    """Uniforms and normals handed out in call order, to both packages."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.log = []

    def __call__(self, kind, shape):
        a = (self.rng.random(shape) if kind == "uniform"
             else self.rng.normal(size=shape))
        self.log.append(a)
        return a


@pytest.mark.parametrize("visible,k", [("binary", 1), ("binary", 3),
                                       ("gaussian", 2)])
def test_cd_k_with_injected_draws_against_jax(visible, k, monkeypatch):
    from deeplearning4j_tpu.nn.layers import feedforward as jff

    conf = _L().RBM(n_in=7, n_out=5, hidden_unit="binary",
                    visible_unit=visible, k=k)
    jl, jp, _, pl, pp, _ = layer_pair(conf, (7,), perturb=("b", "vb"))
    v0 = np.random.default_rng(3).random((6, 7))
    draws = _Draws(11)
    got = pl.cd_grads(pp, torch.from_numpy(v0), draws)
    replay = iter(draws.log)
    monkeypatch.setattr(jff.jax.random, "bernoulli",
                        lambda key, p: jnp.asarray(next(replay)) < p)
    monkeypatch.setattr(jff.jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            next(replay)))
    want = jl.cd_grads(jp, jnp.asarray(v0), jax.random.PRNGKey(0))
    assert next(replay, None) is None  # both took every draw, in order
    assert len(draws.log) == 1 + 2 * k
    for name in ("W", "b", "vb"):
        assert max_diff(np.asarray(want[name]), got[name].numpy()) < TOL


def test_dbn_pretraining_is_seeded_and_lowers_reconstruction():
    """Port against port: two DBNs pretrained from the same seed are
    bit-equal, and CD-1 lowers each RBM's reconstruction loss."""
    def trained():
        net = pdbn.build_dbn(device="cpu", n_in=20, hidden=(12, 8),
                             num_classes=3, seed=4)
        before = [net.layers[i].pretrain_loss(net.params[i], x)
                  for i in range(1)]
        net.pretrain(ListDataSetIterator(x, y, batch=10), num_epochs=30)
        after = [net.layers[i].pretrain_loss(net.params[i], x)
                 for i in range(1)]
        return net, before, after

    rng = np.random.default_rng(5)
    proto = (rng.random((3, 20)) > 0.5).astype(np.float32)
    lab = rng.integers(0, 3, 40)
    x = torch.from_numpy(np.abs(proto[lab] - (rng.random((40, 20)) < 0.05)))
    y = np.eye(3, dtype=np.float32)[lab]
    a, before, after = trained()
    b, _, _ = trained()
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    assert float(after[0]) < float(before[0])


# ---------------------------------------------------------------------------
# gradient checks
# ---------------------------------------------------------------------------


def _gradcheck_cases():
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )

    L = _L()
    out = lambda n_in: L.OutputLayer(n_in=n_in, n_out=3,
                                     activation="softmax")
    rng = np.random.default_rng(6)
    ff = rng.normal(size=(4, 5))
    img = rng.normal(size=(3, 5, 4, 2))
    seq = rng.normal(size=(3, 6, 4))
    yff = np.eye(3)[rng.integers(0, 3, 4)]
    yimg = np.eye(3)[rng.integers(0, 3, 3)]
    yseq = np.eye(3)[rng.integers(0, 3, (3, 6))]
    mask = np.ones((3, 6))
    mask[0, 4:] = 0
    b = lambda: _builder(9).l2(1e-3).list()
    return {
        "embedding": (b().layer(0, L.EmbeddingLayer(n_in=6, n_out=4,
                                                    activation="tanh"))
                      .layer(1, out(4)).build(), (1,),
                      rng.integers(0, 6, (4, 1)).astype(np.float64), yff,
                      None),
        "activation": (b().layer(0, L.DenseLayer(n_in=5, n_out=4))
                       .layer(1, L.ActivationLayer(activation="softsign"))
                       .layer(2, out(4)).build(), (5,), ff, yff, None),
        "batchnorm": (b().layer(0, L.DenseLayer(n_in=5, n_out=4))
                      .layer(1, L.BatchNormalization(n_out=4))
                      .layer(2, out(4)).build(), (5,), ff, yff, None),
        "cnn": (b().layer(0, L.ConvolutionLayer(n_in=2, n_out=3,
                                                kernel_size=(2, 2),
                                                activation="tanh"))
                .layer(1, L.LocalResponseNormalization(n=3))
                .layer(2, L.SubsamplingLayer(pooling_type="max",
                                             kernel_size=(2, 2),
                                             stride=(1, 1)))
                .layer(3, out(3 * 2 * 3))
                .input_preprocessor(3, CnnToFeedForwardPreProcessor(3, 2, 3))
                .build(), (5, 4, 2), img, yimg, None),
        "cnn_bn_sum_pool": (
            b().layer(0, L.ConvolutionLayer(n_in=2, n_out=3,
                                            kernel_size=(2, 2),
                                            stride=(1, 2), padding=(1, 0),
                                            activation="identity"))
            .layer(1, L.BatchNormalization(n_out=3))
            .layer(2, L.SubsamplingLayer(pooling_type="sum",
                                         kernel_size=(3, 2), stride=(2, 1),
                                         padding=(2, 0)))
            .layer(3, out(4 * 1 * 3))
            .input_preprocessor(3, CnnToFeedForwardPreProcessor(4, 1, 3))
            .build(), (5, 4, 2), img, yimg, None),
        "gru": (b().layer(0, L.GRU(n_in=4, n_out=3, activation="tanh"))
                .layer(1, L.RnnOutputLayer(n_in=3, n_out=3,
                                           activation="softmax")).build(),
                (6, 4), seq, yseq, mask),
        "bilstm": (b().layer(0, L.GravesBidirectionalLSTM(
                       n_in=4, n_out=3, activation="tanh"))
                   .layer(1, L.RnnOutputLayer(n_in=3, n_out=3,
                                              activation="softmax")).build(),
                   (6, 4), seq, yseq, mask),
        "autoencoder": (b().layer(0, L.AutoEncoder(n_in=5, n_out=4,
                                                   activation="sigmoid"))
                        .layer(1, out(4)).build(), (5,), ff, yff, None),
        "rbm": (b().layer(0, L.RBM(n_in=5, n_out=4))
                .layer(1, out(4)).build(), (5,), ff, yff, None),
    }


@pytest.mark.parametrize("case", sorted(_gradcheck_cases()))
def test_gradient_check_verdict_matches_jax(case):
    from deeplearning4j_tpu.utils.gradient_check import (
        check_network_gradients as jcheck,
    )

    conf, shape, x, y, mask = _gradcheck_cases()[case]
    jnet = _jnet(conf, shape)
    pnet = port_twin(jnet)
    j_ok, j_err = jcheck(jnet, x, y, mask=None if mask is None
                         else jnp.asarray(mask), max_params_per_leaf=3)
    p_ok, p_err = check_network_gradients(pnet, x, y, mask=mask,
                                          max_params_per_leaf=3)
    assert p_ok and p_ok == j_ok, (p_err, j_err)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def test_evaluation_stats_equal_jax():
    from deeplearning4j_tpu.eval import evaluation as jeval

    rng = np.random.default_rng(7)
    labels = np.eye(5)[rng.integers(0, 5, 40)]
    preds = rng.random((40, 5))
    ts_l = np.eye(5)[rng.integers(0, 5, (3, 6))]
    ts_p = rng.random((3, 6, 5))
    ts_m = (rng.random((3, 6)) > 0.3).astype(np.float64)
    for top_n in (1, 3):
        pe, je = peval.Evaluation(top_n=top_n), jeval.Evaluation(top_n=top_n)
        for ev in (pe, je):
            ev.eval(labels[:20], preds[:20])
            ev.eval(ts_l, ts_p, mask=ts_m)
        pm, jm = peval.Evaluation(top_n=top_n), jeval.Evaluation(top_n=top_n)
        pm.eval(labels[20:], preds[20:])
        jm.eval(labels[20:], preds[20:])
        pe.merge(pm)
        je.merge(jm)
        assert pe.stats() == je.stats()
        for c in (None, 0, 3):
            assert pe.f1(c) == je.f1(c)
        assert pe.top_n_accuracy() == je.top_n_accuracy()
    rl, rp = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    pr, jr = peval.RegressionEvaluation(), jeval.RegressionEvaluation()
    for ev in (pr, jr):
        ev.eval(rl, rp)
    assert pr.stats() == jr.stats()
    assert pr.correlation_r2(1) == jr.correlation_r2(1)
    y = rng.integers(0, 2, 50)
    s = np.round(rng.random(50), 1)  # ties across the threshold sweep
    proc, jroc = peval.ROC().eval(y, s), jeval.ROC().eval(y, s)
    assert proc.auc() == jroc.auc()
    for a, b in zip(proc.roc_curve(), jroc.roc_curve()):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(peval.ROC().eval(np.ones(4), s[:4]).auc())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestDbnZipsBothWays:
    def test_jax_zip_loads_in_the_port(self, tmp_path):
        from deeplearning4j_tpu.models.dbn import build_dbn
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet = build_dbn()
        x = np.random.default_rng(8).random((6, 784)).astype(np.float32)
        jnet.pretrain(jnp.asarray(x))
        path = str(tmp_path / "dbn.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = MultiLayerNetwork.load(path, device="cpu")
        want = np.asarray(jnet.output(jnp.asarray(x)))
        assert np.abs(pnet.output(x).numpy() - want).max() < TOL_F32

    def test_port_zip_loads_in_jax(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        pnet = pdbn.build_dbn(device="cpu")
        rng = np.random.default_rng(9)
        x = (rng.random((6, 784)) > 0.7).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
        pnet.fit_iterator(ListDataSetIterator(x, y, batch=3))
        path = str(tmp_path / "dbn_port.zip")
        pser.write_model(pnet, path)
        jnet = ModelSerializer.restore_multi_layer_network(path)
        assert jnet.iteration == pnet.iteration == 2
        got = np.asarray(jnet.output(jnp.asarray(x)))
        assert np.abs(got - pnet.output(x).numpy()).max() < TOL_F32
