"""The port's MultiLayerNetwork inference path against the JAX package, on
the CPU.

  * Config DSL: a configuration the JAX package writes parses in the port
    and writes back to the identical JSON string, for the char-RNN and
    for a conf that holds every layer class and preprocessor (a network
    of it builds: every layer class has a runtime; a conf class with none
    raises, naming it); the port's own ``char_rnn_conf`` writes the JAX
    package's string.
  * Layers on the same params: dense, RNN output and GravesLSTM (tanh
    through the K1 wrapper, with a mask and with another activation
    through the per-step loop) against the JAX layers, f64 at 1e-10 and
    f32 at 1e-5; the activation registry at 1e-12 in f64.
  * Checkpoint in, output out: a char-RNN zip written by the JAX
    package's ``ModelSerializer`` loads into the port; ``output`` (at equal
    batch shapes: XLA:CPU's f32 bytes depend on the batch size),
    ``feed_forward``, ``rnn_time_step`` step by step and as [N, T, F],
    ``rnn_clear_previous_state`` and the batch-mismatch error, and the
    CharRnn probabilities along the JAX package's own sampled transcript
    (teacher-forced) agree at 1e-5.
"""

import dataclasses
import io
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import char_rnn as pcr  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import factory as pfactory  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import activations as pact  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

VOCAB, HIDDEN, T = 12, 16, 10
TOL = 1e-5
CHARS = list("abcdefghijkl")


def _jax_net(seed=7, **kw):
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    net = JNet(char_rnn_conf(VOCAB, lstm_size=HIDDEN, num_layers=2,
                             seed=seed, **kw))
    return net.init(input_shape=(1, VOCAB))


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    jnet = _jax_net()
    path = str(tmp_path_factory.mktemp("mln") / "char_rnn.zip")
    ModelSerializer.write_model(jnet, path)
    return path


@pytest.fixture(scope="module")
def pair(zip_path):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    return (ModelSerializer.restore_multi_layer_network(zip_path),
            MultiLayerNetwork.load(zip_path, device="cpu"))


def _onehot(seed, n, t):
    rng = np.random.default_rng(seed)
    return np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (n, t))]


# ---------------------------------------------------------------------------
# config DSL
# ---------------------------------------------------------------------------


def _every_layer_conf():
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.conf import preprocessors as P

    return (NeuralNetConfiguration.builder().seed(3).l2(1e-4)
            .updater("adam").drop_out(0.1).list()
            .layer(0, L.ConvolutionLayer(n_in=1, n_out=4, kernel_size=(3, 3)))
            .layer(1, L.SubsamplingLayer(pooling_type="avg"))
            .layer(2, L.LocalResponseNormalization())
            .layer(3, L.BatchNormalization(n_out=4))
            .layer(4, L.DenseLayer(n_in=36, n_out=8, activation="relu"))
            .layer(5, L.AutoEncoder(n_in=8, n_out=8))
            .layer(6, L.RBM(n_in=8, n_out=8, hidden_unit="gaussian"))
            .layer(7, L.ActivationLayer(activation="elu"))
            .layer(8, L.EmbeddingLayer(n_in=8, n_out=8))
            .layer(9, L.GravesBidirectionalLSTM(n_in=8, n_out=8))
            .layer(10, L.GRU(n_in=8, n_out=8))
            .layer(11, L.MultiHeadAttention(n_in=8, n_out=8, num_heads=2))
            .layer(12, L.OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .input_preprocessor(4, P.CnnToFeedForwardPreProcessor(3, 3, 4))
            .input_preprocessor(9, P.FeedForwardToRnnPreProcessor())
            .input_preprocessor(12, P.RnnToFeedForwardPreProcessor())
            .input_preprocessor(0, P.ReshapePreProcessor((5, 5, 1)))
            .dtype_policy("performance").build())


class TestConfigRoundTrip:
    @pytest.mark.parametrize("which", ["char_rnn_80", "every_layer"])
    def test_jax_json_parses_and_writes_back_identically(self, which):
        from deeplearning4j_tpu.models.char_rnn import char_rnn_conf

        conf = char_rnn_conf(80) if which == "char_rnn_80" \
            else _every_layer_conf()
        text = conf.to_json()
        assert pconf.MultiLayerConfiguration.from_json(text).to_json() == text

    def test_port_char_rnn_conf_writes_the_jax_string(self):
        from deeplearning4j_tpu.models.char_rnn import char_rnn_conf

        assert pcr.char_rnn_conf(80).to_json() == char_rnn_conf(80).to_json()
        assert (pcr.char_rnn_conf(12, lstm_size=16, seed=3).to_json()
                == char_rnn_conf(12, lstm_size=16, seed=3).to_json())

    def test_unported_layers_raise_naming_the_layer(self):
        """Every layer class of the JAX zoo has a runtime now (a network
        of all of them builds); a conf class with none raises, naming
        it."""
        conf = pconf.MultiLayerConfiguration.from_json(
            _every_layer_conf().to_json())
        net = MultiLayerNetwork(conf, device="cpu")
        assert [type(lc) for lc in conf.layers] == [
            type(layer.conf) for layer in net.layers]
        assert {type(lc) for lc in conf.layers} <= set(pfactory.FACTORY)

        @dataclasses.dataclass
        class Unmapped(pconf.DenseLayer):
            pass

        with pytest.raises(ValueError, match="no runtime for layer conf "
                                             "Unmapped"):
            pfactory.create_layer(Unmapped(n_in=2, n_out=2))


# ---------------------------------------------------------------------------
# layers on the same params
# ---------------------------------------------------------------------------


def _layer_pair(jconf_obj, input_shape, dtype):
    """The JAX layer impl and params, the port's layer impl and the same
    params, all in ``dtype``."""
    from deeplearning4j_tpu.nn.conf.layers import resolve
    from deeplearning4j_tpu.nn.layers.factory import create_layer

    jconf_obj = resolve(jconf_obj)
    jl = create_layer(jconf_obj)
    params, state, _ = jl.initialize(jax.random.PRNGKey(1), input_shape)
    npp = {k: np.asarray(v, dtype) for k, v in params.items()}
    # nonzero peepholes and biases, so every term of the gates is exercised
    rng = np.random.default_rng(5)
    for k in ("p", "b"):
        if k in npp:
            npp[k] = npp[k] + rng.normal(0, 0.2, npp[k].shape).astype(dtype)
    pl = pfactory.create_layer(pconf.layer_from_dict(
        dataclasses.asdict(jconf_obj) | {"type": type(jconf_obj).__name__}))
    return (jl, {k: jnp.asarray(v) for k, v in npp.items()}, state,
            pl, {k: torch.from_numpy(v.copy()) for k, v in npp.items()})


DTYPES = [(np.float64, 1e-10), (np.float32, TOL)]


class TestLayersAgainstJax:
    @pytest.mark.parametrize("dtype,tol", DTYPES)
    def test_dense(self, dtype, tol):
        from deeplearning4j_tpu.nn.conf.layers import DenseLayer

        jl, jp, js, pl, pp = _layer_pair(
            DenseLayer(n_in=9, n_out=5, activation="tanh"), (9,), dtype)
        x = np.random.default_rng(0).normal(size=(4, 9)).astype(dtype)
        ref = np.asarray(jl.apply(jp, js, jnp.asarray(x))[0])
        out = pl.apply(pp, {}, torch.from_numpy(x))[0].numpy()
        assert out.dtype == dtype and np.abs(out - ref).max() < tol

    @pytest.mark.parametrize("dtype,tol", DTYPES)
    def test_rnn_output(self, dtype, tol):
        from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer

        jl, jp, js, pl, pp = _layer_pair(
            RnnOutputLayer(n_in=HIDDEN, n_out=VOCAB, activation="softmax"),
            (T, HIDDEN), dtype)
        x = np.random.default_rng(1).normal(size=(3, T, HIDDEN)).astype(dtype)
        ref = np.asarray(jl.apply(jp, js, jnp.asarray(x))[0])
        out = pl.apply(pp, {}, torch.from_numpy(x))[0].numpy()
        assert out.shape == (3, T, VOCAB) and np.abs(out - ref).max() < tol

    @pytest.mark.parametrize("dtype,tol", DTYPES)
    @pytest.mark.parametrize("case", ["tanh_kernel_route", "masked",
                                      "softsign", "short"])
    def test_graves_lstm(self, case, dtype, tol):
        from deeplearning4j_tpu.nn.conf.layers import GravesLSTM

        act = "softsign" if case == "softsign" else "tanh"
        t = 5 if case == "short" else T
        jl, jp, js, pl, pp = _layer_pair(
            GravesLSTM(n_in=VOCAB, n_out=HIDDEN, activation=act),
            (t, VOCAB), dtype)
        x = np.random.default_rng(2).normal(size=(3, t, VOCAB)).astype(dtype)
        mask = None
        if case == "masked":
            mask = np.ones((3, t), dtype)
            mask[0, 6:] = 0
            mask[2, 3:] = 0
        ref_y, ref_s = jl.apply(jp, js, jnp.asarray(x),
                                mask=None if mask is None
                                else jnp.asarray(mask))
        plain = port_lstm.lstm_scan_plain.launches
        y, st = pl.apply(pp, {}, torch.from_numpy(x),
                         mask=None if mask is None
                         else torch.from_numpy(mask))
        routed = port_lstm.lstm_scan_plain.launches - plain
        assert routed == (1 if case == "tanh_kernel_route" else 0)
        assert np.abs(y.numpy() - np.asarray(ref_y)).max() < tol
        for k in ("h", "c"):
            assert np.abs(st[k].numpy() - np.asarray(ref_s[k])).max() < tol

    @pytest.mark.parametrize("name", sorted(pact.ACTIVATIONS))
    def test_activation_registry(self, name):
        from deeplearning4j_tpu.ops.activations import activation

        x = np.linspace(-4, 4, 41).reshape(1, 41)
        ref = np.asarray(activation(name)(jnp.asarray(x)))
        out = pact.activation(name)(torch.from_numpy(x)).numpy()
        assert np.abs(out - ref).max() < 1e-12


# ---------------------------------------------------------------------------
# checkpoint in, output out
# ---------------------------------------------------------------------------


class TestCheckpointAgainstJax:
    def test_npz_keys_are_list_index_paths(self, zip_path):
        with zipfile.ZipFile(zip_path) as z:
            coeff = np.load(io.BytesIO(z.read("coefficients.npz")))
            keys = sorted(coeff.files)
        assert "[0]['W']" in keys and "[2]['b']" in keys
        assert [pser.keystr_path(k) for k in keys][:2] == [(0, "U"),
                                                           (0, "W")]
        for bad in ("[0]W", "['a'][b]", "[-1]", "[0]['W']x", ""):
            with pytest.raises(ValueError, match="unsupported npz key"):
                pser.keystr_path(bad)

    def test_params_and_states_load_bit_for_bit(self, pair):
        jnet, pnet = pair
        assert pnet.num_params() == jnet.num_params()
        for jl, pl in zip(jnet.params + jnet.states,
                          pnet.params + pnet.states):
            assert set(jl) == set(pl)
            for k in jl:
                np.testing.assert_array_equal(np.asarray(jl[k]),
                                              pl[k].numpy())

    @pytest.mark.parametrize("n", [1, 5, 8])
    def test_output_at_equal_batch_shapes(self, pair, n):
        jnet, pnet = pair
        x = _onehot(n, n, T)
        ref = np.asarray(jnet.output(x))
        out = pnet.output(x)
        assert out.shape == (n, T, VOCAB) and out.device.type == "cpu"
        assert np.abs(out.numpy() - ref).max() < TOL

    def test_ragged_batch_pads_to_its_bucket_and_rows_are_unchanged(
            self, pair, monkeypatch):
        _, pnet = pair
        x = _onehot(11, 5, T)
        padded = pnet.output(x).numpy()
        alone = np.concatenate([pnet.output(x[i:i + 1]).numpy()
                                for i in range(5)])
        assert np.abs(padded - alone).max() < 1e-6
        monkeypatch.setenv("DL4J_TPU_BUCKET_BATCHES", "0")
        assert np.abs(pnet.output(x).numpy() - padded).max() < 1e-6

    def test_feed_forward(self, pair):
        jnet, pnet = pair
        x = _onehot(3, 2, T)
        ref = jnet.feed_forward(x)
        acts = pnet.feed_forward(x)
        assert len(acts) == len(ref) == 4
        for a, r in zip(acts, ref):
            assert np.abs(a.numpy() - np.asarray(r)).max() < TOL
        # training mode: no dropout in this net, so the same activations
        ref = jnet.feed_forward(x, train=True)
        for a, r in zip(pnet.feed_forward(x, train=True), ref):
            assert np.abs(a.numpy() - np.asarray(r)).max() < TOL

    def test_rnn_time_step_stepwise_and_sequence(self, pair):
        jnet, pnet = pair
        x = _onehot(4, 3, 6)
        for net in (jnet, pnet):
            net.rnn_clear_previous_state()
        for t in range(3):  # three single steps
            ref = np.asarray(jnet.rnn_time_step(x[:, t]))
            out = pnet.rnn_time_step(x[:, t]).numpy()
            assert np.abs(out - ref).max() < TOL
        ref = np.asarray(jnet.rnn_time_step(x[:, 3:]))  # then [N, T, F]
        out = pnet.rnn_time_step(x[:, 3:]).numpy()
        assert out.shape == (3, 3, VOCAB)
        assert np.abs(out - ref).max() < TOL
        for js, ps in zip(jnet.states, pnet.states):
            for k in js:
                assert np.abs(ps[k].numpy() - np.asarray(js[k])).max() < TOL

    def test_clear_previous_state_and_batch_mismatch(self, pair):
        jnet, pnet = pair
        x = _onehot(5, 2, 4)
        pnet.rnn_clear_previous_state()
        first = pnet.rnn_time_step(x).numpy()
        with pytest.raises(ValueError, match="call rnn_clear_previous_state"):
            pnet.rnn_time_step(_onehot(6, 3, 1))
        pnet.rnn_clear_previous_state()
        assert pnet.states[0]["h"].shape == (0, HIDDEN)
        np.testing.assert_array_equal(pnet.rnn_time_step(x).numpy(), first)
        jnet.rnn_clear_previous_state()
        assert np.abs(first - np.asarray(jnet.rnn_time_step(x))).max() < TOL

    def test_char_rnn_probabilities_along_the_jax_transcript(self, pair):
        from deeplearning4j_tpu.models.char_rnn import CharRnn as JaxCharRnn

        jnet, pnet = pair
        jcr = JaxCharRnn(chars=CHARS, lstm_size=HIDDEN, num_layers=2)
        jcr.net = jnet
        text = jcr.sample("abc", length=40, temperature=0.9, seed=3)
        pcr_ = pcr.CharRnn(chars=CHARS, net=pnet)
        np.testing.assert_array_equal(pcr_.encode(text), jcr.encode(text))
        eye = np.eye(VOCAB, dtype=np.float32)
        jnet.rnn_clear_previous_state()
        pnet.rnn_clear_previous_state()
        for ci in pcr_.encode(text):
            x = eye[ci][None, None, :]
            ref = np.asarray(jnet.rnn_time_step(x))
            assert np.abs(pnet.rnn_time_step(x).numpy() - ref).max() < TOL
        # port against port: the same seed draws the same string
        assert pcr_.sample("abc", 40, 0.9, seed=3, top_k=4) == \
            pcr_.sample("abc", 40, 0.9, seed=3, top_k=4)

    def test_performance_policy_casts_like_the_jax_layers(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet = _jax_net(seed=2)
        jnet.conf.dtype_policy = "performance"
        path = str(tmp_path / "bf16.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = MultiLayerNetwork.load(path, device="cpu")
        assert pnet.conf.dtype_policy == "performance"
        x = _onehot(9, 4, T)
        ref = np.asarray(jnet.output(x))
        out = pnet.output(x)
        assert out.dtype == torch.float32  # output layers are never downcast
        assert np.abs(out.numpy() - ref).max() < 2e-2  # bf16 hidden layers

    def test_load_refuses_another_model_class_and_a_missing_leaf(
            self, zip_path, tmp_path):
        from deeplearning4j_tpu.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )

        lm_zip = str(tmp_path / "lm.zip")
        TransformerLM(TransformerConfig(vocab_size=16, d_model=16,
                                        n_layers=1, n_heads=2, d_ff=32,
                                        max_len=16)).save(lm_zip)
        with pytest.raises(ValueError, match="not MultiLayerNetwork"):
            MultiLayerNetwork.load(lm_zip, device="cpu")
        cut = str(tmp_path / "cut.zip")
        with zipfile.ZipFile(zip_path) as zin, \
                zipfile.ZipFile(cut, "w") as zout:
            for item in zin.namelist():
                data = zin.read(item)
                if item == "coefficients.npz":
                    npz = dict(np.load(io.BytesIO(data)))
                    del npz["[1]['p']"]
                    buf = io.BytesIO()
                    np.savez(buf, **npz)
                    data = buf.getvalue()
                zout.writestr(item, data)
        with pytest.raises(ValueError, match="layer 1"):
            MultiLayerNetwork.load(cut, device="cpu")


def test_fresh_init_shapes_and_forget_bias():
    """Port-only: a fresh init has the JAX layout and the forget-gate bias
    (jax threefry and torch Philox differ, so values are not compared)."""
    net = MultiLayerNetwork(pcr.char_rnn_conf(VOCAB, lstm_size=HIDDEN),
                            device="cpu").init(input_shape=(1, VOCAB))
    p0 = net.params[0]
    assert {k: tuple(v.shape) for k, v in p0.items()} == {
        "W": (VOCAB, 4 * HIDDEN), "U": (HIDDEN, 4 * HIDDEN),
        "p": (3, HIDDEN), "b": (4 * HIDDEN,)}
    assert torch.all(p0["b"][HIDDEN:2 * HIDDEN] == 1.0)
    assert torch.all(p0["b"][:HIDDEN] == 0.0)
    assert net.num_params() == _jax_net().num_params()
    std = float(p0["W"].std())
    assert abs(std - (VOCAB + HIDDEN) ** -0.5) < 0.03  # xavier


@pytest.mark.parametrize("scheme,dist", [
    ("xavier", None), ("relu", None), ("size", None), ("uniform", None),
    ("vi", None), ("normalized", None), ("zero", None),
    ("distribution", {"type": "normal", "mean": 1.0, "std": 0.5}),
    ("distribution", {"type": "uniform", "lower": -2.0, "upper": 2.0}),
    ("distribution", {"type": "binomial", "n": 3, "p": 0.5})])
def test_weight_init_schemes_draw_their_distribution(scheme, dist):
    """Port-only: each scheme's draws have the JAX package's support and
    scale (the bits differ: a torch.Generator, not jax threefry)."""
    from deeplearning4j_tpu_torch.nn.weights import init_weights

    gen = torch.Generator().manual_seed(0)
    fan_in, fan_out = 40, 60
    w = init_weights(gen, (fan_in, fan_out), scheme, fan_in, fan_out, dist)
    assert w.shape == (fan_in, fan_out) and w.dtype == torch.float32
    lim = {"size": 4.0 * (6.0 / 100) ** 0.5, "uniform": 1 / 40,
           "vi": 6 ** 0.5 / 101 ** 0.5, "normalized": 0.5 / 40}
    if scheme in lim:
        assert float(w.abs().max()) <= lim[scheme]
        assert float(w.abs().max()) > 0.9 * lim[scheme]
    std = {"xavier": 0.1, "relu": (2 / 40) ** 0.5}
    if scheme in std:
        assert abs(float(w.std()) / std[scheme] - 1) < 0.05
    if scheme == "zero":
        assert not w.any()
    if dist and dist["type"] == "normal":
        assert abs(float(w.mean()) - 1.0) < 0.03
    if dist and dist["type"] == "binomial":
        assert set(w.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0}
    if dist and dist["type"] == "uniform":
        assert -2.0 <= float(w.min()) and float(w.max()) <= 2.0
