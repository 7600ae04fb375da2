"""The port's MultiHeadAttention layer in a MultiLayerNetwork against the
JAX package, on the CPU.

The network: two ``MultiHeadAttention`` layers (n_in 6 -> 32 with 2
heads of 16, tanh; 32 -> 32 with 4 heads of 8, identity) and an
``RnnOutputLayer`` (softmax, mcxent), causal and not. The JAX package
builds it and writes its zip; the JAX side restores the zip, the port
loads it (``MultiLayerNetwork.load``), and both cast their params to f64
(the JAX package's gradient-check mode, x64 from ``tests/conftest.py``).
On the CPU the port's layer runs K5's and K4's plain versions through
``FlashBlockFn`` / ``FlashFn`` (the blocked backward) and the JAX layer
its dense attention, so the two meet at f64 rounding: 1e-10 abs on
``output``, every ``feed_forward`` activation, the masked ``score`` and
5 masked SGD fits (losses and params); 5 masked Adam fits at 1e-5, the
rule of ``tests/test_torch_training.py`` (both packages compute Adam's
bias correction in f32 with their own ``pow``). Masks: variable lengths
per row, the feature mask for the keys and the loss.

Also: ``rnn_time_step`` step by step (the KV cache) against the JAX
package's and, for the causal network, against the port's own batch
``output``, again after ``rnn_clear_previous_state``; the port's zip read
back by the JAX package (``ModelSerializer``) gives the same ``output``;
the masked path counts K5's plain version and the unmasked path K4's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pL  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import (  # noqa: E402
    flash_attention as pflash,
)
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

F_IN, V, N, T = 6, 5, 4, 12
TOL_F64 = 1e-10
TOL_ADAM = 1e-5


def _conf(builder, L, causal, updater="sgd"):
    return (builder.builder().seed(11).learning_rate(0.05)
            .updater(updater).weight_init("xavier").list()
            .layer(0, L.MultiHeadAttention(n_in=F_IN, n_out=32, num_heads=2,
                                           activation="tanh", causal=causal))
            .layer(1, L.MultiHeadAttention(n_in=32, n_out=32, num_heads=4,
                                           activation="identity",
                                           causal=causal))
            .layer(2, L.RnnOutputLayer(n_in=32, n_out=V,
                                       activation="softmax",
                                       loss_function="mcxent"))
            .build())


def _f64_pair(tmp_path, causal, updater="sgd"):
    """(jax net, port net) from the JAX package's zip, params in f64."""
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
    from deeplearning4j_tpu.nn.conf import layers as jL
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    built = JNet(_conf(JB, jL, causal, updater)).init()
    path = str(tmp_path / f"mha_{causal}_{updater}.zip")
    ModelSerializer.write_model(built, path)
    jnet = ModelSerializer.restore_multi_layer_network(path)
    pnet = MultiLayerNetwork.load(path, device="cpu")
    jnet.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    jnet.updater_state = jnet.updater.init(jnet.params)
    pnet.params = [{k: v.double() for k, v in p.items()}
                   for p in pnet.params]
    pnet.updater_state = pnet.updater.init(pnet.params)
    return jnet, pnet


def _data(seed, n=N, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, F_IN))
    y = np.eye(V)[rng.integers(0, V, (n, t))]
    lengths = rng.integers(2, t + 1, n)
    lengths[0] = t
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float64)
    return x, y, mask


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max())
    assert err <= tol, f"{what}: max |diff| {err:.3e} > {tol}"


def test_port_conf_writes_the_jax_json():
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
    from deeplearning4j_tpu.nn.conf import layers as jL

    for causal in (False, True):
        assert _conf(pconf.NeuralNetConfiguration, pL, causal).to_json() \
            == _conf(JB, jL, causal).to_json()


def test_params_carry_the_jax_names_and_init_shapes():
    net = MultiLayerNetwork(_conf(pconf.NeuralNetConfiguration, pL, False),
                            device="cpu").init()
    assert sorted(net.params[0]) == ["Wk", "Wo", "Wq", "Wv", "b"]
    assert tuple(net.params[0]["Wq"].shape) == (F_IN, 32)
    assert tuple(net.params[1]["Wo"].shape) == (32, 32)
    assert float(net.params[0]["b"].abs().max()) == 0.0
    # xavier: N(0, 1 / (fan_in + fan_out))
    std = float(net.params[1]["Wq"].std())
    assert abs(std - (1.0 / 64) ** 0.5) < 0.03


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
class TestForward:
    def test_output_and_feed_forward(self, tmp_path, causal):
        jnet, pnet = _f64_pair(tmp_path, causal)
        x, _, _ = _data(1)
        _close(pnet.output(x).numpy(), jnet.output(jnp.asarray(x)),
               TOL_F64, "output")
        jacts = jnet.feed_forward(jnp.asarray(x))
        pacts = pnet.feed_forward(x)
        assert len(jacts) == len(pacts) == 4
        for i, (a, b) in enumerate(zip(jacts, pacts)):
            _close(b.numpy(), a, TOL_F64, f"feed_forward[{i}]")

    def test_masked_score(self, tmp_path, causal):
        jnet, pnet = _f64_pair(tmp_path, causal)
        x, y, mask = _data(2)
        js = jnet.score(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        ps = pnet.score(x, y, mask)
        assert abs(js - ps) < TOL_F64
        # the mask reaches the layer: the unmasked score differs
        assert abs(pnet.score(x, y) - ps) > 1e-6

    def test_rnn_time_step_against_jax(self, tmp_path, causal):
        jnet, pnet = _f64_pair(tmp_path, causal)
        x, _, _ = _data(3, n=2, t=6)
        for t in range(x.shape[1]):
            _close(pnet.rnn_time_step(x[:, t]).numpy(),
                   jnet.rnn_time_step(jnp.asarray(x[:, t])), TOL_F64,
                   f"rnn_time_step at t={t}")
        assert tuple(pnet.states[0]["k_cache"].shape) == (2, 6, 2, 16)


def test_rnn_time_step_equals_the_causal_batch_forward(tmp_path):
    _, pnet = _f64_pair(tmp_path, True)
    x, _, _ = _data(4, n=3, t=7)
    want = pnet.output(x).numpy()
    steps = np.stack([pnet.rnn_time_step(x[:, t]).numpy()
                      for t in range(7)], axis=1)
    _close(steps, want, TOL_F64, "steps vs batch")
    pnet.rnn_clear_previous_state()
    assert pnet.states[0] == {}
    # a cleared stream starts afresh (the JAX package attends to a zeroed
    # cache of the old length here: ROADMAP queue 3)
    _close(pnet.rnn_time_step(x[:, 0]).numpy(), want[:, 0], TOL_F64,
           "first step after rnn_clear_previous_state")


@pytest.mark.parametrize("updater,tol", [("sgd", TOL_F64),
                                         ("adam", TOL_ADAM)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_masked_fits(tmp_path, causal, updater, tol):
    """5 masked fits through both packages: every loss and the params."""
    jnet, pnet = _f64_pair(tmp_path, causal, updater)
    for i in range(5):
        x, y, mask = _data(10 + i)
        js = jnet.fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        ps = float(pnet.fit(x, y, mask))
        assert abs(js - ps) < tol, (i, js, ps)
    for i, (jp, pp) in enumerate(zip(jnet.params, pnet.params)):
        for k in jp:
            _close(pp[k].numpy(), jp[k], tol, f"layer {i} {k}")


def test_masked_path_runs_k5_and_unmasked_path_k4(tmp_path):
    _, pnet = _f64_pair(tmp_path, False)
    x, y, mask = _data(5)
    counts = lambda: (pflash.flash_attention_block_plain.launches,
                      pflash.flash_attention_plain.launches)
    before = counts()
    pnet.fit(x, y, mask)
    mid = counts()
    assert mid == (before[0] + 2, before[1])   # one K5 per layer
    pnet.fit(x, y)
    assert counts() == (mid[0], mid[1] + 2)    # one K4 per layer


def test_port_zip_restores_in_jax(tmp_path):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    net = MultiLayerNetwork(
        _conf(pconf.NeuralNetConfiguration, pL, True, "adam"),
        device="cpu").init()
    for i in range(2):
        x, y, mask = _data(20 + i)
        net.fit(x.astype(np.float32), y.astype(np.float32),
                mask.astype(np.float32))
    path = str(tmp_path / "port_mha.zip")
    pser.write_model(net, path)
    restored = ModelSerializer.restore_multi_layer_network(path)
    assert restored.iteration == net.iteration == 2
    x = _data(22)[0].astype(np.float32)
    _close(net.output(x).numpy(), restored.output(jnp.asarray(x)), 1e-5,
           "output after the round trip")
    again = MultiLayerNetwork.load(path, device="cpu")
    assert torch.equal(again.output(x), net.output(x))
