"""bf16 loss-scaled training of the port's containers against the JAX
package's, on the CPU (``DL4J_TPU_BF16=1``).

The JAX MultiLayerNetwork and ComputationGraph build a bf16 master-weight
step when the knob is on (``nn/multilayer.py:344-411``,
``nn/graph.py:474-538``): params and floating inputs cast to bf16 at the
step boundary, the loss scaled before the backward and the gradients
unscaled after, a non-finite step selected back (params, states, updater
state) with the scale halved. The port's containers run the same step
(``nn/common.train_iteration``). Both start from the same f32 params, on
``DL4J_TPU_LOSS_SCALE=8:2`` (two clean steps double the scale):

  * the (scale, good, skipped) triple equal after every step, and the
    loss within 1e-3 for LeNet-5 (bf16 products on two backends round
    apart). The graph starts each step from the JAX graph's params,
    states and updater state (XLA sums a bf16 bias gradient over batch
    and space rounding at every add, so the BN net's conv biases land up
    to 16 % of their largest entry apart after one step), and its loss is
    held to one bf16 ulp of its value (2^-8 relative): the two backends'
    bf16 convolutions already differ by one ulp in some outputs at equal
    params (step 1: 2.4e-3 on a loss of 1.6), and BN and the softmax
    carry that to the loss;
  * an inf planted in a weight makes the next step non-finite: skipped in
    both packages, params bit-equal to before, the scale halved,
    ``dispatch_stats.loss_scale_skips`` one;
  * ``training_state`` carries the scale through a zip both ways;
  * with the knob off, the same fits are the f32 step (no scale state).

The nets: LeNet-5 (conv, pooling, dense: the MultiLayerNetwork), and a
small residual graph with BatchNormalization (conv -> BN -> relu, an add
vertex with a projection, average pooling, the output layer).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.graph import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

LOSS_TOL = 1e-3
BF16_ULP = 2.0 ** -8


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)


def _to_port(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    jax.tree_util.tree_map(np.asarray, tree))


def _mln_pair():
    from deeplearning4j_tpu.models.lenet import build_lenet5

    jnet = build_lenet5()
    jnet.params, jnet.states = _f32(jnet.params), _f32(jnet.states)
    jnet.updater_state = jnet.updater.init(jnet.params)
    pnet = MultiLayerNetwork(
        pconf.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(jnet._input_shape)
    pnet.params, pnet.states = _to_port(jnet.params), _to_port(jnet.states)
    pnet.updater_state = pnet.updater.init(pnet.params)
    return jnet, pnet


def _graph_conf_json():
    from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex
    from deeplearning4j_tpu.nn.conf.layers import (
        ActivationLayer,
        BatchNormalization,
        ConvolutionLayer,
        OutputLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )

    gb = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
          .updater("nesterovs").momentum(0.9).l2(1e-4).weight_init("relu")
          .graph_builder().add_inputs("in"))
    gb.add_layer("c1", ConvolutionLayer(n_in=3, n_out=8, kernel_size=(3, 3),
                                        padding=(1, 1),
                                        activation="identity"), "in")
    gb.add_layer("bn1", BatchNormalization(n_in=8, n_out=8), "c1")
    gb.add_layer("a1", ActivationLayer(activation="relu"), "bn1")
    gb.add_layer("c2", ConvolutionLayer(n_in=8, n_out=8, kernel_size=(3, 3),
                                        padding=(1, 1),
                                        activation="identity"), "a1")
    gb.add_layer("proj", ConvolutionLayer(n_in=3, n_out=8,
                                          kernel_size=(1, 1),
                                          activation="identity"), "in")
    gb.add_vertex("add", ElementWiseVertex(op="add"), "c2", "proj")
    gb.add_layer("pool", SubsamplingLayer(pooling_type="avg",
                                          kernel_size=(8, 8),
                                          stride=(8, 8)), "add")
    gb.add_layer("out", OutputLayer(n_in=8, n_out=4, activation="softmax",
                                    loss_function="mcxent"), "pool",
                 preprocessor=CnnToFeedForwardPreProcessor(1, 1, 8))
    return gb.set_outputs("out").build().to_json()


def _graph_pair():
    from deeplearning4j_tpu.nn.conf.graph import (
        ComputationGraphConfiguration as JConf,
    )
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    js = _graph_conf_json()
    jnet = JGraph(JConf.from_json(js)).init({"in": (8, 8, 3)})
    jnet.params, jnet.states = _f32(jnet.params), _f32(jnet.states)
    jnet.updater_state = {n: jnet.updaters[n].init(jnet.params[n])
                          for n in jnet.layer_names}
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(js),
                            device="cpu").init({"in": (8, 8, 3)})
    pnet.params, pnet.states = _to_port(jnet.params), _to_port(jnet.states)
    pnet.updater_state = pnet.updater.init(pnet.params)
    return jnet, pnet


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "mln":
        x = rng.random((8, 28, 28, 1)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    else:
        x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    return x, y


def _triple(snap):
    return (snap["scale"], snap["good"], snap["skipped"])


def _sync(jnet, pnet):
    """The port graph's params, states and updater state set to the JAX
    graph's, bit for bit."""
    pnet.params, pnet.states = _to_port(jnet.params), _to_port(jnet.states)
    pnet.updater_state = _to_port(jnet.updater_state)


def _weight_leaf(kind, params):
    """The first conv's weight leaf of either package's params."""
    return params[0]["W"] if kind == "mln" else params["c1"]["W"]


def _poison(kind, jnet, pnet):
    """An inf in the first conv's weight in both packages."""
    jhost = jax.tree_util.tree_map(np.array, jnet.params)
    w = _weight_leaf(kind, jhost)
    w[0, 0, 0, 0] = np.inf
    jnet.params = _f32(jhost)
    with torch.no_grad():
        _weight_leaf(kind, pnet.params)[0, 0, 0, 0] = float("inf")


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_BF16", "1")
    monkeypatch.setenv("DL4J_TPU_LOSS_SCALE", "8:2")


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_scale_sequence_and_skipped_step_follow_jax(bf16, kind):
    jnet, pnet = _mln_pair() if kind == "mln" else _graph_pair()
    want = [(8.0, 1, 0), (16.0, 0, 0), (16.0, 1, 0), (32.0, 0, 0),
            (32.0, 1, 0)]
    for seed in range(5):
        x, y = _batch(kind, seed)
        if kind == "graph":
            _sync(jnet, pnet)
        jl = float(jnet.fit(jnp.asarray(x), jnp.asarray(y)))
        pl = float(pnet.fit(x, y))
        bar = LOSS_TOL if kind == "mln" else BF16_ULP * abs(jl)
        assert abs(jl - pl) <= bar, (seed, jl, pl)
        assert _triple(pnet.loss_scale) == _triple(jnet.loss_scale) \
            == want[seed]
    for a in tree_leaves(pnet.params):
        assert a.dtype == torch.float32  # the masters stay f32
    if kind == "mln":  # free-running: close to JAX's at the bf16 bar
        for a, b in zip(tree_leaves(pnet.params),
                        jax.tree_util.tree_leaves(jnet.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-2)
    _poison(kind, jnet, pnet)
    before_p = tree_map(torch.clone, pnet.params)
    before_s = tree_map(torch.clone, pnet.states)
    before_u = tree_map(torch.clone, pnet.updater_state)
    before_j = jax.tree_util.tree_map(np.array, jnet.params)
    x, y = _batch(kind, 9)
    jnet.fit(jnp.asarray(x), jnp.asarray(y))
    pnet.fit(x, y)
    assert _triple(pnet.loss_scale) == _triple(jnet.loss_scale) \
        == (16.0, 0, 1)
    assert pnet.dispatch_stats.loss_scale_skips == 1
    for a, b in zip(tree_leaves(pnet.params), tree_leaves(before_p)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(pnet.states), tree_leaves(before_s)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(pnet.updater_state), tree_leaves(before_u)):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                    jax.tree_util.tree_leaves(before_j)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert pnet.iteration == jnet.iteration == 6


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_batches_runs_the_scaled_step(bf16, kind):
    _, pnet = _mln_pair() if kind == "mln" else _graph_pair()
    xs, ys = zip(*(_batch(kind, s) for s in range(3)))
    losses = pnet.fit_batches(np.stack(xs), np.stack(ys))
    assert losses.shape == (3,) and np.isfinite(losses).all()
    assert _triple(pnet.loss_scale) == (16.0, 1, 0)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_scale_rides_the_zip_both_ways(bf16, kind, tmp_path):
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    jnet, pnet = _mln_pair() if kind == "mln" else _graph_pair()
    for seed in range(3):
        x, y = _batch(kind, seed)
        pnet.fit(x, y)
        jnet.fit(jnp.asarray(x), jnp.asarray(y))
    path = str(tmp_path / "port.zip")
    pser.write_model(pnet, path)
    back = ModelSerializer.restore(path)
    assert _triple(back.loss_scale) == _triple(pnet.loss_scale) \
        == (16.0, 1, 0)
    jpath = str(tmp_path / "jax.zip")
    ModelSerializer.write_model(jnet, jpath,
                                training_state=jnet.training_state())
    pback = pser.restore(jpath, device="cpu")
    assert type(pback) is type(pnet)
    assert _triple(pback.loss_scale) == _triple(jnet.loss_scale)
    x, y = _batch(kind, 7)
    pback.fit(x, y)
    assert _triple(pback.loss_scale) == (32.0, 0, 0)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_knob_off_is_the_f32_step(monkeypatch, kind):
    monkeypatch.delenv("DL4J_TPU_BF16", raising=False)
    jnet, pnet = _mln_pair() if kind == "mln" else _graph_pair()
    x, y = _batch(kind, 0)
    jl = float(jnet.fit(jnp.asarray(x), jnp.asarray(y)))
    pl = float(pnet.fit(x, y))
    assert abs(jl - pl) <= 1e-5
    assert pnet.loss_scale is None and jnet.loss_scale is None
    assert "loss_scale" not in pnet.training_state()
