"""The port's ComputationGraph against the JAX package's, on the CPU.

Each case builds the JAX graph from the JAX package's builder, carries its
params (lifted to f64; x64 is on in ``tests/conftest.py``) into the port's
graph of the same configuration JSON, and runs both on the same
numpy-seeded inputs, at 1e-10 abs unless a case says otherwise (the cases
of ``tests/test_computation_graph.py``):

  * the conf: the port's builder writes the JAX package's JSON string
    byte for byte (and reads it back); YAML both ways; topological order;
    a cycle, an unknown input and a duplicate name refused as JAX refuses
    them;
  * every vertex's activation through ``feed_forward`` (Merge, each
    ElementWise op, Subset, Scale, a Preprocessor vertex, LastTimeStep
    with and without a mask, DuplicateToTimeSeries);
  * fits, losses and every param and updater leaf after: a merge graph, a
    residual graph, two outputs with summed losses, a feature mask
    reaching an RnnOutputLayer's loss, the encoder-decoder seq2seq graph,
    TBPTT windows with carried state, ``fit_batches`` (== serial fits ==
    JAX's scan), ``gradient_checkpointing`` (== plain), the
    ``performance`` dtype policy (bf16 compute, f32 masters; at 1e-2),
    ``fit_iterator`` over DataSets and MultiDataSets;
  * ``rnn_time_step`` step by step against JAX's and against ``output``;
  * LBFGS through ``Solver.optimize_graph`` and ``check_graph_gradients``;
  * zips both ways (f32 ``output`` within 1e-5), ``clone``, ``evaluate``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: E402
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import graph as pgraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_map  # noqa: E402
from deeplearning4j_tpu_torch.utils import serialization as pser  # noqa: E402

TOL = 1e-10


def J():
    """The JAX package's conf modules (imported inside the tests)."""
    from deeplearning4j_tpu.nn.conf import graph as g
    from deeplearning4j_tpu.nn.conf import layers as l
    from deeplearning4j_tpu.nn.conf.builder import NeuralNetConfiguration

    return NeuralNetConfiguration, g, l


def _jgraph(conf, shapes=None, dtype=jnp.float64):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

    jnet = JGraph(conf).init(shapes)
    jnet.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                         jnet.params)
    jnet.states = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                         jnet.states)
    jnet.updater_state = {n: jnet.updaters[n].init(jnet.params[n])
                          for n in jnet.layer_names}
    return jnet


def _host(tree, dtype=np.float64):
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype)),
                    jax.tree_util.tree_map(np.asarray, tree))


def twin(jnet, dtype=np.float64):
    """The port's graph of the JAX graph's configuration with its params,
    states and updater state, in ``dtype``, on the CPU."""
    pnet = ComputationGraph(
        pgraph.ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(jnet._input_shapes)
    pnet.params, pnet.states = _host(jnet.params, dtype), _host(jnet.states,
                                                                 dtype)
    pnet.updater_state = _host(jnet.updater_state, dtype)
    return pnet


def max_diff(a, b) -> float:
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max([max_diff(a[k], b[k]) for k in a] or [0.0])
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not a.size:
        return 0.0
    return float(np.where(a == b, 0.0, np.abs(a - b)).max())


def assert_graphs_match(jnet, pnet, tol=TOL):
    assert max_diff(pnet.params, jnet.params) < tol
    assert max_diff(pnet.states, jnet.states) < tol
    assert max_diff(pnet.updater_state, jnet.updater_state) < tol
    assert pnet.iteration == jnet.iteration


def _fit_both(jnet, pnet, feats, labels, masks=None, label_masks=None,
              tol=TOL):
    def ja(xs):
        if xs is None or not isinstance(xs, (list, tuple)):
            return None if xs is None else jnp.asarray(xs)
        return [None if v is None else jnp.asarray(v) for v in xs]

    jl = float(jnet.fit(ja(feats), ja(labels), masks=ja(masks),
                        label_masks=ja(label_masks)))
    pl = float(pnet.fit(feats, labels, masks, label_masks))
    assert abs(jl - pl) < tol, (jl, pl)
    return pl


def simple_conf(NNC, l, seed=12345, lr=0.1):
    return (NNC.builder().seed(seed).learning_rate(lr).graph_builder()
            .add_inputs("in")
            .add_layer("d1", l.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", l.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"), "d1")
            .set_outputs("out").build())


def iris_like(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = np.eye(3)[rng.integers(0, 3, n)]
    return x, y


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def _merge_conf(b, g, l):
    """The same graph from either package's modules (``b`` builder class,
    ``g`` graph conf module, ``l`` layer conf module)."""
    return (b.builder().seed(11).learning_rate(0.05).updater("nesterovs")
            .momentum(0.9).l2(1e-3).graph_builder().add_inputs("a", "b")
            .add_layer("da", l.DenseLayer(n_in=3, n_out=4,
                                          activation="tanh"), "a")
            .add_layer("db", l.DenseLayer(n_in=3, n_out=4,
                                          activation="sigmoid"), "b")
            .add_vertex("m", g.MergeVertex(), "da", "db")
            .add_vertex("s", g.SubsetVertex(from_index=1, to_index=6), "m")
            .add_vertex("sc", g.ScaleVertex(scale=0.5), "s")
            .add_layer("out", l.OutputLayer(n_in=6, n_out=2,
                                            activation="softmax",
                                            loss_function="mcxent"), "sc")
            .set_outputs("out").backprop_type("truncated_bptt")
            .t_bptt_forward_length(7).dtype_policy("strict").build())


class TestConf:
    def test_json_is_the_jax_string_and_reads_back(self):
        NNC, g, l = J()
        jconf = _merge_conf(NNC, g, l)
        pconf_ = _merge_conf(pconf.NeuralNetConfiguration, pgraph, pconf)
        assert pconf_.to_json() == jconf.to_json()
        back = pgraph.ComputationGraphConfiguration.from_json(jconf.to_json())
        assert back.to_json() == jconf.to_json()
        assert back.topological_order() == jconf.topological_order()

    def test_yaml_both_ways(self):
        NNC, g, l = J()
        from deeplearning4j_tpu.nn.conf.graph import (
            ComputationGraphConfiguration as JConf,
        )

        jconf = _merge_conf(NNC, g, l)
        p = pgraph.ComputationGraphConfiguration.from_yaml(jconf.to_yaml())
        assert p.to_json() == jconf.to_json()
        assert JConf.from_yaml(p.to_yaml()).to_json() == jconf.to_json()

    def test_preprocessor_vertex_and_layer_preprocessor_round_trip(self):
        NNC, g, l = J()
        from deeplearning4j_tpu.nn.conf.preprocessors import (
            ReshapePreProcessor,
        )

        jconf = (NNC.builder().graph_builder().add_inputs("in")
                 .add_vertex("r", g.PreprocessorVertex(
                     preprocessor=ReshapePreProcessor((2, 3))), "in")
                 .add_layer("out", l.OutputLayer(n_in=3, n_out=2), "r")
                 .set_outputs("out").build())
        p = pgraph.ComputationGraphConfiguration.from_json(jconf.to_json())
        assert p.to_json() == jconf.to_json()

    def test_topological_order_and_refusals(self):
        b, g, l = pconf.NeuralNetConfiguration, pgraph, pconf
        conf = simple_conf(b, l)
        assert conf.topological_order() == ["d1", "out"]
        bad = pgraph.ComputationGraphConfiguration(
            inputs=["in"], vertices={"a": l.DenseLayer(n_in=2, n_out=2),
                                     "b": l.DenseLayer(n_in=2, n_out=2)},
            vertex_inputs={"a": ["b"], "b": ["a"]}, outputs=["b"])
        with pytest.raises(ValueError, match="cycle"):
            bad.validate()
        with pytest.raises(ValueError, match="unknown input"):
            (b.builder().graph_builder().add_inputs("in")
             .add_layer("d", l.DenseLayer(n_in=2, n_out=2), "nope")
             .set_outputs("d").build())
        with pytest.raises(ValueError, match="duplicate"):
            (b.builder().graph_builder().add_inputs("in")
             .add_layer("d", l.DenseLayer(n_in=2, n_out=2), "in")
             .add_layer("d", l.DenseLayer(n_in=2, n_out=2), "in"))
        with pytest.raises(ValueError, match="no outputs"):
            b.builder().graph_builder().add_inputs("in").build()
        with pytest.raises(ValueError, match="unknown elementwise"):
            g.ElementWiseVertex(op="nope")


# ---------------------------------------------------------------------------
# vertices, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_elementwise_vertices_forward(op):
    NNC, g, l = J()
    conf = (NNC.builder().seed(2).graph_builder().add_inputs("a", "b")
            .add_layer("da", l.DenseLayer(n_in=3, n_out=5), "a")
            .add_layer("db", l.DenseLayer(n_in=3, n_out=5), "b")
            .add_layer("dc", l.DenseLayer(n_in=3, n_out=5), "a")
            .add_vertex("e", g.ElementWiseVertex(op=op), "da", "db", "dc")
            .add_layer("out", l.OutputLayer(n_in=5, n_out=2), "e")
            .set_outputs("out").build())
    jnet = _jgraph(conf)
    pnet = twin(jnet)
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    jacts = jnet.feed_forward(jnp.asarray(a), jnp.asarray(b))
    pacts = pnet.feed_forward(a, b)
    assert set(pacts) == set(jacts)
    for k in jacts:
        assert max_diff(pacts[k], jacts[k]) < TOL, k


def test_merge_subset_scale_and_fits():
    NNC, g, l = J()
    jnet = _jgraph(_merge_conf(NNC, g, l).__class__.from_json(
        _merge_conf(NNC, g, l).to_json().replace("truncated_bptt",
                                                 "standard")))
    pnet = twin(jnet)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    y = np.eye(2)[rng.integers(0, 2, 6)]
    jacts = jnet.feed_forward(jnp.asarray(a), jnp.asarray(b))
    pacts = pnet.feed_forward(a, b)
    for k in ("m", "s", "sc", "out"):
        assert max_diff(pacts[k], jacts[k]) < TOL, k
    assert tuple(pacts["s"].shape) == (6, 6)
    for _ in range(3):
        _fit_both(jnet, pnet, [a, b], [y])
    assert_graphs_match(jnet, pnet)
    s = pnet.score([a, b], [y])
    assert abs(s - jnet.score([jnp.asarray(a), jnp.asarray(b)],
                              [jnp.asarray(y)])) < TOL


def test_residual_graph_with_bn_fits():
    NNC, g, l = J()
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )

    gb = (NNC.builder().seed(9).learning_rate(0.05).updater("nesterovs")
          .momentum(0.9).l2(1e-4).graph_builder().add_inputs("in"))
    gb.add_layer("c", l.ConvolutionLayer(n_in=2, n_out=4, kernel_size=(3, 3),
                                         padding=(1, 1)), "in")
    gb.add_layer("bn", l.BatchNormalization(n_in=4, n_out=4), "c")
    gb.add_layer("p", l.ConvolutionLayer(n_in=2, n_out=4,
                                         kernel_size=(1, 1)), "in")
    gb.add_vertex("add", g.ElementWiseVertex(op="add"), "bn", "p")
    gb.add_layer("act", l.ActivationLayer(activation="relu"), "add")
    gb.add_layer("pool", l.SubsamplingLayer(pooling_type="max",
                                            kernel_size=(2, 2),
                                            stride=(2, 2)), "act")
    gb.add_layer("out", l.OutputLayer(n_in=36, n_out=3, activation="softmax",
                                      loss_function="mcxent"), "pool",
                 preprocessor=CnnToFeedForwardPreProcessor(3, 3, 4))
    jnet = _jgraph(gb.set_outputs("out").build(), {"in": (6, 6, 2)})
    pnet = twin(jnet)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 6, 6, 2))
    y = np.eye(3)[rng.integers(0, 3, 5)]
    for _ in range(3):
        _fit_both(jnet, pnet, x, y)
    assert_graphs_match(jnet, pnet)
    assert max_diff(pnet.output(x)[0], jnet.output(jnp.asarray(x))[0]) < TOL


def test_two_outputs_sum_losses():
    NNC, g, l = J()
    conf = (NNC.builder().seed(3).learning_rate(0.1).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("shared", l.DenseLayer(n_in=4, n_out=6,
                                              activation="relu"), "in")
            .add_layer("o1", l.OutputLayer(n_in=6, n_out=3,
                                           activation="softmax",
                                           loss_function="mcxent"), "shared")
            .add_layer("o2", l.OutputLayer(n_in=6, n_out=2,
                                           activation="identity",
                                           loss_function="mse"), "shared")
            .set_outputs("o1", "o2").build())
    jnet = _jgraph(conf)
    pnet = twin(jnet)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4))
    y1, y2 = np.eye(3)[rng.integers(0, 3, 8)], rng.normal(size=(8, 2))
    for _ in range(3):
        _fit_both(jnet, pnet, x, [y1, y2])
    assert_graphs_match(jnet, pnet, tol=1e-9)  # Adam: f32 bias correction
    outs = pnet.output(x)
    assert [tuple(o.shape) for o in outs] == [(8, 3), (8, 2)]
    for p, j in zip(outs, jnet.output(jnp.asarray(x))):
        assert max_diff(p, j) < TOL


# ---------------------------------------------------------------------------
# recurrent vertices
# ---------------------------------------------------------------------------


def _last_step_conf(NNC, g, l):
    return (NNC.builder().seed(4).learning_rate(0.1).graph_builder()
            .add_inputs("seq")
            .add_layer("lstm", l.GravesLSTM(n_in=3, n_out=5,
                                            activation="tanh"), "seq")
            .add_vertex("last", g.LastTimeStepVertex(mask_input="seq"),
                        "lstm")
            .add_layer("out", l.OutputLayer(n_in=5, n_out=2,
                                            activation="softmax",
                                            loss_function="mcxent"), "last")
            .set_outputs("out").build())


def test_last_time_step_vertex_with_and_without_mask():
    NNC, g, l = J()
    jnet = _jgraph(_last_step_conf(NNC, g, l), {"seq": (-1, 3)})
    pnet = twin(jnet)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 3))
    mask = np.ones((3, 9))
    mask[0, 4:] = 0
    mask[2, 7:] = 0
    y = np.eye(2)[rng.integers(0, 2, 3)]
    jacts = jnet.feed_forward(jnp.asarray(x))
    pacts = pnet.feed_forward(x)
    assert max_diff(pacts["last"], jacts["last"]) < TOL
    jm, _ = jnet._forward(jnet.params, jnet.states, {"seq": jnp.asarray(x)},
                          train=False, masks={"seq": jnp.asarray(mask)})
    pm, _ = pnet._forward(pnet.params, pnet.states,
                          {"seq": torch.from_numpy(x)},
                          masks={"seq": torch.from_numpy(mask)})
    assert max_diff(pm["last"], jm["last"]) < TOL
    np.testing.assert_array_equal(pm["last"][0].numpy(),
                                  pm["lstm"][0, 3].numpy())
    for _ in range(2):
        _fit_both(jnet, pnet, x, y, masks=[mask])
    assert_graphs_match(jnet, pnet)


def test_feature_mask_reaches_the_rnn_output_loss():
    NNC, g, l = J()
    conf = (NNC.builder().seed(8).graph_builder().add_inputs("seq")
            .add_layer("lstm", l.GravesLSTM(n_in=2, n_out=4,
                                            activation="tanh"), "seq")
            .add_layer("out", l.RnnOutputLayer(n_in=4, n_out=2,
                                               activation="softmax",
                                               loss_function="mcxent"),
                       "lstm")
            .set_outputs("out").build())
    jnet = _jgraph(conf, {"seq": (-1, 2)})
    pnet = twin(jnet)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 2))
    y = np.tile(np.array([[1.0, 0.0]]), (2, 6, 1))
    mask = np.ones((2, 6))
    mask[:, 3:] = 0.0
    y2 = y.copy()
    y2[:, 3:] = np.array([0.0, 1.0])
    clean = pnet.score(x, y, masks=[mask])
    assert clean == pnet.score(x, y2, masks=[mask])
    assert abs(clean - pnet.score(x, y)) > 1e-9
    jl, _ = jnet._loss(jnet.params, jnet.states, {"seq": jnp.asarray(x)},
                       [jnp.asarray(y2)], train=False, rng=None,
                       masks={"seq": jnp.asarray(mask)})
    assert abs(float(jl) - clean) < TOL
    for _ in range(2):
        _fit_both(jnet, pnet, x, y, masks=[mask])
    assert_graphs_match(jnet, pnet)


def seq2seq_conf(NNC, g, l, *, vocab=5, hidden=6, tbptt=None):
    """encoder GravesLSTM -> LastTimeStep -> DuplicateToTimeSeries against
    the decoder input -> Merge with it -> decoder GravesLSTM ->
    RnnOutputLayer (the smoke's seq2seq graph at small widths)."""
    gb = (NNC.builder().seed(6).learning_rate(0.1).updater("rmsprop")
          .graph_builder().add_inputs("enc_in", "dec_in")
          .add_layer("enc", l.GravesLSTM(n_in=vocab, n_out=hidden,
                                         activation="tanh"), "enc_in")
          .add_vertex("last", g.LastTimeStepVertex(), "enc")
          .add_vertex("dup", g.DuplicateToTimeSeriesVertex(
              reference_input="dec_in"), "last")
          .add_vertex("merge", g.MergeVertex(), "dup", "dec_in")
          .add_layer("dec", l.GravesLSTM(n_in=hidden + vocab, n_out=hidden,
                                         activation="tanh"), "merge")
          .add_layer("out", l.RnnOutputLayer(n_in=hidden, n_out=vocab,
                                             activation="softmax",
                                             loss_function="mcxent"), "dec")
          .set_outputs("out"))
    if tbptt:
        gb = (gb.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
              .t_bptt_backward_length(tbptt))
    return gb.build()


SEQ2SEQ_SHAPES = {"enc_in": (-1, 5), "dec_in": (-1, 5)}


def seq2seq_batch(n=3, t=10, vocab=5, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(vocab)
    enc = eye[rng.integers(0, vocab, (n, t))]
    dec = eye[rng.integers(0, vocab, (n, t))]
    y = eye[rng.integers(0, vocab, (n, t))]
    return enc, dec, y


def test_seq2seq_fits_and_duplicate_vertex():
    NNC, g, l = J()
    jnet = _jgraph(seq2seq_conf(NNC, g, l), SEQ2SEQ_SHAPES)
    pnet = twin(jnet)
    enc, dec, y = seq2seq_batch()
    pacts = pnet.feed_forward(enc, dec)
    assert tuple(pacts["dup"].shape) == (3, 10, 6)
    np.testing.assert_array_equal(pacts["dup"][:, 4].numpy(),
                                  pacts["last"].numpy())
    first = _fit_both(jnet, pnet, [enc, dec], [y])
    for _ in range(9):
        last = _fit_both(jnet, pnet, [enc, dec], [y])
    assert last < first
    assert_graphs_match(jnet, pnet)


def test_tbptt_carries_state_across_windows():
    NNC, g, l = J()
    jnet = _jgraph(seq2seq_conf(NNC, g, l, tbptt=4), SEQ2SEQ_SHAPES)
    pnet = twin(jnet)
    enc, dec, y = seq2seq_batch(t=10)
    for _ in range(2):
        _fit_both(jnet, pnet, [enc, dec], [y])
    assert pnet.iteration == jnet.iteration == 6  # 3 windows a fit
    assert_graphs_match(jnet, pnet)


def test_rnn_time_step_streams_as_jax_and_as_output():
    NNC, g, l = J()
    conf = (NNC.builder().seed(4).graph_builder().add_inputs("seq")
            .add_layer("l1", l.GravesLSTM(n_in=3, n_out=4,
                                          activation="tanh"), "seq")
            .add_layer("l2", l.GravesLSTM(n_in=4, n_out=4,
                                          activation="tanh"), "l1")
            .add_layer("out", l.RnnOutputLayer(n_in=4, n_out=3,
                                               activation="softmax",
                                               loss_function="mcxent"),
                       "l2")
            .set_outputs("out").build())
    jnet = _jgraph(conf, {"seq": (-1, 3)})
    pnet = twin(jnet)
    seq = np.random.default_rng(0).normal(size=(2, 9, 3))
    (full,) = pnet.output(seq)
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    for t in range(9):
        (p,) = pnet.rnn_time_step(seq[:, t])
        (j,) = jnet.rnn_time_step(jnp.asarray(seq[:, t]))
        assert max_diff(p, j) < TOL
        assert max_diff(p, full[:, t]) < TOL
    # a whole sequence in one call gives its last step
    pnet.rnn_clear_previous_state()
    (p,) = pnet.rnn_time_step(seq)
    assert max_diff(p, full[:, -1]) < TOL


# ---------------------------------------------------------------------------
# training paths
# ---------------------------------------------------------------------------


def _dense_conf(NNC, l, *, seed=3, updater="adam", ckpt=False,
                policy="strict"):
    return (NNC.builder().seed(seed).learning_rate(0.1).updater(updater)
            .graph_builder().add_inputs("in")
            .add_layer("d", l.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", l.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"), "d")
            .set_outputs("out").gradient_checkpointing(ckpt)
            .dtype_policy(policy).build())


def test_fit_batches_equals_serial_fits_and_jax():
    NNC, g, l = J()
    jnet = _jgraph(_dense_conf(NNC, l, updater="nesterovs"))
    pnet, serial = twin(jnet), twin(jnet)
    x, y = iris_like(90, seed=2)
    xs, ys = x.reshape(3, 30, 4), y.reshape(3, 30, 3)
    jl = np.asarray(jnet.fit_batches(jnp.asarray(xs), jnp.asarray(ys)))
    pl = pnet.fit_batches(xs, ys)
    sl = [float(serial.fit(xs[k], ys[k])) for k in range(3)]
    np.testing.assert_array_equal(pl, np.asarray(sl, np.float32))
    assert np.abs(jl - pl).max() < 1e-6  # both round the losses to f32
    assert_graphs_match(jnet, pnet)
    assert max_diff(pnet.params, serial.params) == 0.0


def test_remat_equals_plain():
    NNC, g, l = J()
    jplain = _jgraph(_dense_conf(NNC, l, seed=17))
    plain = twin(jplain)
    ckpt = ComputationGraph(pgraph.ComputationGraphConfiguration.from_json(
        _dense_conf(NNC, l, seed=17, ckpt=True).to_json()), device="cpu")
    ckpt.init()
    ckpt.params, ckpt.states = _host(jplain.params), _host(jplain.states)
    ckpt.updater_state = _host(jplain.updater_state)
    assert ckpt.conf.gradient_checkpointing is True
    x, y = iris_like(30)
    for _ in range(3):
        a = _fit_both(jplain, plain, x, y, tol=1e-9)
        b = float(ckpt.fit(x, y))
        assert a == b
    assert max_diff(ckpt.params, plain.params) == 0.0


def test_performance_policy_trains_with_f32_masters():
    NNC, g, l = J()
    jnet = _jgraph(_dense_conf(NNC, l, seed=19, policy="performance"),
                   dtype=jnp.float32)
    pnet = twin(jnet, np.float32)
    x, y = iris_like(60, seed=4)
    x, y = x.astype(np.float32), y.astype(np.float32)
    first = _fit_both(jnet, pnet, x, y, tol=1e-2)
    for _ in range(40):
        loss = float(pnet.fit(x, y))
    assert loss < first * 0.7
    for lp in pnet.params.values():
        for a in lp.values():
            assert a.dtype == torch.float32


def test_lbfgs_through_optimize_graph():
    NNC, g, l = J()
    conf = (NNC.builder().seed(5).optimization_algo("lbfgs").iterations(10)
            .max_num_line_search_iterations(10).graph_builder()
            .add_inputs("in")
            .add_layer("d1", l.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                       "in")
            .add_layer("out", l.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"), "d1")
            .set_outputs("out").build())
    jnet = _jgraph(conf)
    pnet = twin(jnet)
    x, y = iris_like(32)
    before = pnet.score(x, y)
    jnet.fit(jnp.asarray(x), jnp.asarray(y))
    pnet.fit(x, y)
    after = pnet.score(x, y)
    assert after < before * 0.7
    assert abs(after - jnet.score(jnp.asarray(x), jnp.asarray(y))) < 1e-8
    assert max_diff(pnet.params, jnet.params) < 1e-7
    assert pnet.iteration == jnet.iteration


def test_check_graph_gradients_agrees_with_jax():
    NNC, g, l = J()
    from deeplearning4j_tpu.utils.gradient_check import (
        check_graph_gradients as jcheck,
    )

    from deeplearning4j_tpu_torch.utils.gradient_check import (
        check_graph_gradients,
    )

    jnet = _jgraph(_merge_conf(NNC, g, l).__class__.from_json(
        _merge_conf(NNC, g, l).to_json().replace("truncated_bptt",
                                                 "standard")))
    pnet = twin(jnet)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    y = np.eye(2)[rng.integers(0, 2, 4)]
    ok, rel = check_graph_gradients(pnet, [a, b], [y],
                                    max_params_per_leaf=10)
    jok, _ = jcheck(jnet, [a, b], [y], max_params_per_leaf=10)
    assert ok and jok, rel
    # a wrong gradient is caught: scale the loss inside the value only
    orig = pnet._loss

    def skewed(p, *args, **kw):
        val, st = orig(p, *args, **kw)
        return val + 1e-3 * torch.sum(p["da"]["W"].detach() * p["da"]["W"]), st

    pnet._loss = skewed
    bad, _ = check_graph_gradients(pnet, [a, b], [y],
                                   max_params_per_leaf=10)
    assert not bad


def test_fit_iterator_over_datasets_and_multidatasets():
    NNC, g, l = J()
    jnet = _jgraph(_merge_conf(NNC, g, l).__class__.from_json(
        _merge_conf(NNC, g, l).to_json().replace("truncated_bptt",
                                                 "standard")))
    a_net, b_net = twin(jnet), twin(jnet)
    rng = np.random.default_rng(7)
    batches = [MultiDataSet([rng.normal(size=(5, 3)),
                             rng.normal(size=(5, 3))],
                            [np.eye(2)[rng.integers(0, 2, 5)]])
               for _ in range(3)]
    a_net.fit_iterator(batches, num_epochs=2)
    b_net.fit_iterator(batches, num_epochs=2, fused_batches=2)
    assert max_diff(a_net.params, b_net.params) == 0.0
    assert a_net.iteration == 6
    from deeplearning4j_tpu.datasets.iterator import (
        MultiDataSet as JMulti,
    )

    jnet.fit_iterator([JMulti([jnp.asarray(f) for f in m.features_list],
                              [jnp.asarray(v) for v in m.labels_list])
                       for m in batches], num_epochs=2)
    assert_graphs_match(jnet, a_net)
    # a single-input graph takes DataSets
    single = twin(_jgraph(_dense_conf(NNC, l)))
    x, y = iris_like(20)
    single.fit_iterator([DataSet(x[:10], y[:10]), DataSet(x[10:], y[10:])])
    assert single.iteration == 2
    ev = single.evaluate([DataSet(x, y)])
    assert 0.0 <= ev.accuracy() <= 1.0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestZipsBothWays:
    def _trained(self):
        NNC, g, l = J()
        jnet = _jgraph(_merge_conf(NNC, g, l).__class__.from_json(
            _merge_conf(NNC, g, l).to_json().replace("truncated_bptt",
                                                     "standard")),
            dtype=jnp.float32)
        rng = np.random.default_rng(2)
        a = rng.normal(size=(6, 3)).astype(np.float32)
        b = rng.normal(size=(6, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
        jnet.fit([jnp.asarray(a), jnp.asarray(b)], [jnp.asarray(y)])
        return jnet, a, b, y

    def test_jax_zip_loads_in_the_port(self, tmp_path):
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet, a, b, y = self._trained()
        path = str(tmp_path / "g.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = pser.restore(path, device="cpu")
        assert isinstance(pnet, ComputationGraph)
        assert pnet.iteration == jnet.iteration == 1
        np.testing.assert_allclose(
            pnet.output(a, b)[0].numpy(),
            np.asarray(jnet.output(jnp.asarray(a), jnp.asarray(b))[0]),
            rtol=0, atol=1e-5)
        assert max_diff(pnet.updater_state, jnet.updater_state) == 0.0
        # and it resumes as JAX resumes
        jl = float(jnet.fit([jnp.asarray(a), jnp.asarray(b)],
                            [jnp.asarray(y)]))
        pl = float(pnet.fit([a, b], [y]))
        assert abs(jl - pl) < 1e-5

    def test_port_zip_loads_in_jax(self, tmp_path):
        from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        jnet, a, b, y = self._trained()
        pnet = twin(jnet, np.float32)
        pnet.iteration = jnet.iteration
        pnet.fit([a, b], [y])
        path = str(tmp_path / "p.zip")
        pser.write_model(pnet, path)
        back = ModelSerializer.restore(path)
        assert isinstance(back, JGraph) and back.iteration == 2
        np.testing.assert_allclose(
            np.asarray(back.output(jnp.asarray(a), jnp.asarray(b))[0]),
            pnet.output(a, b)[0].numpy(), rtol=0, atol=1e-5)

    def test_leafless_vertices_and_bn_state_survive(self, tmp_path):
        """A pooling or activation layer's ``{}`` writes no npz leaf and
        BN's running state nests under its vertex: both load back."""
        from deeplearning4j_tpu.utils.serialization import ModelSerializer

        NNC, g, l = J()
        gb = (NNC.builder().seed(1).graph_builder().add_inputs("in"))
        gb.add_layer("c", l.ConvolutionLayer(n_in=1, n_out=2,
                                             kernel_size=(2, 2)), "in")
        gb.add_layer("bn", l.BatchNormalization(n_in=2, n_out=2), "c")
        gb.add_layer("act", l.ActivationLayer(activation="relu"), "bn")
        gb.add_layer("pool", l.SubsamplingLayer(kernel_size=(2, 2),
                                                stride=(2, 2)), "act")
        from deeplearning4j_tpu.nn.conf.preprocessors import (
            CnnToFeedForwardPreProcessor,
        )

        gb.add_layer("out", l.OutputLayer(n_in=2, n_out=2), "pool",
                     preprocessor=CnnToFeedForwardPreProcessor(1, 1, 2))
        jnet = _jgraph(gb.set_outputs("out").build(), {"in": (3, 3, 1)},
                       dtype=jnp.float32)
        x = np.random.default_rng(0).normal(size=(4, 3, 3, 1)).astype(
            np.float32)
        jnet.fit(jnp.asarray(x), jnp.asarray(np.eye(2, dtype=np.float32)[
            [0, 1, 0, 1]]))
        path = str(tmp_path / "bn.zip")
        ModelSerializer.write_model(jnet, path)
        pnet = ComputationGraph.load(path, device="cpu")
        assert pnet.params["pool"] == {} and pnet.params["act"] == {}
        assert max_diff(pnet.states, jnet.states) == 0.0
        np.testing.assert_allclose(
            pnet.output(x)[0].numpy(),
            np.asarray(jnet.output(jnp.asarray(x))[0]), rtol=0, atol=1e-5)

    def test_clone_copies(self):
        NNC, g, l = J()
        pnet = twin(_jgraph(_dense_conf(NNC, l)))
        x, y = iris_like(8)
        pnet.fit(x, y)
        pnet.fit(x, y)
        c = pnet.clone()
        assert c.iteration == pnet.iteration == 2
        c.fit(x, y)
        assert max_diff(c.params, pnet.params) > 0.0
