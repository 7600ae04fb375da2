"""The port's early stopping (``deeplearning4j_tpu_torch/earlystopping/``)
against the JAX package's on the same f64 nets and batches: each of the
six terminations ends both runs at the same epoch for the same reason,
with the same best epoch and scores within 1e-10, on a MultiLayerNetwork
and a ComputationGraph; and the three savers give back the best model."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import earlystopping as jes  # noqa: E402
from deeplearning4j_tpu.datasets import iterator as jit  # noqa: E402
from deeplearning4j_tpu.nn import conf as jconf  # noqa: E402
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet  # noqa: E402

from deeplearning4j_tpu_torch import earlystopping as pes  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterator as pit  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as pconf  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves  # noqa: E402

TOL = 1e-10
_RNG = np.random.default_rng(4)
X = _RNG.standard_normal((40, 5))
Y = np.eye(3)[_RNG.integers(0, 3, 40)]
XV = _RNG.standard_normal((16, 5))
YV = np.eye(3)[_RNG.integers(0, 3, 16)]


def _conf(mod, graph, lr):
    b = (mod.NeuralNetConfiguration.builder().seed(3).learning_rate(lr)
         .updater("nesterovs"))
    dense = mod.DenseLayer(n_in=5, n_out=7, activation="tanh")
    out = mod.OutputLayer(n_in=7, n_out=3, activation="softmax",
                          loss_function="mcxent")
    if graph:
        return (b.graph_builder().add_inputs("in").add_layer("d", dense, "in")
                .add_layer("out", out, "d").set_outputs("out").build())
    return b.list().layer(0, dense).layer(1, out).build()


def _pair(graph=False, lr=0.1):
    """A JAX net in f64 and the port net with the same params in f64."""
    jnet = (JGraph if graph else JNet)(_conf(jconf, graph, lr)).init()
    jnet.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    jnet.updater_state = (
        {n: jnet.updaters[n].init(jnet.params[n]) for n in jnet.layer_names}
        if graph else jnet.updater.init(jnet.params))
    pnet = (ComputationGraph if graph else MultiLayerNetwork)(
        _conf(pconf, graph, lr), device="cpu").init()
    conv = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pnet.params = (
        {k: {n: conv(v) for n, v in p.items()} for k, p in jnet.params.items()}
        if graph else
        [{n: conv(v) for n, v in p.items()} for p in jnet.params])
    pnet.updater_state = pnet.updater.init(pnet.params)
    return jnet, pnet


def _poisoned(x):
    x = x.copy()
    x[18, 0] = np.nan  # batch 3 of every epoch
    return x


def _cfg(mod, epoch_terms, iter_terms, saver=None, x_val=XV):
    it_mod = jit if mod is jes else pit
    return (mod.EarlyStoppingConfiguration.builder()
            .score_calculator(mod.DataSetLossCalculator(
                it_mod.ListDataSetIterator(x_val, YV, 8)))
            .epoch_termination_conditions(*epoch_terms)
            .iteration_termination_conditions(*iter_terms)
            .model_saver(saver).build())


CASES = {
    "max_epochs": (lambda m: [m.MaxEpochsTerminationCondition(4)],
                   lambda m: [], 0.1, X),
    "score_improvement": (
        lambda m: [m.MaxEpochsTerminationCondition(30),
                   m.ScoreImprovementEpochTerminationCondition(1, 0.05)],
        lambda m: [], 0.1, X),
    "best_score": (lambda m: [m.MaxEpochsTerminationCondition(30),
                              m.BestScoreEpochTerminationCondition(1.01)],
                   lambda m: [], 0.3, X),
    "max_time": (lambda m: [m.MaxEpochsTerminationCondition(30)],
                 lambda m: [m.MaxTimeIterationTerminationCondition(0.0)],
                 0.1, X),
    "max_score": (lambda m: [m.MaxEpochsTerminationCondition(30)],
                  lambda m: [m.MaxScoreIterationTerminationCondition(1.0)],
                  3.0, X),
    "invalid_score": (
        lambda m: [m.MaxEpochsTerminationCondition(30)],
        lambda m: [m.InvalidScoreIterationTerminationCondition()], 0.1,
        _poisoned(X)),
}


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_terminations_follow_jax(case, graph):
    epoch_terms, iter_terms, lr, x = CASES[case]
    jnet, pnet = _pair(graph, lr)
    jr = jes.EarlyStoppingTrainer(
        _cfg(jes, epoch_terms(jes), iter_terms(jes)), jnet,
        jit.ListDataSetIterator(x, Y, 8)).fit()
    pr = pes.EarlyStoppingTrainer(
        _cfg(pes, epoch_terms(pes), iter_terms(pes)), pnet,
        pit.ListDataSetIterator(x, Y, 8), device="cpu").fit()
    assert pr.termination_reason == jr.termination_reason
    assert pr.termination_details == jr.termination_details
    assert pr.total_epochs == jr.total_epochs
    assert pr.best_model_epoch == jr.best_model_epoch
    assert sorted(pr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, s in jr.score_vs_epoch.items():
        assert abs(pr.score_vs_epoch[e] - s) <= TOL, (e, s)
    if jr.best_model_epoch >= 0:
        assert abs(pr.best_model_score - jr.best_model_score) <= TOL
    for a, b in zip(jax.tree_util.tree_leaves(jnet.params),
                    tree_leaves(pnet.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
    fired = {"max_epochs": "MaxEpochs", "score_improvement":
             "ScoreImprovement", "best_score": "BestScore",
             "max_time": "MaxTime", "max_score": "MaxScore",
             "invalid_score": "InvalidScore"}[case]
    assert pr.termination_details.startswith(fired)


def _score(net):
    return pes.DataSetLossCalculator(
        pit.ListDataSetIterator(XV, YV, 8)).calculate_score(net)


@pytest.mark.parametrize("saver", ["memory", "file", "manager", "none"])
def test_savers_give_back_the_best_model(saver, tmp_path):
    # f32: a saved zip loads as f32, as on the card
    pnet = MultiLayerNetwork(_conf(pconf, False, 0.3), device="cpu").init()
    s = {"memory": lambda: pes.InMemoryModelSaver(),
         "file": lambda: pes.LocalFileModelSaver(str(tmp_path)),
         "manager": lambda: pes.CheckpointManagerSaver(str(tmp_path),
                                                       keep_last=2),
         "none": lambda: None}[saver]()
    cfg = _cfg(pes, [pes.MaxEpochsTerminationCondition(5)], [], saver=s)
    cfg.save_last_model = s is not None
    r = pes.EarlyStoppingTrainer(cfg, pnet, pit.ListDataSetIterator(X, Y, 8),
                                 device="cpu").fit()
    assert r.total_epochs == 5 and r.best_model is not None
    assert abs(_score(r.best_model) - r.best_model_score) <= 1e-12
    assert r.best_model.params is not pnet.params
    if s is not None:
        latest = s.get_latest_model()
        assert abs(_score(latest) - r.score_vs_epoch[4]) <= 1e-12
    if saver == "manager":
        assert len(s.manager.checkpoints()) == 2
        # a new saver over the same directory continues the step chain
        again = pes.CheckpointManagerSaver(str(tmp_path), keep_last=2)
        assert again._saves == 5
        s.manager.close()


def test_a_failed_fit_ends_with_the_best_model():
    _, pnet = _pair()

    class Fails(pit.ListDataSetIterator):
        def __iter__(self):
            self.passes = getattr(self, "passes", 0) + 1
            if self.passes == 3:
                raise RuntimeError("feed lost")
            yield from super().__iter__()

    r = pes.EarlyStoppingTrainer(
        _cfg(pes, [pes.MaxEpochsTerminationCondition(9)], []), pnet,
        Fails(X, Y, 8), device="cpu").fit()
    assert r.termination_reason == "error"
    assert "feed lost" in r.termination_details
    assert r.best_model_epoch in (0, 1) and r.best_model is not pnet
