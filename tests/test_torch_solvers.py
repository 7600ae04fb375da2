"""The port's full-batch optimizers and Solver against the JAX package, on
the CPU, in f64.

  * ``line_gradient_descent``, ``conjugate_gradient`` and ``lbfgs`` on
    the JAX tests' sphere, Rosenbrock and Rastrigin objectives (the same
    start, from a numpy seed; both oracles answer with the same numbers):
    every point either package's optimizer asks its oracle for, in order,
    within 1e-10, and the same result (iterations, convergence, score
    within 1e-10). Rosenbrock runs 12 iterations there: its valley
    grows the last bits in which the two packages' dot products differ
    (their summation orders do) ~10x an iteration, past 1e-10 by the
    20th (CG 1.1e-8 at 20, LBFGS 3.1e-9 at 40, measured on this test's
    start); the port's own CG and LBFGS then cut Rosenbrock's score
    100-fold in 300 iterations, the JAX tests' bar. The backtracking line
    search and the terminations on their own.
  * The Solver on a small MultiLayerNetwork (dense tanh, softmax head, l2)
    and on a small LeNet-like CNN, each algorithm: ``fit`` with
    ``iterations=4``, then a second ``fit``: the score, every param and
    the iteration count against the JAX package's; the ``score`` LR
    policy's decay on a converged run.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.optimize import solvers as psol  # noqa: E402

from test_torch_cnn import TOL, assert_nets_match, jax_net_f64, port_twin  # noqa: E402

ALGOS = ["conjugate_gradient", "lbfgs", "line_gradient_descent"]


def _objectives():
    """name -> (jax f, torch f, x0 range, max iterations)."""
    return {
        "sphere": (lambda x: jnp.sum(x * x), lambda x: torch.sum(x * x),
                   4.0, 30),
        "rosenbrock": (
            lambda x: jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                              + (1.0 - x[:-1]) ** 2),
            lambda x: torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                + (1.0 - x[:-1]) ** 2),
            2.0, 12),
        "rastrigin": (
            lambda x: 10.0 * x.size + jnp.sum(
                x * x - 10.0 * jnp.cos(2.0 * jnp.pi * x)),
            lambda x: 10.0 * x.numel() + torch.sum(
                x * x - 10.0 * torch.cos(2.0 * np.pi * x)),
            4.0, 30),
    }


def _value_and_grad(f, x: np.ndarray):
    """The objective's value and gradient at x, both packages' oracles
    answering with these same numbers, so the comparison sees only the
    optimizers' own arithmetic (two autodiffs sum in other orders, and
    Rosenbrock's curvature grows those last bits past 1e-10)."""
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    val = f(t)
    (g,) = torch.autograd.grad(val, t)
    return float(val.detach()), g.numpy()


def _jax_oracle(f, log):
    def oracle(x):
        log.append(np.asarray(x))
        val, g = _value_and_grad(f, np.asarray(x))
        return jnp.asarray(val), jnp.asarray(g)

    return oracle


def _torch_oracle(f, log):
    def oracle(x):
        log.append(x.detach().numpy().copy())
        val, g = _value_and_grad(f, x.detach().numpy())
        return val, torch.from_numpy(g)

    return oracle


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["sphere", "rosenbrock", "rastrigin"])
@pytest.mark.parametrize("dim", [2, 10])
def test_optimizer_iterates_equal_jax(algo, name, dim):
    from deeplearning4j_tpu.optimize import solvers as jsol

    jf, tf, span, iters = _objectives()[name]
    x0 = np.random.default_rng(dim).uniform(-span, span, dim)
    jlog, plog = [], []
    jres = jsol.OPTIMIZERS[algo](_jax_oracle(tf, jlog), jnp.asarray(x0),
                                 max_iterations=iters,
                                 line_search_iterations=20)
    pres = psol.OPTIMIZERS[algo](_torch_oracle(tf, plog),
                                 torch.from_numpy(x0),
                                 max_iterations=iters,
                                 line_search_iterations=20)
    assert len(plog) == len(jlog) > 1
    for a, b in zip(jlog, plog):
        assert np.abs(a - b).max() < TOL
    assert (pres.iterations, pres.converged) == (jres.iterations,
                                                 jres.converged)
    assert abs(pres.score - jres.score) < TOL
    assert np.abs(pres.params.numpy() - np.asarray(jres.params)).max() < TOL
    assert pres.score < float(jf(jnp.asarray(x0)))


@pytest.mark.parametrize("algo", ["conjugate_gradient", "lbfgs"])
def test_rosenbrock_improves(algo):
    _, tf, _, _ = _objectives()["rosenbrock"]
    x0 = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, 10))
    first = float(tf(x0))
    res = psol.OPTIMIZERS[algo](_torch_oracle(tf, []), x0,
                                max_iterations=300,
                                line_search_iterations=30)
    assert res.score < first * 1e-2


class TestLineSearchAndTerminations:
    def test_backtracking(self):
        f = lambda x: float(torch.sum(x * x))
        x = torch.tensor([3.0, 4.0], dtype=torch.float64)
        g = 2 * x
        step, new = psol.backtrack_line_search(f, x, 25.0, g, -g,
                                               max_iterations=10)
        assert step == 0.5 and new == 0.0
        assert psol.backtrack_line_search(f, x, 25.0, g, g) == (0.0, 25.0)
        # nothing improves within the budget: no step
        assert psol.backtrack_line_search(
            f, x, 25.0, g, -1e3 * g, max_iterations=3) == (0.0, 25.0)

    def test_terminations(self):
        t = psol.EpsTermination(eps=1e-3, tolerance=0.0)
        assert t.terminate(100.0, 100.05)
        assert not t.terminate(100.0, 150.0)
        n = psol.Norm2Termination(gradient_norm_threshold=1e-3)
        assert n.terminate(0, 0, torch.tensor([1e-5, 1e-5]))
        assert not n.terminate(0, 0, torch.tensor([1.0, 1.0]))
        assert not n.terminate(0, 0, None)
        z = psol.ZeroDirection()
        assert z.terminate(0, 0, torch.zeros(3))
        assert not z.terminate(0, 0, torch.tensor([0.0, 1e-30]))
        step = psol.negative_gradient_step(torch.ones(2), -torch.ones(2),
                                           0.25)
        assert torch.equal(step, torch.full((2,), 0.75))


def _mlp_conf(algo, lr_policy="none", l2=1e-3):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )

    b = (NeuralNetConfiguration.builder().seed(42).optimization_algo(algo)
         .iterations(4).max_num_line_search_iterations(10).l2(l2))
    if lr_policy != "none":
        b = b.learning_rate_policy(lr_policy).lr_policy_decay_rate(0.5)
    return (b.list()
            .layer(0, DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())


def _cnn_conf(algo):
    from deeplearning4j_tpu.nn.conf import (
        ConvolutionLayer,
        NeuralNetConfiguration,
        OutputLayer,
        SubsamplingLayer,
    )
    from deeplearning4j_tpu.nn.conf.preprocessors import (
        CnnToFeedForwardPreProcessor,
    )

    return (NeuralNetConfiguration.builder().seed(7).optimization_algo(algo)
            .iterations(4).l2(5e-4).list()
            .layer(0, ConvolutionLayer(n_in=1, n_out=3, kernel_size=(3, 3),
                                       activation="identity"))
            .layer(1, SubsamplingLayer(pooling_type="max"))
            .layer(2, OutputLayer(n_in=3 * 3 * 3, n_out=3,
                                  activation="softmax"))
            .input_preprocessor(2, CnnToFeedForwardPreProcessor(3, 3, 3))
            .build())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("net", ["mlp", "cnn"])
def test_solver_on_a_network_equals_jax(algo, net):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    rng = np.random.default_rng(3)
    if net == "mlp":
        jnet = jax_net_f64(JNet(_mlp_conf(algo)).init())
        x = rng.normal(size=(16, 4))
    else:
        jnet = jax_net_f64(JNet(_cnn_conf(algo)).init(input_shape=(8, 8, 1)))
        x = rng.normal(size=(6, 8, 8, 1))
    y = np.eye(3)[rng.integers(0, 3, x.shape[0])]
    pnet = port_twin(jnet)
    first = pnet.score(x, y)
    for _ in range(2):
        js = float(jnet.fit(jnp.asarray(x), jnp.asarray(y)))
        ps = float(pnet.fit(x, y))
        assert abs(js - ps) < TOL
        assert pnet.iteration == jnet.iteration
        assert_nets_match(jnet, pnet)
    assert ps < first
    assert abs(pnet.score(x, y) - float(jnet.score(x, y))) < TOL


def test_score_policy_decays_the_lr_on_a_converged_run():
    """A run that stops on the eps plateau under the ``score`` LR policy
    multiplies each layer's ``lr_scale`` by the decay rate, as in the JAX
    package."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    jnet = jax_net_f64(JNet(_mlp_conf("line_gradient_descent", "score",
                                      l2=0.0)).init())
    pnet = port_twin(jnet)
    x = np.zeros((4, 4))
    y = np.full((4, 3), 1.0 / 3.0)  # a zero gradient: converges at once
    jnet.fit(jnp.asarray(x), jnp.asarray(y))
    pnet.fit(x, y)
    for js, ps in zip(jnet.updater_state, pnet.updater_state):
        assert float(ps["lr_scale"]) == float(js["lr_scale"]) == 0.5
