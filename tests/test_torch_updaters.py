"""The port's losses and updaters against the JAX package, on the CPU.

  * Losses: the eight losses and the softmax-fused ``mcxent_from_logits``,
    with and without a per-step mask, against
    ``deeplearning4j_tpu.nn.losses`` in f64 at 1e-12.
  * Updaters, closed form: every case of ``tests/test_updaters.py`` (the
    rules' first steps, the bias learning rate, the LR policy table, the
    gradient normalizations, ``apply_updates``, the ``score`` policy's
    decay) re-run against the port.
  * Updaters against JAX: each of the 7 rules under each of the 7 LR
    policies with each gradient normalization (none and the 5 schemes),
    three iterations of ``LayerUpdater.update`` on the same random f64
    gradients, the updates and the state compared leaf for leaf. The
    tolerance is 1e-12 where no power or exponential is evaluated; where
    one is (the exponential, inverse, poly, sigmoid and step policies, and
    Adam's bias correction), both packages compute the schedule scalar in
    f32 with their own ``pow``/``exp`` (XLA's and the C library's differ
    by up to an ulp, which ``1 - b2**t`` amplifies), so rtol 1e-5.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the JAX reference side

from deeplearning4j_tpu_torch.nn import losses as plosses  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as pconf_layers  # noqa: E402
from deeplearning4j_tpu_torch.optimize import updaters as pupd  # noqa: E402

LOSS_NAMES = sorted(plosses.LOSSES)


def _loss_case(seed, name):
    rng = np.random.default_rng(seed)
    shape = (3, 5, 4)
    if name in ("mcxent", "negativeloglikelihood", "xent",
                "reconstruction_crossentropy", "expll"):
        out = rng.uniform(0.05, 0.95, shape)
        labels = (rng.uniform(size=shape) > 0.5).astype(np.float64)
    else:
        out = rng.standard_normal(shape)
        labels = rng.standard_normal(shape)
    mask = (rng.uniform(size=shape[:2]) > 0.3).astype(np.float64)
    return labels, out, mask


class TestLossesAgainstJax:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("name", LOSS_NAMES)
    def test_loss(self, name, masked):
        from deeplearning4j_tpu.nn import losses as jlosses

        labels, out, mask = _loss_case(len(name), name)
        m = mask if masked else None
        ref = float(jlosses.loss_fn(name)(
            jnp.asarray(labels), jnp.asarray(out),
            None if m is None else jnp.asarray(m)))
        got = plosses.loss_fn(name)(
            torch.from_numpy(labels), torch.from_numpy(out),
            None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float64
        assert abs(float(got) - ref) < 1e-12

    @pytest.mark.parametrize("masked", [False, True])
    def test_mcxent_from_logits(self, masked):
        from deeplearning4j_tpu.nn import losses as jlosses

        rng = np.random.default_rng(4)
        logits = rng.standard_normal((3, 5, 7)) * 3
        labels = np.eye(7)[rng.integers(0, 7, (3, 5))]
        mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                        np.float64) if masked else None
        ref = float(jlosses.mcxent_from_logits(
            jnp.asarray(labels), jnp.asarray(logits),
            None if mask is None else jnp.asarray(mask)))
        got = plosses.mcxent_from_logits(
            torch.from_numpy(labels), torch.from_numpy(logits),
            None if mask is None else torch.from_numpy(mask))
        assert abs(float(got) - ref) < 1e-12

    def test_fused_names_and_unknown_loss(self):
        assert plosses.fused_with_softmax("MCXENT")
        assert plosses.fused_with_softmax("negativeloglikelihood")
        assert not plosses.fused_with_softmax("mse")
        with pytest.raises(ValueError, match="Unknown loss"):
            plosses.loss_fn("hinge")


# ---------------------------------------------------------------------------
# closed-form cases (tests/test_updaters.py, re-run against the port)
# ---------------------------------------------------------------------------

G = {"W": np.array([[1.0, -2.0], [0.5, 3.0]]), "b": np.array([0.1, -0.1])}


def _t(d):
    return {k: torch.from_numpy(np.array(v, np.float64)) for k, v in d.items()}


def _make_updater(**kw):
    conf = pconf_layers.resolve(pconf_layers.DenseLayer(n_in=2, n_out=2,
                                                        **kw))
    return pupd.LayerUpdater(conf)


def _zeros():
    return _t({"W": np.zeros((2, 2)), "b": np.zeros(2)})


def _sgd():
    u = _make_updater(updater="sgd", learning_rate=0.5)
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    np.testing.assert_allclose(upd["W"], 0.5 * G["W"])
    np.testing.assert_allclose(upd["b"], 0.5 * G["b"])


def _bias_learning_rate():
    u = _make_updater(updater="sgd", learning_rate=0.5,
                      bias_learning_rate=0.1)
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    np.testing.assert_allclose(upd["W"], 0.5 * G["W"])
    np.testing.assert_allclose(upd["b"], np.float32(0.1) * G["b"])


def _nesterov_two_steps():
    lr, mu = 0.1, 0.9
    u = _make_updater(updater="nesterovs", learning_rate=lr, momentum=mu)
    state = u.init(_zeros())
    g = G["W"]
    upd1, state = u.update(_t(G), state, _zeros(), 0)
    v1 = -lr * g
    np.testing.assert_allclose(upd1["W"], -(1 + mu) * v1, rtol=1e-6)
    upd2, state = u.update(_t(G), state, _zeros(), 1)
    v2 = mu * v1 - lr * g
    np.testing.assert_allclose(upd2["W"], mu * v1 - (1 + mu) * v2,
                               rtol=1e-6)


def _adagrad():
    lr, eps = 0.5, 1e-8
    u = _make_updater(updater="adagrad", learning_rate=lr, epsilon=eps)
    upd, state = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    g = G["W"]
    np.testing.assert_allclose(upd["W"], lr * g / (np.sqrt(g * g) + eps),
                               rtol=1e-6)
    upd2, _ = u.update(_t(G), state, _zeros(), 1)
    np.testing.assert_allclose(
        upd2["W"], lr * g / (np.sqrt(2 * g * g) + eps), rtol=1e-6)


def _rmsprop():
    lr, d, eps = 0.2, 0.95, 1e-8
    u = _make_updater(updater="rmsprop", learning_rate=lr, rms_decay=d,
                      epsilon=eps)
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    g = G["W"]
    cache = (1 - d) * g * g
    np.testing.assert_allclose(upd["W"], lr * g / np.sqrt(cache + eps),
                               rtol=1e-6)


def _adadelta_first_step():
    rho, eps = 0.95, 1e-6
    u = _make_updater(updater="adadelta", rho=rho, epsilon=eps)
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    g = G["W"]
    msg = (1 - rho) * g * g
    np.testing.assert_allclose(upd["W"], g * np.sqrt(eps) / np.sqrt(msg + eps),
                               rtol=1e-5)


def _adam_first_step():
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    u = _make_updater(updater="adam", learning_rate=lr, adam_mean_decay=b1,
                      adam_var_decay=b2, epsilon=eps)
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    g = G["W"]
    m = (1 - b1) * g
    v = (1 - b2) * g * g
    alpha = np.sqrt(1 - b2) / (1 - b1)
    np.testing.assert_allclose(upd["W"], lr * alpha * m / (np.sqrt(v) + eps),
                               rtol=1e-5)


def _noop():
    u = _make_updater(updater="none")
    upd, _ = u.update(_t(G), u.init(_zeros()), _zeros(), 0)
    np.testing.assert_allclose(upd["W"], G["W"])


def _apply_updates_minimize():
    p = [_zeros()]
    pupd.apply_updates(p, [_t(G)], minimize=True)
    np.testing.assert_allclose(p[0]["W"], -G["W"])


def _clip_elementwise():
    out = pupd.normalize_gradients(_t(G), "clip_elementwise_absolute_value",
                                   1.0)
    assert out["W"].abs().max().item() <= 1.0


def _renormalize_l2_per_layer():
    out = pupd.normalize_gradients(_t(G), "renormalize_l2_per_layer", 1.0)
    total = sum(float((v * v).sum()) for v in out.values())
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def _clip_l2_per_param_type():
    out = pupd.normalize_gradients(_t(G), "clip_l2_per_param_type", 1.0)
    for v in out.values():
        assert float(torch.linalg.vector_norm(v)) <= 1.0 + 1e-5


def _clip_l2_noop_when_under_threshold():
    out = pupd.normalize_gradients(_t(G), "clip_l2_per_layer", 1e9)
    np.testing.assert_allclose(out["W"], G["W"])


def _score_lr_policy_decay():
    """'score' policy: apply_lr_score_decay multiplies the step by the
    decay rate (an MLP on a fixed random batch in place of Iris)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(42).learning_rate(0.5)
            .learning_rate_policy("score").lr_policy_decay_rate(0.1).list()
            .layer(0, DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert float(net.updater_state[0]["lr_scale"]) == 1.0
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 30)]
    net.fit(x, y)
    before = net.params[0]["W"].clone()
    net.fit(x, y)
    full = (net.params[0]["W"] - before).abs().max().item()
    net.apply_lr_score_decay()
    assert abs(float(net.updater_state[0]["lr_scale"]) - 0.1) < 1e-6
    before = net.params[0]["W"].clone()
    net.fit(x, y)
    decayed = (net.params[0]["W"] - before).abs().max().item()
    assert decayed < full * 0.5, (full, decayed)


CLOSED_FORM = {f.__name__.lstrip("_"): f for f in (
    _sgd, _bias_learning_rate, _nesterov_two_steps, _adagrad, _rmsprop,
    _adadelta_first_step, _adam_first_step, _noop, _apply_updates_minimize,
    _clip_elementwise, _renormalize_l2_per_layer, _clip_l2_per_param_type,
    _clip_l2_noop_when_under_threshold, _score_lr_policy_decay)}


@pytest.mark.parametrize("case", sorted(CLOSED_FORM))
def test_closed_form(case):
    CLOSED_FORM[case]()


class _Conf:
    def __init__(self, **kw):
        self.lr_policy = kw.get("lr_policy", "none")
        self.lr_policy_decay_rate = kw.get("decay")
        self.lr_policy_steps = kw.get("steps")
        self.lr_policy_power = kw.get("power")
        self.lr_schedule = kw.get("schedule")
        self.momentum_schedule = None


@pytest.mark.parametrize(
    "conf,it,expected",
    [
        (_Conf(), 10, 0.1),
        (_Conf(lr_policy="exponential", decay=0.9), 2, 0.1 * 0.9**2),
        (_Conf(lr_policy="inverse", decay=0.5, power=2.0), 3,
         0.1 / (1 + 0.5 * 3) ** 2),
        (_Conf(lr_policy="step", decay=0.5, steps=10.0), 25, 0.1 * 0.5**2),
        (_Conf(lr_policy="poly", power=2.0, steps=100.0), 50, 0.1 * 0.25),
        (_Conf(lr_policy="schedule", schedule={5: 0.01, 10: 0.001}), 3, 0.1),
        (_Conf(lr_policy="schedule", schedule={5: 0.01, 10: 0.001}), 7, 0.01),
        (_Conf(lr_policy="schedule", schedule={5: 0.01, 10: 0.001}), 11,
         0.001),
    ],
)
def test_lr_policies(conf, it, expected):
    np.testing.assert_allclose(float(pupd.lr_at(conf, 0.1, it)), expected,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# every rule x LR policy x gradient normalization against JAX
# ---------------------------------------------------------------------------

RULES = ["sgd", "none", "nesterovs", "adagrad", "rmsprop", "adadelta",
         "adam"]
POLICIES = {
    "none": {},
    "exponential": {"lr_policy_decay_rate": 0.9},
    "inverse": {"lr_policy_decay_rate": 0.5, "lr_policy_power": 2.0},
    "poly": {"lr_policy_power": 2.0, "lr_policy_steps": 10.0},
    "sigmoid": {"lr_policy_decay_rate": 0.7, "lr_policy_steps": 1.0},
    "step": {"lr_policy_decay_rate": 0.5, "lr_policy_steps": 2.0},
    "schedule": {"lr_schedule": {1: 0.05, 2: 0.02}},
}
NORMS = [None, "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
         "clip_elementwise_absolute_value", "clip_l2_per_layer",
         "clip_l2_per_param_type"]
_EXACT_POLICIES = ("none", "schedule")


class _NetConf:
    def __init__(self, policy):
        self.lr_policy = policy
        self.lr_policy_decay_rate = None
        self.lr_policy_steps = None
        self.lr_policy_power = None
        self.lr_schedule = None
        self.momentum_schedule = {2: 0.7}
        for k, v in POLICIES[policy].items():
            setattr(self, k, v)


def _flat(state):
    """(path, array) pairs of a nested state dict, sorted by path."""
    out = []
    for k, v in state.items():
        if isinstance(v, dict):
            out += [(f"{k}.{kk}", vv) for kk, vv in _flat(v)]
        else:
            out.append((k, np.asarray(v)))
    return sorted(out, key=lambda kv: kv[0])


@pytest.mark.parametrize("norm", NORMS, ids=lambda n: n or "no_norm")
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("rule", RULES)
def test_layer_updater_matches_jax(rule, policy, norm):
    from deeplearning4j_tpu.nn.conf import layers as jconf_layers
    from deeplearning4j_tpu.optimize.updaters import LayerUpdater

    kw = dict(n_in=3, n_out=4, updater=rule, learning_rate=0.1,
              bias_learning_rate=0.03, momentum=0.9, rms_decay=0.9,
              rho=0.9, epsilon=1e-6, gradient_normalization=norm,
              gradient_normalization_threshold=0.5)
    net_conf = _NetConf(policy)
    jup = LayerUpdater(jconf_layers.resolve(jconf_layers.DenseLayer(**kw)),
                       net_conf)
    pup = pupd.LayerUpdater(
        pconf_layers.resolve(pconf_layers.DenseLayer(**kw)), net_conf)
    rng = np.random.default_rng(len(rule) * 31 + len(policy))
    params = {"W": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)}
    jstate = jup.init({k: jnp.asarray(v) for k, v in params.items()})
    pstate = pup.init(_t(params))
    exact = policy in _EXACT_POLICIES and rule != "adam"
    tol = dict(rtol=1e-12, atol=1e-14) if exact else dict(rtol=1e-5,
                                                          atol=1e-12)
    for it in range(3):
        grads = {k: rng.standard_normal(v.shape) for k, v in params.items()}
        jupd, jstate = jup.update({k: jnp.asarray(v) for k, v in grads.items()},
                                  jstate, params, it)
        pupd_, pstate = pup.update(_t(grads), pstate, _t(params), it)
        for k in params:
            np.testing.assert_allclose(pupd_[k].numpy(), np.asarray(jupd[k]),
                                       **tol, err_msg=f"update {k} it {it}")
        jflat, pflat = _flat(jstate), _flat(pstate)
        assert [k for k, _ in jflat] == [k for k, _ in pflat]
        for (k, a), (_, b) in zip(jflat, pflat):
            np.testing.assert_allclose(b, a, **tol, err_msg=f"state {k}")


def test_multi_layer_updater_and_apply_updates_match_jax():
    """Two layers, maximizing: MultiLayerUpdater + apply_updates."""
    from deeplearning4j_tpu.nn.conf import layers as jconf_layers
    from deeplearning4j_tpu.optimize import updaters as jupd

    kw = [dict(n_in=3, n_out=4, updater="adam", learning_rate=0.1),
          dict(n_in=4, n_out=2, updater="rmsprop", learning_rate=0.2)]
    jm = jupd.MultiLayerUpdater(
        [jconf_layers.resolve(jconf_layers.DenseLayer(**k)) for k in kw])
    pm = pupd.MultiLayerUpdater(
        [pconf_layers.resolve(pconf_layers.DenseLayer(**k)) for k in kw])
    rng = np.random.default_rng(9)
    params = [{"W": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)},
              {"W": rng.standard_normal((4, 2)), "b": rng.standard_normal(2)}]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    pp = [_t(p) for p in params]
    js, ps = jm.init(jp), pm.init(pp)
    for it in range(3):
        grads = [{k: rng.standard_normal(v.shape) for k, v in p.items()}
                 for p in params]
        ju, js = jm.update([{k: jnp.asarray(v) for k, v in g.items()}
                            for g in grads], js, jp, it)
        jp = jupd.apply_updates(jp, ju, minimize=False)
        pu, ps = pm.update([_t(g) for g in grads], ps, pp, it)
        pupd.apply_updates(pp, pu, minimize=False)
    for a, b in zip(jp, pp):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-12)
