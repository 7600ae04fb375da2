"""The port's north-star harness (``utils/equivalence.py``) against the
JAX package's, on the CPU.

  * ``compare_backends(..., device="cpu")`` runs both legs on the CPU:
    the deviation is exactly 0 on LeNet-5 and on the char-RNN (JAX's
    determinism check, ``tests/test_equivalence.py``), and LeNet-5's loss
    falls over 12 steps.
  * ``mnist_batches`` and ``char_batches`` are bit-equal to JAX's.
  * The port's 12-step LeNet-5 and char-RNN ``loss_curve``s, started from
    the JAX nets' initial parameters carried across, match JAX's
    ``loss_curve`` (its strict f32 mode) within 1e-4 relative each step
    in f32.
  * The card's leg starts from the CPU leg's initial state
    (``_carry``), and the card's entry points raise with no card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.utils import equivalence as jeq  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    params_from_numpy,
    updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.utils import equivalence as peq  # noqa: E402

REL = 1e-4


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_lenet():
    from deeplearning4j_tpu.models.lenet import build_lenet5

    return build_lenet5(seed=12345)


def _jax_char():
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(
        char_rnn_conf(40, lstm_size=64, num_layers=1, seed=777,
                      tbptt_length=16)).init(input_shape=(1, 40))


def _carried(port_builder, jnet):
    """A port builder whose net starts from ``jnet``'s initial state."""
    params, states = _host(jnet.params), _host(jnet.states)
    upd = _host(jnet.updater_state)

    def build(device):
        net = port_builder(device)
        net.params = params_from_numpy(params, device=device)
        net.states = params_from_numpy(states, device=device)
        net.updater_state = updater_state_from_numpy(upd, device=device)
        return net

    return build


class TestDeterminismOnTheCpu:
    def test_lenet_curve_deterministic_and_decreasing(self):
        res = peq.compare_backends(peq.lenet_builder,
                                   peq.mnist_batches(n_steps=12, batch=32),
                                   device="cpu")
        assert res["same_backend"] and res["backend_accel"] == "cpu"
        assert res["max_abs_deviation"] == 0.0, res
        assert res["max_rel_deviation"] == 0.0
        assert res["first_step_over_1e-3"] is None
        curve = np.asarray(res["curve_cpu"])
        assert res["curve_accel"] == res["curve_cpu"]
        assert curve[-1] < curve[0], "loss did not fall over 12 steps"

    def test_char_rnn_curve_deterministic(self):
        from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_conf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        def builder(device):
            return MultiLayerNetwork(
                char_rnn_conf(20, lstm_size=16, num_layers=1, seed=3,
                              tbptt_length=8),
                device=device).init(input_shape=(1, 20))

        res = peq.compare_backends(
            builder, peq.char_batches(n_steps=6, batch=8, seq=16, vocab=20),
            device="cpu")
        assert res["max_abs_deviation"] == 0.0, res
        assert res["steps"] == 6

    def test_north_star_at_three_steps(self, tmp_path):
        path = tmp_path / "ns.json"
        res = peq.run_north_star(steps=3, artifact_path=str(path),
                                 device="cpu")
        assert set(res) == {"lenet5", "char_rnn"}
        for r in res.values():
            assert r["max_abs_deviation"] == 0.0
            assert np.isfinite(r["curve_cpu"]).all()
        assert path.exists()

    def test_steps_cuts_the_batches(self):
        res = peq.compare_backends(peq.lenet_builder,
                                   peq.mnist_batches(n_steps=4, batch=8),
                                   steps=2, device="cpu")
        assert res["steps"] == 2 and len(res["curve_cpu"]) == 2


class TestBatchesEqualJax:
    @pytest.mark.parametrize("kw", [{}, {"n_steps": 5, "batch": 16},
                                    {"n_steps": 3, "batch": 8, "seed": 4}])
    def test_mnist_batches(self, kw):
        j, p = jeq.mnist_batches(**kw), peq.mnist_batches(**kw)
        assert len(j) == len(p)
        for (jx, jy), (px, py) in zip(j, p):
            assert jx.dtype == px.dtype and jy.dtype == py.dtype
            assert np.array_equal(jx, px) and np.array_equal(jy, py)

    @pytest.mark.parametrize("kw", [{}, {"n_steps": 4, "batch": 8,
                                         "seq": 16, "vocab": 20,
                                         "seed": 9}])
    def test_char_batches(self, kw):
        j, p = jeq.char_batches(**kw), peq.char_batches(**kw)
        for (jx, jy), (px, py) in zip(j, p):
            assert np.array_equal(jx, px) and np.array_equal(jy, py)


class TestCurvesAgainstJax:
    @pytest.mark.parametrize("which", ["lenet5", "char_rnn"])
    def test_twelve_steps_within_1e4(self, which):
        if which == "lenet5":
            jbuild, pbuild = _jax_lenet, peq.lenet_builder
            batches = jeq.mnist_batches(n_steps=12, batch=32)
        else:
            jbuild, pbuild = _jax_char, peq.char_builder
            batches = jeq.char_batches(n_steps=12)
        jnet = jbuild()
        want = jeq.loss_curve(lambda: jnet, batches)
        got = peq.loss_curve(_carried(pbuild, jbuild()), batches,
                             device="cpu")
        assert got.dtype == np.float64 and got.shape == want.shape
        rel = np.abs(got - want) / np.abs(want)
        assert rel.max() < REL, (rel.max(), got, want)


def test_the_card_leg_starts_from_the_cpu_leg():
    a = peq.char_builder("cpu")
    b = peq.char_builder("cpu")
    for t in b.params[0].values():
        t.add_(1.0)
    peq._carry(a, b)
    for ta, tb in zip(a.params[0].values(), b.params[0].values()):
        assert torch.equal(ta, tb) and ta.data_ptr() != tb.data_ptr()


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batches = peq.char_batches(n_steps=1, batch=2, seq=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peq.compare_backends(peq.char_builder, batches)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peq.loss_curve(peq.char_builder, batches)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peq.run_north_star(steps=1)
