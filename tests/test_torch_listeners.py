"""The port's stats and performance listeners against the JAX package's
(``optimize/listeners.py`` :47-176), on the CPU.

  * ``StatsListener.render`` and ``_render_value`` give JAX's line for the
    same snapshot: ints, floats to 3 places, dicts collapsed to the sum of
    their numeric leaves (nested one level), strings and lists left out.
  * Each ledger subclass reads its attribute (``dispatch_stats``,
    ``resilience_stats``, ``pipeline_stats``) every N iterations, keeps
    the snapshot with its iteration and logs JAX's line.
  * ``PerformanceListener`` opens and closes the same windows as JAX's on
    the same iteration sequence (a fake clock), and logs the same rates.
  * A port network's ``dispatch_stats`` reaches the listener through a
    real ``fit``.
"""

import logging

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.optimize import listeners as jl  # noqa: E402
from deeplearning4j_tpu_torch.optimize import listeners as pl  # noqa: E402

SNAP = {
    "traces": {"train_step": 1, "score": 2},
    "cache_hits": 7,
    "stall_fraction": 0.123456,
    "nested": {"a": {"x": 1, "y": 2.5, "s": "no"}, "b": 3},
    "name": "ignored",
    "list": [1, 2],
    "zero": 0.0,
    "iteration": 99,
}


class Ledger:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return dict(self.snap)


@pytest.mark.parametrize("value", [
    1, 0.5, 2.0 / 3.0, {"a": 1, "b": 2.25}, {"a": {"x": 1, "y": "z"}},
    "text", True, -0.0005])
def test_render_value_equals_jax(value):
    assert (pl.StatsListener._render_value(value)
            == jl.StatsListener._render_value(value))


def test_render_equals_jax():
    assert pl.StatsListener().render(SNAP) == jl.StatsListener().render(SNAP)
    assert "iteration" not in pl.StatsListener().render(SNAP)


@pytest.mark.parametrize("name", ["DispatchStatsListener",
                                  "ResilienceStatsListener",
                                  "PipelineStatsListener"])
def test_ledger_listeners_equal_jax(name, caplog):
    jcls, pcls = getattr(jl, name), getattr(pl, name)
    assert pcls.attr == jcls.attr
    j, p = jcls(frequency=2), pcls(frequency=2)
    assert p.title == j.title

    class Model:
        pass

    model = Model()
    setattr(model, pcls.attr, Ledger(SNAP))
    with caplog.at_level(logging.INFO):
        for it in range(5):
            j.iteration_done(model, it, 1.0)
            p.iteration_done(model, it, 1.0)
    assert p.snapshots == j.snapshots
    assert [s["iteration"] for s in p.snapshots] == [0, 2, 4]
    jlines = [r.getMessage() for r in caplog.records
              if r.name == "deeplearning4j_tpu"]
    plines = [r.getMessage() for r in caplog.records
              if r.name == "deeplearning4j_tpu_torch"]
    assert plines == jlines and len(plines) == 3


def test_plain_dict_ledger_and_missing_attr():
    p = pl.StatsListener(frequency=1, attr="custom_stats")
    j = jl.StatsListener(frequency=1, attr="custom_stats")
    assert p.title == j.title == "custom"

    class Model:
        custom_stats = {"a": 1, "b": 0.25}

    p.iteration_done(Model(), 0, 0.0)
    j.iteration_done(Model(), 0, 0.0)
    assert p.snapshots == j.snapshots
    p.iteration_done(object(), 1, 0.0)  # no ledger: nothing recorded
    assert len(p.snapshots) == 1


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("frequency,batch", [(1, 0), (3, 16), (4, 8)])
def test_performance_windows_equal_jax(frequency, batch, monkeypatch,
                                       caplog):
    iters = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 17, 20]
    times = list(np.cumsum(np.linspace(0.01, 0.2, len(iters))))
    j = jl.PerformanceListener(frequency=frequency, batch_size=batch)
    p = pl.PerformanceListener(frequency=frequency, batch_size=batch)
    windows = {}
    for name, lst, mod in (("jax", j, jl), ("port", p, pl)):
        monkeypatch.setattr(mod.time, "perf_counter", FakeClock(times))
        seen = []
        with caplog.at_level(logging.INFO):
            caplog.clear()
            for it in iters:
                lst.iteration_done(None, it, 0.5)
                seen.append((lst._last_iter, lst._last_time))
        windows[name] = (seen, [r.getMessage() for r in caplog.records])
    assert windows["port"] == windows["jax"]
    assert windows["port"][1], "no window closed"


def test_dispatch_listener_through_a_fit():
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (pconf.NeuralNetConfiguration.builder().seed(1).list()
            .layer(0, pconf.OutputLayer(n_in=4, n_out=3,
                                        activation="softmax"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    lst = pl.DispatchStatsListener(frequency=2)
    net.set_listeners(lst)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(5):
        net.fit(x, y)
    assert [s["iteration"] for s in lst.snapshots] == [0, 2, 4]
    assert lst.render(lst.snapshots[-1]) == jl.StatsListener().render(
        lst.snapshots[-1])
