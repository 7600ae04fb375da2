"""The port's profiler traces (``utils/profiling.py``) against the JAX
package's hook (``deeplearning4j_tpu/utils/profiling.py``), on the CPU.

The port writes a ``torch.profiler`` Chrome trace; the cases mirror
``tests/test_profiling.py``: a region's trace is written, the listener
traces only its window of iterations and links the stats timeline,
``link_stats`` records JAX's event, and a disabled region makes nothing.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu.parallel.stats import TrainingStats as JStats  # noqa: E402
from deeplearning4j_tpu.utils.profiling import link_stats as jlink  # noqa: E402
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats  # noqa: E402
from deeplearning4j_tpu_torch.utils.profiling import (  # noqa: E402
    XplaneTraceListener,
    link_stats,
    xplane_trace,
)


def _net():
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (pconf.NeuralNetConfiguration.builder()
            .seed(1).learning_rate(0.1).list()
            .layer(0, pconf.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, pconf.OutputLayer(n_in=8, n_out=3,
                                        activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=32):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with xplane_trace(logdir) as t:
        with torch.profiler.record_function("region_mark"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert t["path"] and t["path"].startswith(logdir)
    assert glob.glob(os.path.join(logdir, "*.json")) == [t["path"]]
    names = _names(t["path"])
    assert "region_mark" in names
    assert any(n and "mm" in n for n in names)


def test_error_inside_the_region_propagates(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with xplane_trace(str(tmp_path / "t")):
            1 / 0
    assert glob.glob(str(tmp_path / "t" / "*.json"))


def test_listener_traces_only_its_window(tmp_path):
    net = _net()
    x, y = _data()
    stats = TrainingStats()
    logdir = str(tmp_path / "fit_trace")
    lst = XplaneTraceListener(logdir, start_iteration=1, num_iterations=2,
                              stats=stats)
    net.set_listeners(lst)
    for i in range(6):
        with torch.profiler.record_function(f"fit_{i}"):
            net.fit(x, y)
    lst.stop()  # idempotent
    assert lst.path and os.path.exists(lst.path)
    fits = {n for n in _names(lst.path) if n and n.startswith("fit_")}
    # started at the end of fit 1, stopped at the end of fit 3
    assert "fit_2" in fits
    assert fits <= {"fit_1", "fit_2", "fit_3"}, fits
    assert any(e.event_type.startswith("xplane_trace:")
               for e in stats.events)
    assert len(glob.glob(os.path.join(logdir, "*.json"))) == 1


def test_listener_window_past_the_end_closes_on_stop(tmp_path):
    net = _net()
    x, y = _data()
    lst = XplaneTraceListener(str(tmp_path / "t"), start_iteration=0,
                              num_iterations=100)
    net.set_listeners(lst)
    net.fit(x, y)
    net.fit(x, y)
    assert lst.path is None
    lst.stop()
    assert lst.path and os.path.exists(lst.path)


def test_link_stats_equals_jax():
    p, j = TrainingStats(), JStats()
    link_stats(p, "/tmp/some_trace")
    jlink(j, "/tmp/some_trace")
    assert p.events[-1].event_type == j.events[-1].event_type \
        == "xplane_trace:/tmp/some_trace"
    assert p.events[-1].duration_ms == j.events[-1].duration_ms
    link_stats(None, "/tmp/x")  # no stats: nothing to do


def test_disabled_trace_is_a_no_op(tmp_path):
    with xplane_trace(str(tmp_path / "x"), enabled=False) as t:
        pass
    assert t["path"] is None
    assert not (tmp_path / "x").exists()


def test_a_profiler_that_cannot_start_leaves_the_region_untraced(
        tmp_path, monkeypatch, caplog):
    def refuse(*a, **k):
        raise RuntimeError("profiler already enabled")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with xplane_trace(str(tmp_path / "x")) as t:
        pass
    assert t["path"] is None
    assert "untraced" in caplog.text


def test_a_dropped_listener_closes_its_window(tmp_path):
    import gc

    net = _net()
    x, y = _data()
    lst = XplaneTraceListener(str(tmp_path / "t"), start_iteration=0,
                              num_iterations=100)
    net.set_listeners(lst)
    net.fit(x, y)
    net.fit(x, y)
    net.set_listeners()
    del lst
    gc.collect()
    assert len(glob.glob(str(tmp_path / "t" / "*.json"))) == 1
    # the profiler is free again
    with xplane_trace(str(tmp_path / "u")) as t:
        pass
    assert t["path"]
