"""The port's observability plane (``deeplearning4j_tpu_torch/obs/``) on
the CPU, the JAX package's ``tests/test_obs.py`` cases for the modules
this port carries:

  * the tracer: spans nest with parent ids and attributes, the gate is
    off by default and read at every call, the disabled path records
    nothing, ``record_span`` backdates, the ring is bounded;
  * obs on vs off gives the same bits: a fit and a ``/predict``;
  * the registry: counters, gauges, histograms, the Prometheus text
    pinned by the JAX package's golden file (``tests/data/
    prometheus_golden.txt``), counter monotonicity, dead owners pruned,
    and ``register_net``: every ``*_stats`` ledger of a MultiLayerNetwork,
    a ComputationGraph and a ``QuantizedNet`` registered (a new ledger
    attached without it fails the check loudly);
  * the journal: the ring's bound, markers surviving a span flood, the
    atomic flush with no tmp litter, ``load`` of a torn line, the
    default path's ``.p{pid}`` suffix;
  * the exporter's four endpoints;
  * the serving path: request ids threading from ``serve.request``
    through ``serve.batch`` (``/predict``, ``/embed``), a decode tick's
    ``serve.batch`` span, a search's span, the same span names and
    attribute keys as the JAX engine's, no device sync inside a span,
    and the journal's ``serve.drain``, ``serve.drain_complete``,
    ``serve.health`` and ``serve.preempt`` events, the drain's flushed to
    disk.
"""

import json
import os
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import conf as pconf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import journal as journal_mod
from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry
from deeplearning4j_tpu_torch.serving.engine import ServingEngine

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "prometheus_golden.txt")


@pytest.fixture(autouse=True)
def journal(tmp_path, monkeypatch):
    """Every test's journal in its tmp_path (``DL4J_TPU_OBS_JOURNAL``), the
    process's journal and the tracer's made anew there: nothing lands in
    the working directory."""
    monkeypatch.setenv("DL4J_TPU_OBS_JOURNAL", str(tmp_path / "flight.jsonl"))
    jr = obs.FlightRecorder(capacity=4096, flush_interval_s=1e9)
    monkeypatch.setattr(journal_mod, "_DEFAULT", jr)
    obs.tracer().attach(journal=jr)
    return jr


@pytest.fixture
def obs_on(journal):
    """The gate forced on, from a clear tracer ring."""
    obs.set_enabled(True)
    obs.tracer().clear()
    try:
        yield journal
    finally:
        obs.set_enabled(None)


def mlp(seed=7):
    conf = (pconf.NeuralNetConfiguration.builder().seed(seed)
            .learning_rate(0.05).updater("adam").list()
            .layer(0, pconf.DenseLayer(n_in=6, n_out=12, activation="relu"))
            .layer(1, pconf.OutputLayer(n_in=12, n_out=3,
                                        activation="softmax",
                                        loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_spans_nest_with_parent_ids(obs_on):
    with obs.span("outer", a=1) as sp_outer:
        with obs.span("inner") as sp_inner:
            sp_inner.set_attr("x", "y")
        assert sp_inner.parent_id == sp_outer.span_id
    by_name = {s["name"]: s for s in obs.tracer().spans()}
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["outer"]["parent_id"] is None
    assert by_name["inner"]["attrs"] == {"x": "y"}
    assert by_name["outer"]["attrs"] == {"a": 1}
    assert by_name["outer"]["duration_s"] >= by_name["inner"]["duration_s"]
    # finished spans reach the journal and the duration histogram
    assert {e["name"] for e in obs_on.events("span")} >= {"outer", "inner"}
    assert "dl4j_span_seconds_count{span=\"inner\"}" in \
        obs.default_registry().render_prometheus()


def test_disabled_tracer_records_nothing():
    obs.set_enabled(False)
    try:
        obs.tracer().clear()
        with obs.span("nope", k=1) as sp:
            sp.set_attr("still", "a no-op")
        obs.record_span("nope2", 0.5)
        assert obs.tracer().spans() == []
    finally:
        obs.set_enabled(None)


def test_env_gate_default_off_and_read_per_call(monkeypatch):
    monkeypatch.delenv(obs.ENV_OBS, raising=False)
    assert not obs.obs_enabled()
    monkeypatch.setenv(obs.ENV_OBS, "1")
    assert obs.obs_enabled()
    obs.tracer().clear()
    with obs.span("gated"):
        pass
    monkeypatch.setenv(obs.ENV_OBS, "0")
    assert not obs.obs_enabled()
    with obs.span("gated"):
        pass
    assert len(obs.tracer().spans("gated")) == 1


def test_record_span_backdates_start(obs_on):
    obs.record_span("wait", 0.25, seq=3)
    (s,) = obs.tracer().spans("wait")
    assert abs(s["duration_s"] - 0.25) < 1e-6
    assert s["attrs"]["seq"] == 3


def test_span_ring_is_bounded():
    tr = obs.Tracer(capacity=8)
    for i in range(50):
        with tr.span(f"s{i}"):
            pass
    spans = tr.spans()
    assert len(spans) == 8
    assert spans[-1]["name"] == "s49"


def test_span_error_attr_and_thread_local_parents(obs_on):
    import threading

    with pytest.raises(KeyError):
        with obs.span("boom"):
            raise KeyError("x")
    assert obs.tracer().spans("boom")[0]["attrs"]["error"] == "KeyError"
    with obs.span("main"):
        t = threading.Thread(target=lambda: obs.span("other").__enter__()
                             .set_attr("t", 1))
        t.start()
        t.join()
        with obs.span("child") as c:
            pass
    main = obs.tracer().spans("main")[0]
    assert obs.tracer().spans("child")[0]["parent_id"] == main["span_id"]
    assert c.parent_id == main["span_id"]


# ---------------------------------------------------------------------------
# obs on vs off: the same bits
# ---------------------------------------------------------------------------


def _fit_and_predict():
    x, y = data(48)
    net = mlp()
    losses = [float(net.fit(x, y)) for _ in range(5)]
    eng = ServingEngine(model=net, device="cpu").start()
    try:
        out = [eng.predict(x[i:i + 3]) for i in range(0, 12, 3)]
    finally:
        eng.stop()
    return losses, net.params, out


def test_fit_and_predict_bit_exact_with_obs_on_vs_off():
    """Spans, the journal and the registry are host-side observers: the
    same seed with the gate flipped gives bit-identical losses, params
    and /predict answers."""
    obs.set_enabled(False)
    try:
        off = _fit_and_predict()
    finally:
        obs.set_enabled(None)
    obs.set_enabled(True)
    obs.tracer().clear()
    try:
        on = _fit_and_predict()
    finally:
        obs.set_enabled(None)
    assert obs.tracer().spans("serve.batch")  # obs was really on
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    r = MetricsRegistry()
    r.counter("dl4j_c", 2, k="a")
    r.counter("dl4j_c", 3, k="a")
    r.gauge("dl4j_g", 1.5)
    r.gauge("dl4j_g", 2.5)
    for v in (0.001, 0.2):
        r.histogram("dl4j_h", v, buckets=(0.01, 0.1))
    snap = r.snapshot()
    assert snap["counters"]["dl4j_c"]["k=a"] == 5
    assert snap["gauges"]["dl4j_g"]["_"] == 2.5
    h = snap["histograms"]["dl4j_h"]["_"]
    assert h["count"] == 2 and h["counts"] == [1, 0, 1]
    with pytest.raises(ValueError):
        r.counter("dl4j_c", -1)


def test_prometheus_exposition_matches_golden_file():
    r = MetricsRegistry()
    r.set_help("dl4j_requests", "serving requests accepted")
    r.counter("dl4j_requests", 3, model="mnist@v1", path="/predict")
    r.counter("dl4j_requests", 1, model='with"quote\\and\nnewline',
              path="/predict")
    r.gauge("dl4j_queue_depth", 7)
    for v in (0.003, 0.02, 0.33, 0.5055):
        r.histogram("dl4j_latency_seconds", v, buckets=(0.005, 0.05, 0.5),
                    model="mnist@v1")
    with open(GOLDEN) as f:
        assert r.render_prometheus() == f.read()


def test_counter_monotonicity_across_two_scrapes():
    r = MetricsRegistry()
    r.counter("dl4j_events", 2)

    def scrape():
        return {line.split(" ")[0]: float(line.split(" ")[1])
                for line in r.render_prometheus().splitlines()
                if not line.startswith("#")}

    first = scrape()
    r.counter("dl4j_events", 1)
    second = scrape()
    for name, v in first.items():
        assert second[name] >= v, name
    assert second["dl4j_events_total"] == 3


def _assert_all_ledgers_registered(net, registry) -> None:
    registered = registry.ledgers(net)
    for attr, val in vars(net).items():
        if attr.endswith("_stats") and val is not None:
            assert registered.get(attr) is val, (
                f"net.{attr} is not registered in the MetricsRegistry — "
                "new ledgers must go through obs.registry.register_net")


def test_every_mln_ledger_registers():
    net = mlp()
    assert "dispatch_stats" in obs.default_registry().ledgers(net)
    _assert_all_ledgers_registered(net, obs.default_registry())


def test_every_cg_ledger_registers():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = (pconf.NeuralNetConfiguration.builder().seed(3)
            .learning_rate(0.1).graph_builder()
            .add_inputs("in")
            .add_layer("out", pconf.OutputLayer(
                n_in=6, n_out=3, activation="softmax",
                loss_function="mcxent"), "in")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    assert "dispatch_stats" in obs.default_registry().ledgers(net)
    _assert_all_ledgers_registered(net, obs.default_registry())


def test_quantized_net_registers():
    from deeplearning4j_tpu_torch.etl.calibrate import QuantCalibrator
    from deeplearning4j_tpu_torch.ops.lowprec import QuantizedNet

    net = mlp()
    x, _ = data(16)
    q = QuantizedNet(net, QuantCalibrator().fit(net, x).spec(net))
    q.shiny_stats = {"n": 1}
    with pytest.raises(AssertionError, match="shiny_stats"):
        _assert_all_ledgers_registered(q, obs.default_registry())
    obs.register_net(q)
    _assert_all_ledgers_registered(q, obs.default_registry())


def test_unregistered_new_ledger_fails_loudly():
    net = mlp()
    net.shiny_new_stats = {"things": 1}
    with pytest.raises(AssertionError, match="shiny_new_stats"):
        _assert_all_ledgers_registered(net, obs.default_registry())


def test_dead_owner_is_pruned():
    r = MetricsRegistry()

    class Owner:
        pass

    o = Owner()
    r.register_ledger(o, "x_stats", {"n": 1})
    assert r.collect_ledger_samples()
    del o
    assert r.collect_ledger_samples() == []


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def test_journal_ring_bounded_and_loadable(tmp_path):
    j = obs.FlightRecorder(path=str(tmp_path / "j.jsonl"), capacity=5,
                           flush_interval_s=1e9)
    for i in range(12):
        j.record("tick", i=i)
    path = j.flush(fsync=True)
    events = obs.FlightRecorder.load(path)
    assert [e["i"] for e in events] == list(range(7, 12))
    assert all(e["kind"] == "tick" for e in events)
    assert [e["seq"] for e in events] == list(range(8, 13))


def test_marker_events_survive_span_floods(tmp_path):
    j = obs.FlightRecorder(path=str(tmp_path / "j.jsonl"), capacity=64,
                           flush_interval_s=1e9)
    j.record("serve.drain", drain_s=1.0)
    j.record("serve.health", old="closed", new="open")
    for i in range(500):
        j.append({"kind": "span", "name": f"serve.batch{i}"})
    events = obs.FlightRecorder.load(j.flush(fsync=True))
    kinds = [e["kind"] for e in events]
    assert "serve.drain" in kinds and "serve.health" in kinds
    assert j.events("serve.health")[0]["new"] == "open"
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs)


def test_journal_flush_is_atomic_no_tmp_litter(tmp_path):
    j = obs.FlightRecorder(path=str(tmp_path / "j.jsonl"), capacity=4)
    j.record("a")
    j.flush()
    j.record("b")
    j.flush(fsync=True)
    assert j.flush() is None  # nothing new
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.jsonl"]
    assert j.flushes == 2


def test_load_tolerates_a_torn_line(tmp_path):
    path = tmp_path / "torn.jsonl"
    path.write_text('{"seq": 1, "kind": "a"}\n\n{"seq": 2, "kind": "b"}\n'
                    '{"seq": 3, "ki')
    assert [e["seq"] for e in obs.FlightRecorder.load(str(path))] == [1, 2]
    assert obs.FlightRecorder.load(str(tmp_path / "missing.jsonl")) == []


def test_periodic_flush_runs_off_the_recording_thread(tmp_path):
    j = obs.FlightRecorder(path=str(tmp_path / "j.jsonl"), capacity=16,
                           flush_interval_s=0.0)
    j.record("a")
    for _ in range(200):
        if j.flushes:
            break
        time.sleep(0.01)
    assert j.flushes >= 1
    assert obs.FlightRecorder.load(str(tmp_path / "j.jsonl"))[0]["kind"] \
        == "a"


def test_default_journal_path(monkeypatch, tmp_path):
    monkeypatch.delenv("DL4J_TPU_OBS_JOURNAL", raising=False)
    monkeypatch.delenv("DL4J_TPU_PROCESS_ID", raising=False)
    monkeypatch.chdir(tmp_path)
    assert obs.default_journal_path() == str(tmp_path / ".obs_journal.jsonl")
    monkeypatch.setenv("DL4J_TPU_PROCESS_ID", "3")
    assert obs.default_journal_path() == str(
        tmp_path / ".obs_journal.p3.jsonl")
    monkeypatch.setenv("DL4J_TPU_OBS_JOURNAL", "/x/y.jsonl")
    assert obs.default_journal_path() == "/x/y.jsonl"


def test_gated_event_and_flush(tmp_path, monkeypatch):
    jr = obs.FlightRecorder(path=str(tmp_path / "g.jsonl"),
                            flush_interval_s=1e9)
    monkeypatch.setattr(journal_mod, "_DEFAULT", jr)
    obs.set_enabled(False)
    try:
        journal_mod.event("quiet")
        assert journal_mod.flush(fsync=True) is None
    finally:
        obs.set_enabled(None)
    assert jr.events() == []
    obs.set_enabled(True)
    try:
        journal_mod.event("loud", n=1)
        assert journal_mod.flush(fsync=True) == str(tmp_path / "g.jsonl")
    finally:
        obs.set_enabled(None)
    assert obs.FlightRecorder.load(jr.path)[0]["n"] == 1


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------


def test_exporter_endpoints(tmp_path, monkeypatch):
    reg = MetricsRegistry()
    reg.counter("dl4j_things", 4)
    jr = obs.FlightRecorder(path=str(tmp_path / "j.jsonl"))
    jr.record("hello", x=1)
    monkeypatch.setenv("DL4J_TPU_OBS_PORT", "0")
    exp = obs.MetricsExporter(registry=reg, journal=jr).start()
    try:
        with urllib.request.urlopen(exp.url + "/metrics", timeout=10) as r:
            assert "text/plain; version=0.0.4" in r.headers["Content-Type"]
            assert b"dl4j_things_total 4" in r.read()
        with urllib.request.urlopen(exp.url + "/metrics.json",
                                    timeout=10) as r:
            assert json.loads(r.read())["counters"]["dl4j_things"]["_"] == 4
        with urllib.request.urlopen(exp.url + "/journal", timeout=10) as r:
            lines = r.read().decode().strip().splitlines()
            assert json.loads(lines[-1])["kind"] == "hello"
        with urllib.request.urlopen(exp.url + "/health", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(exp.url + "/nope", timeout=10)
        assert e.value.code == 404
    finally:
        exp.stop()


# ---------------------------------------------------------------------------
# the serving path's spans and journal
# ---------------------------------------------------------------------------


def test_request_id_threads_through_the_batcher(obs_on):
    x, _ = data(8)
    eng = ServingEngine(model=mlp(), device="cpu").start()
    try:
        eng.predict(x[:2])
        eng.embed(x[:3])
    finally:
        eng.stop()
    requests = obs.tracer().spans("serve.request")
    batches = obs.tracer().spans("serve.batch")
    assert [r["attrs"].get("kind") for r in requests] == [None, "embed"]
    for req in requests:
        rid = req["attrs"]["rid"]
        owners = [b for b in batches if rid in b["attrs"]["request_ids"]]
        assert len(owners) == 1
        assert owners[0]["attrs"]["rows"] == req["attrs"]["rows"]
    assert requests[0]["attrs"]["rid"] < requests[1]["attrs"]["rid"]


def _tiny_lm():
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    return TransformerLM(TransformerConfig(
        vocab_size=16, d_model=16, n_layers=1, n_heads=2, d_ff=32,
        max_len=32), device="cpu")


def test_decode_ticks_and_search_open_spans(obs_on, monkeypatch):
    """A /generate opens one serve.request and one serve.batch per tick
    (kind decode.paged, lanes, tick_k); a search opens one request span;
    no span synchronizes the device."""
    from deeplearning4j_tpu_torch.retrieval import VectorStore

    def no_sync(*a, **k):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    eng = ServingEngine(_tiny_lm(), kv_blocks=32, device="cpu").start()
    try:
        out = eng.generate(np.arange(5) % 16, 4, temperature=0.0)
        store = VectorStore(4, capacity=8, kind="exact", name="s",
                            device="cpu")
        store.upsert([1, 2], np.eye(4, dtype=np.float32)[:2])
        store.publish()
        eng.register_index("s", store)
        eng.search("s", np.eye(4, dtype=np.float32)[:2], k=1)
    finally:
        eng.stop()
    assert out.shape == (1, 4)
    reqs = obs.tracer().spans("serve.request")
    assert [r["attrs"]["kind"] for r in reqs] == ["generate", "search"]
    assert reqs[1]["attrs"]["index"] == "s" and reqs[1]["attrs"]["rows"] == 2
    ticks = [b for b in obs.tracer().spans("serve.batch")
             if b["attrs"].get("kind") == "decode.paged"]
    assert ticks and all(b["attrs"]["tick_k"] == 1 and b["attrs"]["lanes"]
                         == 1 for b in ticks)
    assert len(ticks) >= 3  # the first token comes from the prefill


def test_span_names_and_keys_match_the_jax_engine(obs_on, tmp_path,
                                                  monkeypatch):
    """The same /predict and /embed on both engines: the same span names
    and attribute keys (the ids are each process's own)."""
    jax = pytest.importorskip("jax")  # noqa: F841 — the JAX reference
    from deeplearning4j_tpu import obs as jobs
    from deeplearning4j_tpu.obs import journal as jjournal
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.serving.engine import ServingEngine as JEngine

    conf = (jconf.NeuralNetConfiguration.builder().seed(7).list()
            .layer(0, jconf.DenseLayer(n_in=6, n_out=12, activation="relu"))
            .layer(1, jconf.OutputLayer(n_in=12, n_out=3,
                                        activation="softmax",
                                        loss_function="mcxent"))
            .build())
    x, _ = data(8)
    jjr = jobs.FlightRecorder(path=str(tmp_path / "jax.jsonl"),
                              flush_interval_s=1e9)
    monkeypatch.setattr(jjournal, "_DEFAULT", jjr)
    jobs.tracer().attach(journal=jjr)
    jobs.set_enabled(True)
    jobs.tracer().clear()
    try:
        jeng = JEngine(model=JNet(conf).init()).start()
        try:
            jeng.predict_for(None, None, x[:2])
            jeng.embed(x[:3])
        finally:
            jeng.stop()
    finally:
        jobs.set_enabled(None)
    eng = ServingEngine(model=mlp(), device="cpu").start()
    try:
        eng.predict(x[:2])
        eng.embed(x[:3])
    finally:
        eng.stop()

    def shape(spans):
        return [(s["name"], sorted(s["attrs"])) for s in spans
                if s["name"].startswith("serve.")]

    assert shape(obs.tracer().spans()) == shape(jobs.tracer().spans())


def test_drain_health_and_preempt_journal(obs_on, tmp_path):
    """drain() journals serve.drain and serve.drain_complete and leaves
    them on disk (flushed with fsync); a breaker transition journals
    serve.health; a SIGTERM journals serve.preempt."""
    from deeplearning4j_tpu_torch.resilience import (
        ServingChaos,
        ServingChaosConfig,
    )

    x, _ = data(8)
    chaos = ServingChaos(ServingChaosConfig(infer_raise_at=1))
    eng = ServingEngine(model=mlp(), device="cpu", breaker_fails=1,
                        chaos=chaos).start()
    try:
        with pytest.raises(Exception):
            eng.predict(x[:1])
        assert eng.drain(2.0)
    finally:
        eng.stop()
    events = obs.FlightRecorder.load(obs_on.path)
    kinds = [e["kind"] for e in events]
    assert kinds.index("serve.drain") < kinds.index("serve.drain_complete")
    health = [e for e in events if e["kind"] == "serve.health"]
    assert health and (health[0]["old"], health[0]["new"]) == (
        "serving", "broken")
    assert [e for e in events if e["kind"] == "serve.drain_complete"][0][
        "completed"] is True
    eng = ServingEngine(model=mlp(), device="cpu",
                        handle_signals=True).start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(500):
            if eng.drained:
                break
            time.sleep(0.01)
        assert eng.drained
    finally:
        eng.stop()
    pre = obs_on.events("serve.preempt")
    assert pre and pre[0]["signum"] == int(signal.SIGTERM)
