"""The port's serving planes against the JAX engine, on the CPU at small
widths: SLO classes from ``DL4J_TPU_SERVE_SLO_CLASSES``, the circuit
breaker, tenant quotas, the ``POST /models`` lifecycle, the watchdog,
drain, Prometheus exposition, ``record_base64``, unload and the decode
admission fault.

  * SLO classes: with the knob set, the port's paged pool gets the JAX
    engine's classes; a typo'd spec fails at construction in both, for
    every model kind.
  * Breaker: JAX ``CircuitBreaker`` and the port's, fed one scripted
    sequence of outcomes on an injected clock, make the same transitions,
    snapshots, counters and Retry-After values.
  * Quotas: ``parse_slo_classes`` and ``parse_tenant_quotas`` give the
    same results and raise on the same malformed specs; ``TenantBucket``
    gives the same verdicts on one clock.
  * HTTP: one scripted scenario against both engines under the same
    ``ServingChaos`` plan — load, warmup and serve through ``POST
    /models``, ``record_base64`` against ``record``, injected failures
    walking the breaker open (503 with Retry-After) and the probe closing
    it, a failed load and a failed warmup landing broken while the
    default answers, v2 then v1 by version, unload, 429 and 504, a hung
    dispatch answered 503 "Wedged" and a fresh worker answering after
    the cooldown, the shared serving counters of the Prometheus scrape,
    a malformed payload (400), and a drain (503, ``/health?ready=1`` live
    but not ready, the registry sealed): every status and Retry-After
    equal.
  * Watchdog (port): an injected hang under a 0.2 s watchdog fails its
    request with ModelWedgedError, a fresh worker answers, and the hung
    call's late return changes nothing.
  * Admission fault (port against port): the faulted lane alone is
    evicted; the co-resident transcripts are byte-equal to a run without
    the fault, on the paged and the fixed-slot pool.
  * Unload drops the record's tensors and ``hbm_report`` prices the
    live records; ``rollback_target`` and ``mark_broken`` follow the
    lineage; SIGTERM drains and stops an engine; the metrics registry
    renders the same exposition text as JAX's for one ledger and one
    histogram.
"""

import base64
import json
import os
import signal
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.obs import registry as p_obs  # noqa: E402
from deeplearning4j_tpu_torch.resilience import (  # noqa: E402
    InjectedServingFault,
    ServingChaos,
    ServingChaosConfig,
)
from deeplearning4j_tpu_torch.serving import resilience as p_res  # noqa: E402
from deeplearning4j_tpu_torch.serving import slo as p_slo  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher  # noqa: E402
from deeplearning4j_tpu_torch.serving.decode import ContinuousDecoder  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder  # noqa: E402
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats  # noqa: E402

N_IN, N_OUT = 6, 3
LM_KW = dict(vocab_size=32, d_model=32, n_layers=2, n_heads=2, d_ff=64,
             max_len=64)
# the ledger counters both engines count the same way
SHARED_COUNTERS = (
    "requests", "completed", "errors", "rejected_429", "timeouts",
    "breaker_opens", "breaker_closes", "breaker_probes", "fast_fails_503",
    "wedged_batches", "watchdog_restarts", "worker_deaths",
    "load_failures", "warmup_failures", "drains_started",
    "drains_completed")


@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    conf = (NeuralNetConfiguration.builder().seed(7).learning_rate(0.1)
            .list()
            .layer(0, DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=N_OUT, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    path = str(tmp_path_factory.mktemp("planes") / "mlp.zip")
    ModelSerializer.write_model(JNet(conf).init(), path)
    return path


def _call(url, path, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class TestSloClassesKnob:
    def test_the_knob_reaches_the_paged_pool_as_in_jax(self, monkeypatch):
        from deeplearning4j_tpu.models.transformer import (
            TransformerConfig,
            TransformerLM,
        )
        from deeplearning4j_tpu.serving.engine import (
            ServingEngine as JaxEngine,
        )

        monkeypatch.setenv("DL4J_TPU_SERVE_SLO_CLASSES",
                           "interactive:5, batch:60,bulk:600")
        jeng = JaxEngine(TransformerLM(TransformerConfig(**LM_KW)),
                         kv_blocks=16)
        peng = ServingEngine(pt.TransformerLM(pt.TransformerConfig(**LM_KW),
                                              device="cpu"),
                             kv_blocks=16, device="cpu")
        try:
            jd = jeng._decoder_for(jeng.registry.get())
            want = [(c.name, c.deadline_s, c.priority) for c in jd._classes]
            got = [(c.name, c.deadline_s, c.priority)
                   for c in peng.decoder._classes]
            assert got == want == [("interactive", 5.0, 0),
                                   ("batch", 60.0, 1), ("bulk", 600.0, 2)]
        finally:
            jeng.stop()
            peng.stop()

    @pytest.mark.parametrize("spec", ["interactive:5,batch", "a:1,a:2",
                                      "x:0", ":3", "y:soon"])
    def test_a_typo_fails_at_construction_in_both(self, spec, monkeypatch,
                                                  mlp_zip):
        from deeplearning4j_tpu.serving.engine import (
            ServingEngine as JaxEngine,
        )

        monkeypatch.setenv("DL4J_TPU_SERVE_SLO_CLASSES", spec)
        with pytest.raises(ValueError):
            JaxEngine(model_path=mlp_zip)
        lm = pt.TransformerLM(pt.TransformerConfig(**LM_KW), device="cpu")
        for kw in (dict(model=lm), dict(model_path=mlp_zip), {}):
            with pytest.raises(ValueError):
                ServingEngine(device="cpu", **kw)


class TestBreaker:
    def _drive(self, breaker, clock, stats, transitions):
        """One scripted sequence; returns what each step observed."""
        seen = []

        def step(label, fn):
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — recorded, compared
                out = (type(e).__name__,
                       round(getattr(e, "retry_after_s", -1.0), 9))
            snap = breaker.snapshot()
            snap["open_reason"] = snap["open_reason"].split(":")[0]
            seen.append((label, out, snap))

        step("ok", breaker.record_success)
        step("fail1", lambda: breaker.record_failure("e1"))
        step("check-degraded", breaker.check)
        step("ok2", breaker.record_success)
        for i in range(3):
            step(f"fail{i + 2}", lambda: breaker.record_failure("boom"))
        clock.t += 0.5
        step("check-open", breaker.check)
        clock.t += 1.6
        step("probe", breaker.check)
        step("check-probe-out", breaker.check)
        step("probe-fails", lambda: breaker.record_failure("again"))
        clock.t += 2.1
        step("probe2", breaker.check)
        step("probe2-ok", breaker.record_success)
        step("trip", lambda: breaker.trip("watchdog"))
        clock.t += 0.01
        step("check-tripped", breaker.check)
        clock.t += 61.0
        step("probe3", breaker.check)
        clock.t += 61.0
        step("probe-ttl", breaker.check)  # the first probe never answered
        # the failure-rate window: 10 outcomes at >= 50 % failures
        step("ok3", breaker.record_success)
        for i in range(12):
            step(f"mix{i}", breaker.record_success if i % 2 else
                 (lambda: breaker.record_failure("flaky")))
        snap = {k: v for k, v in stats.snapshot().items()
                if k in ("breaker_opens", "breaker_closes",
                         "breaker_probes", "fast_fails_503")}
        return seen, [(o, n, r.split(":")[0]) for o, n, r in transitions], \
            snap

    def test_same_transitions_as_jax_on_one_clock(self, monkeypatch):
        from deeplearning4j_tpu.serving import resilience as j_res
        from deeplearning4j_tpu.serving.telemetry import (
            ServingStats as JStats,
        )

        kw = dict(fails=4, cooldown_s=2.0, window_s=30.0, rate=0.5,
                  min_window=10, probe_ttl_s=60.0, key="m@v1")
        jclock, pclock = FakeClock(), FakeClock()
        monkeypatch.setattr(j_res, "time",
                            types.SimpleNamespace(monotonic=jclock))
        jt, pt_ = [], []
        jstats, pstats = JStats(), ServingStats()
        jb = j_res.CircuitBreaker(stats=jstats, on_transition=lambda *a:
                                  jt.append(a), **kw)
        pb = p_res.CircuitBreaker(stats=pstats, on_transition=lambda *a:
                                  pt_.append(a), clock=pclock, **kw)
        want = self._drive(jb, jclock, jstats, jt)
        got = self._drive(pb, pclock, pstats, pt_)
        assert got == want
        assert [t[1] for t in got[1]][:3] == ["degraded", "serving",
                                              "degraded"]
        assert got[2]["breaker_opens"] >= 3 and got[2]["breaker_closes"] >= 1

    def test_disabled_and_defaults(self, monkeypatch):
        b = p_res.CircuitBreaker(fails=0)
        for _ in range(10):
            b.record_failure()
        assert b.check() is False and b.state == "serving"
        monkeypatch.setenv("DL4J_TPU_SERVE_BREAKER_FAILS", "7")
        monkeypatch.setenv("DL4J_TPU_SERVE_WATCHDOG_S", "1.5")
        monkeypatch.setenv("DL4J_TPU_SERVE_DRAIN_S", "3")
        assert (p_res.breaker_fails_default(), p_res.watchdog_s_default(),
                p_res.drain_s_default()) == (7, 1.5, 3.0)
        assert p_res.CircuitBreaker().fails == 7


class TestQuotas:
    GOOD = ["", "acme:10", "acme:10,free:2:5", " a:0.5 , b:3:1 ,"]
    BAD = ["acme", "acme:x", "acme:0", "acme:1:0.5", "a:1,a:2", ":1",
           "a:1:2:3"]

    @pytest.mark.parametrize("spec", GOOD)
    def test_parse_matches(self, spec):
        from deeplearning4j_tpu.serving import slo as j_slo

        want = [(q.name, q.rate_per_s, q.burst)
                for q in j_slo.parse_tenant_quotas(spec)]
        assert [(q.name, q.rate_per_s, q.burst)
                for q in p_slo.parse_tenant_quotas(spec)] == want

    @pytest.mark.parametrize("spec", BAD)
    def test_malformed_raises_in_both(self, spec):
        from deeplearning4j_tpu.serving import slo as j_slo

        with pytest.raises(ValueError):
            j_slo.parse_tenant_quotas(spec)
        with pytest.raises(ValueError):
            p_slo.parse_tenant_quotas(spec)

    @pytest.mark.parametrize("spec", ["", "i:5,b:60", "a:1,a:2", "x:-1",
                                      "nocolon", "y:z"])
    def test_slo_classes_match(self, spec):
        from deeplearning4j_tpu.serving import slo as j_slo

        try:
            want = [(c.name, c.deadline_s, c.priority)
                    for c in j_slo.parse_slo_classes(spec)]
        except ValueError:
            with pytest.raises(ValueError):
                p_slo.parse_slo_classes(spec)
            return
        assert [(c.name, c.deadline_s, c.priority)
                for c in p_slo.parse_slo_classes(spec)] == want

    def test_bucket_verdicts_on_one_clock(self):
        from deeplearning4j_tpu.serving import slo as j_slo

        out = []
        for mod in (j_slo, p_slo):
            clock = FakeClock()
            b = mod.TenantBucket(mod.TenantQuota("t", 2.0, 3.0),
                                 now_fn=clock)
            seen = []
            for dt in (0, 0, 0, 0, 0.25, 0.25, 0.1, 5.0, 0, 0, 0):
                clock.t += dt
                ok, retry = b.try_take()
                seen.append((ok, round(retry, 9), round(b.tokens(), 9)))
            out.append(seen)
        assert out[0] == out[1]
        assert [s[0] for s in out[1][:4]] == [True, True, True, False]


def _scenario(eng, chaos, zip_path):
    """The scripted HTTP run; returns [(step, status, Retry-After, error
    kind or a compared body field)]."""
    url = eng.url
    log = []
    row = np.linspace(-1, 1, N_IN).astype(np.float32)

    def rec(label, code, hdr, body, keep=None):
        got = json.loads(body) if body.startswith("{") else {}
        if keep is not None:
            kind = keep(got)
        else:
            kind = got.get("error", body[:20]).split(":")[0] \
                if code != 200 else None
        log.append((label, code, hdr.get("Retry-After"), kind))
        return body

    def post(label, path, payload, keep=None):
        return rec(label, *_call(url, path, payload), keep=keep)

    def get(label, path, keep=None, headers=None):
        return rec(label, *_call(url, path, headers=headers), keep=keep)

    state = lambda b: b.get("state")  # noqa: E731
    get("health-empty", "/health", keep=lambda b: (b["ok"], b["models"]))
    post("load", "/models", {"action": "load", "name": "m",
                             "path": zip_path, "input_shape": [N_IN]},
         keep=state)
    post("warmup", "/models", {"action": "warmup", "name": "m",
                               "max_batch": 4},
         keep=lambda b: b["buckets"])
    post("serve", "/models", {"action": "serve", "name": "m"}, keep=state)
    a = json.loads(post("record", "/predict", {"record": row.tolist()}))
    b64 = base64.b64encode(row.tobytes()).decode()
    b = json.loads(post("record_base64", "/predict",
                        {"record_base64": b64}))
    log.append(("base64==record", a["output"] == b["output"], None, None))
    post("raise1", "/predict", {"record": row.tolist()})
    post("raise2", "/predict", {"record": row.tolist()})
    post("open", "/predict", {"record": row.tolist()})
    time.sleep(0.4)
    post("probe", "/predict", {"record": row.tolist()},
         keep=lambda b: len(b["output"]))
    post("load-bad", "/models", {"action": "load", "name": "bad",
                                 "path": zip_path})
    post("predict-bad", "/predict", {"record": row.tolist(),
                                     "model": "bad"})
    post("load-v2", "/models", {"action": "load", "name": "m",
                                "path": zip_path, "input_shape": [N_IN]},
         keep=lambda b: b["version"])
    post("warmup-v2", "/models", {"action": "warmup", "name": "m",
                                  "version": 2, "max_batch": 4},
         keep=lambda b: b["model"])
    post("serve-v2", "/models", {"action": "serve", "name": "m",
                                 "version": 2},
         keep=lambda b: (b["state"], b["prior_default"]))
    post("predict-v2", "/predict", {"record": row.tolist()})
    post("predict-v1", "/predict", {"record": row.tolist(), "model": "m",
                                    "version": 1})
    get("models", "/models", keep=lambda b: (
        b["default"], [(e["from"], e["to"]) for e in b["lineage"]],
        [(d["name"], d["version"], d["state"]) for d in b["models"]]))
    post("unload-v1", "/models", {"action": "unload", "name": "m",
                                  "version": 1}, keep=state)
    post("predict-unloaded", "/predict", {"record": row.tolist(),
                                          "model": "m", "version": 1})
    post("load-wf", "/models", {"action": "load", "name": "wf",
                                "path": zip_path, "input_shape": [N_IN]},
         keep=state)
    post("warmup-wf", "/models", {"action": "warmup", "name": "wf"})
    post("predict-wf", "/predict", {"record": row.tolist(), "model": "wf"})
    # 429 and 504: dispatch 8 sleeps while one request waits in the queue
    results = {}

    def bg(key):
        results[key] = _call(url, "/predict", {"record": row.tolist()})

    t1 = threading.Thread(target=bg, args=("slow",))
    t1.start()
    for _ in range(500):
        if (8, "slow_infer") in chaos.log:
            break
        time.sleep(0.01)
    t2 = threading.Thread(target=bg, args=("queued",))
    t2.start()
    for _ in range(500):
        if eng.stats.snapshot()["queue_depth"] == 1:
            break
        time.sleep(0.01)
    post("queue-full", "/predict", {"record": row.tolist()})
    t1.join()
    t2.join()
    for key in ("slow", "queued"):
        rec(key, *results[key])
    post("deadline", "/predict", {"record": row.tolist(), "timeout_s": 0})
    # the expired request holds the one queue slot until the worker takes
    # it off; "hang" must find the slot free (else it reads 429 and the
    # hang lands on the next dispatch, "fresh-worker")
    for _ in range(500):
        if eng.stats.snapshot()["queue_depth"] == 0:
            break
        time.sleep(0.01)
    post("hang", "/predict", {"record": row.tolist()})
    get("health-wedged", "/health",
        keep=lambda b: b["health"])
    time.sleep(0.4)
    post("fresh-worker", "/predict", {"record": row.tolist()},
         keep=lambda b: len(b["output"]))
    chaos.release_hangs()
    snap = eng.stats.snapshot()
    log.append(("counters", {k: snap[k] for k in SHARED_COUNTERS},
                None, None))
    # the scrape before the malformed payload, which the JAX engine
    # queues (its rows are shaped inside the batch) and the port refuses
    # before the queue: from then on "requests" differs by one
    code, hdr, text = _call(url, "/metrics", headers={"Accept":
                                                      "text/plain"})
    log.append(("prometheus", code, None, hdr.get("Content-Type")))
    post("malformed", "/predict", {"record": [1.0, 2.0]})
    post("no-payload", "/predict", {"rows": [1.0]})
    eng.drain(5.0)
    get("health-draining", "/health",
        keep=lambda b: (b["ok"], b["draining"], b["health"]))
    get("ready", "/health?ready=1")
    code, hdr, body = _call(url, "/health?ready=1")
    got = json.loads(body)
    log.append(("ready-body", code, None,
                (got["live"], got["ready"], got["draining"])))
    post("drained", "/predict", {"record": row.tolist()})
    post("sealed", "/models", {"action": "load", "name": "late",
                               "path": zip_path})
    code, hdr, _ = _call(url, "/metrics?format=prometheus")
    log.append(("prometheus-query", code, None, hdr.get("Content-Type")))
    return log, text


def _prometheus_counters(text, owner):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or f'owner="{owner}"' not in line:
            continue
        name, value = line.rsplit(" ", 1)
        name = name.split("{")[0]
        if name.startswith("dl4j_serving_"):
            out[name[len("dl4j_serving_"):]] = float(value)
    return out


class TestHttpAgainstTheJaxEngine:
    def test_one_scenario_same_statuses(self, mlp_zip):
        from deeplearning4j_tpu.obs import registry as j_obs
        from deeplearning4j_tpu.resilience import (
            ServingChaos as JChaos,
            ServingChaosConfig as JChaosConfig,
        )
        from deeplearning4j_tpu.serving.engine import (
            ServingEngine as JaxEngine,
        )

        plan = dict(infer_raise_at=3, infer_raise_count=2,
                    load_fail_name="bad", warmup_fail_name="wf",
                    slow_infer_at=8, slow_infer_s=0.6, infer_hang_at=10,
                    infer_hang_s=30.0)
        kw = dict(max_batch=4, max_wait_ms=1, queue_capacity=1,
                  breaker_fails=2, breaker_cooldown_s=0.3, watchdog_s=1.5)
        runs = []
        for make, chaos, obs in (
                (lambda c: JaxEngine(chaos=c, **kw),
                 JChaos(JChaosConfig(**plan)), j_obs),
                (lambda c: ServingEngine(chaos=c, device="cpu", **kw),
                 ServingChaos(ServingChaosConfig(**plan)), p_obs)):
            eng = make(chaos).start()
            try:
                log, text = _scenario(eng, chaos, mlp_zip)
                owner = obs.default_registry()._owner_labels[id(eng)]
                runs.append((log, _prometheus_counters(text, owner),
                             [c for c in chaos.log]))
            finally:
                chaos.release_hangs()
                eng.stop(drain=False)
        (jlog, jprom, jchaos), (plog, pprom, pchaos) = runs
        assert len(plog) == len(jlog)
        for j, p in zip(jlog, plog):
            assert p == j, (j, p)
        assert pchaos == jchaos
        want = [e for e in plog if e[0] == "counters"][0][1]
        assert want["breaker_opens"] == 2 and want["wedged_batches"] == 1
        assert want["watchdog_restarts"] == 1 and want["load_failures"] == 1
        for k in SHARED_COUNTERS:
            assert pprom[k] == jprom[k], k
        statuses = {e[0]: e[1] for e in plog}
        assert statuses["open"] == 503 and statuses["queue-full"] == 429
        assert statuses["deadline"] == 504 and statuses["hang"] == 503
        assert statuses["fresh-worker"] == 200
        assert statuses["drained"] == 503 and statuses["sealed"] == 503


class TestWatchdog:
    def test_hang_is_diagnosed_and_the_late_return_changes_nothing(self):
        chaos = ServingChaos(ServingChaosConfig(infer_hang_at=1,
                                                infer_hang_s=30.0))
        wedged, outcomes = [], []
        stats = ServingStats()

        def infer(batch):
            chaos.on_infer()
            return batch * 2.0

        b = DynamicBatcher(infer, max_wait_ms=1, stats=stats,
                           watchdog_s=0.2, on_wedged=wedged.append,
                           on_outcome=lambda ok, e: outcomes.append(ok))
        try:
            first = b.submit(np.ones((1, 3), np.float32))
            with pytest.raises(p_res.ModelWedgedError, match="watchdog"):
                first.result(timeout=10)
            assert len(wedged) == 1 and wedged[0]["failed_requests"] == 1
            out = b.predict(np.full((2, 3), 3.0, np.float32), timeout_s=10)
            np.testing.assert_array_equal(out, np.full((2, 3), 6.0))
            before = stats.snapshot()
            chaos.release_hangs()  # the hung call returns now
            time.sleep(0.3)
            after = stats.snapshot()
            assert after == before
            assert after["wedged_batches"] == 1
            assert after["watchdog_restarts"] == 1
            assert outcomes == [True]  # the hung dispatch never reported
            assert isinstance(first.exception(), p_res.ModelWedgedError)
        finally:
            chaos.release_hangs()
            b.stop()


class TestAdmissionFault:
    @pytest.mark.parametrize("pool", ["paged", "fixed"])
    def test_only_the_faulted_lane_is_evicted(self, pool):
        lm = pt.TransformerLM(pt.TransformerConfig(**LM_KW, seed=3),
                              device="cpu")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(1, 32, n).tolist() for n in (5, 9, 3, 12)]

        def run(chaos):
            if pool == "paged":
                d = PagedDecoder(lm, block_tokens=8, n_blocks=40,
                                 chaos=chaos, device="cpu")
            else:
                d = ContinuousDecoder(lm, slots=4, chaos=chaos,
                                      device="cpu")
            try:
                futs = [d.submit(p, 12, temperature=0.0) for p in prompts]
                out = []
                for f in futs:
                    try:
                        out.append(np.asarray(f.result(timeout=120)))
                    except InjectedServingFault as e:
                        out.append(e)
                return out, d.stats.snapshot()["slot_crashes"], d._dead
            finally:
                d.stop()

        clean, crashes, dead = run(None)
        assert crashes == 0
        chaos = ServingChaos(ServingChaosConfig(admit_raise_at=2))
        faulted, crashes, dead = run(chaos)
        assert crashes == 1 and dead is None
        assert chaos.log == [(2, "admit_raise")]
        assert isinstance(faulted[1], InjectedServingFault)
        for i in (0, 2, 3):
            np.testing.assert_array_equal(faulted[i], clean[i])


class TestLifecycleInProcess:
    def test_unload_drops_the_tensors_and_hbm_prices_live_records(
            self, mlp_zip):
        eng = ServingEngine(model_path=mlp_zip, input_shape=(N_IN,),
                            device="cpu")
        try:
            rec = eng.registry.get()
            net = rec.model
            want = sum(t.numel() * t.element_size()
                       for tree in (net.params, net.states,
                                    net.updater_state)
                       for layer in tree for t in _leaves(layer))
            hbm = eng.hbm_report()
            assert hbm["models"]["default"]["param_bytes"] == want > 0
            assert hbm["used_bytes"] == want and hbm["indexes"] == {}
            eng.predict(np.zeros((2, N_IN), np.float32))
            assert rec.key in eng._batchers
            eng.retire("default")
            assert rec.state == "unloaded" and rec.model is None
            assert net.params is None and net.updater_state is None
            assert rec.key not in eng._batchers
            assert eng.hbm_report()["used_bytes"] == 0
            assert eng.health()[1]["health"] == {"default@v1": "unloaded"}
        finally:
            eng.stop()

    def test_sigterm_drains_and_stops(self, mlp_zip):
        eng = ServingEngine(model_path=mlp_zip, device="cpu",
                            handle_signals=True).start()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(500):
                if eng.drained:
                    break
                time.sleep(0.01)
            assert eng.draining and eng.drained
            assert eng.stats.snapshot()["drains_completed"] == 1
        finally:
            eng.stop()
        assert signal.getsignal(signal.SIGTERM) != eng._on_signal


class TestRegistryAndExposition:
    def test_rollback_target_and_mark_broken(self, mlp_zip):
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

        reg = ModelRegistry(device="cpu")
        assert reg.rollback_target() is None
        v1 = reg.load("m", model_path=mlp_zip)
        reg.serve("m")
        assert reg.rollback_target() is None  # replaced nothing
        reg.load("m", model_path=mlp_zip)
        reg.serve("m", 2)
        assert reg.rollback_target() == ("m", 1)
        assert [(e["from"], e["to"]) for e in reg.lineage()] == \
            [(None, "m@v1"), ("m@v1", "m@v2")]
        with pytest.raises(ValueError, match="serving default"):
            reg.mark_broken("m", 2)
        reg.mark_broken("m", 1, error="gate")
        assert v1.state == "broken" and reg.rollback_target() is None
        reg.seal()
        with pytest.raises(p_res.DrainingError):
            reg.load("m", model_path=mlp_zip)
        reg.unload("m", 2)  # unload stays legal once sealed
        assert reg.default() is None

    def test_render_prometheus_matches_jax(self):
        from deeplearning4j_tpu.obs import registry as j_obs

        class Engine:
            pass

        ledger = {"requests": 7, "ok": True, "none": None, "p": 0.25,
                  "nested": {"a b": 3, "q\"x": 1.5e-7}, "big": 2 ** 60}
        texts = []
        for mod in (j_obs, p_obs):
            reg, owner = mod.MetricsRegistry(), Engine()
            reg.register_ledger(owner, "serving_stats", ledger)
            for v in (0.0004, 0.01, 0.3, 20.0):
                reg.histogram("dl4j_serving_latency_seconds", v)
            reg.histogram("h", 2.0, buckets=(1.0, 3.0), model='a"b\\c')
            texts.append(reg.render_prometheus())
        assert texts[1] == texts[0]
        assert 'model="a\\"b\\\\c"' in texts[1]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def test_the_port_net_loads_its_zip(mlp_zip):
    assert MultiLayerNetwork.load(mlp_zip, device="cpu").params is not None
