"""The port's serving fleet on the CPU: ``ServingFleet``, ``FleetRouter``
and the OS-process replica (``deeplearning4j_tpu_torch/serving/{fleet,
router}.py``), held to JAX ``tests/test_serving_fleet.py`` and
``test_serving_fleet_process.py``'s contracts and, where the wire is
shared, to the JAX package itself.

Port contracts: the router plus 2 replicas byte-identical to one engine
on ``/predict`` (an MLP) and ``/generate`` (a small TransformerLM,
greedy, the paged pool); a replica hard-killed mid-stream by
``RouterChaos`` loses no admitted request; an announced departure is a
clean leave; a partition ejects a replica through its breaker and the
half-open probe re-admits it; a rolling rollout shifts every replica and
an injected warmup failure rolls back; the SLO classes shed the low
class (429 + Retry-After) while the high class admits; a draining
replica is alive but not ready and gets no breaker vote; a drain seals
the registry; the router's ledger rides the central registry; OS-process
replicas started by ``python -m deeplearning4j_tpu_torch.serving.fleet
--cpu`` answer, say goodbye on SIGTERM and expire on SIGKILL.

Against the JAX package: one ``RouterChaos`` scenario (r0 killed after 3
proxied requests, 10 requests) through JAX's ``ServingFleet`` and the
port's, both serving the same JAX-written zip: the same HTTP statuses in
the same order and the same router counters; the replica address files
each package writes are read by the other.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_net(seed=7, n_in=4, n_out=3):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.1)
            .list()
            .layer(0, DenseLayer(n_in=n_in, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=n_out, activation="softmax",
                                  loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(seed)
    net.fit(rng.normal(size=(32, n_in)).astype(np.float32),
            np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, 32)])
    return net


def small_lm():
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    torch.manual_seed(0)
    return TransformerLM(TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
        max_len=64), device="cpu")


@pytest.fixture(scope="module")
def net():
    return small_net()


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)


def _post_raw(url, path, payload, timeout=60):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, path, timeout=30):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine(model, **kw):
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model=model, device="cpu", **kw).start()


def _fleet(model, n=2, **kw):
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet

    kw.setdefault("heartbeat_s", 0.5)
    return ServingFleet(model=model, replicas=n, device="cpu", **kw).start()


def _wait_members(fleet, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        fleet.router.refresh()
        if sorted(fleet.router.describe_replicas()) == want:
            return
        time.sleep(0.1)
    assert sorted(fleet.router.describe_replicas()) == want


class TestByteIdentity:
    def test_predict_through_router_equals_one_engine(self, net, rows):
        solo, fleet = _engine(net), _fleet(net, 2)
        try:
            for batch in (rows[:1], rows[1:4], rows[4:9], rows[2:3],
                          rows[:8], rows[9:16]):
                payload = {"batch": batch.tolist()}
                s = _post_raw(solo.url, "/predict", payload)
                f = _post_raw(fleet.url, "/predict", payload)
                assert s[0] == f[0] == 200
                assert s[1] == f[1]  # bytes
        finally:
            fleet.stop()
            solo.stop()

    def test_generate_through_router_equals_one_engine(self):
        lm = small_lm()
        solo = _engine(lm, kv_blocks=64)
        fleet = _fleet(lm, 2, engine_kwargs={"kv_blocks": 64})
        try:
            rng = np.random.default_rng(4)
            for n in (3, 11, 20, 7):
                payload = {"tokens": [rng.integers(0, 64, n).tolist()],
                           "n_new": 9, "temperature": 0.0}
                s = _post_raw(solo.url, "/generate", payload)
                f = _post_raw(fleet.url, "/generate", payload)
                assert s[0] == f[0] == 200
                assert s[1] == f[1]
        finally:
            fleet.stop()
            solo.stop()


class TestChaos:
    def test_killed_replica_loses_no_admitted_request(self, net, rows):
        from deeplearning4j_tpu_torch.resilience import (
            RouterChaos,
            RouterChaosConfig,
        )

        chaos = RouterChaos(RouterChaosConfig(
            kill_replica={"replica": "r0", "after_proxied": 3}))
        fleet = _fleet(net, 2, chaos=chaos, router_kwargs={"poll_s": 30.0})
        try:
            want = net.output(rows[:2]).numpy()
            for i in range(20):
                code, body = _post_raw(fleet.url, "/predict",
                                       {"batch": rows[:2].tolist()})
                assert code == 200, f"request {i} failed: {body!r}"
                np.testing.assert_array_equal(
                    np.asarray(json.loads(body)["outputs"], np.float32),
                    want)
            assert any("kill_replica" in str(f) for _, f in chaos.log)
            assert not fleet._handles["r0"].alive
            snap = fleet.router.stats.snapshot()
            assert snap["replica_failures"] >= 1 and snap["retries"] >= 1
            _wait_members(fleet, ["r1"])
            code, body = _get(fleet.url, "/health")
            assert code == 200 and body["routable"] == ["r1"]
            fleet.restart_replica("r0")  # the respawn path
            _wait_members(fleet, ["r0", "r1"])
        finally:
            fleet.stop()

    def test_announced_departure_is_a_clean_leave(self, net, rows):
        fleet = _fleet(net, 2)
        try:
            fleet.depart_replica("r1")
            _wait_members(fleet, ["r0"])
            code, _ = _post_raw(fleet.url, "/predict",
                                {"batch": rows[:2].tolist()})
            assert code == 200
            assert fleet.router.stats.snapshot()["breaker_opens"] == 0
        finally:
            fleet.stop()

    def test_partition_ejects_then_halfopen_readmits(self, net, rows):
        from deeplearning4j_tpu_torch.resilience import (
            RouterChaos,
            RouterChaosConfig,
        )
        from deeplearning4j_tpu_torch.serving.router import FleetRouter

        e0, e1 = _engine(net), _engine(net)
        router = FleetRouter(
            replicas={"r0": e0.url, "r1": e1.url}, replica_fails=2,
            breaker_cooldown_s=0.2, poll_s=30.0,
            chaos=RouterChaos(RouterChaosConfig(
                partition_replica={"replica": "r0", "calls": 2})))
        try:
            body = json.dumps({"batch": rows[:2].tolist()}).encode()
            for _ in range(4):
                assert router.proxy_predict(body)[0] == 200
            state = lambda: router.describe_replicas()["r0"]["breaker"][
                "state"]
            assert state() == "broken"
            assert router.stats.snapshot()["breaker_opens"] == 1
            time.sleep(0.25)
            deadline = time.monotonic() + 5.0
            while state() != "serving" and time.monotonic() < deadline:
                assert router.proxy_predict(body)[0] == 200
                time.sleep(0.05)
            assert state() == "serving"
            assert router.stats.snapshot()["breaker_closes"] >= 1
        finally:
            router.stop()
            e0.stop()
            e1.stop()


class TestRollout:
    def test_rollout_shifts_every_replica(self, net, rows, tmp_path):
        from deeplearning4j_tpu_torch.utils.serialization import write_model

        net2 = small_net(seed=11)
        path = str(tmp_path / "m2.zip")
        write_model(net2, path)
        fleet = _fleet(net, 2)
        try:
            code, report = _post_raw(fleet.url, "/rollout",
                                     {"name": "m2", "path": path,
                                      "input_shape": [4]})
            report = json.loads(report)
            assert code == 200 and report["ok"], report
            for eng in fleet.engines().values():
                assert eng.registry.default().key == "m2@v1"
            code, body = _post_raw(fleet.url, "/predict",
                                   {"batch": rows[:3].tolist()})
            assert code == 200
            np.testing.assert_array_equal(
                np.asarray(json.loads(body)["outputs"], np.float32),
                net2.output(rows[:3]).numpy())
            assert fleet.router.stats.snapshot()["rollouts"] == 1
        finally:
            fleet.stop()

    def test_warmup_failure_rolls_back(self, net, rows, tmp_path):
        from deeplearning4j_tpu_torch.resilience import (
            ServingChaos,
            ServingChaosConfig,
        )
        from deeplearning4j_tpu_torch.utils.serialization import write_model

        path = str(tmp_path / "m2.zip")
        write_model(small_net(seed=11), path)
        fleet = _fleet(net, 2)
        try:
            fleet.engines()["r1"].registry.chaos = ServingChaos(
                ServingChaosConfig(warmup_fail_name="m2"))
            code, report = _post_raw(fleet.url, "/rollout",
                                     {"name": "m2", "path": path,
                                      "input_shape": [4]})
            report = json.loads(report)
            assert code == 409 and not report["ok"]
            assert report["failed_replica"] == "r1"
            assert report["rolled_back"] == ["r0"]
            for eng in fleet.engines().values():
                assert eng.registry.default().key == "default@v1"
            assert fleet.engines()["r1"].registry.get("m2").state == \
                "broken"
            code, body = _post_raw(fleet.url, "/predict",
                                   {"batch": rows[:3].tolist()})
            assert code == 200
            np.testing.assert_array_equal(
                np.asarray(json.loads(body)["outputs"], np.float32),
                net.output(rows[:3]).numpy())
            assert fleet.router.stats.snapshot()["rollbacks"] == 1
        finally:
            fleet.stop()


class TestAdmission:
    def test_low_class_sheds_while_high_class_admits(self, net, rows):
        from deeplearning4j_tpu_torch.serving.router import (
            FleetOverloadError,
        )

        fleet = _fleet(net, 1, router_kwargs={
            "slo_classes": "interactive:5,batch:60", "queue_cap": 2})
        router = fleet.router
        try:
            assert router._admit({"slo": "batch"}) == "batch"
            with pytest.raises(FleetOverloadError):
                router._admit({"slo": "batch"})
            assert router._admit({"slo": "interactive"}) == "interactive"
            router._release()
            router._release()
            assert router.stats.snapshot()["shed_by_class"] == {"batch": 1}
            assert router._class_of({}) == ("batch", 1)
            router._admit({"slo": "batch"})
            try:
                req = urllib.request.Request(
                    fleet.url + "/predict",
                    data=json.dumps({"batch": rows[:1].tolist(),
                                     "slo": "batch"}).encode(),
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=30)
                assert ei.value.code == 429
                assert ei.value.headers["Retry-After"] == "1"
                assert _post_raw(fleet.url, "/predict",
                                 {"batch": rows[:1].tolist(),
                                  "slo": "interactive"})[0] == 200
            finally:
                router._release()
        finally:
            fleet.stop()

    def test_draining_is_alive_but_not_ready(self, net):
        eng = _engine(net)
        try:
            code, body = _get(eng.url, "/health")
            assert code == 200 and "live" not in body
            code, body = _get(eng.url, "/health?ready=1")
            assert code == 200 and body["live"] and body["ready"]
            eng.drain()
            code, body = _get(eng.url, "/health?ready=1")
            assert code == 503
            assert body["live"] is True and body["ready"] is False
        finally:
            eng.stop()

    def test_drain_stops_admission_without_breaker_vote(self, net, rows):
        fleet = _fleet(net, 2)
        try:
            fleet.engines()["r0"].drain()
            deadline = time.monotonic() + 5.0
            while (fleet.router.describe_replicas()["r0"]["ready"]
                   and time.monotonic() < deadline):
                fleet.router.refresh()
                time.sleep(0.05)
            desc = fleet.router.describe_replicas()
            assert desc["r0"]["ready"] is False
            assert desc["r0"]["breaker"]["state"] == "serving"
            assert _post_raw(fleet.url, "/predict",
                             {"batch": rows[:2].tolist()})[0] == 200
        finally:
            fleet.stop()

    def test_drain_seals_the_registry(self, net):
        from deeplearning4j_tpu_torch.serving.resilience import DrainingError

        eng = _engine(net)
        try:
            eng.registry.load("m2", model=small_net(seed=11))
            eng.drain()
            with pytest.raises(DrainingError):
                eng.registry.warmup("m2")
            with pytest.raises(DrainingError):
                eng.registry.serve("m2")
            assert _post_raw(eng.url, "/models",
                             {"action": "serve", "name": "m2"})[0] == 503
            assert eng.registry.default().key == "default@v1"
            eng.registry.unload("m2")
        finally:
            eng.stop()

    def test_router_ledger_rides_the_central_registry(self, net, rows):
        from deeplearning4j_tpu_torch.obs import registry as obs_registry

        fleet = _fleet(net, 1)
        try:
            _post_raw(fleet.url, "/predict", {"batch": rows[:2].tolist()})
            reg = obs_registry.default_registry()
            assert "router_stats" in reg.ledgers(fleet.router)
            text = reg.render_prometheus()
            assert "dl4j_router_requests" in text
            assert "dl4j_router_proxied_ok" in text
            code, body = _get(fleet.url, "/metrics")
            assert code == 200 and body["router"]["proxied_ok"] >= 1
        finally:
            fleet.stop()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _chaos_scenario(pkg, zip_path):
    """(statuses, router counters) of 10 /predict requests through a
    2-replica fleet whose r0 is killed after 3 proxied requests."""
    if pkg == "jax":
        from deeplearning4j_tpu.resilience import (
            RouterChaos,
            RouterChaosConfig,
        )
        from deeplearning4j_tpu.serving.fleet import ServingFleet

        kw = {}
    else:
        from deeplearning4j_tpu_torch.resilience import (
            RouterChaos,
            RouterChaosConfig,
        )
        from deeplearning4j_tpu_torch.serving.fleet import ServingFleet

        kw = {"device": "cpu"}
    chaos = RouterChaos(RouterChaosConfig(
        kill_replica={"replica": "r0", "after_proxied": 3}))
    fleet = ServingFleet(model_path=zip_path, replicas=2, heartbeat_s=0.5,
                         chaos=chaos, input_shape=[4],
                         engine_kwargs={"max_wait_ms": 0.0},
                         router_kwargs={"poll_s": 30.0}, **kw).start()
    rows = np.random.default_rng(9).normal(size=(2, 4)).astype(np.float32)
    try:
        statuses = [_post_raw(fleet.url, "/predict",
                              {"batch": rows.tolist()})[0]
                    for _ in range(10)]
        snap = fleet.router.stats.snapshot()
    finally:
        fleet.stop()
    keys = ("requests", "proxied_ok", "retries", "replica_failures",
            "breaker_opens", "shed")
    return statuses, {k: snap.get(k) for k in keys}, chaos.log


def test_router_chaos_scenario_equal_across_packages(tmp_path):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(0, DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .build())
    jnet = MultiLayerNetwork(conf).init()
    jnet.params = [{k: jnp.asarray(np.asarray(v, np.float32))
                    for k, v in p.items()} for p in jnet.params]
    path = str(tmp_path / "mlp.zip")
    ModelSerializer.write_model(jnet, path)
    j_status, j_counts, j_log = _chaos_scenario("jax", path)
    p_status, p_counts, p_log = _chaos_scenario("port", path)
    assert p_status == j_status == [200] * 10
    assert p_counts == j_counts
    assert p_counts["replica_failures"] >= 1 and p_counts["retries"] >= 1
    assert p_log == j_log


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replica_addr_files_read_across_packages(tmp_path, writer):
    pytest.importorskip("jax")
    from deeplearning4j_tpu.serving import router as jrouter

    from deeplearning4j_tpu_torch.serving import router as prouter

    w, r = (jrouter, prouter) if writer == "jax" else (prouter, jrouter)
    w.publish_replica_addr(str(tmp_path), "r3", "http://127.0.0.1:9",
                           role="decode")
    assert r.read_replica_addr(str(tmp_path), "r3") == "http://127.0.0.1:9"
    assert r.read_replica_entry(str(tmp_path), "r3") == {
        "url": "http://127.0.0.1:9", "role": "decode"}
    r.remove_replica_addr(str(tmp_path), "r3")
    assert w.read_replica_addr(str(tmp_path), "r3") is None


# ---------------------------------------------------------------------------
# OS-process replicas
# ---------------------------------------------------------------------------


def _spawn_replica(fleet_dir, rid, model_path, heartbeat_s=0.5):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serving.fleet",
         "--cpu", "--fleet-dir", str(fleet_dir), "--replica-id", rid,
         "--model-path", str(model_path), "--heartbeat-s",
         str(heartbeat_s)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait_addr(fleet_dir, rid, deadline_s=90.0):
    from deeplearning4j_tpu_torch.serving.router import read_replica_addr

    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        url = read_replica_addr(str(fleet_dir), rid)
        if url is not None:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if r.status == 200:
                        return url
            except OSError:
                pass
        time.sleep(0.2)
    raise AssertionError(f"replica {rid} never came up")


def test_process_replicas_goodbye_and_expiry(net, tmp_path):
    from deeplearning4j_tpu_torch.parallel.fleet import FileMembershipBoard
    from deeplearning4j_tpu_torch.serving.router import (
        FleetRouter,
        read_replica_addr,
    )
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    model_path = tmp_path / "model.zip"
    write_model(net, str(model_path))
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    procs = {rid: _spawn_replica(fleet_dir, rid, model_path)
             for rid in ("r0", "r1")}
    router = None
    try:
        for rid in procs:
            _wait_addr(fleet_dir, rid)
        router = FleetRouter(board=FileMembershipBoard(
            str(fleet_dir), heartbeat_timeout=0.5), poll_s=0.2)
        router.start()
        assert sorted(router.describe_replicas()) == ["r0", "r1"]
        rows = np.random.default_rng(5).normal(size=(4, 4)).astype(
            np.float32)
        body = json.dumps({"batch": rows.tolist()}).encode()
        bodies = set()
        for _ in range(4):
            status, _, data = router.proxy_predict(body)
            assert status == 200
            bodies.add(data)
        assert len(bodies) == 1
        np.testing.assert_allclose(
            np.asarray(json.loads(bodies.pop())["outputs"], np.float32),
            net.output(rows).numpy(), rtol=0, atol=1e-6)
        procs["r1"].send_signal(signal.SIGTERM)
        assert procs["r1"].wait(timeout=60) == 0
        deadline = time.monotonic() + 10.0
        while sorted(router.describe_replicas()) != ["r0"] and \
                time.monotonic() < deadline:
            router.refresh()
            time.sleep(0.1)
        assert sorted(router.describe_replicas()) == ["r0"]
        assert read_replica_addr(str(fleet_dir), "r1") is None
        assert router.proxy_predict(body)[0] == 200
        assert router.stats.snapshot()["breaker_opens"] == 0
        procs["r0"].kill()
        procs["r0"].wait(timeout=30)
        deadline = time.monotonic() + 10.0
        while router.describe_replicas() and time.monotonic() < deadline:
            router.refresh()
            time.sleep(0.1)
        assert not router.describe_replicas()
    finally:
        if router is not None:
            router.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
