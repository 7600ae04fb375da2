"""The port's autoscaler, placement and tenant quotas on the CPU
(``deeplearning4j_tpu_torch/serving/{autoscale,placement}.py``, the
router's quota and affinity gates), held to JAX
``tests/test_autoscale.py``'s contracts and to the JAX package:

* one recorded ``signals_log`` (a scripted wave, and the log of a live
  port run) replayed through JAX's and the port's ``FleetAutoscaler``:
  equal ``decisions`` lists;
* ``pack_models`` plans equal to JAX's on the same footprints (FFD, the
  unplaced list, utilization);
* ``model_footprint`` bytes equal to JAX's closed form for the same
  TransformerLM (params and Adam state, the KV arena at a budget) and
  MLP;
* ``AutoscaleChaos`` overlays equal to JAX's, tick by tick;
* ``kv_block_bytes(devices=...)`` and ``kv_arena_blocks(devices=...)``
  equal to JAX's;

and port contracts: tenant quotas (one tenant's burst sheds 429 with
Retry-After while another is untouched), affinity routing and the loud
503 for an unplaced model, the ``/signals``, ``/placement`` and
``/replicas`` surfaces, the goodbye order (the address file goes before
the board entry), and a scripted ``/predict`` wave scaling the fleet
1 -> 2 -> 1 with no failed request, its decisions replaying exactly.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_serving_fleet import small_net

LM_KW = dict(vocab_size=29, d_model=16, n_layers=2, n_heads=2, d_ff=32,
             max_len=32, use_flash=False)


@pytest.fixture(scope="module")
def net():
    return small_net()


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _post_raw(url, path, payload, timeout=60):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _get(url, path, timeout=30):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fleet(model, n=2, **kw):
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet

    kw.setdefault("heartbeat_s", 0.5)
    return ServingFleet(model=model, replicas=n, device="cpu", **kw).start()


def _wait_ready(router, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(router.signals()["ready_replicas"]) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"fleet never reached {n} ready replicas")


def _stripped(decisions):
    return [{k: v for k, v in d.items()
             if k not in ("enacted", "enact_error")} for d in decisions]


def _snap(ready, queue, shed=0, p99_ms=None, deadline_s=5.0):
    lat = {}
    if p99_ms is not None:
        lat["default"] = {"p50": p99_ms / 2, "p99": p99_ms, "count": 10}
    return {"ready_replicas": [f"r{i}" for i in range(ready)],
            "queue_depth": queue, "shed_total": shed,
            "slo_classes": [{"name": "default", "deadline_s": deadline_s}],
            "per_class_latency_ms": lat}


SCRIPT = ([_snap(1, 20)] * 2 + [_snap(2, 0)] * 4 + [_snap(1, 0)]
          + [_snap(1, 1, p99_ms=4500)] * 3
          + [_snap(1, 0, shed=5), _snap(1, 0, shed=10)]
          + [_snap(3, 40)] * 3 + [_snap(3, 0)] * 3)
CFG = dict(min_replicas=1, max_replicas=3, up_queue=8.0, up_p99_frac=0.8,
           up_shed=1, window=2, down_queue=0.0, cooldown=1)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


class TestAgainstJax:
    def test_scripted_signals_log_replays_to_equal_decisions(self, jax):
        from deeplearning4j_tpu.serving.autoscale import (
            FleetAutoscaler as JAuto,
        )
        from deeplearning4j_tpu.serving.autoscale import ScaleConfig as JCfg

        from deeplearning4j_tpu_torch.serving.autoscale import (
            FleetAutoscaler,
            ScaleConfig,
        )

        got = FleetAutoscaler.replay(SCRIPT, config=ScaleConfig(**CFG))
        want = JAuto.replay(SCRIPT, config=JCfg(**CFG))
        assert got == want
        actions = [d["action"] for d in got]
        assert actions.count("up") >= 2 and actions.count("down") >= 1
        for cfg in (dict(min_replicas=1, max_replicas=1, window=1,
                         cooldown=2), {}):
            assert FleetAutoscaler.replay(SCRIPT, config=ScaleConfig(
                **cfg)) == JAuto.replay(SCRIPT, config=JCfg(**cfg))

    def test_env_config_equal(self, jax, monkeypatch):
        from deeplearning4j_tpu.serving.autoscale import ScaleConfig as JCfg

        from deeplearning4j_tpu_torch.serving.autoscale import ScaleConfig

        monkeypatch.setenv("DL4J_TPU_SERVE_SCALE_MAX", "6")
        monkeypatch.setenv("DL4J_TPU_SERVE_SCALE_UP_P99_FRAC", "0.7")
        monkeypatch.setenv("DL4J_TPU_SERVE_SCALE_COOLDOWN", "junk")
        assert ScaleConfig.from_env() == ScaleConfig(**vars(
            JCfg.from_env()))

    def test_pack_models_plans_equal(self, jax):
        from deeplearning4j_tpu.serving.placement import (
            ModelFootprint as JFp,
        )
        from deeplearning4j_tpu.serving.placement import pack_models as jpack

        from deeplearning4j_tpu_torch.serving.placement import (
            ModelFootprint,
            pack_models,
        )

        gb = 2 ** 30
        spec = [("big", 6 * gb, 0, 0), ("mid", 3 * gb, gb, 0),
                ("small", gb, 0, 0), ("huge", 40 * gb, 0, 0),
                ("ann", gb // 2, 0, gb // 4), ("tie", gb, 0, 0)]
        for rids, hbm, copies in ((["r1", "r0"], 8.0, 1),
                                  (["r0", "r1", "r2"], 7.5, 2),
                                  (["a"], 80.0, 1)):
            got = pack_models([ModelFootprint(*s) for s in spec], rids,
                              hbm_gb=hbm, copies=copies)
            want = jpack([JFp(*s) for s in spec], rids, hbm_gb=hbm,
                         copies=copies)
            assert got.describe() == want.describe()
            assert got.unplaced == want.unplaced

    def test_model_footprint_bytes_equal(self, jax):
        from deeplearning4j_tpu.models.transformer import (
            TransformerConfig as JC,
        )
        from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
        from deeplearning4j_tpu.serving.placement import (
            model_footprint as jfp,
        )

        from deeplearning4j_tpu_torch.models import transformer as pt
        from deeplearning4j_tpu_torch.serving.placement import (
            model_footprint,
        )

        jlm = JLM(JC(**LM_KW))
        tree = jax.tree_util.tree_map(np.asarray, jlm.params)
        plm = pt.TransformerLM.from_state(
            pt.TransformerConfig(**LM_KW),
            pt.params_from_numpy(tree, device="cpu"), None, device="cpu")
        plm.opt  # noqa: B018 — JAX's LM holds Adam's state from the start
        for hbm in (0.25, 0.001, 16.0):
            assert model_footprint("lm", plm, hbm_gb=hbm, ann_bytes=7) \
                .describe() == jfp("lm", jlm, hbm_gb=hbm,
                                   ann_bytes=7).describe()
        from deeplearning4j_tpu.nn import conf as jconf
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

        import test_torch_mesh_spawn as ms
        from deeplearning4j_tpu_torch.nn import conf as pconf
        from deeplearning4j_tpu_torch.nn.multilayer import (
            MultiLayerNetwork as PNet,
        )

        jnet = MultiLayerNetwork(ms.mlp_conf(jconf, "nesterovs")).init()
        pnet = PNet(ms.mlp_conf(pconf, "nesterovs"), device="cpu").init()
        assert model_footprint("mlp", pnet).describe() == \
            jfp("mlp", jnet).describe()

    @pytest.mark.parametrize("devices", [1, 2, 3, 4])
    def test_kv_sizing_with_devices_equal(self, jax, devices):
        from deeplearning4j_tpu.models.transformer import (
            TransformerConfig as JC,
        )
        from deeplearning4j_tpu.ops import memory as jmem

        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig,
        )
        from deeplearning4j_tpu_torch.ops import memory as pmem

        kw = dict(LM_KW, n_heads=4)
        for bt in (4, 8, 16):
            assert pmem.kv_block_bytes(TransformerConfig(**kw), bt,
                                       devices=devices) == \
                jmem.kv_block_bytes(JC(**kw), bt, devices=devices)
            for hbm in (0.001, 0.5, 16.0):
                assert pmem.kv_arena_blocks(
                    TransformerConfig(**kw), bt, hbm_gb=hbm,
                    devices=devices) == jmem.kv_arena_blocks(
                        JC(**kw), bt, hbm_gb=hbm, devices=devices)

    def test_chaos_overlay_equal(self, jax):
        from deeplearning4j_tpu.resilience import AutoscaleChaos as JChaos
        from deeplearning4j_tpu.resilience import (
            AutoscaleChaosConfig as JCfg,
        )

        from deeplearning4j_tpu_torch.resilience import (
            AutoscaleChaos,
            AutoscaleChaosConfig,
        )

        plan = {"load_wave": {"at_tick": 1, "ticks": 2, "queue_depth": 40,
                              "sheds_per_tick": 3}}
        pc, jc = AutoscaleChaos(AutoscaleChaosConfig(**plan)), \
            JChaos(JCfg(**plan))
        base = {"ready_replicas": ["r0"], "queue_depth": 0, "shed_total": 2}
        outs = [pc.on_signals(t, dict(base)) for t in range(5)]
        assert outs == [jc.on_signals(t, dict(base)) for t in range(5)]
        assert [o["queue_depth"] for o in outs] == [0, 40, 40, 0, 0]
        assert [o["shed_total"] for o in outs[1:3]] == [5, 8]
        assert pc.log == jc.log
        with pytest.raises(ValueError):
            AutoscaleChaosConfig(load_wave={"ticks": 0, "queue_depth": 1})


# ---------------------------------------------------------------------------
# port contracts
# ---------------------------------------------------------------------------


class TestTenantQuotas:
    def test_burst_tenant_never_starves_the_other(self, net):
        from deeplearning4j_tpu_torch.serving.router import TenantQuotaError

        fleet = _fleet(net, 1, router_kwargs={
            "tenant_quotas": "a:0.001:3,b:1000:1000"})
        try:
            router = fleet.router
            a_shed = 0
            for _ in range(10):
                try:
                    router._admit({"tenant": "a"})
                    router._release()
                except TenantQuotaError as e:
                    a_shed += 1
                    assert e.retry_after_s > 0
            assert a_shed == 7
            for _ in range(20):
                router._admit({"tenant": "b"})
                router._release()
            snap = router.stats.snapshot()
            assert snap["tenant_admitted"] == {"a": 3, "b": 20}
            assert snap["tenant_shed"] == {"a": 7}
            assert snap["fleet_429"] == 0
        finally:
            fleet.stop()

    def test_http_shed_carries_retry_after(self, net):
        fleet = _fleet(net, 1, router_kwargs={"tenant_quotas": "a:0.5:1"})
        try:
            rows = [[0.1, 0.2, 0.3, 0.4]]
            assert _post_raw(fleet.url, "/predict",
                             {"batch": rows, "tenant": "a"})[0] == 200
            code, body, headers = _post_raw(
                fleet.url, "/predict", {"batch": rows, "tenant": "a"})
            assert code == 429
            assert int(headers.get("Retry-After")) >= 1
            assert "tenant" in json.loads(body)["error"]
            assert _post_raw(fleet.url, "/predict", {"batch": rows})[0] \
                == 200
        finally:
            fleet.stop()


class TestPlacementRouting:
    def test_affinity_routes_only_to_holders(self, net):
        from deeplearning4j_tpu_torch.serving.placement import PlacementPlan

        fleet = _fleet(net, 2)
        try:
            _wait_ready(fleet.router, 2)
            fleet.router.set_placement(PlacementPlan(
                budget_bytes=2 ** 30, assignments={"r0": ["default"],
                                                   "r1": []},
                used_bytes={"r0": 100, "r1": 0}))
            rows = [[0.1, 0.2, 0.3, 0.4]]
            for _ in range(6):
                assert _post_raw(fleet.url, "/predict",
                                 {"batch": rows, "model": "default"})[0] \
                    == 200
            engines = fleet.engines()
            assert engines["r0"].stats.snapshot()["requests"] == 6
            assert engines["r1"].stats.snapshot()["requests"] == 0
        finally:
            fleet.stop()

    def test_unplaced_model_is_a_loud_503(self, net):
        from deeplearning4j_tpu_torch.serving.placement import PlacementPlan
        from deeplearning4j_tpu_torch.serving.router import (
            ModelUnplacedError,
        )

        fleet = _fleet(net, 1)
        try:
            _wait_ready(fleet.router, 1)
            fleet.router.set_placement(PlacementPlan(
                budget_bytes=2 ** 30, assignments={"r0": []},
                used_bytes={"r0": 0}, unplaced=["default"]))
            with pytest.raises(ModelUnplacedError, match="default"):
                fleet.router._candidates(model="default")
            rows = [[0.1, 0.2, 0.3, 0.4]]
            code, body, _ = _post_raw(fleet.url, "/predict",
                                      {"batch": rows, "model": "default"})
            assert code == 503 and "default" in json.loads(body)["error"]
            assert fleet.router.stats.snapshot()["affinity_503"] >= 2
            assert _post_raw(fleet.url, "/predict", {"batch": rows})[0] \
                == 200
        finally:
            fleet.stop()

    def test_signals_placement_and_replicas_surfaces(self, net):
        from deeplearning4j_tpu_torch.serving.autoscale import (
            FleetAutoscaler,
            ScaleConfig,
        )
        from deeplearning4j_tpu_torch.serving.placement import (
            model_footprint,
        )

        fleet = _fleet(net, 2)
        try:
            _wait_ready(fleet.router, 2)
            code, sig = _get(fleet.url, "/signals")
            assert code == 200 and sig["ready_replicas"] == ["r0", "r1"]
            for entry in sig["replicas"].values():
                assert set(entry) >= {"ready", "role", "breaker",
                                      "queue_depth", "cordoned"}
            assert _get(fleet.url, "/placement") == (200,
                                                     {"placement": None})
            plan = FleetAutoscaler(fleet, config=ScaleConfig()) \
                .plan_placement([model_footprint("default", net)])
            assert _get(fleet.url, "/placement") == (
                200, {"placement": plan.describe()})
            code, reps = _get(fleet.url, "/replicas")
            assert code == 200
            for rid in ("r0", "r1"):
                hbm = reps[rid]["hbm"]
                assert hbm["used_bytes"] > 0
                assert hbm["models"]["default"]["param_bytes"] > 0
        finally:
            fleet.stop()


class TestGoodbyeOrdering:
    def test_addr_unlinked_before_deregister(self, tmp_path):
        from deeplearning4j_tpu_torch.serving.fleet import goodbye_replica
        from deeplearning4j_tpu_torch.serving.router import (
            publish_replica_addr,
            read_replica_addr,
        )

        root = str(tmp_path)
        publish_replica_addr(root, "rX", "http://127.0.0.1:1")
        order = []

        class Board:
            def deregister_worker(self, rid):
                order.append(("dereg", rid, read_replica_addr(root, "rX")))

        goodbye_replica(Board(), root, "rX")
        assert order == [("dereg", "rX", None)]

    def test_board_failure_still_removed_addr(self, tmp_path):
        from deeplearning4j_tpu_torch.serving.fleet import goodbye_replica
        from deeplearning4j_tpu_torch.serving.router import (
            publish_replica_addr,
            read_replica_addr,
        )

        root = str(tmp_path)
        publish_replica_addr(root, "rX", "http://127.0.0.1:1")

        class Board:
            def deregister_worker(self, rid):
                raise OSError("board transport died")

        with pytest.raises(OSError):
            goodbye_replica(Board(), root, "rX")
        assert read_replica_addr(root, "rX") is None


class TestScaleWave:
    def test_wave_up_then_down_under_predict_traffic(self, net):
        """A scripted load wave (``AutoscaleChaos``) scales 1 -> 2; quiet
        ticks then scale back to 1 through the drain + goodbye path,
        while 3 clients post /predict: no request fails, and the run's
        own signals log replays to its decisions (here and through the
        JAX autoscaler when it is installed)."""
        from deeplearning4j_tpu_torch.resilience import (
            AutoscaleChaos,
            AutoscaleChaosConfig,
        )
        from deeplearning4j_tpu_torch.serving.autoscale import (
            FleetAutoscaler,
            ScaleConfig,
        )
        from deeplearning4j_tpu_torch.serving.router import read_replica_addr

        cfg = ScaleConfig(min_replicas=1, max_replicas=2, up_queue=10.0,
                          up_shed=0, window=2, down_queue=0.5, cooldown=1)
        fleet = _fleet(net, 1)
        auto = FleetAutoscaler(fleet, config=cfg, chaos=AutoscaleChaos(
            AutoscaleChaosConfig(load_wave={"at_tick": 0, "ticks": 2,
                                            "queue_depth": 50})))
        failures, codes = [], []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    code = _post_raw(fleet.url, "/predict",
                                     {"batch": [[0.1, 0.2, 0.3, 0.4]]})[0]
                    codes.append(code)
                    if code != 200:
                        failures.append(code)
                except OSError as e:
                    failures.append(str(e))
                time.sleep(0.005)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        try:
            _wait_ready(fleet.router, 1)
            for t in threads:
                t.start()
            d0, d1 = auto.tick(), auto.tick()
            assert [d0["action"], d1["action"]] == ["hold", "up"]
            assert d1["enacted"] == "r1"
            _wait_ready(fleet.router, 2)
            down = None
            for _ in range(8):
                d = auto.tick()
                if d["action"] == "down":
                    down = d
                    break
            assert down is not None and down["enacted"] == "r1"
            assert read_replica_addr(fleet.fleet_dir, "r1") is None
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            fleet.stop()
        assert not failures, f"failed admitted requests: {failures[:5]}"
        assert len(codes) > 20
        assert _stripped(auto.decisions) == FleetAutoscaler.replay(
            auto.signals_log, config=cfg)
        snap = auto.stats.snapshot()
        assert snap["scale_ups"] == 1 and snap["scale_downs"] == 1
        assert snap["enact_failures"] == 0
        try:
            from deeplearning4j_tpu.serving.autoscale import (
                FleetAutoscaler as JAuto,
            )
            from deeplearning4j_tpu.serving.autoscale import (
                ScaleConfig as JCfg,
            )
        except ImportError:
            return
        assert _stripped(auto.decisions) == JAuto.replay(
            auto.signals_log, config=JCfg(**vars(cfg)))
