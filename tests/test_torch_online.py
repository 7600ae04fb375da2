"""The port's online plane on the CPU: ``ShadowPromoter``/``ShadowMirror``,
``ContinuousTrainer`` (``deeplearning4j_tpu_torch/online/``) and the
streaming front ends (``streaming/{pipeline,serving}.py``), held to JAX
``tests/test_online.py``'s contracts and to the JAX package.

Port contracts (JAX's (a), (b), (c), (d)): mirroring on leaves the
``/predict`` answers byte-identical; a promotion swap under 4 hammering
clients fails no request and every answer is the primary's or the
candidate's; an injected warmup failure never moves the default; a
refused gate (too little mirrored traffic) breaks the candidate; a
shadow that raises on every batch never votes the primary's breaker; a
drift alarm blocks promotion; a drain mid-shadow seals without promoting;
a ContinuousTrainer killed at step 6 and resumed from its stream offset
is bit-exact; an empty round moves nothing; a candidate zip is written
on the snapshot cadence.

Against the JAX package: the mirror's fraction stride picks the same
request indices as JAX's (fractions 1, 0.75, 0.5, 0.3); the
``ContinuousTrainer``'s rounds in f64 (SGD, no dropout) at 1e-10;
``StreamingTrainingPipeline`` in f32 at 1e-5; ``ModelServer`` answers
for one JAX-written zip at 1e-5 (the f32 layer bar).
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

_RNG = np.random.default_rng(0)
X = _RNG.standard_normal((96, 6)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[_RNG.integers(0, 3, 96)]


def conf(pkg, seed=7, updater="adam"):
    if pkg == "jax":
        from deeplearning4j_tpu.nn import conf as c
    else:
        from deeplearning4j_tpu_torch.nn import conf as c
    return (c.NeuralNetConfiguration.builder().seed(seed).learning_rate(0.05)
            .updater(updater).list()
            .layer(0, c.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(1, c.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .build())


def build_net(seed=7, updater="adam"):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(conf("port", seed, updater), device="cpu")


def serving_net(seed=7):
    net = build_net(seed).init()
    net.fit(X[:32], Y[:32])
    return net


def fitted_norm():
    from deeplearning4j_tpu_torch.etl.normalize import NormalizerStandardize

    return NormalizerStandardize().fit(X)


def push_all(src, upto=96, batch=8, x=X, y=Y, ds=None):
    if ds is None:
        from deeplearning4j_tpu_torch.datasets.iterator import DataSet as ds
    for i in range(0, upto, batch):
        src.push(ds(x[i:i + batch], y[i:i + batch]))


def flat(params):
    return {f"{i}.{k}": np.asarray(v.numpy() if torch.is_tensor(v) else v,
                                   np.float64)
            for i, p in enumerate(params) for k, v in p.items()}


def bit_equal(a, b):
    """Every leaf of two nests (params, or updater state) bit-equal."""
    from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def engine(**kw):
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model=serving_net(), input_shape=(6,),
                         max_batch=16, device="cpu", **kw)


@pytest.fixture()
def candidate_zip(tmp_path):
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    path = str(tmp_path / "candidate.zip")
    write_model(serving_net(11), path, normalizer=fitted_norm())
    return path


def promoter(eng, **kw):
    from deeplearning4j_tpu_torch.online import ShadowPromoter

    return ShadowPromoter(eng, **kw)


def stage(p, path, name="candidate"):
    return p.stage(name, model_path=path, input_shape=(6,), max_batch=16)


# ---------------------------------------------------------------------------
# shadow promotion (port)
# ---------------------------------------------------------------------------


class TestShadowPromotion:
    def test_mirroring_on_is_byte_invisible(self, candidate_zip):
        eng = engine()
        try:
            rows = [X[i:i + 8] for i in range(0, 64, 8)]
            before = [eng.predict(r) for r in rows]
            p = promoter(eng, min_mirrored=1, fraction=1.0)
            stage(p, candidate_zip)
            after = [eng.predict(r) for r in rows]
            for b, a in zip(before, after):
                assert b.tobytes() == a.tobytes()
            assert p.mirror.wait_idle()
            assert p.mirror.report()["mirrored"] == len(rows)
            p.abort("test teardown")
        finally:
            eng.stop(drain=False)

    def test_promotion_swap_zero_failed_requests(self, candidate_zip):
        eng = engine()
        try:
            p = promoter(eng, min_mirrored=2, fraction=1.0)
            rec = stage(p, candidate_zip)
            rows = X[:8]
            for _ in range(4):
                eng.predict(rows)
            assert p.mirror.wait_idle()
            want_primary = eng.predict(rows)
            want_cand = rec.model.output(
                rec.normalizer.transform_array(rows)).numpy()
            stop = threading.Event()
            failures, answers = [], []

            def hammer():
                while not stop.is_set():
                    try:
                        answers.append(eng.predict(rows))
                    except Exception as e:  # noqa: BLE001 — the contract
                        failures.append(e)

            with ThreadPoolExecutor(4) as ex:
                futs = [ex.submit(hammer) for _ in range(4)]
                time.sleep(0.05)
                report = p.promote()
                time.sleep(0.05)
                stop.set()
                for f in futs:
                    f.result(timeout=30)
            assert report["ok"] and report["promoted"] == rec.key
            assert not failures
            assert answers and all(np.array_equal(o, want_primary)
                                   or np.array_equal(o, want_cand)
                                   for o in answers)
            np.testing.assert_array_equal(eng.predict(rows), want_cand)
            assert eng.registry.default().key == rec.key
            assert eng._shadow is None
            assert eng.registry.rollback_target() == ("default", 1)
        finally:
            eng.stop(drain=False)

    def test_injected_warmup_failure_never_moves_default(self,
                                                         candidate_zip):
        from deeplearning4j_tpu_torch.resilience import (
            InjectedServingFault,
            ServingChaos,
            ServingChaosConfig,
        )

        eng = engine(chaos=ServingChaos(ServingChaosConfig(
            warmup_fail_name="candidate")))
        try:
            with pytest.raises(InjectedServingFault):
                stage(promoter(eng, min_mirrored=1), candidate_zip)
            assert eng.registry.default().key == "default@v1"
            assert eng.registry.get("candidate").state == "broken"
            assert eng._shadow is None
            assert eng.predict(X[:8]).shape == (8, 3)
        finally:
            eng.stop(drain=False)

    def test_refused_gate_breaks_the_candidate(self, candidate_zip):
        from deeplearning4j_tpu_torch.online import PromotionRefused

        eng = engine()
        try:
            p = promoter(eng, min_mirrored=1000)
            rec = stage(p, candidate_zip)
            eng.predict(X[:8])
            with pytest.raises(PromotionRefused) as ei:
                p.promote()
            assert any("min_mirrored" in f for f in ei.value.report["failed"])
            assert eng.registry.default().key == "default@v1"
            assert eng.registry.get(rec.name, rec.version).state == "broken"
            assert p.online_stats.snapshot()["promotion_refusals"] == 1
        finally:
            eng.stop(drain=False)

    def test_shadow_errors_never_vote_the_breaker(self, candidate_zip):
        from deeplearning4j_tpu_torch.online import PromotionRefused

        eng = engine()
        try:
            p = promoter(eng, min_mirrored=1)
            rec = stage(p, candidate_zip)

            class Exploding:
                def output(self, x):
                    raise RuntimeError("shadow boom")

            rec.model = Exploding()
            for _ in range(4):
                assert eng.predict(X[:8]).shape == (8, 3)
            assert p.mirror.wait_idle()
            assert p.online_stats.snapshot()["mirror_errors"] >= 1
            assert eng.stats.snapshot()["breaker_opens"] == 0
            assert eng._breakers["default@v1"].state == "serving"
            with pytest.raises(PromotionRefused) as ei:
                p.promote()
            assert any("mirror_errors" in f
                       for f in ei.value.report["failed"])
            assert eng.registry.default().key == "default@v1"
        finally:
            eng.stop(drain=False)

    def test_drift_alarm_blocks_promotion(self, candidate_zip):
        from deeplearning4j_tpu_torch.online import (
            DriftMonitor,
            PromotionRefused,
        )

        eng = engine()
        try:
            mon = DriftMonitor(fitted_norm(), min_rows=16, z_threshold=3.0)
            mon.observe(X[:32] + 50.0)
            assert mon.check()["verdict"] == "alarm"
            p = promoter(eng, drift=mon, min_mirrored=1)
            rec = stage(p, candidate_zip)
            eng.predict(X[:8])
            assert p.mirror.wait_idle()
            with pytest.raises(PromotionRefused) as ei:
                p.promote()
            assert "drift_alarm" in ei.value.report["failed"]
            assert eng.registry.default().key == "default@v1"
            assert eng.registry.get(rec.name, rec.version).state == "broken"
        finally:
            eng.stop(drain=False)

    def test_drain_mid_shadow_seals_without_promoting(self, candidate_zip):
        from deeplearning4j_tpu_torch.serving.resilience import DrainingError

        eng = engine()
        try:
            p = promoter(eng, min_mirrored=1, fraction=1.0)
            rec = stage(p, candidate_zip)
            eng.predict(X[:8])
            assert p.mirror.wait_idle()
            assert eng.drain(timeout_s=10.0)
            with pytest.raises(DrainingError):
                p.promote()
            assert eng.registry.default().key == "default@v1"
            assert eng.registry.get(rec.name, rec.version).state == "warm"
            assert eng._shadow is None
        finally:
            eng.stop(drain=False)


# ---------------------------------------------------------------------------
# ContinuousTrainer (port)
# ---------------------------------------------------------------------------


def trainer(net, src, **kw):
    from deeplearning4j_tpu_torch.online import ContinuousTrainer

    return ContinuousTrainer(net, src, workers=1, shard=None,
                             handle_signals=False, device="cpu", **kw)


def source(**kw):
    from deeplearning4j_tpu_torch.online import StreamSource

    return StreamSource(**kw)


class TestContinuousTrainer:
    def _run(self, manager, *, chaos=None):
        src = source(watermark=64, idle_s=0.1)
        push_all(src)
        ct = trainer(build_net(), src, manager=manager, chaos=chaos)
        ct.fit_round()
        return ct

    def test_kill_at_a_stream_offset_and_resume_bit_exact(self, tmp_path):
        from deeplearning4j_tpu_torch.resilience import (
            ChaosConfig,
            ChaosMonkey,
            CheckpointManager,
            InjectedKill,
        )

        baseline = self._run(None)
        assert baseline.step == 12
        mgr = CheckpointManager(str(tmp_path), every_steps=4, keep_last=3)
        with pytest.raises(InjectedKill):
            self._run(mgr, chaos=ChaosMonkey(ChaosConfig(kill_at_step=6)))
        mgr.close()
        mgr2 = CheckpointManager(str(tmp_path), every_steps=4, keep_last=3)
        resumed = self._run(mgr2)
        mgr2.close()
        assert resumed.resilient.resumed_step == 4
        assert resumed.step == baseline.step
        assert bit_equal(baseline.net.params, resumed.net.params)
        assert bit_equal(baseline.net.updater_state,
                         resumed.net.updater_state)
        assert baseline.losses[:4] + resumed.losses == baseline.losses

    def test_empty_round_moves_nothing_and_snapshots_on_cadence(
            self, tmp_path):
        from deeplearning4j_tpu_torch.online import DriftMonitor
        from deeplearning4j_tpu_torch.resilience import CheckpointManager
        from deeplearning4j_tpu_torch.utils.serialization import restore

        mgr = CheckpointManager(str(tmp_path / "ck"), every_steps=4,
                                keep_last=3)
        src = source(watermark=64, idle_s=0.05)
        mon = DriftMonitor(fitted_norm(), min_rows=16)
        cand = str(tmp_path / "cand.zip")
        ct = trainer(build_net(), src, manager=mgr, drift=mon,
                     candidate_path=cand, snapshot_rounds=2,
                     normalizer=fitted_norm())
        push_all(src, upto=32)
        assert len(ct.fit_round()) == 4
        assert ct.fit_round() == []
        assert ct.rounds_done == 1
        assert ct.snapshot()["snapshots"] == 0
        push_all(src, upto=32)
        assert len(ct.fit_round()) == 4
        assert ct.step == 8 and ct.snapshot()["snapshots"] == 1
        assert mon.check()["rows"] == 64
        net = restore(cand, device="cpu")
        assert bit_equal(net.params, ct.net.params)
        mgr.close()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


class _Rec:
    """A record the mirror reshapes nothing for; output() logs its rows."""

    def __init__(self):
        self.input_shape = None
        self.normalizer = None
        self.model = self
        self.seen = []

    def output(self, x):
        self.seen.append(int(np.asarray(x).reshape(-1)[0]))
        return np.zeros((1, 1), np.float32)


@pytest.mark.parametrize("fraction", [1.0, 0.75, 0.5, 0.3])
def test_mirror_stride_picks_jax_indices(jax, fraction):
    from deeplearning4j_tpu.online.promote import ShadowMirror as JMirror

    from deeplearning4j_tpu_torch.online.promote import ShadowMirror

    picked = []
    for cls in (ShadowMirror, JMirror):
        rec = _Rec()
        m = cls(rec, fraction=fraction)
        try:
            for i in range(20):
                m.offer(np.asarray([[float(i)]], np.float32),
                        np.zeros((1, 1), np.float32))
            assert m.wait_idle()
        finally:
            m.close()
        picked.append(rec.seen)
    assert picked[0] == picked[1] and picked[0]


def _f64_pair(updater="sgd"):
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    pnet = build_net(updater=updater).init()
    init = [{k: v.double().numpy() for k, v in p.items()}
            for p in pnet.params]
    pnet.params = [{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                   for p in init]
    pnet.updater_state = pnet.updater.init(pnet.params)
    jnet = JNet(conf("jax", updater=updater)).init()
    jnet.params = [{k: jnp.asarray(v) for k, v in p.items()} for p in init]
    jnet.updater_state = jnet.updater.init(jnet.params)
    return pnet, jnet


def test_continuous_trainer_rounds_match_jax_f64(jax):
    from deeplearning4j_tpu.datasets.iterator import DataSet as JDS
    from deeplearning4j_tpu.online import ContinuousTrainer as JCT
    from deeplearning4j_tpu.online import StreamSource as JSrc

    pnet, jnet = _f64_pair("sgd")
    x64, y64 = X.astype(np.float64), Y.astype(np.float64)
    psrc, jsrc = source(watermark=64, idle_s=0.05), JSrc(watermark=64,
                                                         idle_s=0.05)
    pct = trainer(pnet, psrc)
    jct = JCT(jnet, jsrc, workers=1, shard=None, handle_signals=False)
    for r in range(3):
        sl = slice(32 * r, 32 * (r + 1))
        push_all(psrc, upto=32, x=x64[sl], y=y64[sl])
        push_all(jsrc, upto=32, x=x64[sl], y=y64[sl], ds=JDS)
        pl, jl = pct.fit_round(), jct.fit_round()
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-10)
    assert pct.step == jct.step == 12
    got = flat(pnet.params)
    want = {f"{i}.{k}": np.asarray(v, np.float64)
            for i, p in enumerate(jnet.params) for k, v in p.items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10,
                                   err_msg=k)


def test_streaming_pipeline_matches_jax(jax):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.streaming import (
        StreamingTrainingPipeline as JPipe,
    )

    from deeplearning4j_tpu_torch.streaming import (
        StreamingTrainingPipeline,
        encode_record_base64,
        record_to_array,
    )

    import jax.numpy as jnp

    pnet = build_net(updater="sgd").init()
    jnet = JNet(conf("jax", updater="sgd")).init()
    jnet.params = [{k: jnp.asarray(v.numpy().copy()) for k, v in p.items()}
                   for p in pnet.params]
    jnet.updater_state = jnet.updater.init(jnet.params)
    labels = Y.argmax(1)
    losses = []
    for pipe in (StreamingTrainingPipeline(pnet, 3, batch_size=8),
                 JPipe(jnet, 3, batch_size=8)):
        pipe.start()
        for i in range(40):
            pipe.publish([str(v) for v in X[i]], int(labels[i]))
        deadline = time.monotonic() + 30
        while pipe.batches_fit < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        pipe.stop()
        assert pipe.batches_fit == 5 and pipe.error is None
        losses.append(pipe.losses)
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=1e-5)
    for i, p in enumerate(jnet.params):
        for k, v in p.items():
            np.testing.assert_allclose(pnet.params[i][k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5)
    assert record_to_array(["1", 2.5]).dtype == np.float32
    assert len(encode_record_base64([1.0, 2.0])) == 12


def test_model_server_matches_jax(jax, tmp_path):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.streaming import ModelServer as JServer
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    from deeplearning4j_tpu_torch.streaming import (
        ModelServer,
        encode_record_base64,
    )

    jnet = JNet(conf("jax", updater="sgd")).init()
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(jnet, path)
    with pytest.raises(ValueError):
        ModelServer(device="cpu")
    outs = []
    for srv in (ModelServer(model_path=path, input_shape=(6,),
                            device="cpu"),
                JServer(model_path=path, input_shape=(6,))):
        srv.start()
        try:
            got = []
            for payload in ({"record": X[0].tolist()},
                            {"record_base64": encode_record_base64(X[1])},
                            {"batch": X[2:6].tolist()}):
                req = urllib.request.Request(
                    srv.url + "/predict", data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    body = json.loads(r.read())
                got.append(np.asarray(body.get("output",
                                               body.get("outputs"))))
            outs.append(got)
        finally:
            srv.stop()
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
