"""The port's ``POST /predict`` path end to end on the CPU: a char-RNN zip
written by the JAX package, served by the port's ``ServingEngine``.

  * Port against port: ``record`` and ``batch`` payloads equal direct
    ``output`` on the same rows; the dynamic batcher equals the locked
    direct path (``DL4J_TPU_SERVE_BATCH=0``) within 1e-6 under concurrent
    clients; 429 at queue capacity, 504 past a deadline, 400 on malformed
    rows, on a ``record_base64`` that is not float32 bytes and on
    ``/generate`` to a MultiLayerNetwork; the registry's load -> warmup ->
    serve; ``/metrics`` carries the batch fill and K1's launch counts;
    drain answers 503.
  * Port against JAX: one answer of the port's engine against the JAX
    engine's answer on the same zip and rows, at 1e-5.
  * The batcher alone: the shape guard fails a malformed request alone,
    pad accounting follows the bucket ladder, stop fails what is queued.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX reference side

from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_scan as port_lstm  # noqa: E402
from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: E402
    DynamicBatcher,
    QueueFullError,
    RequestTimeoutError,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.registry import (  # noqa: E402
    ModelRegistry,
    bucket_ladder,
)

VOCAB, HIDDEN, T = 12, 16, 10


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    from deeplearning4j_tpu.models.char_rnn import char_rnn_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.utils.serialization import ModelSerializer

    jnet = JNet(char_rnn_conf(VOCAB, lstm_size=HIDDEN, num_layers=2,
                              seed=11)).init(input_shape=(1, VOCAB))
    path = str(tmp_path_factory.mktemp("predict") / "char_rnn.zip")
    ModelSerializer.write_model(jnet, path)
    return path


@pytest.fixture(scope="module")
def net(zip_path):
    return MultiLayerNetwork.load(zip_path, device="cpu")


@pytest.fixture(scope="module")
def engine(net):
    eng = ServingEngine(model=net, device="cpu", max_wait_ms=5).start()
    yield eng
    eng.stop()


def _rows(seed, k, t=T):
    rng = np.random.default_rng(seed)
    return np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (k, t))]


def _post(url, payload, path="/predict", timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _error(url, payload, path="/predict"):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload, path)
    return e.value.code, json.loads(e.value.read())["error"]


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


class TestPredictPortAgainstPort:
    def test_record_and_batch_payloads_equal_direct_output(self, engine,
                                                           net):
        x = _rows(0, 3)
        code, body = _post(engine.url, {"record": x[0].tolist()})
        assert code == 200
        ref = net.output(x[:1]).numpy()[0]
        assert np.abs(np.asarray(body["output"]) - ref).max() < 1e-6
        code, body = _post(engine.url, {"batch": x.tolist(),
                                        "model": "default", "version": 1,
                                        "timeout_s": 30})
        assert code == 200
        out = np.asarray(body["outputs"])
        assert out.shape == (3, T, VOCAB)
        assert np.abs(out - net.output(x).numpy()).max() < 1e-6

    def test_batcher_equals_direct_under_concurrent_clients(
            self, net, monkeypatch):
        reqs = [_rows(10 + i, 1 + i % 3) for i in range(16)]

        def serve(batched):
            monkeypatch.setenv("DL4J_TPU_SERVE_BATCH",
                               "" if batched else "0")
            eng = ServingEngine(model=net, device="cpu",
                                max_wait_ms=20).start()
            try:
                assert eng.batching_enabled == batched
                with ThreadPoolExecutor(8) as ex:
                    answers = list(ex.map(
                        lambda x: _post(eng.url, {"batch": x.tolist()}),
                        reqs))
                return ([np.asarray(b["outputs"]) for _, b in answers],
                        eng.stats.snapshot())
            finally:
                eng.stop()

        batched, stats = serve(True)
        direct, direct_stats = serve(False)
        for a, b, x in zip(batched, direct, reqs):
            assert a.shape == (x.shape[0], T, VOCAB)
            assert np.abs(a - b).max() < 1e-6
        assert stats["batched_rows"] == sum(x.shape[0] for x in reqs)
        assert stats["batches"] < len(reqs)  # requests were coalesced
        assert direct_stats["batches"] == 0

    def test_malformed_rows_answer_400(self, engine):
        x = _rows(1, 1)
        for payload, needle in (
                ({"record": x[0, :, :5].tolist()}, "features"),
                ({"batch": [1.0, 2.0]}, "rank 2"),
                ({"record": [[1.0, 2.0], [3.0]]}, "ValueError"),
                ({"rows": x.tolist()}, "need record|record_base64|batch"),
                ({"record_base64": "AAAA"}, "multiple of float32"),
                ({"record": x[0].tolist(), "model": "nope"}, "nope")):
            code, err = _error(engine.url, payload)
            assert code == 400 and needle in err, (payload.keys(), err)
        code, err = _error(engine.url, {"tokens": [[1, 2]], "n_new": 2},
                           path="/generate")
        assert code == 400 and "needs a TransformerLM" in err

    def test_metrics_and_health(self, engine):
        _post(engine.url, {"record": _rows(2, 1)[0].tolist()})
        m = _get(engine.url, "/metrics")
        s = m["serving"]
        assert s["completed"] >= 1 and s["batches"] >= 1
        assert s["batched_rows"] >= 1 and 0 < s["batch_fill_ratio"] <= 1
        assert set(m["kernels"]) == {"lstm_scan"}
        # T = 10 >= 8, tanh, no mask: every layer went through the K1
        # wrapper, which runs the plain version on the CPU
        assert m["kernels"]["lstm_scan"]["plain_launches"] > 0
        assert m["kernels"]["lstm_scan"]["launches"] == 0
        assert "decode" not in m
        assert [r["state"] for r in m["models"]] == ["serving"]
        h = _get(engine.url, "/health")
        assert h["ok"] and h["model"] == "MultiLayerNetwork"
        assert h["device"] == "cpu"

    def test_queue_capacity_429_and_deadline_504(self, net):
        """With the batcher's worker held inside the model call and a queue
        capacity of one row: a queued request fills the queue, the next is
        refused (429), and a request whose deadline passes in the queue is
        answered 504; everything admitted is answered."""
        entered, release = threading.Event(), threading.Event()

        class Held:
            _input_shape = net._input_shape
            device = net.device

            def output(self, x):
                entered.set()
                release.wait(60)
                return net.output(x)

        eng = ServingEngine(model=net, device="cpu", queue_capacity=1,
                            max_wait_ms=1).start()
        eng.registry.get().model = Held()
        x = _rows(3, 1)
        try:
            with ThreadPoolExecutor(3) as ex:
                first = ex.submit(_post, eng.url, {"record": x[0].tolist()})
                assert entered.wait(60)
                queued = ex.submit(_post, eng.url,
                                   {"record": x[0].tolist()})
                for _ in range(200):
                    if eng.stats.snapshot()["queue_depth"] == 1:
                        break
                    threading.Event().wait(0.01)
                code, err = _error(eng.url, {"record": x[0].tolist()})
                assert code == 429 and "QueueFull" in err
                release.set()
                assert first.result(60)[0] == 200
                assert queued.result(60)[0] == 200
            release.clear()
            entered.clear()
            with ThreadPoolExecutor(2) as ex:
                first = ex.submit(_post, eng.url, {"record": x[0].tolist()})
                assert entered.wait(60)
                code, err = _error(eng.url, {"record": x[0].tolist(),
                                             "timeout_s": 0.05})
                assert code == 504 and "Timeout" in err
                release.set()
                assert first.result(60)[0] == 200
            assert eng.stats.snapshot()["rejected_429"] == 1
            assert eng.stats.snapshot()["timeouts"] == 1
        finally:
            release.set()
            eng.stop()

    def test_registry_load_warmup_serve(self, zip_path, net):
        reg = ModelRegistry(device="cpu")
        rec = reg.load("char", model_path=zip_path)
        assert rec.version == 1 and rec.state == "loaded"
        assert reg.default() is None
        with pytest.raises(ValueError, match="needs input_shape"):
            reg.warmup("char")
        before = port_lstm.lstm_scan_plain.launches
        rep = reg.warmup("char", max_batch=8,
                         sample_row=np.zeros((T, VOCAB), np.float32))
        assert rep["buckets"] == bucket_ladder(8) == [1, 2, 3, 4, 6, 8]
        # two LSTM layers per bucket size, each through the K1 wrapper
        assert port_lstm.lstm_scan_plain.launches - before == 12
        assert reg.serve("char") is rec and rec.state == "serving"
        rec2 = reg.load("char", model=net, input_shape=(T, VOCAB))
        assert rec2.version == 2 and reg.get("char") is rec
        reg.warmup("char", 2, max_batch=2)
        reg.serve("char", 2)
        assert (rec.state, rec2.state) == ("warm", "serving")
        assert reg.get() is rec2
        assert [d["version"] for d in reg.describe()] == [1, 2]

    def test_failed_warmup_lands_broken_and_is_not_served(self, net):
        reg = ModelRegistry(device="cpu")
        rec = reg.load("bad", model=net, input_shape=(T, VOCAB + 1))
        with pytest.raises(RuntimeError):
            reg.warmup("bad", max_batch=2)
        assert rec.state == "broken" and rec.error
        with pytest.raises(ValueError, match="refusing to serve"):
            reg.serve("bad")

    def test_engine_from_a_zip_and_drain(self, zip_path, net):
        eng = ServingEngine(model_path=zip_path, device="cpu").start()
        try:
            x = _rows(4, 2)
            code, body = _post(eng.url, {"batch": x.tolist()})
            assert code == 200
            assert np.abs(np.asarray(body["outputs"])
                          - net.output(x).numpy()).max() < 1e-6
            assert eng.drain(5.0)
            code, _ = _error(eng.url, {"record": x[0].tolist()})
            assert code == 503
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(eng.url, "/health")
            assert e.value.code == 503
        finally:
            eng.stop()


def test_one_answer_against_the_jax_engine(zip_path, engine):
    from deeplearning4j_tpu.serving.engine import (
        ServingEngine as JaxServingEngine,
    )

    x = _rows(5, 4)
    jeng = JaxServingEngine(model_path=zip_path)
    try:
        ref = np.asarray(jeng.predict(x))
    finally:
        jeng.stop()
    code, body = _post(engine.url, {"batch": x.tolist()})
    assert code == 200
    assert np.abs(np.asarray(body["outputs"]) - ref).max() < 1e-5


class TestBatcherAlone:
    def test_shape_guard_fails_the_malformed_request_alone(self):
        def infer(batch):
            if batch.shape[1] != 3:
                raise ValueError("bad width")
            return batch * 2

        b = DynamicBatcher(infer, max_batch=8, max_wait_ms=50)
        try:
            good = b.submit(np.ones((2, 3), np.float32))
            bad = b.submit(np.ones((1, 4), np.float32))
            good2 = b.submit(np.ones((1, 3), np.float32))
            np.testing.assert_array_equal(good.result(10), np.full((2, 3), 2))
            with pytest.raises(ValueError, match="bad width"):
                bad.result(10)
            np.testing.assert_array_equal(good2.result(10),
                                          np.full((1, 3), 2))
        finally:
            b.stop()

    @pytest.mark.parametrize("rows,padded", [(1, 0), (3, 0), (5, 1),
                                             (7, 1), (9, 3)])
    def test_pad_accounting_follows_the_bucket_ladder(self, rows, padded):
        b = DynamicBatcher(lambda x: x, max_batch=16, max_wait_ms=1)
        try:
            b.predict(np.zeros((rows, 2), np.float32), timeout_s=10)
            s = b.stats.snapshot()
            assert (s["batches"], s["batched_rows"], s["padded_rows"]) == \
                (1, rows, padded)
        finally:
            b.stop()

    def test_stop_fails_queued_requests_and_refuses_new_ones(self):
        release = threading.Event()
        b = DynamicBatcher(lambda x: (release.wait(10), x)[1], max_batch=1,
                           max_wait_ms=1)
        first = b.submit(np.zeros((1, 2)))
        queued = b.submit(np.zeros((1, 2)))
        threading.Timer(0.2, release.set).start()
        b.stop(timeout_s=0.05)
        with pytest.raises(RuntimeError, match="stopped"):
            queued.result(10)
        with pytest.raises(RuntimeError, match="stopped"):
            b.submit(np.zeros((1, 2)))
        release.set()
        first.exception(10)

    def test_queue_full_and_expired_requests(self):
        release = threading.Event()
        b = DynamicBatcher(lambda x: (release.wait(10), x)[1], max_batch=1,
                           max_wait_ms=1, queue_capacity=2)
        try:
            held = b.submit(np.zeros((1, 2)))
            for _ in range(200):
                if b._inflight is not None:
                    break
                threading.Event().wait(0.01)
            doomed = b.submit(np.zeros((2, 2)), timeout_s=0.01)
            with pytest.raises(QueueFullError):
                b.submit(np.zeros((1, 2)))
            threading.Event().wait(0.05)
            release.set()
            held.result(10)
            with pytest.raises(RequestTimeoutError):
                doomed.result(10)
            assert b.stats.snapshot()["timeouts"] == 1
        finally:
            release.set()
            b.stop()
