"""The port's paged ``/generate`` path, end to end on the CPU.

  * JAX against port: the JAX ``PagedDecoder`` and the port's
    ``PagedDecoder(device="cpu")`` serve the same mixed-length greedy
    batch — with a shared prompt prefix and a preemption forced by a
    small arena — and their transcripts are equal. Where they differ, the
    JAX top-2 logit margin at that position must be below 1e-4 (a tie
    that f32 summation order may break either way); the rest of that
    transcript is not compared.
  * Port against port: HTTP ``/generate`` equals the in-process answer,
    streaming equals non-streaming, a sampled request gives the same
    tokens solo and co-scheduled, and a preempted sampled request resumes
    its own stream.
  * Serving surface: top_k/top_p answer 400, ``/metrics`` carries each
    kernel's launch counts, ``/health``, 429 backpressure, SLO classes.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder  # noqa: E402

CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)
TIE = 1e-4


@pytest.fixture(scope="module")
def pair():
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    jlm = TransformerLM(TransformerConfig(**CFG_KW, seed=5))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=5),
                           device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


@pytest.fixture(scope="module")
def lm():
    return pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=1),
                            device="cpu")


def _batch():
    rng = np.random.default_rng(4)
    shared = rng.integers(1, 64, 20).tolist()   # one full 16-token block
    return [
        (shared + [7], 30),
        (shared + [9, 3, 5], 30),
        (rng.integers(1, 64, 5).tolist(), 40),
        (rng.integers(1, 64, 50).tolist(), 20),
    ]


def _serve(decoder_cls, lm, batch, **kw):
    d = decoder_cls(lm, block_tokens=16, n_blocks=10, **kw)
    try:
        futs = [d.submit(p, n, temperature=0.0) for p, n in batch]
        outs = [np.asarray(f.result(timeout=300)) for f in futs]
        return outs, d.stats
    finally:
        d.stop()


class TestTranscriptsAgainstJax:
    def test_greedy_batch_with_prefix_sharing_and_preemption(self, pair):
        from deeplearning4j_tpu.models.transformer import forward
        from deeplearning4j_tpu.serving.paged import (
            PagedDecoder as JaxPagedDecoder,
        )

        jlm, plm = pair
        batch = _batch()
        j_outs, j_stats = _serve(JaxPagedDecoder, jlm, batch)
        p_outs, p_stats = _serve(PagedDecoder, plm, batch, device="cpu")
        assert p_stats.preemptions >= 1 and j_stats.preemptions >= 1
        assert p_stats.prefix_hits >= 1
        compared = 0
        for (prompt, n_new), jt, ptk in zip(batch, j_outs, p_outs):
            assert len(ptk) == n_new
            diff = np.nonzero(jt != ptk)[0]
            if diff.size == 0:
                compared += 1
                continue
            j = int(diff[0])
            keep = min(len(prompt), CFG_KW["max_len"] - n_new)
            ctx = np.asarray(prompt[len(prompt) - keep:] + jt[:j].tolist(),
                             np.int32)[None]
            logits = np.asarray(forward(jlm.params, jnp.asarray(ctx),
                                        jlm.cfg)[0])[0, -1]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TIE, (
                f"transcripts split at token {j} with a JAX margin of "
                f"{top2[1] - top2[0]:.3g}: not a tie")
        assert compared >= 3


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def engine(lm):
    eng = ServingEngine(lm, kv_block=16, kv_blocks=64, device="cpu").start()
    yield eng
    eng.stop()


class TestEnginePortAgainstPort:
    def test_http_equals_in_process(self, engine):
        prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
        direct = engine.generate(prompt, 12, temperature=0.0)
        code, body = _post(engine.url, {"tokens": prompt, "n_new": 12,
                                        "temperature": 0.0})
        assert code == 200
        assert json.loads(body)["tokens"] == direct.tolist()
        code, body = _post(engine.url, {"tokens": prompt, "n_new": 12,
                                        "temperature": 0.8, "seed": 4})
        assert json.loads(body)["tokens"] == engine.generate(
            prompt, 12, temperature=0.8, seed=4).tolist()

    def test_stream_equals_non_stream(self, engine):
        prompt = list(range(1, 30))
        want = engine.generate([prompt], 15, temperature=0.8, seed=2)[0]
        code, body = _post(engine.url, {"tokens": [prompt], "n_new": 15,
                                        "temperature": 0.8, "seed": 2,
                                        "stream": True})
        lines = [json.loads(x) for x in body.strip().splitlines()]
        assert code == 200
        assert [x["token"] for x in lines[:-1]] == want.tolist()
        assert lines[-1] == {"done": True, "tokens": want.tolist()}
        assert list(engine.generate_stream(prompt, 15, temperature=0.8,
                                           seed=2)) == want.tolist()

    def test_sampled_solo_equals_coscheduled(self, engine):
        d = engine.decoder
        p = [5, 4, 3, 2, 1, 9]
        solo = d.submit(p, 20, temperature=0.8, seed=9).result(timeout=120)
        futs = [d.submit(list(range(2, 2 + k)), 18, temperature=0.8,
                         seed=k) for k in (3, 17, 40)]
        mid = d.submit(p, 20, temperature=0.8, seed=9)
        futs += [d.submit([1] * 70, 25, temperature=0.0)]
        np.testing.assert_array_equal(solo, mid.result(timeout=120))
        for f in futs:
            f.result(timeout=120)
        assert d.peak_active >= 2

    def test_preempted_sampled_request_resumes_its_stream(self, lm):
        """Three long sampled requests on an arena that cannot hold them
        together: preemption fires, and each transcript equals the one it
        gets alone on a roomy arena."""
        reqs = [([2, 4, 6], 60, 1), ([1, 1, 1, 1], 60, 2),
                ([9, 8, 7], 60, 3)]
        roomy = PagedDecoder(lm, block_tokens=16, n_blocks=40, device="cpu")
        try:
            alone = [roomy.submit(p, n, temperature=0.9, seed=s)
                     .result(timeout=120) for p, n, s in reqs]
        finally:
            roomy.stop()
        tight = PagedDecoder(lm, block_tokens=16, n_blocks=10, device="cpu")
        try:
            futs = [tight.submit(p, n, temperature=0.9, seed=s)
                    for p, n, s in reqs]
            got = [f.result(timeout=120) for f in futs]
            assert tight.stats.preemptions >= 1
        finally:
            tight.stop()
        for a, b in zip(alone, got):
            np.testing.assert_array_equal(a, b)


class TestEngineSurface:
    def test_top_k_top_p_answer_400(self, engine):
        for extra in ({"top_k": 5}, {"top_p": 0.9},
                      {"top_k": 5, "stream": True}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(engine.url, {"tokens": [[1, 2]], "n_new": 3, **extra})
            assert e.value.code == 400
            assert "not ported yet" in json.loads(e.value.read())["error"]

    def test_metrics_and_health(self, engine):
        engine.generate([[1, 2, 3]], 4, temperature=0.0)
        m = _get(engine.url, "/metrics")
        assert m["serving"]["completed"] >= 1
        assert m["serving"]["generated_tokens"] >= 4
        assert m["decode"]["block_tokens"] == 16
        k = m["kernels"]
        assert set(k) == {"flash_attention", "paged_attention"}
        # on the CPU every attention call is the plain version's
        assert k["paged_attention"]["plain_launches"] > 0
        assert k["flash_attention"]["plain_launches"] > 0
        h = _get(engine.url, "/health")
        assert h["ok"] and h["model"] == "TransformerLM"
        assert h["device"] == "cpu"

    def test_queue_cap_sheds_and_answers_429(self, lm):
        """With the decode thread held inside a streaming callback and a
        queue cap of 1: a second lowest-class request is refused (429), a
        higher-class one sheds the queued lowest-class one, an unknown
        class is a 400, and everything admitted is answered."""
        import threading

        from deeplearning4j_tpu_torch.serving.batcher import QueueFullError

        eng = ServingEngine(lm, kv_block=16, kv_blocks=16, device="cpu",
                            queue_capacity=1,
                            slo_classes="interactive:30,batch:60").start()
        d = eng.decoder
        entered, release = threading.Event(), threading.Event()

        def hold(_tok):
            entered.set()
            release.wait(60)

        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(eng.url, {"tokens": [[1]], "n_new": 2, "slo": "nope"})
            assert e.value.code == 400
            first = d.submit([1, 2], 3, temperature=0.0, on_token=hold)
            assert entered.wait(60)
            queued = d.submit([5, 6], 3, temperature=0.0, slo="batch")
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(eng.url, {"tokens": [[3]], "n_new": 2,
                                "slo": "batch"})
            assert e.value.code == 429
            urgent = d.submit([4], 2, temperature=0.0, slo="interactive")
            with pytest.raises(QueueFullError, match="shed"):
                queued.result(timeout=60)
            assert eng.stats.shed_by_class == {"batch": 2}
            release.set()
            assert len(first.result(timeout=60)) == 3
            assert len(urgent.result(timeout=60)) == 2
        finally:
            release.set()
            eng.stop()

    def test_fixed_slot_pool_is_not_ported(self, lm):
        with pytest.raises(ValueError, match="not ported"):
            ServingEngine(lm, kv_block=0, device="cpu")


class TestFailureIsolation:
    def test_crashed_admission_fails_only_its_own_request(self, lm,
                                                          monkeypatch):
        """An admission whose prefill raises fails its own future and
        returns its blocks; a co-resident's tokens are unchanged."""
        from deeplearning4j_tpu_torch.serving import paged

        d = PagedDecoder(lm, block_tokens=16, n_blocks=16, device="cpu")
        try:
            ok = [1, 2, 3, 4, 5, 6]
            solo = d.submit(ok, 10, temperature=0.0).result(timeout=120)
            real = paged.paged_admit

            def admit(params, arena, window, write_table, cfg):
                if window.shape[1] == 24:  # the 20-token prompt's bucket
                    raise RuntimeError("injected prefill fault")
                return real(params, arena, window, write_table, cfg)

            monkeypatch.setattr(paged, "paged_admit", admit)
            bad = d.submit(list(range(1, 21)), 10, temperature=0.0)
            good = d.submit(ok, 10, temperature=0.0)
            with pytest.raises(RuntimeError, match="injected"):
                bad.result(timeout=120)
            np.testing.assert_array_equal(good.result(timeout=120), solo)
            assert d.stats.slot_crashes == 1
            assert d.stats.kv_blocks_in_use == 0
        finally:
            d.stop()

    def test_tick_failure_fails_active_lanes_and_keeps_serving(
            self, lm, monkeypatch):
        from deeplearning4j_tpu_torch.serving import paged

        d = PagedDecoder(lm, block_tokens=16, n_blocks=16, device="cpu")
        try:
            real, calls = paged.paged_decode_step, []

            def step(*a, **k):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("injected tick fault")
                return real(*a, **k)

            monkeypatch.setattr(paged, "paged_decode_step", step)
            with pytest.raises(RuntimeError, match="injected"):
                d.submit([3, 4, 5], 6, temperature=0.0).result(timeout=120)
            out = d.submit([3, 4, 5], 6, temperature=0.0).result(timeout=120)
            assert len(out) == 6 and d._dead is None
        finally:
            d.stop()

    def test_drain_closes_admission_with_503(self, lm):
        eng = ServingEngine(lm, kv_block=16, kv_blocks=16,
                            device="cpu").start()
        try:
            assert eng.drain(5.0)
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(eng.url, {"tokens": [[1, 2]], "n_new": 2})
            assert e.value.code == 503
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(eng.url, "/health")
            assert e.value.code == 503
        finally:
            eng.stop()
