"""The port's fixed-slot pool and k-step ticks on the CPU.

  * JAX against port (f32, the same seeded weights carried through
    ``params_from_numpy``): ``decode_step_slots`` logits and cache within
    1e-4 abs over several steps from prefilled slots; ``ContinuousDecoder``
    greedy transcripts equal, except after a position where the JAX top-2
    logit margin is below 1e-4 (a tie f32 summation order may break either
    way; the rest of that transcript is not compared).
  * Port against port, byte-equal: the fixed-slot k = 4 tick against
    k = 1 on a mixed greedy/sampled pool; the paged k = 4 tick against
    k = 1 with prefix sharing, under preemption and with a crashed
    admission beside a live lane; the tokens-per-dispatch ledger; the
    paged pool against the fixed-slot pool (the same attention arithmetic
    on the CPU: ``slot_attention`` is ``paged_attention_plain``'s).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX reference side
jnp = pytest.importorskip("jax.numpy")

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size  # noqa: E402
from deeplearning4j_tpu_torch.serving import decode as pdec  # noqa: E402
from deeplearning4j_tpu_torch.serving import paged as ppaged  # noqa: E402
from deeplearning4j_tpu_torch.serving.decode import (  # noqa: E402
    ContinuousDecoder,
)
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder  # noqa: E402

CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)
BT = 8
TOL = 1e-4
TIE = 1e-4


@pytest.fixture(scope="module")
def pair():
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    jlm = TransformerLM(TransformerConfig(**CFG_KW, seed=7))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=7),
                           device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


@pytest.fixture(scope="module")
def lm():
    return pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=3),
                            device="cpu")


def _prompts(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, n).tolist() for n in (5, 19, 33)]


def gated(cls):
    """``cls`` with its worker held until ``release()``: every request of
    a run is queued before the first admission, so two runs follow the
    same schedule (where preemption falls depends on it)."""
    class Gated(cls):
        def _start_worker(self):
            self.release = super()._start_worker

    return Gated


def run_pool(dec, prompts, n_new=12, temps=(0.0, 0.0, 0.0), seed=11,
             stream=True):
    """Submit the prompts at once (streaming callbacks on the paged pool;
    a gated decoder's worker starts after the last submit); returns
    (transcripts, streamed tokens per request)."""
    streams = [[] for _ in prompts]
    try:
        futs = []
        for i, (p, t) in enumerate(zip(prompts, temps)):
            kw = {"on_token": streams[i].append} if stream else {}
            futs.append(dec.submit(p, n_new, temperature=t, seed=seed, **kw))
        if hasattr(dec, "release"):
            dec.release()
        outs = [f.result(timeout=240).tolist() for f in futs]
    finally:
        dec.stop()
    return outs, streams


def _tie_rule(jlm, prompts, n_new, j_outs, p_outs):
    """Transcripts equal, or split after a JAX top-2 margin below TIE;
    returns how many were equal."""
    from deeplearning4j_tpu.models.transformer import forward

    equal = 0
    for prompt, jt, ptk in zip(prompts, j_outs, p_outs):
        jt, ptk = np.asarray(jt), np.asarray(ptk)
        assert len(ptk) == n_new
        diff = np.nonzero(jt != ptk)[0]
        if diff.size == 0:
            equal += 1
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
    return equal


class TestFixedSlotAgainstJax:
    def test_decode_step_slots_logits_and_cache(self, pair):
        """Slots prefilled from prompts of three lengths, then four
        steps at per-slot positions: logits and the whole cache within
        1e-4 of JAX's."""
        from deeplearning4j_tpu.serving import decode as jdec

        jlm, plm = pair
        cfg = plm.cfg
        prompts = _prompts()
        s, hd = len(prompts), cfg.d_model // cfg.n_heads
        shape = (cfg.n_layers, s, cfg.max_len, cfg.n_heads, hd)
        jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
        pcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        tok = np.zeros((s,), np.int32)
        pos = np.zeros((s,), np.int32)
        with torch.inference_mode():
            for i, p in enumerate(prompts):
                width = bucket_size(len(p))
                buf = np.zeros((1, width), np.int32)
                buf[0, :len(p)] = p
                jcache = jdec._admit_for(jlm._run_cfg, width)(
                    jlm.params, jcache, jnp.asarray(buf),
                    jnp.asarray(i, jnp.int32))
                pdec.slot_admit(plm.compute_params, pcache,
                                torch.from_numpy(buf), i, cfg)
                tok[i], pos[i] = p[-1], len(p) - 1
            for step in range(4):
                jcache, jl = jdec.decode_step_slots(
                    jlm.params, jcache, jnp.asarray(tok), jnp.asarray(pos),
                    jlm._run_cfg)
                _, pl_ = pdec.decode_step_slots(
                    plm.compute_params, pcache, torch.from_numpy(tok),
                    torch.from_numpy(pos), cfg)
                jl = np.asarray(jl)
                np.testing.assert_allclose(pl_.numpy(), jl, rtol=0,
                                           atol=TOL, err_msg=f"step {step}")
                tok = jl.argmax(-1).astype(np.int32)
                pos = pos + 1
        for name in ("k", "v"):
            np.testing.assert_allclose(pcache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=0,
                                       atol=TOL)

    def test_continuous_decoder_greedy_transcripts(self, pair):
        from deeplearning4j_tpu.serving.decode import (
            ContinuousDecoder as JaxContinuousDecoder,
        )

        jlm, plm = pair
        prompts = _prompts(5)
        j_outs, _ = run_pool(JaxContinuousDecoder(jlm, slots=2), prompts,
                             n_new=16, stream=False)
        p_outs, _ = run_pool(ContinuousDecoder(plm, slots=2, device="cpu"),
                             prompts, n_new=16, stream=False)
        assert _tie_rule(jlm, prompts, 16, j_outs, p_outs) >= 2


class TestFixedSlotFailureIsolation:
    def test_crashed_admission_and_failed_tick(self, lm, monkeypatch):
        """A crashed admission fails only its own request (a co-resident
        keeps its solo tokens); a failed tick fails the active slots and
        the pool keeps serving."""
        ok = [1, 5, 2, 9]
        d = ContinuousDecoder(lm, slots=2, device="cpu")
        try:
            solo = d.submit(ok, 10, temperature=0.0).result(timeout=120)
            real_admit = pdec.slot_admit

            def admit(params, cache, window, slot, cfg):
                if window.shape[1] == 24:  # the 20-token prompt's bucket
                    raise RuntimeError("injected prefill fault")
                return real_admit(params, cache, window, slot, cfg)

            monkeypatch.setattr(pdec, "slot_admit", admit)
            good = d.submit(ok, 10, temperature=0.0)
            bad = d.submit(list(range(1, 21)), 6, temperature=0.0)
            with pytest.raises(RuntimeError, match="injected"):
                bad.result(timeout=60)
            np.testing.assert_array_equal(good.result(timeout=120), solo)
            assert d.stats.slot_crashes == 1
            real_step, calls = pdec.decode_step_slots, []

            def step(*a, **k):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("injected tick fault")
                return real_step(*a, **k)

            monkeypatch.setattr(pdec, "decode_step_slots", step)
            with pytest.raises(RuntimeError, match="injected tick"):
                d.submit(ok, 6, temperature=0.0).result(timeout=120)
            again = d.submit(ok, 10, temperature=0.0).result(timeout=120)
            np.testing.assert_array_equal(again, solo)
            assert d._dead is None and d.kv_capacity()["tokens_in_use"] == 0
        finally:
            d.stop()


class TestAdmissionHoldsItsPrefixHits:
    def test_reclaim_never_frees_a_hit_of_the_same_admission(self, lm,
                                                             monkeypatch):
        """A request whose prefix hits are the cache's only evictable
        entries, admitted when the free list is one block short: funding
        that block must not evict (and hand back out) one of its own hits.
        Every admitted lane's table holds distinct blocks."""
        tables = []
        real = PagedDecoder._admit_prefill

        def spy(self, i, buf, width, write_table):
            tables.append(self._tables[i].copy())
            return real(self, i, buf, width, write_table)

        monkeypatch.setattr(PagedDecoder, "_admit_prefill", spy)
        rng = np.random.default_rng(4)
        a = rng.integers(1, 64, 33).tolist()     # 4 full blocks + 1
        b = rng.integers(1, 64, 100).tolist()    # 13 blocks
        d = gated(PagedDecoder)(lm, lanes=2, block_tokens=BT, n_blocks=17,
                                device="cpu")
        try:
            first = d.submit(a, 1, temperature=0.0)
            long_ = d.submit(b, 20, temperature=0.0)
            again = d.submit(a, 1, temperature=0.0)
            d.release()
            assert again.result(timeout=120).tolist() == \
                first.result(timeout=120).tolist()
            long_.result(timeout=120)
        finally:
            d.stop()
        assert d.stats.prefix_hits >= 3
        for row in tables:
            used = row[row > 0].tolist()
            assert len(used) == len(set(used)), row


class TestTickIdentity:
    def test_fixed_slot_k_tick(self, lm):
        """tick_k=4 == tick_k=1 byte for byte on a mixed greedy/sampled
        pool, in fewer ticks, with the same tokens."""
        prompts = _prompts()
        d1 = ContinuousDecoder(lm, slots=3, tick_k=1, device="cpu")
        o1, _ = run_pool(d1, prompts, temps=(0.0, 0.8, 0.0), stream=False)
        dk = ContinuousDecoder(lm, slots=3, tick_k=4, device="cpu")
        ok, _ = run_pool(dk, prompts, temps=(0.0, 0.8, 0.0), stream=False)
        assert o1 == ok
        assert dk.dispatch_stats.decode_ticks < \
            d1.dispatch_stats.decode_ticks
        assert dk.dispatch_stats.decode_tokens == \
            d1.dispatch_stats.decode_tokens == 3 * 12

    def test_paged_k_tick_with_prefix_sharing(self, lm):
        shared = list(range(2, 20))  # two full 8-token blocks and more
        results = []
        for k in (1, 4):
            d = PagedDecoder(lm, block_tokens=BT, n_blocks=40, tick_k=k,
                             device="cpu")
            try:
                f1 = d.submit(shared + [7], 9, temperature=0.0)
                f2 = d.submit(shared + [9], 9, temperature=0.8, seed=4)
                results.append((f1.result(timeout=120).tolist(),
                                f2.result(timeout=120).tolist(),
                                d.stats.prefix_hits > 0))
            finally:
                d.stop()
        assert results[0] == results[1]
        assert results[0][2]  # the share registered

    def test_paged_k_tick_under_preemption(self, lm):
        """An arena of 17 blocks cannot hold three ~70-token sequences:
        growth preempts, at k=4 as at k=1, and the sampled transcripts
        (and the streams' order) stay byte-equal."""
        rng = np.random.default_rng(9)
        prompts = [rng.integers(1, 64, 40).tolist() for _ in range(3)]
        outs, preempted = {}, {}
        for k in (1, 4):
            d = gated(PagedDecoder)(lm, lanes=3, block_tokens=BT,
                                    n_blocks=17, tick_k=k, device="cpu")
            outs[k] = run_pool(d, prompts, n_new=30, temps=(0.7,) * 3,
                               seed=3)
            preempted[k] = d.stats.preemptions
        assert outs[1] == outs[4]
        assert preempted[4] > 0

    def test_paged_k_tick_crash_eviction(self, lm, monkeypatch):
        """A crashed admission under k=4 fails only its own request; the
        co-resident's tokens equal its solo run."""
        ok = [1, 5, 2, 9]
        d0 = PagedDecoder(lm, block_tokens=BT, n_blocks=40, tick_k=4,
                          device="cpu")
        try:
            solo = d0.generate(np.asarray([ok]), 10, temperature=0.0)[0]
        finally:
            d0.stop()
        real = ppaged.paged_admit

        def admit(params, arena, window, write_table, cfg):
            if window.shape[1] == 24:  # the 20-token prompt's bucket
                raise RuntimeError("injected prefill fault")
            return real(params, arena, window, write_table, cfg)

        monkeypatch.setattr(ppaged, "paged_admit", admit)
        d = PagedDecoder(lm, block_tokens=BT, n_blocks=40, tick_k=4,
                         device="cpu")
        try:
            good = d.submit(ok, 10, temperature=0.0)
            bad = d.submit(list(range(1, 21)), 6, temperature=0.0)
            with pytest.raises(RuntimeError, match="injected"):
                bad.result(timeout=60)
            np.testing.assert_array_equal(good.result(timeout=120), solo)
            assert d.stats.slot_crashes == 1
        finally:
            d.stop()

    def test_tokens_per_dispatch_ledger(self, lm):
        d = PagedDecoder(lm, block_tokens=BT, n_blocks=40, tick_k=4,
                         device="cpu")
        try:
            d.generate(np.asarray([[1, 5, 2, 9]]), 9, temperature=0.0)
            snap = d.dispatch_stats.snapshot()
        finally:
            d.stop()
        assert snap["decode_tokens"] == 9
        # 2 ticks of 4 steps, then one of 1 (a lane 1 token from its end)
        assert snap["decode_ticks"] == 3
        assert snap["tokens_per_dispatch"] == pytest.approx(3.0)

    def test_paged_equals_fixed_slot_greedy(self, lm):
        """Both pools, the same lane count: greedy tokens byte-equal (the
        paged tick's gather and the fixed slots' stripes feed the same
        f32 einsums)."""
        prompts = _prompts(8)
        paged, _ = run_pool(PagedDecoder(lm, lanes=3, block_tokens=BT,
                                         n_blocks=40, device="cpu"),
                            prompts, n_new=20, stream=False)
        fixed, _ = run_pool(ContinuousDecoder(lm, slots=3, device="cpu"),
                            prompts, n_new=20, stream=False)
        assert paged == fixed
