"""The port's speculative decode, self-drafts, KV-dtype arena and
prefill/decode handoff on the CPU.

  * Port against port, byte-equal: speculative greedy == target-only
    greedy (transcripts and stream order) for the int8 and ``layers:1``
    drafts, through a chaos-forced all-reject round, with a sampled pool
    falling back to the base tick, and under preemption; primed ==
    unprimed through ``/prefill`` and ``/prime``.
  * JAX against port: ``draft_lm("int8")``'s block weights bit-equal to
    the JAX draft's on the same weights (round half to even on both);
    the ``layers:1`` draft's logits within 1e-4; a bf16 arena's paged
    tick under an f32 model against the JAX gather path within 2e-2 on
    the logits (the bf16 bar), with ``kv_capacity`` and
    ``kv_block_bytes`` equal; ``export_prefix`` digests equal and blocks
    within 1e-4 (f32); the wire format both ways in f32 and bf16 (a JAX
    ``/prefill`` payload adopted by the port's ``/prime`` and the other
    way round), a dtype that does not match the arena answering 400.
  * Draft validation, the acceptance arithmetic, ``spec_mode`` parsing,
    ``draft_net`` cached per mode, the engine's decoder choice.
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
from deeplearning4j_tpu_torch.ops import lowprec  # noqa: E402
from deeplearning4j_tpu_torch.ops import memory as pmem  # noqa: E402
from deeplearning4j_tpu_torch.resilience import (  # noqa: E402
    SpecChaos,
    SpecChaosConfig,
)
from deeplearning4j_tpu_torch.serving import paged as ppaged  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder  # noqa: E402
from deeplearning4j_tpu_torch.serving.speculate import (  # noqa: E402
    SpeculativeDecoder,
)

CFG_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_len=128)
BT = 8
TOL = 1e-4
TOL_BF16 = 2e-2


@pytest.fixture(scope="module")
def pair():
    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    jlm = TransformerLM(TransformerConfig(**CFG_KW, seed=11))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=11),
                           device="cpu",
                           params=pt.params_from_numpy(tree, device="cpu"))
    return jlm, plm


@pytest.fixture(scope="module")
def lm():
    return pt.TransformerLM(pt.TransformerConfig(**CFG_KW, seed=4),
                            device="cpu")


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13], [6, 7, 8, 9]]


def gated(cls):
    """``cls`` with its worker held until ``release()``: every request of
    a run is queued before the first admission, so two runs follow the
    same schedule (where preemption falls depends on it)."""
    class Gated(cls):
        def _start_worker(self):
            self.release = super()._start_worker

    return Gated


def run_pool(dec, n_new=14, temps=(0.0, 0.0, 0.0), seed=11, prompts=PROMPTS):
    streams = [[] for _ in prompts]
    try:
        futs = [dec.submit(p, n_new, temperature=t, seed=seed,
                           on_token=streams[i].append)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        if hasattr(dec, "release"):
            dec.release()
        outs = [f.result(timeout=240).tolist() for f in futs]
    finally:
        dec.stop()
    return outs, streams


def spec_decoder(lm, mode="int8", **kw):
    kw.setdefault("lanes", 3)
    kw.setdefault("block_tokens", 4)
    kw.setdefault("n_blocks", 96)
    draft = lowprec.draft_lm(lm, mode, device="cpu")
    return gated(SpeculativeDecoder)(lm, draft=draft, spec_k=3,
                                     device="cpu", **kw)


def base_decoder(lm, **kw):
    kw.setdefault("lanes", 3)
    kw.setdefault("block_tokens", 4)
    kw.setdefault("n_blocks", 96)
    return gated(PagedDecoder)(lm, device="cpu", **kw)


class TestSpeculative:
    def test_spec_equals_target_greedy(self, lm):
        base = run_pool(base_decoder(lm))
        for mode in ("int8", "layers:1"):
            d = spec_decoder(lm, mode)
            assert run_pool(d) == base, mode
            assert d.spec_rounds > 0
            snap = d.stats.snapshot()
            assert snap["draft_proposed"] > 0
            assert 0.0 <= snap["acceptance_rate"] <= 1.0
            ds = d.dispatch_stats.snapshot()
            assert ds["decode_tokens"] == 3 * 14

    def test_chaos_all_reject_round_stays_byte_exact(self, lm):
        base = run_pool(base_decoder(lm))
        chaos = SpecChaos(SpecChaosConfig(reject_at_round=0, count=2))
        d = spec_decoder(lm, spec_chaos=chaos)
        assert run_pool(d) == base
        assert chaos.log and chaos.log[0] == (0, "reject_all")
        assert d.stats.draft_rejected > 0
        assert d.stats.snapshot()["acceptance_rate"] < 1.0

    def test_sampled_pool_falls_back_to_base_tick(self, lm):
        temps = (0.8, 0.8, 0.8)
        base = run_pool(base_decoder(lm), temps=temps)
        d = spec_decoder(lm)
        assert run_pool(d, temps=temps) == base
        assert d.spec_rounds == 0

    def test_spec_under_preemption(self, lm):
        """An arena of 17 blocks of 8 cannot hold three ~60-token
        sequences: growth preempts under the spec decoder as under the
        base pool, greedy byte-equal."""
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, 64, 36).tolist() for _ in range(3)]
        base = run_pool(base_decoder(lm, block_tokens=8, n_blocks=17),
                        n_new=24, prompts=prompts)
        d = spec_decoder(lm, block_tokens=8, n_blocks=17)
        assert run_pool(d, n_new=24, prompts=prompts) == base
        assert d.stats.preemptions > 0
        assert d.spec_rounds > 0

    def test_draft_validation(self, lm):
        other = pt.TransformerLM(pt.TransformerConfig(
            **dict(CFG_KW, vocab_size=31)), device="cpu")
        with pytest.raises(ValueError):
            SpeculativeDecoder(lm, draft=other, block_tokens=8,
                               n_blocks=17, device="cpu")
        with pytest.raises(ValueError):
            SpeculativeDecoder(lm, draft=None, block_tokens=8, n_blocks=17,
                               device="cpu")

    def test_acceptance_ledger_arithmetic(self):
        from deeplearning4j_tpu_torch.serving.telemetry import ServingStats

        st = ServingStats()
        st.record_draft(3, 3)
        st.record_draft(3, 0)
        snap = st.snapshot()
        assert snap["draft_proposed"] == 6
        assert snap["draft_accepted"] == 3
        assert snap["draft_rejected"] == 3
        assert snap["acceptance_rate"] == pytest.approx(0.5)


class TestDrafts:
    def test_draft_lm_modes(self, lm):
        d8 = lowprec.draft_lm(lm, "int8", device="cpu")
        assert d8.draft_mode == "int8" and d8.cfg == lm.cfg
        assert not torch.equal(d8.params["blocks"]["Wq"],
                               lm.params["blocks"]["Wq"])
        assert d8.params["blocks"]["ln1_g"] is lm.params["blocks"]["ln1_g"]
        assert d8._opt is None  # no optimizer state
        dl = lowprec.draft_lm(lm, "layers:1", device="cpu")
        assert dl.cfg.n_layers == 1
        assert dl.compute_params["blocks"]["Wq"].shape[0] == 1
        with pytest.raises(ValueError):
            lowprec.draft_lm(lm, "layers:9", device="cpu")
        with pytest.raises(ValueError):
            lowprec.draft_lm(lm, "bogus", device="cpu")

    def test_int8_draft_weights_bit_equal_to_jax(self, pair):
        from deeplearning4j_tpu.ops import lowprec as jlowprec

        jlm, plm = pair
        jd = jlowprec.draft_lm(jlm, "int8")
        pd = lowprec.draft_lm(plm, "int8", device="cpu")
        for k in lowprec._DRAFT_WEIGHT_KEYS:
            np.testing.assert_array_equal(
                pd.params["blocks"][k].numpy(),
                np.asarray(jd.params["blocks"][k]), err_msg=k)
        w = np.array(jlm.params["blocks"]["W1"][0])
        jq, js = jlowprec.quantize_weight(w)
        pq, ps = lowprec.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))

    def test_layers_draft_logits_against_jax(self, pair):
        from deeplearning4j_tpu.models.transformer import forward
        from deeplearning4j_tpu.ops import lowprec as jlowprec

        jlm, plm = pair
        jd = jlowprec.draft_lm(jlm, "layers:1")
        pd = lowprec.draft_lm(plm, "layers:1", device="cpu")
        toks = np.random.default_rng(0).integers(0, 64, (2, 24)) \
            .astype(np.int32)
        jl = np.asarray(forward(jd.params, jnp.asarray(toks),
                                jd._run_cfg)[0])
        pl_ = pd.logits(toks).numpy()
        np.testing.assert_allclose(pl_, jl, rtol=0, atol=TOL)

    def test_precision_of_and_kv_dtype_against_jax(self, monkeypatch):
        from deeplearning4j_tpu.models.transformer import TransformerConfig
        from deeplearning4j_tpu.ops import lowprec as jlowprec

        for policy in ("strict", "performance"):
            kw = dict(CFG_KW, dtype_policy=policy)
            jcfg, pcfg = TransformerConfig(**kw), pt.TransformerConfig(**kw)
            plm = pt.TransformerLM(pcfg, device="cpu")

            class JaxModel:  # precision_of reads .cfg only
                cfg = jcfg

            assert lowprec.precision_of(plm) == \
                jlowprec.precision_of(JaxModel()), policy
            for kv in ("", "bf16", "f32"):
                monkeypatch.setenv("DL4J_TPU_SERVE_KV_DTYPE", kv)
                assert str(lowprec.kv_dtype(pcfg)).replace("torch.", "") \
                    == np.dtype(jlowprec.kv_dtype(jcfg)).name, (policy, kv)

    def test_spec_mode_parsing(self, monkeypatch):
        monkeypatch.delenv("DL4J_TPU_SERVE_SPEC", raising=False)
        assert lowprec.spec_mode() == ""
        for raw, want in (("0", ""), ("1", "int8"), ("int8", "int8"),
                          ("layers:2", "layers:2"), (" Layers ", "layers")):
            monkeypatch.setenv("DL4J_TPU_SERVE_SPEC", raw)
            assert lowprec.spec_mode() == want, raw

    def test_record_draft_net_cached(self, lm):
        from deeplearning4j_tpu_torch.serving.registry import ModelRecord

        rec = ModelRecord("m", 1, lm)
        d1 = rec.draft_net("int8")
        assert d1 is rec.draft_net("int8")
        assert d1 is not rec.draft_net("layers:1")


class TestKvDtypeArena:
    def test_bf16_arena_tick_against_jax_gather(self, pair, monkeypatch):
        """DL4J_TPU_SERVE_KV_DTYPE=bf16 under an f32 model: admission
        prefills and four ticks into a bf16 arena, logits within 2e-2 of
        the JAX gather path; the arena's pricing and report equal."""
        from deeplearning4j_tpu.ops import memory as jmem
        from deeplearning4j_tpu.serving import paged as jpaged

        monkeypatch.setenv("DL4J_TPU_SERVE_KV_DTYPE", "bf16")
        jlm, plm = pair
        cfg, jcfg = plm.cfg, jlm._run_cfg
        assert lowprec.kv_dtype(cfg) == torch.bfloat16
        assert pmem.kv_block_bytes(cfg, BT) == jmem.kv_block_bytes(jcfg, BT)
        assert pmem.kv_block_bytes(cfg, BT) * 2 == \
            pmem.kv_block_bytes(cfg, BT, dtype=torch.float32)
        gb = 0.01
        assert pmem.kv_arena_blocks(cfg, BT, budget_bytes=gb * 2**30,
                                    params=plm.params) == \
            jmem.kv_arena_blocks(jcfg, BT, params=jlm.params, hbm_gb=gb)
        jd = jpaged.PagedDecoder(jlm, block_tokens=BT, n_blocks=40, lanes=3)
        pd = PagedDecoder(plm, block_tokens=BT, n_blocks=40, lanes=3,
                          device="cpu")
        try:
            assert pd.kv_capacity() == jd.kv_capacity()
            assert pd.kv_capacity()["kv_dtype"] == "bfloat16"
        finally:
            jd.stop()
            pd.stop()
        m = cfg.max_len // BT
        hd = cfg.d_model // cfg.n_heads
        shape = (cfg.n_layers, 41, BT, cfg.n_heads, hd)
        jar = {"k": jnp.zeros(shape, jnp.bfloat16),
               "v": jnp.zeros(shape, jnp.bfloat16)}
        par = {"k": torch.zeros(shape, dtype=torch.bfloat16),
               "v": torch.zeros(shape, dtype=torch.bfloat16)}
        prompts = [[3, 1, 4, 1, 5], list(range(1, 20)), [9] * 11]
        tables = np.zeros((3, m), np.int32)
        tok = np.zeros((3,), np.int32)
        pos = np.zeros((3,), np.int32)
        nxt_block = 1
        with torch.inference_mode():
            for i, p in enumerate(prompts):
                nb = (len(p) - 1 + 4) // BT + 1   # room for four ticks
                tables[i, :nb] = range(nxt_block, nxt_block + nb)
                nxt_block += nb
                width = len(p)
                buf = np.asarray([p], np.int32)
                jar = jpaged._paged_admit_for(jcfg, width, BT)(
                    jlm.params, jar, jnp.asarray(buf),
                    jnp.asarray(tables[i]))
                ppaged.paged_admit(plm.compute_params, par,
                                   torch.from_numpy(buf),
                                   torch.from_numpy(tables[i]), cfg)
                tok[i], pos[i] = p[-1], len(p) - 1
            for step in range(4):
                jar, jl = jpaged.paged_decode_step(
                    jlm.params, jar, jnp.asarray(tok), jnp.asarray(pos),
                    jnp.asarray(tables), jcfg, attention="gather")
                _, pl_ = ppaged.paged_decode_step(
                    plm.compute_params, par, torch.from_numpy(tok),
                    torch.from_numpy(pos), torch.from_numpy(tables), cfg)
                jl = np.asarray(jl)
                np.testing.assert_allclose(pl_.numpy(), jl, rtol=0,
                                           atol=TOL_BF16,
                                           err_msg=f"step {step}")
                tok = jl.argmax(-1).astype(np.int32)
                pos = pos + 1


def _post(url, path, payload, timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


HANDOFF_PROMPT = list(range(3, 40))  # 37 tokens: 4 full blocks of 8


class TestHandoff:
    def test_export_prefix_against_jax(self, pair):
        from deeplearning4j_tpu.serving.paged import (
            PagedDecoder as JaxPagedDecoder,
        )

        jlm, plm = pair
        jd = JaxPagedDecoder(jlm, block_tokens=BT, n_blocks=40)
        pd = PagedDecoder(plm, block_tokens=BT, n_blocks=40, device="cpu")
        try:
            jdig, jk, jv = jd.export_prefix(HANDOFF_PROMPT, 10)
            pdig, pk, pv = pd.export_prefix(HANDOFF_PROMPT, 10)
            assert pd.export_prefix([1, 2, 3], 5)[0] == []
        finally:
            jd.stop()
            pd.stop()
        assert pdig == jdig and len(pdig) == 4
        assert tuple(pk.shape) == jk.shape
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                                   atol=TOL)

    @pytest.mark.parametrize("kv", ["", "bf16"])
    def test_wire_format_both_ways(self, pair, monkeypatch, kv):
        """A JAX /prefill payload adopted by the port's /prime, and a
        port /prefill payload by the JAX /prime (raw f32 or bf16 words,
        the same digests); the port's primed answer equals its unprimed
        one."""
        from deeplearning4j_tpu.serving import ServingEngine as JaxEngine

        monkeypatch.setenv("DL4J_TPU_SERVE_KV_DTYPE", kv)
        jlm, plm = pair
        req = {"tokens": HANDOFF_PROMPT, "n_new": 10}
        gen = dict(req, temperature=0.0)
        jeng = JaxEngine(model=jlm, kv_block=BT, kv_blocks=40).start()
        cold = ServingEngine(plm, kv_block=BT, kv_blocks=40,
                             device="cpu").start()
        warm = ServingEngine(plm, kv_block=BT, kv_blocks=40,
                             device="cpu").start()
        try:
            jpay = _post(jeng.url, "/prefill", req)
            ppay = _post(cold.url, "/prefill", req)
            want = "bfloat16" if kv else "float32"
            assert jpay["dtype"] == ppay["dtype"] == want
            assert jpay["shape"] == ppay["shape"] == [2, 4, BT, 4, 16]
            assert jpay["digests"] == ppay["digests"]
            assert _post(warm.url, "/prime", jpay)["adopted"] == 4
            assert warm.stats.prefix_import_blocks == 4
            primed = _post(warm.url, "/generate", gen)["tokens"]
            assert warm.stats.prefix_hits == 4
            unprimed = _post(cold.url, "/generate", gen)["tokens"]
            assert primed == unprimed
            # the other way: the port's payload into the JAX engine
            assert _post(jeng.url, "/prime", ppay)["adopted"] == 4
            assert _post(warm.url, "/prime", ppay)["adopted"] == 0
        finally:
            jeng.stop()
            cold.stop()
            warm.stop()

    def test_primed_equals_unprimed_and_dtype_mismatch_400(self, lm,
                                                          monkeypatch):
        prompt = list(range(5, 60))
        gen = {"tokens": prompt, "n_new": 12, "temperature": 0.0}
        pre = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                            device="cpu").start()
        dec = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                            device="cpu").start()
        ref = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                            device="cpu").start()
        monkeypatch.setenv("DL4J_TPU_SERVE_KV_DTYPE", "bf16")
        bf = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                           device="cpu").start()
        try:
            pay = _post(pre.url, "/prefill", {"tokens": prompt,
                                              "n_new": 12})
            adopted = _post(dec.url, "/prime", pay)["adopted"]
            assert adopted == 6
            assert dec.stats.prefix_import_blocks == adopted
            primed = _post(dec.url, "/generate", gen)["tokens"]
            assert dec.stats.prefix_hits == adopted
            assert primed == _post(ref.url, "/generate", gen)["tokens"]
            assert pre.stats.prefix_exports == 1
            m = _get(dec.url, "/metrics")["serving"]
            assert m["prefix_imports"] == 1
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(bf.url, "/prime", pay)
            assert e.value.code == 400
            assert "dtype" in json.loads(e.value.read())["error"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(dec.url, "/prime", dict(pay, dtype="float16"))
            assert e.value.code == 400
        finally:
            for eng in (pre, dec, ref, bf):
                eng.stop()


class TestEngineWiring:
    def test_engine_builds_spec_decoder_and_stays_byte_exact(
            self, lm, monkeypatch):
        prompts = np.asarray([[1, 5, 2, 9]])
        monkeypatch.delenv("DL4J_TPU_SERVE_SPEC", raising=False)
        eng = ServingEngine(lm, kv_block=BT, kv_blocks=40, device="cpu")
        try:
            base = eng.generate(prompts, 10, temperature=0.0)
        finally:
            eng.stop()
        monkeypatch.setenv("DL4J_TPU_SERVE_SPEC", "int8")
        monkeypatch.setenv("DL4J_TPU_SERVE_SPEC_K", "3")
        eng = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                            device="cpu").start()
        try:
            out = eng.generate(prompts, 10, temperature=0.0)
            assert isinstance(eng.decoder, SpeculativeDecoder)
            assert eng.decoder.spec_k == 3
            m = _get(eng.url, "/metrics")
            assert m["decode"]["spec_rounds"] > 0
            assert m["decode"]["draft"] == "int8"
            assert m["serving"]["draft_proposed"] > 0
            assert m["dispatch"]["decode_tokens"] == 10
        finally:
            eng.stop()
        np.testing.assert_array_equal(base, out)

    def test_paged_and_fixed_slot_report_at_models(self, lm):
        """kv_block > 0 serves from the paged pool, kv_block = 0 from the
        fixed-slot pool; both report their scheme and capacity in tokens
        at /models, and their greedy tokens agree."""
        req = {"tokens": [1, 5, 2, 9], "n_new": 6, "temperature": 0.0}
        eng = ServingEngine(lm, kv_block=BT, kv_blocks=40,
                            device="cpu").start()
        try:
            paged = _post(eng.url, "/generate", req)["tokens"][0]
            models = _get(eng.url, "/models")
            kv = models["kv"]["default@v1"]
            assert models["default"] == "default@v1"
            assert models["models"][0]["precision"] == "f32"
            assert kv["scheme"] == "paged"
            assert kv["capacity_tokens"] == 40 * BT
        finally:
            eng.stop()
        eng = ServingEngine(lm, kv_block=0, device="cpu").start()
        try:
            fixed = _post(eng.url, "/generate", req)["tokens"][0]
            kv = _get(eng.url, "/models")["kv"]["default@v1"]
            assert kv["scheme"] == "fixed-slot"
            assert kv["capacity_tokens"] == kv["slots"] * 128
            m = _get(eng.url, "/metrics")
            assert m["decode"]["scheme"] == "fixed-slot"
            assert m["dispatch"]["decode_tokens"] == 6
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(eng.url, "/prefill", {"tokens": [1, 2, 3]})
            assert e.value.code == 400
        finally:
            eng.stop()
        assert paged == fixed

    def test_decoder_value_error_falls_back_to_lm_generate(self, lm):
        """An arena too small for one max_len sequence: building the
        decoder raises a ValueError, the engine keeps no decoder and
        samples through lm.generate, as the JAX engine does."""
        eng = ServingEngine(lm, kv_block=BT, kv_blocks=4, device="cpu")
        try:
            assert eng.decoder is None
            out = eng.generate([[1, 2, 3]], 5, temperature=0.0)
            assert eng.kv_report() == {}
        finally:
            eng.stop()
        want = lm.generate(np.asarray([[1, 2, 3]]), 5, temperature=0.0)
        np.testing.assert_array_equal(out, want.numpy())
