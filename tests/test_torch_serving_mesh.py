"""The port's serving mesh on the CPU (``deeplearning4j_tpu_torch/
serving/mesh.py``), held to JAX ``tests/test_serving_mesh.py``'s
contracts and to the JAX package:

* ``MeshPagedDecoder`` over a 2-rank ``gloo`` group (rank 0 schedules,
  rank 1 follows; one spawn for the module, ~10 s) against the port's
  ``PagedDecoder`` in this process, across JAX's contract matrix: greedy
  and sampled lanes co-scheduled, prefix sharing, preemption, crash
  eviction, streaming order, the k-step tick; tokens equal; and one tick's
  logits over the gathered heads ``torch.equal`` to the dense tick's;
* the same matrix with the 2 (and 4) shards in one process;
* greedy transcripts of the port's mesh decoder against JAX's
  ``MeshPagedDecoder`` on the conftest's virtual mesh, for the same
  weights, under the 1e-4 tie rule (a split only where JAX's top-2 logit
  margin is below 1e-4);
* the loud gates: a width below 2, heads not divisible by the width, a
  bf16 arena, speculative decoding, the fixed-slot pool, a bad role;
* an engine under ``DL4J_TPU_SERVE_MESH=2`` answering ``/generate``
  byte-equal to the dense engine; ``kv_capacity`` stamps the width;
* a disaggregated ``/generate`` (a prefill-role and a decode-role engine
  behind the router) byte-equal to one engine and routed by role, the
  fallback when the prefill replica is gone, and a short prompt that
  skips the handoff.
"""

import datetime
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

DEADLINE_S = 150.0
TIE = 1e-4
LM_KW = dict(vocab_size=29, d_model=16, n_layers=2, n_heads=4, d_ff=32,
             max_len=32, use_flash=False)


def make_lm(path=None):
    """The small LM: seeded, or the params saved at ``path``."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    cfg = pt.TransformerConfig(**LM_KW)
    if path is None:
        torch.manual_seed(0)
        return pt.TransformerLM(cfg, device="cpu")
    with open(path, "rb") as f:
        params = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                      device="cpu")
    return pt.TransformerLM.from_state(cfg, params, None, device="cpu")


# ---------------------------------------------------------------------------
# the scenarios (JAX's contract matrix), each run on a decoder factory
# ---------------------------------------------------------------------------

PREFIX = [2, 4, 6, 8, 10, 12, 14, 16, 3, 5]


def scenario(name, make):
    """(tokens, facts) of one scenario on decoders from ``make(**kw)``;
    on a follower rank the decoder only follows (returns None)."""
    from deeplearning4j_tpu_torch.resilience import (
        InjectedServingFault,
        ServingChaos,
        ServingChaosConfig,
    )

    kw = {"coscheduled": dict(block_tokens=4, n_blocks=16),
          "prefix": dict(block_tokens=4, n_blocks=16),
          "preemption": dict(block_tokens=8, n_blocks=7),
          "crash": dict(block_tokens=8, n_blocks=16),
          "streaming": dict(block_tokens=4, n_blocks=16),
          "k_tick": dict(block_tokens=4, n_blocks=16, tick_k=4)}[name]
    if name == "crash":
        kw["chaos"] = ServingChaos(ServingChaosConfig(admit_raise_at=3))
    d = make(**kw)
    if not getattr(d, "leader", True):
        d.stop()
        return None
    facts = {}
    try:
        if name == "coscheduled":
            futs = [d.submit([1, 5, 2, 9], 6, temperature=0.0),
                    d.submit([4, 4, 4], 6, temperature=0.8, seed=7),
                    d.submit([9, 8, 7, 6, 5], 6, temperature=0.0)]
            toks = [f.result(timeout=120).tolist() for f in futs]
        elif name == "prefix":
            toks = [d.submit(PREFIX + [7], 5, temperature=0.0)
                    .result(timeout=120).tolist()]
            toks.append(d.submit(PREFIX + [9], 5, temperature=0.0)
                        .result(timeout=120).tolist())
            facts["prefix_hits"] = int(d.stats.prefix_hits)
        elif name == "preemption":
            futs = [d.submit(p, 20, temperature=0.0)
                    for p in ([2, 4, 6], [1, 1, 1, 1], [9, 8, 7])]
            toks = [f.result(timeout=120).tolist() for f in futs]
            facts["preemptions"] = int(d.stats.preemptions)
        elif name == "crash":
            solo = d.submit([1, 5, 2, 9], 8, temperature=0.0).result(
                timeout=120).tolist()
            long_fut = d.submit([1, 5, 2, 9], 8, temperature=0.0)
            time.sleep(0.05)
            crash = d.submit([3, 3, 4], 6, temperature=0.0)
            try:
                crash.result(timeout=120)
                facts["crashed"] = False
            except InjectedServingFault:
                facts["crashed"] = True
            toks = [solo, long_fut.result(timeout=120).tolist()]
            cap = d.kv_capacity()
            facts["blocks_back"] = (cap["blocks_in_use"]
                                    == cap["prefix_blocks_cached"])
        elif name == "streaming":
            streamed = []
            out = d.submit([1, 5, 2, 9], 6, temperature=0.0,
                           on_token=streamed.append).result(timeout=120)
            toks = [out.tolist()]
            facts["streamed_equal"] = streamed == list(out)
        else:  # k_tick
            toks = [d.submit([1, 5, 2, 9], 8, temperature=0.0)
                    .result(timeout=120).tolist()]
    finally:
        d.stop()
    return toks, facts


SCENARIOS = ("coscheduled", "prefix", "preemption", "crash", "streaming",
             "k_tick")


def _dense(lm):
    from deeplearning4j_tpu_torch.serving.paged import PagedDecoder

    return lambda **kw: PagedDecoder(lm, device="cpu", **kw)


def _tick_inputs(cfg, seed=5):
    """A filled arena (dense), and a tick's tok/pos/tables."""
    g = torch.Generator().manual_seed(seed)
    hd = cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, 17, 4, cfg.n_heads, hd)
    arena = {n: torch.randn(shape, generator=g) for n in ("k", "v")}
    tok = torch.tensor([3, 4, 5], dtype=torch.int32)
    pos = torch.tensor([10, 3, 20], dtype=torch.int32)
    tables = torch.tensor([[1, 2, 3, 0, 0, 0, 0, 0],
                           [5, 0, 0, 0, 0, 0, 0, 0],
                           [6, 7, 8, 9, 10, 11, 0, 0]], dtype=torch.int32)
    return arena, tok, pos, tables


# ---------------------------------------------------------------------------
# the 2-rank gloo spawn
# ---------------------------------------------------------------------------


def worker(rank, world, tmp):
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.serving.mesh import (
        MeshPagedDecoder,
        group_gather,
        mesh_paged_decode_step,
    )

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
    group = dist.new_group(list(range(world)))
    lm = make_lm(os.path.join(tmp, "lm.npz"))
    out = {}
    for name in SCENARIOS:
        got = scenario(name, lambda **kw: MeshPagedDecoder(
            lm, group=group, device="cpu", **kw))
        if got is not None:
            out[name] = got
    cfg = lm.cfg
    arena, tok, pos, tables = _tick_inputs(cfg)
    hl = cfg.n_heads // world
    mine = {n: a[:, :, :, rank * hl:(rank + 1) * hl].contiguous()
            for n, a in arena.items()}
    with torch.inference_mode():
        logits = mesh_paged_decode_step(
            lm.compute_params, [(rank, mine)], tok, pos, tables, cfg, world,
            group_gather(group))
    torch.save(logits, os.path.join(tmp, f"logits{rank}.pt"))
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib",
                                                   "deeplearning4j_tpu"))
    with open(os.path.join(tmp, f"out{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from deeplearning4j_tpu_torch.utils.serialization import (
        tree_to_npz_bytes,
    )

    tmp = str(tmp_path_factory.mktemp("serving_mesh"))
    lm = make_lm()
    tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in lm.params.items()}
    with open(os.path.join(tmp, "lm.npz"), "wb") as f:
        f.write(tree_to_npz_bytes(tree))
    ctx = mp.start_processes(worker, args=(2, tmp), nprocs=2, join=False,
                             start_method="spawn")
    lm = make_lm(os.path.join(tmp, "lm.npz"))
    dense = {name: scenario(name, _dense(lm)) for name in SCENARIOS}
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 2-process serving mesh did not end in time")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"out{r}.json")) as f:
            ranks.append(json.load(f))
    return lm, dense, ranks, tmp


@pytest.mark.parametrize("name", SCENARIOS)
def test_group_mesh_equals_dense(spawned, name):
    _, dense, ranks, _ = spawned
    toks, facts = ranks[0][name]
    assert toks == dense[name][0]
    assert name not in ranks[1]  # the follower served nothing itself
    if name == "prefix":
        assert facts["prefix_hits"] > 0
    if name == "preemption":
        assert facts["preemptions"] >= 1
    if name == "crash":
        assert facts["crashed"] and facts["blocks_back"]
        assert toks[0] == toks[1]
    if name == "streaming":
        assert facts["streamed_equal"]


def test_group_tick_logits_equal_dense_and_no_jax(spawned):
    from deeplearning4j_tpu_torch.serving.paged import paged_decode_step

    lm, _, ranks, tmp = spawned
    arena, tok, pos, tables = _tick_inputs(lm.cfg)
    with torch.inference_mode():
        _, want = paged_decode_step(lm.compute_params, arena, tok, pos,
                                    tables, lm.cfg)
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"logits{r}.pt"))
        assert torch.equal(got, want)
        assert ranks[r]["foreign"] == []


@pytest.mark.parametrize("devices", [2, 4])
@pytest.mark.parametrize("name", SCENARIOS)
def test_in_process_mesh_equals_dense(spawned, name, devices):
    from deeplearning4j_tpu_torch.serving.mesh import MeshPagedDecoder

    lm, dense, _, _ = spawned
    toks, facts = scenario(name, lambda **kw: MeshPagedDecoder(
        lm, devices=devices, device="cpu", **kw))
    assert toks == dense[name][0]
    assert facts == dense[name][1]


def test_in_process_tick_logits_equal_dense(spawned):
    from deeplearning4j_tpu_torch.serving.mesh import (
        concat_gather,
        mesh_paged_decode_step,
    )
    from deeplearning4j_tpu_torch.serving.paged import paged_decode_step

    lm = spawned[0]
    cfg = lm.cfg
    arena, tok, pos, tables = _tick_inputs(cfg)
    shards = [(i, {n: a[:, :, :, 2 * i:2 * i + 2].contiguous()
                   for n, a in arena.items()}) for i in range(2)]
    with torch.inference_mode():
        got = mesh_paged_decode_step(lm.compute_params, shards, tok, pos,
                                     tables, cfg, 2, concat_gather)
        _, want = paged_decode_step(lm.compute_params, arena, tok, pos,
                                    tables, cfg)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# against the JAX package's mesh decoder
# ---------------------------------------------------------------------------


def test_greedy_transcripts_match_jax_mesh_under_tie_rule():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.transformer import TransformerConfig as JC
    from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
    from deeplearning4j_tpu.models.transformer import forward
    from deeplearning4j_tpu.serving.mesh import MeshPagedDecoder as JMesh

    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.serving.mesh import MeshPagedDecoder

    jlm = JLM(JC(**LM_KW))
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    plm = pt.TransformerLM.from_state(
        pt.TransformerConfig(**LM_KW),
        pt.params_from_numpy(tree, device="cpu"), None, device="cpu")
    prompts = [[1, 5, 2, 9], [4, 4, 4], [9, 8, 7, 6, 5], PREFIX + [7],
               [3] * 13]
    jd = JMesh(jlm, devices=2, block_tokens=4, n_blocks=32)
    pd = MeshPagedDecoder(plm, devices=2, block_tokens=4, n_blocks=32,
                          device="cpu")
    try:
        want = [jd.submit(p, 8, temperature=0.0).result(timeout=240)
                for p in prompts]
        got = [pd.submit(p, 8, temperature=0.0).result(timeout=240)
               for p in prompts]
    finally:
        jd.stop()
        pd.stop()
    equal = 0
    for p, w, g in zip(prompts, want, got):
        w, g = np.asarray(w), np.asarray(g)
        diff = np.nonzero(w != g)[0]
        if diff.size == 0:
            equal += 1
            continue
        j = int(diff[0])
        ctx = np.asarray(p + w[:j].tolist(), np.int32)[None]
        logits = np.asarray(forward(jlm.params, jnp.asarray(ctx),
                                    jlm.cfg)[0])[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE, f"split at {j}: not a tie"
    assert equal >= len(prompts) - 1


# ---------------------------------------------------------------------------
# gates, the engine, sizing
# ---------------------------------------------------------------------------


class TestLoudGates:
    def test_indivisible_heads_and_one_shard_raise(self, spawned):
        from deeplearning4j_tpu_torch.serving.mesh import MeshPagedDecoder

        lm = spawned[0]
        with pytest.raises(ValueError, match="not divisible"):
            MeshPagedDecoder(lm, devices=3, device="cpu")
        with pytest.raises(ValueError, match=">= 2"):
            MeshPagedDecoder(lm, devices=1, device="cpu")

    def test_bf16_arena_and_spec_raise(self, spawned, monkeypatch):
        from deeplearning4j_tpu_torch.serving.mesh import MeshPagedDecoder

        lm = spawned[0]
        monkeypatch.setenv("DL4J_TPU_SERVE_KV_DTYPE", "bf16")
        with pytest.raises(ValueError, match="KV_DTYPE"):
            MeshPagedDecoder(lm, devices=2, device="cpu")
        monkeypatch.delenv("DL4J_TPU_SERVE_KV_DTYPE")
        monkeypatch.setenv("DL4J_TPU_SERVE_SPEC", "int8")
        with pytest.raises(ValueError, match="SPEC"):
            MeshPagedDecoder(lm, devices=2, device="cpu")

    def test_engine_mesh_needs_the_paged_pool_and_is_loud(self, spawned):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        lm = spawned[0]
        # the engine builds an LM record's decoder as it loads it
        with pytest.raises(ValueError, match="paged KV pool"):
            ServingEngine(lm, kv_block=0, mesh_devices=2, device="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            ServingEngine(lm, mesh_devices=3, device="cpu")

    def test_engine_role_validated(self, spawned):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        with pytest.raises(ValueError, match="SERVE_ROLE"):
            ServingEngine(spawned[0], role="both", device="cpu")
        eng = ServingEngine(spawned[0], role="decode", device="cpu")
        assert eng.health()[1]["role"] == "decode"
        assert "role" not in ServingEngine(spawned[0], device="cpu") \
            .health()[1]

    def test_knob_readers(self, monkeypatch):
        from deeplearning4j_tpu_torch.serving.mesh import (
            serve_mesh_devices,
            serve_role,
        )

        assert serve_mesh_devices() == 0 and serve_role() == ""
        monkeypatch.setenv("DL4J_TPU_SERVE_MESH", "4")
        monkeypatch.setenv("DL4J_TPU_SERVE_ROLE", "Prefill")
        assert serve_mesh_devices() == 4 and serve_role() == "prefill"


def _post(url, path, payload, timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


class TestEngine:
    def test_engine_under_serve_mesh_equals_dense(self, spawned,
                                                  monkeypatch):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.mesh import MeshPagedDecoder

        lm = spawned[0]
        dense = ServingEngine(lm, kv_block=4, kv_blocks=24,
                              device="cpu").start()
        monkeypatch.setenv("DL4J_TPU_SERVE_MESH", "2")
        mesh = ServingEngine(lm, kv_block=4, kv_blocks=24,
                             device="cpu").start()
        try:
            for prompt in ([1, 5, 2, 9], PREFIX, [7]):
                body = {"tokens": prompt, "n_new": 6, "temperature": 0.0}
                assert _post(mesh.url, "/generate", body) == \
                    _post(dense.url, "/generate", body)
            dec = mesh._decoders[mesh.registry.default().key]
            assert isinstance(dec, MeshPagedDecoder)
            assert dec.kv_capacity()["mesh_devices"] == 2
        finally:
            mesh.stop()
            dense.stop()


class TestDisaggregation:
    def _pair(self, lm, bt=4):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        return (ServingEngine(lm, kv_block=bt, kv_blocks=24,
                              role="prefill", device="cpu").start(),
                ServingEngine(lm, kv_block=bt, kv_blocks=24,
                              role="decode", device="cpu").start())

    def test_disaggregated_generate_byte_equal_and_routed(self, spawned):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.router import FleetRouter

        lm = spawned[0]
        prompt = [1, 5, 2, 9, 3, 7, 4, 8, 6, 2]
        body = {"tokens": prompt, "n_new": 6, "temperature": 0.0}
        solo = ServingEngine(lm, kv_block=4, kv_blocks=24,
                             device="cpu").start()
        try:
            want = _post(solo.url, "/generate", body)
        finally:
            solo.stop()
        pre, dec = self._pair(lm)
        router = FleetRouter(replicas={
            "p0": {"url": pre.url, "role": "prefill"},
            "d0": {"url": dec.url, "role": "decode"}}).start()
        try:
            for _ in range(2):
                assert _post(router.url, "/generate", body) == want
            assert router.stats.snapshot()["prefill_handoffs"] >= 1
            ps, ds = pre.stats.snapshot(), dec.stats.snapshot()
            assert ps["prefix_exports"] >= 1
            assert ps["generated_tokens"] == 0
            assert ds["prefix_imports"] >= 1 and ds["prefix_hits"] >= 1
            assert ds["errors"] == 0 and ds["completed"] == 2
            assert router.describe_replicas()["p0"]["role"] == "prefill"
        finally:
            router.stop()
            pre.stop()
            dec.stop()

    def test_handoff_failure_falls_back(self, spawned):
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from deeplearning4j_tpu_torch.serving.router import FleetRouter

        lm = spawned[0]
        prompt = [1, 5, 2, 9, 3, 7, 4, 8, 6, 2]
        dec = ServingEngine(lm, kv_block=4, kv_blocks=24,
                            device="cpu").start()
        router = FleetRouter(replicas={
            "p0": {"url": "http://127.0.0.1:9", "role": "prefill"},
            "d0": {"url": dec.url, "role": "decode"}}).start()
        try:
            got = json.loads(_post(router.url, "/generate", {
                "tokens": prompt, "n_new": 6,
                "temperature": 0.0}))["tokens"][0]
            want = dec.generate(np.asarray([prompt]), 6,
                                temperature=0.0)[0].tolist()
            assert got == want
            snap = router.stats.snapshot()
            assert snap["prefill_fallbacks"] == 1
            assert snap["prefill_handoffs"] == 0
        finally:
            router.stop()
            dec.stop()

    def test_short_prompt_skips_handoff(self, spawned):
        from deeplearning4j_tpu_torch.serving.router import FleetRouter

        pre, dec = self._pair(spawned[0], bt=8)
        router = FleetRouter(replicas={
            "p0": {"url": pre.url, "role": "prefill"},
            "d0": {"url": dec.url, "role": "decode"}}).start()
        try:
            _post(router.url, "/generate", {"tokens": [1, 5, 2],
                                            "n_new": 4, "temperature": 0.0})
            snap = router.stats.snapshot()
            assert snap["prefill_handoffs"] == 0
            assert snap["prefill_fallbacks"] == 0
            assert dec.stats.snapshot()["prefix_imports"] == 0
        finally:
            router.stop()
            pre.stop()
            dec.stop()
