"""The port's mixture of experts against the JAX package on the CPU:
routing, the index-form FFN, the MoE TransformerLM (logits, training,
accumulation, decoding), and the 2-rank cases of the distributed stack.

In one process (``parallel/expert_parallel.py``,
``models/transformer.py``):

  * routing: the port's ``_routing`` (JAX's dense formulation) byte-equal
    to JAX's in f32, and the index form's slots (``top_k``,
    ``_positions``) scattered into dispatch and combine byte-equal too,
    at top 1 and 2 and with capacity drops;
  * ``moe_ffn`` (gather, batched expert products, weighted sum) against
    the dense einsum chain (``expert_mlp``) in f64 at 1e-10, outputs and
    gradients, and against JAX ``moe_reference`` in f32 at 1e-5; dropped
    tokens get a zero row; the load-balance loss against JAX's;
  * the MoE LM's logits against JAX ``forward`` at 1e-4 (f32), its steps
    against JAX's in f64 (Adam, 1e-5), ``decode_step`` against JAX's, and
    greedy ``generate`` with the KV cache equal to the full-forward
    sampler;
  * the paged decoder's tick on an MoE LM against ``decode_step``.

Across 2 ranks (the world-2 spawn of ``test_torch_mesh_spawn.py``, joined
through the multihost env contract): the TP block, the dense pair, EP
and GPipe against JAX; LM steps at TP 2, EP 2 (MoE), PP 2 (dense, MoE as
one group and grouped) against JAX; the ``accum_steps`` grouped
objective: the accumulated MoE step against the pipeline at n_micro 2
and JAX's accumulated step; SP x MoE (the ring step routing over the
whole sequence) against JAX's step; save_lm at TP 2 restored on one
device; the env contract's process info.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_mesh_spawn as ms
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.parallel import expert_parallel as pep

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_transformer_train import f64  # noqa: E402,F401 (fixture)

TOL_F64 = 1e-10
TOL_F32 = 1e-5
TOL_LOGITS = 1e-4
TOL_ADAM = 1e-5
CASES = [c[0] for c in ms.LM_CASES[2]]
LM_KW = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=4, d_ff=32,
             max_len=16, learning_rate=1e-3, moe_experts=4, seed=0)


def _jep():
    from deeplearning4j_tpu.parallel import expert_parallel as jep

    return jep


def _jtr():
    from deeplearning4j_tpu.models import transformer as jtr

    return jtr


def _gates(t, e, seed, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((t, e)).astype(np.float32)
    if ties:  # exact ties between experts: the lower index wins
        s[::3, 1] = s[::3, 0]
        s[1::5, 3] = s[1::5, 2]
    g = np.exp(s - s.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _dense_from_index(gates, k, cap):
    """dispatch and combine built from the index form's slots."""
    g = torch.from_numpy(gates)
    topv, topi = pep.top_k(g, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    pos, _ = pep._positions(topi, g.shape[1], 1, None)
    t, e = g.shape
    dispatch = torch.zeros((t, e, cap))
    combine = torch.zeros((t, e, cap))
    for tt in range(t):
        for j in range(k):
            if pos[tt, j] < cap:
                dispatch[tt, topi[tt, j], pos[tt, j]] = 1.0
                combine[tt, topi[tt, j], pos[tt, j]] = topv[tt, j]
    return dispatch.numpy(), combine.numpy()


@pytest.mark.parametrize("t,e,k,cap,ties", [
    (24, 8, 2, 7, False), (24, 8, 1, 3, False), (40, 4, 2, 6, True),
    (16, 8, 2, 2, False)], ids=["top2", "top1", "ties", "drops"])
def test_routing_byte_equal_to_jax(t, e, k, cap, ties):
    gates = _gates(t, e, seed=t + e, ties=ties)
    jd, jc = jax.jit(_jep()._routing, static_argnums=(1, 2))(
        jnp.asarray(gates), k, cap)
    jd, jc = np.asarray(jd), np.asarray(jc)
    pd, pc = pep._routing(torch.from_numpy(gates), k, cap)
    assert np.array_equal(pd.numpy(), jd) and np.array_equal(pc.numpy(), jc)
    id_, ic = _dense_from_index(gates, k, cap)
    assert np.array_equal(id_, jd) and np.array_equal(ic, jc)


@pytest.mark.parametrize("k,factor", [(2, 1.25), (1, 1.25), (2, 0.3)],
                         ids=["top2", "top1", "drops"])
def test_index_form_equals_dense_chain_f64(k, factor):
    p = pep.init_moe_params(0, 16, 32, 8, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((24, 16)))
    cap = pep.capacity_of(factor, 24, k, 8)

    def run(fn):
        pp = {a: v.clone().requires_grad_() for a, v in p.items()}
        xx = x.clone().requires_grad_()
        y = fn(pp, xx)
        g = torch.autograd.grad((y ** 2).sum(), [xx] + list(pp.values()))
        return y.detach(), g

    y1, g1 = run(lambda pp, xx: pep.moe_ffn(xx, pp, top_k_=k,
                                            capacity=cap, rows=2)[0])
    y2, g2 = run(lambda pp, xx: pep.moe_reference(pp, xx, top_k_=k,
                                                  capacity_factor=factor))
    assert (y1 - y2).abs().max().item() <= TOL_F64
    for a, b in zip(g1, g2):
        assert (a - b).abs().max().item() <= TOL_F64


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_jax_reference_f32(k):
    jep = _jep()
    p = pep.init_moe_params(0, 16, 32, 8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, 16)).astype(np.float32))
    jp = {a: jnp.asarray(v.numpy()) for a, v in p.items()}
    jx = jnp.asarray(x.numpy())
    want, jaux = jax.jit(lambda q, xx: (
        jep.moe_reference(q, xx, top_k=k),
        jep.load_balancing_loss(xx, q["Wg"])))(jp, jx)
    want, jaux = np.asarray(want), float(jaux)
    got = pep.moe_reference(p, x, top_k_=k)
    assert np.abs(got.numpy() - want).max() <= TOL_F32
    y, aux = pep.moe_ffn(x.reshape(24, 16), p, top_k_=k,
                         capacity=pep.capacity_of(1.25, 24, k, 8))
    assert np.abs(y.numpy().reshape(2, 12, 16) - want).max() <= TOL_F32
    assert abs(float(aux) - jaux) <= TOL_F32
    assert float(aux) >= 1.0 - 1e-6  # E * sum f P >= 1, equal at balance


def test_capacity_drops_leave_zero_rows():
    p = pep.init_moe_params(0, 16, 32, 8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, 16)).astype(np.float32))
    y = pep.moe_reference(p, x, top_k_=1, capacity_factor=0.1)
    yi, _ = pep.moe_ffn(x.reshape(24, 16), p, top_k_=1,
                        capacity=pep.capacity_of(0.1, 24, 1, 8))
    rows = y.reshape(24, 16).abs().sum(-1)
    assert (rows == 0).any() and y.shape == x.shape
    assert torch.equal(yi.abs().sum(-1) == 0, rows == 0)
    stats = {}
    pep.moe_ffn(x.reshape(24, 16), p, top_k_=1,
                capacity=pep.capacity_of(0.1, 24, 1, 8), stats=stats)
    assert int(stats["dropped"]) == int((rows == 0).sum())
    assert stats["slots"] == 24


# ---------------------------------------------------------------------------
# the MoE TransformerLM
# ---------------------------------------------------------------------------


def _pair(dtype=np.float32, **kw):
    """(JAX config, port config, the params as numpy in ``dtype``, the
    same as port tensors): the port's seeded init, carried to both."""
    jtr = _jtr()
    jcfg = jtr.TransformerConfig(**dict(LM_KW, **kw))
    pcfg = pt.TransformerConfig(**dict(LM_KW, **kw))
    init = pt.init_params(pcfg, device="cpu")
    tree = {k: ({kk: vv.numpy().astype(dtype) for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy().astype(dtype))
            for k, v in init.items()}
    to_port = lambda t: ({k: to_port(v) for k, v in t.items()}
                         if isinstance(t, dict)
                         else torch.from_numpy(np.array(t)))
    return jcfg, pcfg, tree, to_port(tree)


def _tokens(seed, n=4, t=16, vocab=50):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, t + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.mark.parametrize("use_flash", [True, False])
def test_moe_lm_logits_match_jax(use_flash):
    jcfg, pcfg, tree, params = _pair()
    pcfg = dataclasses.replace(pcfg, use_flash=use_flash)
    jcfg = dataclasses.replace(jcfg, use_flash=False)
    x, _ = _tokens(0)
    jl, ja = jax.jit(_jtr().forward, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jcfg)
    pl, pa = pt.forward(params, torch.from_numpy(x), pcfg)
    assert np.abs(pl.numpy() - np.asarray(jl)).max() <= TOL_LOGITS
    assert abs(float(pa) - float(ja)) <= TOL_F32 and float(pa) > 0


def _three_steps(jcfg, pcfg, tree, params, tol_loss, tol_params):
    jtr = _jtr()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jtr.init_opt_state(jp)
    po = pt.init_opt_state(params)
    jstep, pstep = jtr.make_train_step(jcfg), pt.make_train_step(pcfg)
    for seed in range(3):
        x, y = _tokens(seed)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        params, po, pl = pstep(params, po, torch.from_numpy(x),
                               torch.from_numpy(y))
        assert abs(float(jl) - float(pl)) <= tol_loss
    got = ms.flat(params)
    for key, want in ms.flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        assert np.abs(got[key] - want).max() <= tol_params, key


def test_moe_lm_steps_match_jax_f64(f64):  # noqa: F811
    """Three Adam steps of the MoE LM in f64."""
    _three_steps(*_pair(np.float64), TOL_ADAM, TOL_ADAM)


def test_moe_decode_step_matches_jax():
    """Drop-free capacity: prefill + decode_step at position 3 against
    JAX's, and against the forward's logits there."""
    jtr = _jtr()
    jcfg, pcfg, tree, params = _pair(moe_capacity_factor=4.0)
    jcfg = dataclasses.replace(jcfg, use_flash=False)
    toks = np.random.default_rng(1).integers(0, 50, (2, 6)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jc, _ = jax.jit(jtr.prefill_cache, static_argnums=2)(
        jp, jnp.asarray(toks), jcfg)
    _, jlog = jax.jit(jtr.decode_step, static_argnums=4)(
        jp, jc, jnp.asarray(toks[:, 3]), jnp.asarray(3, jnp.int32), jcfg)
    pc, _ = pt.prefill_cache(params, torch.from_numpy(toks), pcfg)
    _, plog = pt.decode_step(params, pc, torch.from_numpy(toks[:, 3]), 3,
                             pcfg)
    assert np.abs(plog.numpy() - np.asarray(jlog)).max() <= TOL_LOGITS
    full, _ = pt.forward(params, torch.from_numpy(toks), pcfg)
    assert (plog - full[:, 3]).abs().max().item() <= TOL_LOGITS


def test_moe_generate_kv_equals_full_and_paged_tick_serves_moe():
    from deeplearning4j_tpu_torch.serving.paged import paged_decode_step

    _, pcfg, _, params = _pair(moe_capacity_factor=4.0)
    lm = pt.TransformerLM(pcfg, device="cpu", params=params)
    prompt = np.asarray([[5, 9, 2, 7], [1, 1, 3, 8]], np.int32)
    kv = lm.generate(prompt, 8, temperature=1e-8, seed=3, use_cache=True)
    full = lm.generate(prompt, 8, temperature=1e-8, seed=3, use_cache=False)
    assert torch.equal(kv, full)
    # one paged tick at position 3 against decode_step
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 50, (2, 4)).astype(np.int64))
    cp = lm.compute_params
    cache, _ = pt.prefill_cache(cp, toks[:, :3], pcfg)
    _, want = pt.decode_step(cp, cache, toks[:, 3], 3, pcfg)
    bt, hd = 4, pcfg.d_model // pcfg.n_heads
    arena = {n: torch.zeros((pcfg.n_layers, 3, bt, pcfg.n_heads, hd))
             for n in ("k", "v")}
    for lane in range(2):  # lane s's first block is block s + 1
        for n in ("k", "v"):
            arena[n][:, lane + 1, :3] = cache[n][:, lane, :3]
    tables = torch.tensor([[1, 0, 0, 0], [2, 0, 0, 0]], dtype=torch.int32)
    _, got = paged_decode_step(cp, arena, toks[:, 3],
                               torch.tensor([3, 3], dtype=torch.int32),
                               tables, pcfg)
    assert (got - want).abs().max().item() <= TOL_LOGITS


# ---------------------------------------------------------------------------
# the 2-rank spawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank port results, JAX results, seconds, dir)."""
    return ms.run_world(2, tmp_path_factory)


def test_spawn_ends_in_time_and_workers_import_no_jax(run):
    ms.check_spawn_ends_in_time_and_workers_import_no_jax(run)


def test_tp_block_and_gradients_match_jax(run):
    ms.check_tp_block_and_gradients_match_jax(run)


def test_column_row_dense_roundtrip(run):
    ms.check_column_row_dense_roundtrip(run)


def test_expert_parallel_matches_jax(run):
    ms.check_expert_parallel_matches_jax(run)


def test_pipeline_matches_serial(run):
    """4 microbatches over 2 stages."""
    ms.check_pipeline_matches_serial_and_jax(run, "pp")


@pytest.mark.parametrize("case", CASES)
def test_lm_step_matches_jax(run, case):
    ms.check_lm_step_matches_jax(run, case)


@pytest.mark.parametrize("case", CASES)
def test_replicas_bit_equal_on_every_rank(run, case):
    ms.check_replicas_bit_equal_on_every_rank(run, case)


def test_accum_moe_equals_pipelined_groups(run):
    """MoE at accum_steps 2 optimizes the same grouped loss as the
    pipeline at n_micro 2 (JAX ``test_accum_moe_equals_pipelined_groups``):
    the port's accumulated step here, its pipeline in the spawn, JAX's
    accumulated step (f32: JAX's accumulation carries an f32 loss); the
    accumulated step's params against JAX's at 1e-4 (f32 Adam)."""
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    ranks, ref, _, tmp = run
    kw = dict(ms.LM_CFG, **ms.MOE)
    cfg_a = pt.TransformerConfig(**dict(kw, accum_steps=2))
    with open(os.path.join(tmp, "lm_accum_moe_pp.npz"), "rb") as f:
        params = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                      device="cpu")
    xs, ys = ms.lm_batches(kw, 4, 1, seed=4)
    p_a, _, loss_a = pt.make_train_step(cfg_a)(
        params, pt.init_opt_state(params), torch.from_numpy(xs[0]),
        torch.from_numpy(ys[0]))
    loss_p = float(ranks[0]["lm_accum_moe_pp/curve"][0])
    np.testing.assert_allclose(float(loss_a), loss_p, rtol=1e-5)
    np.testing.assert_allclose(float(loss_a), ref["accum_moe/jax_loss"],
                               rtol=1e-5)
    want = ref["lm_accum_moe_pp/mesh"][0]
    for key, a in ms.flat(p_a).items():
        np.testing.assert_allclose(a, want[key], rtol=0, atol=1e-4,
                                   err_msg=key)


def test_sp_x_moe_matches_jax_step(run):
    """The ring step of an MoE LM in 2 processes: the routing and the
    load-balance statistics of the whole batch (as GSPMD computes JAX's
    ring step), so it equals JAX's serial step."""
    ranks, ref, _, _ = run
    want_p, want_c = ref["sp_moe"]
    for r in ranks:
        np.testing.assert_allclose(r["sp_moe/curve"], want_c,
                                   rtol=ms.CURVE_RTOL)
    keys = [k for k in ranks[0] if k.startswith("sp_moe/p/")]
    assert len(keys) == 17
    for key in keys:
        np.testing.assert_allclose(ranks[0][key], want_p[key[9:]], rtol=0,
                                   atol=ms.PARAM_ATOL, err_msg=key)
        assert np.array_equal(ranks[0][key], ranks[1][key])


def test_sharded_checkpoint_tp2_restores_on_one_device(run):
    """save_lm from the TP 2 ranks; restore_lm in this one process gives
    the whole params and the same logits."""
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc

    ranks, _, _, tmp = run
    lm = sc.restore_lm(os.path.join(tmp, "ckpt_tp2"), device="cpu")
    assert lm.iteration == ms.K_STEPS
    for key, a in ms.flat(lm.params).items():
        assert np.array_equal(a, ranks[0][f"lm_tp2/p/{key}"]), key
    xs, _ = ms.lm_batches(ms.LM_CFG, 8, 1)
    np.testing.assert_allclose(lm.logits(xs[0][:2]).numpy(),
                               ranks[0]["lm_tp2/logits"], rtol=0,
                               atol=ms.LAYER_TOL)


def test_multihost_env_contract_drives_the_spawn(run):
    """The world-2 spawn joined through DL4J_TPU_COORDINATOR /
    _NUM_PROCESSES / _PROCESS_ID: process info, the primary, each
    process's rows of a batch of 8."""
    ranks, _, _, _ = run
    for rank, r in enumerate(ranks):
        assert bool(r["multihost/active"])
        assert r["multihost/info"].tolist() == [rank, 2]
        assert bool(r["multihost/primary"]) == (rank == 0)
        assert r["multihost/slice"].tolist() == [4 * rank, 4 * rank + 4]


@pytest.mark.parametrize("case", [c[0] for c in ms.CLIP_CASES[2]])
def test_clip_grad_norm_on_sharded_mesh_matches_jax(run, case):
    """``clip_grad_norm`` on a sharded mesh is computed, not refused: the
    global norm's squared sums meet over each split leaf's shard groups
    (JAX ``make_train_step(cfg, mesh)``, f64, at 1e-10)."""
    ms.check_clip_on_sharded_mesh_matches_jax(run, case)


@pytest.mark.parametrize("case", [c[0] for c in ms.BF16_CASES[2]])
def test_bf16_loss_scaling_on_megatron_mesh_follows_jax(run, case):
    """``DL4J_TPU_BF16`` on a ``'model'``/``'expert'`` mesh is computed:
    the finite flag agrees over the shard groups before the select."""
    ms.check_bf16_on_megatron_mesh_follows_jax(run, case)


@pytest.mark.parametrize("case", [c[0] for c in ms.GEN_CASES[2]])
def test_generate_on_mesh_matches_jax(run, case):
    """``generate`` in the Megatron and pipeline modes: the same greedy
    tokens on every rank, JAX's on its TP mesh, the serial model's."""
    ms.check_generate_on_mesh_matches_jax(run, case)
