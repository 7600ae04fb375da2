"""The port's sequence-parallel TransformerLM training against the JAX
package, on the CPU.

One ``torch.multiprocessing`` spawn per world size (2 and 4) runs every
case: each worker joins a ``gloo`` group through a ``FileStore`` under the
test's temporary directory (the world-4 spawn also splits it into a 2 x 2
``data x seq`` mesh), runs the port on the JAX package's initial params
(handed over as numpy) and the same global batches, and writes its
results to a file; a worker imports torch and the port only (it records
whether ``jax`` or the JAX package got into its ``sys.modules``). The
spawn must end within ``DEADLINE_S`` or its workers are killed and the
file's tests fail. While the workers run, the parent computes the JAX
side on the conftest's virtual CPU mesh of the same shape, at
``tests/test_ring_training.py``'s config (vocab 64, d_model 32, 2 layers,
4 heads, d_ff 64, T 32, batch 4, Adam lr 1e-3):

  * ``make_ring_train_step`` with ``"ring"`` and ``"ulysses"`` in 2 and 4
    processes, DP x SP on the 2 x 2 mesh with both, and the bf16 policy
    (``dtype_policy="performance"``, lr 1e-2) with both strategies: the
    loss curves and the end params. f32 bars (the JAX step runs in f32
    on the virtual mesh, as ``tests/test_ring_training.py`` holds it):
    curves at rtol 1e-4, every param leaf at 1e-5 abs; bf16 curves at
    rtol 5e-2 (the rounding differs), finite;
  * ``TransformerLM(cfg, group=...)``: 3 ``fit`` calls and one
    ``fit_batches`` of 3 on the global batch against the JAX
    ``TransformerLM`` on a ``('seq',)`` mesh (rtol 1e-4), the iteration,
    and ``save`` written by rank 0 alone, which the JAX ``TransformerLM
    .load`` reads back at the port's params and every rank ``load``s
    into the sequence mode to take the next step bit-equal to the model
    it came from;
  * port against port: the params bit-equal on every rank after every
    case; the multi step bit-equal to the single steps; the gradients of
    ring (with and without a key mask) and Ulysses attention through the
    collectives against ``jax.vjp`` of the dense attention at 1e-5.

In one process: the configurations the ring step refuses (``accum_steps``,
``DL4J_TPU_BF16``, a bad schedule, MoE) raise ``ValueError``; and the
gradients through an in-process 4-shard ring of ``ring_flash_step`` (the
chain ``chip_smoke.py`` drives on the card) equal the dense attention's
in f64 at 1e-10, with the lse cotangent reaching K7's plain version.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import flash_attention as pflash
from deeplearning4j_tpu_torch.parallel import sequence_parallel as psp

WORLDS = (2, 4)
DEADLINE_S = 120.0
CFG_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              max_len=32, learning_rate=1e-3, use_flash=False)
BF16_KW = dict(dtype_policy="performance", learning_rate=1e-2)
N_BATCH, K_STEPS, K_BF16 = 4, 4, 5
CURVE_RTOL, PARAM_ATOL, BF16_RTOL = 1e-4, 1e-5, 5e-2
# (case, strategy, config overrides, steps, mesh shape (data, seq) or None)
STEP_CASES = {
    2: [("ring", "ring", {}, K_STEPS, None),
        ("ulysses", "ulysses", {}, K_STEPS, None)],
    4: [("ring", "ring", {}, K_STEPS, None),
        ("ulysses", "ulysses", {}, K_STEPS, None),
        ("dpxsp", "ring", {}, K_STEPS, (2, 2)),
        ("dpxsp_ulysses", "ulysses", {}, K_STEPS, (2, 2)),
        ("bf16_ring", "ring", BF16_KW, K_BF16, None),
        ("bf16_ulysses", "ulysses", BF16_KW, K_BF16, None)],
}
LM_WORLD, LM_STEPS = 2, 3
ATT_N, ATT_T, ATT_H, ATT_D = 2, 32, 4, 8
ATT_TOL = 1e-5


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG_KW["vocab_size"],
                        (k, N_BATCH, CFG_KW["max_len"] + 1))
    return toks[:, :, :-1].astype(np.int64), toks[:, :, 1:].astype(np.int64)


def _att_inputs(world):
    rng = np.random.default_rng(300 + world)
    q, k, v, g = (rng.standard_normal((ATT_N, ATT_T, ATT_H, ATT_D))
                  .astype(np.float32) for _ in range(4))
    km = (rng.random((ATT_N, ATT_T)) < 0.75).astype(np.float32)
    km[1, :ATT_T // world] = 0.0  # a whole shard of keys masked
    return {"q": q, "k": k, "v": v, "g": g, "km": km}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
    return out


def _worker(rank, world, tmp, t0):
    """One rank: every case, results to ``out<rank>.npz`` with the
    seconds since the parent started the spawn at ``t0``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import (
        init_seq_group,
        mesh_groups,
    )
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    torch.set_num_threads(1)
    seq = init_seq_group(os.path.join(tmp, "store"), rank, world,
                         backend="gloo", timeout_s=60.0)
    meshes = {(2, 2): mesh_groups(2, 2)} if world == 4 else {}
    with open(os.path.join(tmp, "params.npz"), "rb") as f:
        tree = npz_bytes_to_tree(f.read())
    data = np.load(os.path.join(tmp, "batches.npz"))
    out = {}
    for name, strategy, over, k, shape in STEP_CASES[world]:
        cfg = pt.TransformerConfig(**dict(CFG_KW, **over))
        group = seq if shape is None else meshes[shape]
        step = pt.make_ring_train_step(cfg, group, strategy=strategy)
        params = pt.params_from_numpy(tree, device="cpu")
        opt = pt.init_opt_state(params)
        losses = []
        for i in range(k):
            params, opt, loss = step(params, opt,
                                     torch.from_numpy(data["x"][i]),
                                     torch.from_numpy(data["y"][i]))
            losses.append(float(loss))
        out[f"{name}/curve"] = np.asarray(losses)
        for key, a in _flat(params).items():
            out[f"{name}/p/{key}"] = a
        if name == "ring" and world == LM_WORLD:
            multi = pt.make_ring_train_multi_step(cfg, seq)
            p0 = pt.params_from_numpy(tree, device="cpu")
            mp_, _, ml = multi(p0, pt.init_opt_state(p0),
                               torch.from_numpy(data["x"][:k]),
                               torch.from_numpy(data["y"][:k]))
            out["multi/curve"] = ml.numpy()
            for key, a in _flat(mp_).items():
                out[f"multi/p/{key}"] = a
    if world == LM_WORLD:
        cfg = pt.TransformerConfig(**CFG_KW)
        xs, ys = data["x"][:LM_STEPS], data["y"][:LM_STEPS]
        lm = pt.TransformerLM(cfg, device="cpu", group=seq,
                              params=pt.params_from_numpy(tree,
                                                          device="cpu"))
        out["lm/fit"] = np.asarray([float(lm.fit(x, y))
                                    for x, y in zip(xs, ys)])
        out["lm/iteration"] = np.asarray(lm.iteration)
        lm.save(os.path.join(tmp, f"saved{rank}.zip"))
        lm2 = pt.TransformerLM(cfg, device="cpu", group=seq,
                               params=pt.params_from_numpy(tree,
                                                           device="cpu"))
        out["lm/fit_batches"] = lm2.fit_batches(xs, ys).numpy()
        out["lm/iteration_batches"] = np.asarray(lm2.iteration)
        for key, a in _flat(lm.params).items():
            out[f"lm/p/{key}"] = a
        # every rank resumes from rank 0's zip and takes one more step
        dist.barrier(group=seq)
        lm3 = pt.TransformerLM.load(os.path.join(tmp, "saved0.zip"),
                                    device="cpu", group=seq)
        out["lm/loaded_iteration"] = np.asarray(lm3.iteration)
        for name, model in (("continued", lm), ("resumed", lm3)):
            model.fit(xs[0], ys[0])
            for key, a in _flat(model.params).items():
                out[f"lm_{name}/p/{key}"] = a
    # attention gradients through the collectives (this rank's shards)
    att = np.load(os.path.join(tmp, "att.npz"))
    tl = ATT_T // world
    shard = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[:, rank * tl:(rank + 1) * tl]))
    for name in ("ring", "ring_mask", "ulysses"):
        q, k, v = (shard(att[x]).requires_grad_() for x in "qkv")
        if name == "ulysses":
            o = psp.ulysses_attention_sharded(q, k, v, seq, causal=True)
        else:
            o = psp.ring_attention_sharded(
                q, k, v, seq, causal=True,
                key_mask=shard(att["km"]) if name == "ring_mask" else None)
        grads = torch.autograd.grad(o, (q, k, v), shard(att["g"]))
        for x, gx in zip("qkv", grads):
            out[f"att_{name}/d{x}"] = gx.numpy()
    out["foreign_modules"] = np.asarray(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")),
        dtype=str)
    out["seconds"] = np.asarray(time.time() - t0)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    dist.destroy_process_group()


def _join(ctx, world):
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the {world}-process gloo spawn did not end within "
                        f"{DEADLINE_S:.0f} s")


def _jax_side(world, tree, data, att, tmp):
    """Every JAX reference of ``world``'s cases, on the virtual mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deeplearning4j_tpu.models import transformer as jtr
    from deeplearning4j_tpu.parallel.sequence_parallel import (
        multi_head_attention,
    )

    devs = np.array(jax.devices()[:world])
    seq_mesh = Mesh(devs, ("seq",))
    xs, ys = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    ref = {}
    for name, strategy, over, k, shape in STEP_CASES[world]:
        cfg = jtr.TransformerConfig(**dict(CFG_KW, **over))
        mesh = (seq_mesh if shape is None
                else Mesh(devs.reshape(shape), ("data", "seq")))
        step = jtr.make_ring_train_step(cfg, mesh, strategy=strategy)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt = jtr.init_opt_state(params)
        losses = []
        for i in range(k):
            params, opt, loss = step(params, opt, xs[i], ys[i])
            losses.append(float(loss))
        ref[f"{name}/curve"] = np.asarray(losses)
        for key, a in _flat(jax.tree_util.tree_map(np.asarray,
                                                   params)).items():
            ref[f"{name}/p/{key}"] = a
    if world == LM_WORLD:
        cfg = jtr.TransformerConfig(**CFG_KW)
        lm = jtr.TransformerLM(cfg, mesh=seq_mesh)
        ref["lm/fit"] = np.asarray([float(lm.fit(xs[i], ys[i]))
                                    for i in range(LM_STEPS)])
        ref["lm/params"] = _flat(jax.tree_util.tree_map(np.asarray,
                                                        lm.params))
        lm2 = jtr.TransformerLM(cfg, mesh=seq_mesh)
        ref["lm/fit_batches"] = np.asarray(
            lm2.fit_batches(xs[:LM_STEPS], ys[:LM_STEPS]))
    q, k, v, g = (jnp.asarray(att[x]) for x in "qkvg")
    for name, km in (("ring", None), ("ring_mask", att["km"]),
                     ("ulysses", None)):
        _, vjp = jax.vjp(lambda a, b, c: multi_head_attention(
            a, b, c, causal=True, key_mask=km), q, k, v)
        for x, gx in zip("qkv", vjp(g)):
            ref[f"att_{name}/d{x}"] = np.asarray(gx)
    return ref


def _spawn_inputs(world, tmp, tree):
    with open(os.path.join(tmp, "params.npz"), "wb") as f:
        f.write(tree)
    x, y = _batches(max(K_STEPS, K_BF16))
    data = {"x": x, "y": y}
    np.savez(os.path.join(tmp, "batches.npz"), **data)
    att = _att_inputs(world)
    np.savez(os.path.join(tmp, "att.npz"), **att)
    return data, att


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (world, per-rank port results, JAX results, the workers'
    seconds, directory)}: the parent computes each world's JAX side while
    that world's spawn runs."""
    jax = pytest.importorskip("jax")  # the JAX reference side, parent only
    from deeplearning4j_tpu.models import transformer as jtr
    from deeplearning4j_tpu.utils.serialization import _tree_to_npz_bytes

    tree = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jtr.TransformerConfig(**CFG_KW)))
    blob = _tree_to_npz_bytes(tree)
    out = {}
    for world in WORLDS:
        tmp = str(tmp_path_factory.mktemp(f"sptrain{world}"))
        data, att = _spawn_inputs(world, tmp, blob)
        t0 = time.time()
        ctx = mp.start_processes(_worker, args=(world, tmp, t0),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        try:
            ref = _jax_side(world, tree, data, att, tmp)
        finally:
            _join(ctx, world)
        ranks = [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
                 for r in range(world)]
        spawn_s = max(float(r["seconds"]) for r in ranks)
        out[world] = (world, ranks, ref, spawn_s, tmp)
    return out


@pytest.fixture
def run(runs, request):
    return runs[request.param]


def _per_world(*worlds):
    """Parametrize ``run`` by the world whose spawn it reads."""
    return pytest.mark.parametrize("run", worlds, indirect=True,
                                   ids=[f"world{w}" for w in worlds])


@_per_world(*WORLDS)
def test_spawn_ends_in_time_and_workers_import_no_jax(run):
    world, ranks, _, spawn_s, _ = run
    assert spawn_s < DEADLINE_S
    for r in ranks:
        assert r["foreign_modules"].tolist() == []


@_per_world(*WORLDS)
def test_params_bit_equal_on_every_rank(run):
    world, ranks, _, _, _ = run
    keys = [k for k in ranks[0] if "/p/" in k or k.endswith("curve")]
    assert len(keys) > len(STEP_CASES[world]) * 12
    for r in ranks[1:]:
        for key in keys:
            assert np.array_equal(r[key], ranks[0][key]), key


@pytest.mark.parametrize("run,case", [(w, c[0]) for w in WORLDS
                                      for c in STEP_CASES[w]],
                         indirect=["run"],
                         ids=[f"world{w}-{c[0]}" for w in WORLDS
                              for c in STEP_CASES[w]])
def test_step_matches_jax_ring_step(run, case):
    """Loss curve and every end param leaf against JAX
    ``make_ring_train_step`` on a mesh of the same shape."""
    world, ranks, ref, _, _ = run
    got = ranks[0]
    curve = got[f"{case}/curve"]
    assert np.isfinite(curve).all()
    if case.startswith("bf16"):
        np.testing.assert_allclose(curve, ref[f"{case}/curve"],
                                   rtol=BF16_RTOL)
        return
    np.testing.assert_allclose(curve, ref[f"{case}/curve"], rtol=CURVE_RTOL)
    leaves = [k for k in ref if k.startswith(f"{case}/p/")]
    assert len(leaves) == 16
    for key in leaves:
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


@_per_world(LM_WORLD)
def test_multi_step_equals_single_steps(run):
    world, ranks, _, _, _ = run
    got = ranks[0]
    assert np.array_equal(got["multi/curve"], got["ring/curve"])
    for key in (k for k in got if k.startswith("multi/p/")):
        assert np.array_equal(got[key], got[key.replace("multi/", "ring/")])


@_per_world(LM_WORLD)
def test_transformer_lm_sequence_mode_matches_jax(run):
    world, ranks, ref, _, tmp = run
    import jax

    from deeplearning4j_tpu.models.transformer import TransformerLM as JLM

    got = ranks[0]
    np.testing.assert_allclose(got["lm/fit"], ref["lm/fit"], rtol=CURVE_RTOL)
    np.testing.assert_allclose(got["lm/fit_batches"], ref["lm/fit_batches"],
                               rtol=CURVE_RTOL)
    np.testing.assert_allclose(got["lm/fit_batches"], got["lm/fit"],
                               rtol=0, atol=0)
    assert int(got["lm/iteration"]) == int(got["lm/iteration_batches"]) \
        == int(got["lm/loaded_iteration"]) == LM_STEPS
    resumed = [k for k in got if k.startswith("lm_resumed/p/")]
    assert len(resumed) == 16
    for key in resumed:  # load restores params and Adam's state exactly
        assert np.array_equal(got[key],
                              got[key.replace("resumed", "continued")]), key
    for key, want in ref["lm/params"].items():
        np.testing.assert_allclose(got[f"lm/p/{key}"], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    # rank 0 alone wrote its zip, and the JAX package reads it
    assert os.path.exists(os.path.join(tmp, "saved0.zip"))
    for r in range(1, world):
        assert not os.path.exists(os.path.join(tmp, f"saved{r}.zip"))
    loaded = JLM.load(os.path.join(tmp, "saved0.zip"))
    assert loaded.iteration == LM_STEPS
    for key, a in _flat(jax.tree_util.tree_map(np.asarray,
                                               loaded.params)).items():
        assert np.array_equal(a, got[f"lm/p/{key}"]), key


@_per_world(*WORLDS)
@pytest.mark.parametrize("name", ["ring", "ring_mask", "ulysses"])
def test_attention_gradients_through_the_collectives(run, name):
    """dq, dk, dv of each rank's shard (the ring's rotations and Ulysses'
    all-to-alls carry the cotangents back) against ``jax.vjp`` of the
    dense attention."""
    world, ranks, ref, _, _ = run
    tl = ATT_T // world
    for x in "qkv":
        got = np.concatenate([r[f"att_{name}/d{x}"] for r in ranks], axis=1)
        want = ref[f"att_{name}/d{x}"]
        assert got.shape == want.shape == (ATT_N, ATT_T, ATT_H, ATT_D)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATT_TOL,
                                   err_msg=f"d{x}")
    assert tl * world == ATT_T


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"accum_steps": 2}, "accum_steps"),
    ({"lr_schedule": "cosine"}, "total_steps"),
    ({"lr_schedule": "linear"}, "lr_schedule"),
    ({"moe_experts": 4}, "MoE"),
], ids=["accum", "cosine_without_total", "unknown_schedule", "moe"])
def test_ring_step_refuses(kw, match):
    cfg = pt.TransformerConfig(**dict(CFG_KW, **kw))
    for factory in (pt.make_ring_train_step, pt.make_ring_train_multi_step):
        with pytest.raises(ValueError, match=match):
            factory(cfg, None)


def test_ring_step_refuses_bf16_loss_scaling(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_BF16", "1")
    cfg = pt.TransformerConfig(**CFG_KW)
    for factory in (pt.make_ring_train_step, pt.make_ring_train_multi_step):
        with pytest.raises(ValueError, match="DL4J_TPU_BF16"):
            factory(cfg, None)
    with pytest.raises(ValueError, match="DL4J_TPU_BF16"):
        pt.TransformerLM(cfg, device="cpu", group=object())


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "masked"])
def test_four_shard_ring_gradients_equal_dense_attention_f64(monkeypatch,
                                                             masked):
    """``ring_flash_step`` over every (my, src) of a 4-rank ring in one
    process, with autograd: K5's and K7's plain versions through
    ``FlashBlockFn``, the shards combined through each block's lse (so K7
    gets a nonzero lse cotangent). dq, dk, dv equal autograd through the
    dense causal attention of the whole sequence in f64 at 1e-10; masked
    keys get dk = dv = 0 exactly."""
    p, n, t, h, d = 4, 2, 64, 3, 8
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, t, h, d)))
                  for _ in range(4))
    km = None
    if masked:
        km = torch.from_numpy((rng.random((n, t)) < 0.7).astype(np.float64))
        km[:, 0] = 1.0  # every query sees its first key
    seen = []
    real = pflash.flash_block_bwd

    def spy(*args):
        g_lse = args[-1]
        seen.append(0.0 if g_lse is None else float(g_lse.abs().max()))
        return real(*args)

    spy.launches = 0  # the real function counts on the name it is under
    monkeypatch.setattr(pflash, "flash_block_bwd", spy)
    tl = t // p
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qq, kk, vv = leaves
    sh = lambda a, r: None if a is None else a[:, r * tl:(r + 1) * tl]
    outs = []
    for my in range(p):
        st = psp.ring_flash_init(sh(qq, my))
        for step in range(p):
            src = (my - step) % p
            st = psp.ring_flash_step(st, sh(qq, my), sh(kk, src),
                                     sh(vv, src), sh(km, src), my=my,
                                     src=src, t_local=tl, n_dev=p,
                                     causal=True)
        outs.append(psp.ring_flash_finish(st, q.dtype))
    got = torch.autograd.grad(torch.cat(outs, 1), leaves, g)
    dense = [x.clone().requires_grad_() for x in (q, k, v)]
    o = psp.multi_head_attention(*dense, causal=True, key_mask=km)
    want = torch.autograd.grad(o, dense, g)
    for name, a, b in zip("qkv", got, want):
        assert (a - b).abs().max().item() <= 1e-10, name
    assert len(seen) == p * p and max(seen) > 1e-3
    if masked:
        hidden = km == 0
        assert (got[1][hidden] == 0).all() and (got[2][hidden] == 0).all()
