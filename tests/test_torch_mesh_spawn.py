"""The one 2-process and one 4-process ``gloo`` spawn behind the port's
distributed tests (no tests here: ``test_torch_moe.py`` reads the world-2
spawn, ``test_torch_model_parallel.py`` the world-4 one). Every case of a
world runs inside its spawn; each rank writes its results to
``out<rank>.npz`` and the tests read them. The world-2 spawn joins its
group through the multihost env contract (``DL4J_TPU_COORDINATOR``,
``DL4J_TPU_NUM_PROCESSES``, ``DL4J_TPU_PROCESS_ID`` ->
``parallel/multihost.initialize_multihost`` over TCP), the world-4 one
through a ``FileStore``. The inputs (the port's seeded LM and MLP
inits, seeded numpy layer params and batches) are written before the
spawn starts and carried to both packages; the workers import torch and
the port only and record whether ``jax`` or the JAX package got into
their ``sys.modules``. A spawn must end within ``DEADLINE_S``; while it
runs the parent computes the JAX references on the same inputs.
"""

import os
import socket
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

DEADLINE_S = 150.0
LM_CFG = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=4, d_ff=64,
              max_len=16, learning_rate=1e-3, use_flash=False)
PP_CFG = dict(LM_CFG, n_layers=4)  # one layer a stage over 4
MOE = dict(moe_experts=4, d_ff=32)
MOE_FREE = dict(MOE, moe_capacity_factor=4.0)
SP_CFG = dict(LM_CFG, **MOE)
K_STEPS = 2
# (case, config, mesh shape, mesh axes, steps, n_micro or None, batch)
LM_CASES = {
    2: [("tp2", LM_CFG, (1, 2), ("data", "model"), K_STEPS, None, 8),
        ("ep2_moe", dict(LM_CFG, **MOE), (1, 1, 2),
         ("data", "model", "expert"), K_STEPS, None, 8),
        ("pp2", LM_CFG, (2,), ("pipe",), K_STEPS, 4, 8),
        ("pp2_moe_one_group", dict(LM_CFG, **MOE), (2,), ("pipe",),
         K_STEPS, 1, 8),
        ("pp2_moe_grouped", dict(LM_CFG, **MOE_FREE), (2,), ("pipe",),
         K_STEPS, 4, 8),
        ("accum_moe_pp", dict(LM_CFG, **MOE), (2,), ("pipe",), 1, 2, 4)],
    4: [("tp4", LM_CFG, (1, 4), ("data", "model"), K_STEPS, None, 8),
        ("dpxtp", LM_CFG, (2, 2), ("data", "model"), K_STEPS, None, 8),
        ("tpxep_moe", dict(LM_CFG, **MOE), (1, 2, 2),
         ("data", "model", "expert"), K_STEPS, None, 8),
        ("dpxtpxep_moe", dict(LM_CFG, **MOE), (2, 1, 2),
         ("data", "model", "expert"), K_STEPS, None, 8),
        ("pp4", PP_CFG, (4,), ("pipe",), K_STEPS, 4, 8),
        ("ppxdp", PP_CFG, (2, 2), ("pipe", "data"), K_STEPS, 4, 8)],
}
SP_STEPS = K_STEPS
# the sharded clip and bf16 cases: (case, config, mesh shape, axes,
# n_micro or None); in f64 one Adam step from fresh state, with a clip
# that binds (the gradients' norm is ~1e3 times it, so the update lands
# where eps and the scaled gradient are of one size: a norm off by any
# factor moves it)
CLIP = 1e-5
CLIP_CFG = LM_CFG
CLIP_CASES = {
    2: [("clip_tp2", CLIP_CFG, (1, 2, 1), ("data", "model", "expert"), None),
        ("clip_ep2_moe", dict(CLIP_CFG, **MOE_FREE), (1, 1, 2),
         ("data", "model", "expert"), None),
        ("clip_pp2", CLIP_CFG, (2,), ("pipe",), 4)],
    4: [("clip_dpxtp", CLIP_CFG, (2, 2), ("data", "model"), None),
        ("clip_tpxep_moe", dict(CLIP_CFG, **MOE_FREE), (1, 2, 2),
         ("data", "model", "expert"), None),
        ("clip_pp4", dict(CLIP_CFG, n_layers=4), (4,), ("pipe",), 4)],
}
# bf16 loss scaling on a Megatron mesh: growth 2 from 8, BF16_CLEAN clean
# steps, then one with an inf in embed[7, 0] (rank 0's d columns)
BF16_CASES = {2: [("bf16_tp2", LM_CFG, (1, 2), ("data", "model"))],
              4: [("bf16_tpxep_moe", dict(LM_CFG, **MOE_FREE), (1, 2, 2),
                   ("data", "model", "expert"))]}
BF16_CLEAN = 5
AVG_CASES = (("freq1", 1, 1), ("freq3", 3, 2))  # (name, frequency, rounds)
# generate on a mesh: (case, the LM case whose initial params it samples
# from, mesh shape, axes); JAX's test_tp_mesh_kv_decode_equals_serial's
# prompt, greedy at temperature 1e-8
GEN_CASES = {2: [("gen_tp", "tp2", (1, 2), ("data", "model")),
                 ("gen_pp", "pp2", (2,), ("pipe",))],
             4: [("gen_tp", "tp4", (1, 4), ("data", "model")),
                 ("gen_pp", "pp4", (4,), ("pipe",))]}
GEN_PROMPT = [[5, 9, 2, 7], [1, 1, 3, 8]]
GEN_NEW, GEN_TEMP, GEN_SEED = 8, 1e-8, 3


def lm_batches(cfg, n, k, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg["vocab_size"], (k, n, cfg["max_len"] + 1))
    return toks[:, :, :-1].astype(np.int64), toks[:, :, 1:].astype(np.int64)


def mlp_data(n=48, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4))
    y = np.eye(3)[rng.integers(0, 3, n)]
    return x, y


def mlp_conf(mod, updater="sgd", lr=0.1):
    return (mod.NeuralNetConfiguration.builder().seed(5).learning_rate(lr)
            .updater(updater).list()
            .layer(0, mod.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(1, mod.OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .build())


def flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = np.asarray(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
    return out


def _gather_spec(a, spec, mesh):
    import torch.distributed as dist

    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        parts = [torch.empty_like(a) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, a.contiguous(), group=mesh.group(axis))
        a = torch.cat(parts, dim=dim)
    return a


def _blocks(out, name, rank, world, mesh):
    """Layer-level cases: TP block, dense pair, EP, PP."""
    from deeplearning4j_tpu_torch.parallel import expert_parallel as pep
    from deeplearning4j_tpu_torch.parallel import pipeline_parallel as ppp
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as ptp
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh

    d = np.load(os.path.join(os.environ["MESH_TMP"], "blocks.npz"))
    t = lambda k: torch.from_numpy(np.array(d[k]))
    tp = device_mesh((world,), ("model",))
    p = {k[3:]: t(k) for k in d if k.startswith("tp/")}
    mine = {k: v.requires_grad_() for k, v in
            ptp.shard_tp_params(p, tp).items()}
    y = ptp.tp_block_apply(mine, t("x_tp"), tp.group("model"), num_heads=4)
    grads = torch.autograd.grad((y ** 2).sum(), list(mine.values()))
    out["tp_block/y"] = y.detach().numpy()
    try:  # 4 heads do not split over 8 ranks: tp_block_apply refuses
        ptp.tp_block_apply(mine, t("x_tp"), tp.group("model"),
                           num_heads=world + 1)
        out["tp_block/refused"] = np.asarray(False)
    except ValueError:
        out["tp_block/refused"] = np.asarray(True)
    for (k, _), g in zip(mine.items(), grads):
        out[f"tp_block/g/{k}"] = _gather_spec(
            g, ptp.TP_BLOCK_SPECS[k], tp).numpy()
    sh = lambda a, spec: pep.shard(a, spec, {"model": world},
                                   {"model": rank})
    h = ptp.column_parallel_dense(sh(t("W1"), (None, "model")),
                                  sh(t("b1"), ("model",)), t("x_cr"),
                                  tp.group("model"), gather=False)
    out["col_row/y"] = ptp.row_parallel_dense(
        sh(t("W2"), ("model", None)), t("b2"), h, tp.group("model")).numpy()
    ep = device_mesh((world,), ("expert",))
    pm = {k[3:]: t(k) for k in d if k.startswith("ep/")}
    mine = {k: v.requires_grad_() for k, v in
            pep.shard_moe_params(pm, ep).items()}
    y = pep.moe_apply(mine, t("x_ep"), ep.group("expert"), top_k_=2,
                      expert_index=rank)
    grads = torch.autograd.grad((y ** 2).sum(), list(mine.values()))
    out["ep/y"] = y.detach().numpy()
    for (k, _), g in zip(mine.items(), grads):
        out[f"ep/g/{k}"] = _gather_spec(g, pep.MOE_SPECS[k], ep).numpy()
    try:  # 6 experts do not split over 4 ranks
        pep.moe_apply({**mine, "Wg": mine["Wg"][:, :6]}, t("x_ep"),
                      ep.group("expert"), expert_index=rank)
        out["ep/refused"] = np.asarray(world == 2)
    except ValueError:
        out["ep/refused"] = np.asarray(True)
    out["ep/y_top1"] = pep.moe_apply(
        {k: v.detach() for k, v in mine.items()}, t("x_ep"),
        ep.group("expert"), top_k_=1, expert_index=rank).numpy()
    stage = lambda sp, x: torch.tanh(x @ sp["W"] + sp["b"])
    for case, shape, axes, n_micro, data_axis in (
            ("pp", (world,), ("pipe",), 2 * world, None),
            ("ppxdp", (world // 2, 2), ("pipe", "data"), 4, "data")):
        if world == 2 and case == "ppxdp":
            continue
        pmesh = device_mesh(shape, axes)
        s = shape[0]
        pp = {k: t(f"pp{s}/{k}") for k in ("W", "b")}
        mine = {k: v.requires_grad_() for k, v in
                ppp.shard_pipeline_params(pp, pmesh).items()}
        y = ppp.pipeline_apply(mine, t("x_pp"), pmesh, stage_fn=stage,
                               n_micro=n_micro, data_axis=data_axis)
        grads = torch.autograd.grad((y ** 2).sum(), list(mine.values()))
        out[f"{case}/y"] = y.detach().numpy()
        for (k, _), g in zip(mine.items(), grads):
            g = _gather_spec(g, ("pipe",), pmesh)
            if data_axis is not None:  # the rows' grads sum over 'data'
                import torch.distributed as dist

                dist.all_reduce(g, group=pmesh.group("data"))
            out[f"{case}/g/{k}"] = g.numpy()


def _lm_cases(out, world, tmp):
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    for name, kw, shape, axes, k, n_micro, n in LM_CASES[world]:
        cfg = pt.TransformerConfig(**kw)
        with open(os.path.join(tmp, f"lm_{name}.npz"), "rb") as f:
            whole = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                         device="cpu")
        mesh = device_mesh(shape, axes)
        if "pipe" in axes:
            step = pt.make_pipeline_train_step(cfg, mesh, n_micro=n_micro)
        else:
            step = pt.make_train_step(cfg, mesh)
        params = pt.shard_params(whole, cfg, mesh)
        opt = pt.init_opt_state(params)
        xs, ys = lm_batches(kw, n, k, seed=4 if name == "accum_moe_pp"
                            else 0)
        losses = []
        for i in range(k):
            params, opt, loss = step(params, opt, torch.from_numpy(xs[i]),
                                     torch.from_numpy(ys[i]))
            losses.append(float(loss))
        out[f"lm_{name}/curve"] = np.asarray(losses)
        local = flat(params)
        for key, a in flat(pt.gather_params(params, cfg, mesh)).items():
            out[f"lm_{name}/p/{key}"] = a
            out[f"lm_{name}/local/{key}"] = local[key]
        if name in ("tp2", "ppxdp"):
            lm = pt.TransformerLM.from_state(cfg, params, opt, device="cpu",
                                             group=mesh, sharded=True)
            sc.save_lm(os.path.join(tmp, f"ckpt_{name}"), lm)
            out[f"lm_{name}/logits"] = lm.logits(
                torch.from_numpy(xs[0][:2])).numpy()
        if name == "ppxdp":  # pipe 2 x data 2 -> data 2 x model 2
            tpm = device_mesh((2, 2), ("data", "model"))
            back = sc.restore_lm(os.path.join(tmp, "ckpt_ppxdp"), group=tpm,
                                 device="cpu")
            out["restore_pp_to_tp/logits"] = back.logits(
                torch.from_numpy(xs[0][:2])).numpy()
            out["restore_pp_to_tp/iteration"] = np.asarray(back.iteration)


def _generate_cases(out, world, tmp):
    """Greedy ``generate`` in the Megatron and pipeline modes, with the
    cache and with the group's default (the full-forward sampler, which
    the recorder notes), and the same model with no group."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    kw = dict(temperature=GEN_TEMP, seed=GEN_SEED)
    prompt = np.asarray(GEN_PROMPT, np.int64)
    for name, lm_case, shape, axes in GEN_CASES[world]:
        cfg = pt.TransformerConfig(**next(
            c[1] for c in LM_CASES[world] if c[0] == lm_case))
        with open(os.path.join(tmp, f"lm_{lm_case}.npz"), "rb") as f:
            whole = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                         device="cpu")
        lm = pt.TransformerLM(cfg, device="cpu", params=whole,
                              group=device_mesh(shape, axes))
        samplers = []
        for attr in ("_sample_fn", "_sample_kv_fn"):
            fn = getattr(lm, attr)
            setattr(lm, attr, lambda *a, fn=fn, attr=attr: (
                samplers.append(attr), fn(*a))[1])
        out[f"{name}/cache"] = lm.generate(prompt, GEN_NEW, use_cache=True,
                                           **kw).numpy()
        out[f"{name}/default"] = lm.generate(prompt, GEN_NEW, **kw).numpy()
        out[f"{name}/samplers"] = np.asarray(samplers)
        serial = pt.TransformerLM(cfg, device="cpu", params=whole)
        out[f"{name}/serial"] = serial.generate(prompt, GEN_NEW,
                                                **kw).numpy()


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _clip_cases(out, world, tmp):
    """One f64 Adam step of each clip case: the port's compute dtype is
    f64 inside (both forwards run in f64 here; the parent lifts JAX's)."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    saved = pt.TransformerConfig.compute_dtype
    pt.TransformerConfig.compute_dtype = property(lambda self: torch.float64)
    try:
        for name, kw, shape, axes, n_micro in CLIP_CASES[world]:
            cfg = pt.TransformerConfig(**dict(kw, clip_grad_norm=CLIP))
            with open(os.path.join(tmp, f"lm_{name}.npz"), "rb") as f:
                whole = _as_torch(npz_bytes_to_tree(f.read()))  # f64 kept
            mesh = device_mesh(shape, axes)
            step = (pt.make_pipeline_train_step(cfg, mesh, n_micro=n_micro)
                    if "pipe" in axes else pt.make_train_step(cfg, mesh))
            params = pt.shard_params(whole, cfg, mesh)
            xs, ys = lm_batches(kw, 8, 1, seed=6)
            params, _, loss = step(params, pt.init_opt_state(params),
                                   torch.from_numpy(xs[0]),
                                   torch.from_numpy(ys[0]))
            out[f"{name}/loss"] = np.asarray(float(loss))
            for key, a in flat(pt.gather_params(params, cfg, mesh)).items():
                out[f"{name}/p/{key}"] = a
    finally:
        pt.TransformerConfig.compute_dtype = saved


def _bf16_cases(out, rank, world, tmp):
    """BF16_CLEAN clean bf16 steps, then a poisoned one, on a Megatron
    mesh: the (scale, good, skipped) state and the loss of each step;
    and the finite flag's agreement when only rank 0 saw a non-finite
    gradient."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.ops import lowprec as plow
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    os.environ["DL4J_TPU_BF16"] = "1"
    os.environ["DL4J_TPU_LOSS_SCALE"] = "8:2"
    try:
        for name, kw, shape, axes in BF16_CASES[world]:
            cfg = pt.TransformerConfig(**kw)
            with open(os.path.join(tmp, f"lm_{name}.npz"), "rb") as f:
                whole = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                             device="cpu")
            mesh = device_mesh(shape, axes)
            step = pt.make_train_step(cfg, mesh)
            assert step.loss_scaled
            params = pt.shard_params(whole, cfg, mesh)
            opt = pt.init_opt_state(params, True)
            xs, ys = lm_batches(kw, 8, BF16_CLEAN + 1, seed=8)
            states, losses = [], []
            for i in range(BF16_CLEAN + 1):
                if i == BF16_CLEAN and mesh.index("model") == 0:
                    params = dict(params, embed=params["embed"].clone())
                    params["embed"][7, 0] = float("inf")
                before = params
                params, opt, loss = step(params, opt,
                                         torch.from_numpy(xs[i]),
                                         torch.from_numpy(ys[i]))
                states.append([float(opt[k]) for k in plow.OPT_SCALE_KEYS])
                losses.append(float(loss))
            out[f"{name}/states"] = np.asarray(states)
            out[f"{name}/losses"] = np.asarray(losses)
            out[f"{name}/t"] = np.asarray(int(opt["t"]))
            out[f"{name}/kept"] = np.asarray(all(
                torch.equal(params["blocks"][k], before["blocks"][k])
                for k in ("Wq", "W1")))
            out[f"{name}/agreed"] = np.asarray(bool(
                pt._finite_on_every_shard(torch.tensor(rank != 0), mesh)))
    finally:
        del os.environ["DL4J_TPU_BF16"], os.environ["DL4J_TPU_LOSS_SCALE"]


def _sp_moe(out, rank, world):
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    cfg = pt.TransformerConfig(**SP_CFG)
    with open(os.path.join(os.environ["MESH_TMP"], "lm_sp_moe.npz"),
              "rb") as f:
        params = pt.params_from_numpy(npz_bytes_to_tree(f.read()),
                                      device="cpu")
    seq = device_mesh((world,), ("seq",))
    step = pt.make_ring_train_step(cfg, seq)
    opt = pt.init_opt_state(params)
    xs, ys = lm_batches(SP_CFG, 8, SP_STEPS)
    losses = []
    for i in range(SP_STEPS):
        params, opt, loss = step(params, opt, torch.from_numpy(xs[i]),
                                 torch.from_numpy(ys[i]))
        losses.append(float(loss))
    out["sp_moe/curve"] = np.asarray(losses)
    for key, a in flat(params).items():
        out[f"sp_moe/p/{key}"] = a


def _data_parallel(out, rank, world):
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelWrapper,
        ParameterAveragingTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    data = device_mesh((world,), ("data",)).group("data")
    with open(os.path.join(os.environ["MESH_TMP"], "mlp.npz"), "rb") as f:
        init = npz_bytes_to_tree(f.read())
    x, y = mlp_data()

    def net(updater):
        n = MultiLayerNetwork(mlp_conf(pconf, updater), device="cpu").init()
        n.params = [{k: torch.from_numpy(np.array(v)) for k, v in
                     init[i].items()} for i in range(2)]
        n.updater_state = n.updater.init(n.params)
        return n

    n = net("nesterovs")
    pw = ParallelWrapper(n, group=data, device="cpu")
    for _ in range(3):
        pw.fit(x, y)
    for key, a in flat(n.params).items():
        out[f"pw/p/{key}"] = a
    for name, freq, rounds in AVG_CASES:
        n = net("sgd")
        tr = ParameterAveragingTrainer(n, averaging_frequency=freq,
                                       group=data, device="cpu")
        for r in range(rounds):
            tr.fit(x, y)
        out[f"avg_{name}/score"] = np.asarray(n.score_value)
        out[f"avg_{name}/iteration"] = np.asarray(n.iteration)
        for key, a in flat(n.params).items():
            out[f"avg_{name}/p/{key}"] = a


def worker(rank, world, tmp, t0, port):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["MESH_TMP"] = tmp
    out = {}
    if world == 2:
        os.environ["DL4J_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        os.environ["DL4J_TPU_NUM_PROCESSES"] = str(world)
        os.environ["DL4J_TPU_PROCESS_ID"] = str(rank)
        from deeplearning4j_tpu_torch.parallel import multihost

        out["multihost/active"] = np.asarray(
            multihost.initialize_multihost(backend="gloo", timeout_s=60.0))
        info = multihost.process_info()
        out["multihost/info"] = np.asarray(
            [info["process_index"], info["process_count"]])
        out["multihost/primary"] = np.asarray(multihost.is_primary())
        sl = multihost.local_batch_slice(8)
        out["multihost/slice"] = np.asarray([sl.start, sl.stop])
    else:
        import datetime

        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
    _blocks(out, "blocks", rank, world, None)
    _lm_cases(out, world, tmp)
    _clip_cases(out, world, tmp)
    _bf16_cases(out, rank, world, tmp)
    _generate_cases(out, world, tmp)
    if world == 2:
        _sp_moe(out, rank, world)
    else:
        _data_parallel(out, rank, world)
    out["foreign_modules"] = np.asarray(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")),
        dtype=str)
    out["seconds"] = np.asarray(time.time() - t0)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(world, tmp):
    return mp.start_processes(worker,
                              args=(world, tmp, time.time(), free_port()),
                              nprocs=world, join=False, start_method="spawn")


def join(ctx, deadline):
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError("the gloo spawn did not end in time")


# ---------------------------------------------------------------------------
# the JAX references (parent only)
# ---------------------------------------------------------------------------


GROUPED = ("pp2_moe_grouped", "accum_moe_pp")


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _block_inputs(world, tmp):
    """The layer cases' inputs (numpy, f32, seeded), written for the
    workers: a transformer block's params (xavier scale), a column/row
    pair, 8 experts, stage-stacked MLP stages."""
    rng = np.random.default_rng(11)
    f = lambda *shape, scale=1.0: (  # noqa: E731
        rng.standard_normal(shape) * scale).astype(np.float32)
    d, ff = 32, 64
    xav = lambda a, b: f(a, b, scale=(2.0 / (a + b)) ** 0.5)  # noqa: E731
    inp = {
        "tp": {"ln1_g": np.ones(d, np.float32), "ln1_b": f(d, scale=0.1),
               "Wq": xav(d, d), "Wk": xav(d, d), "Wv": xav(d, d),
               "Wo": xav(d, d), "ln2_g": np.ones(d, np.float32),
               "ln2_b": f(d, scale=0.1), "W1": xav(d, ff),
               "b1": f(ff, scale=0.1), "W2": xav(ff, d),
               "b2": f(d, scale=0.1)},
        "x_tp": f(2, 6, 32),
        "W1": f(16, 32), "W2": f(32, 16), "b1": f(32, scale=0.1),
        "b2": f(16, scale=0.1), "x_cr": f(4, 16),
        "ep": {"Wg": xav(16, 8), "W1": f(8, 16, 32, scale=0.3),
               "b1": f(8, 32, scale=0.1), "W2": f(8, 32, 16, scale=0.2),
               "b2": f(8, 16, scale=0.1)},
        "x_ep": f(2, 12, 16),
        "x_pp": f(8, 16),
    }
    for s in sorted({world, 2}):
        inp[f"pp{s}"] = {"W": f(s, 16, 16, scale=0.3),
                         "b": f(s, 16, scale=0.1)}
    flat_inp = {}
    for k, v in inp.items():
        if isinstance(v, dict):
            flat_inp.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            flat_inp[k] = v
    np.savez(os.path.join(tmp, "blocks.npz"), **flat_inp)
    return inp


def _jax_blocks(world, inp):
    """JAX's results of the layer cases (references on one device)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import expert_parallel as jep
    from deeplearning4j_tpu.parallel import pipeline_parallel as jpp
    from deeplearning4j_tpu.parallel import tensor_parallel as jtp

    inp = jax.tree_util.tree_map(jnp.asarray, inp)
    ref = {}
    tp, x = inp["tp"], inp["x_tp"]
    y, g = jax.jit(lambda p: (
        jtp.tp_block_reference(p, x, num_heads=4),
        jax.grad(lambda q: jnp.sum(jtp.tp_block_reference(
            q, x, num_heads=4) ** 2))(p)))(tp)
    ref["tp_block/y"] = np.asarray(y)
    ref.update({f"tp_block/g/{k}": np.asarray(v) for k, v in g.items()})
    xc = inp["x_cr"]
    ref["col_row/y"] = np.asarray((xc @ inp["W1"] + inp["b1"]) @ inp["W2"]
                                  + inp["b2"])
    ep, xe = inp["ep"], inp["x_ep"]
    y2, y1, g = jax.jit(lambda p: (
        jep.moe_reference(p, xe, top_k=2), jep.moe_reference(p, xe, top_k=1),
        jax.grad(lambda q: jnp.sum(jep.moe_reference(q, xe, top_k=2)
                                   ** 2))(p)))(ep)
    ref["ep/y"], ref["ep/y_top1"] = np.asarray(y2), np.asarray(y1)
    ref.update({f"ep/g/{k}": np.asarray(v) for k, v in g.items()})
    stage = lambda p, h: jnp.tanh(h @ p["W"] + p["b"])
    xp = inp["x_pp"]
    for case, s in (("pp", world), ("ppxdp", 2)):
        if world == 2 and case == "ppxdp":
            continue
        y, g = jax.jit(lambda p, s=s: (
            jpp.pipeline_reference(p, xp, stage_fn=stage, n_stages=s),
            jax.grad(lambda q: jnp.sum(jpp.pipeline_reference(
                q, xp, stage_fn=stage, n_stages=s) ** 2))(p)))(inp[f"pp{s}"])
        ref[f"{case}/y"] = np.asarray(y)
        ref.update({f"{case}/g/{k}": np.asarray(v) for k, v in g.items()})
    return ref


def _run_jax_steps(step, params, opt, xs, ys):
    losses = []
    for i in range(xs.shape[0]):
        params, opt, loss = step(params, opt, xs[i], ys[i])
        losses.append(float(loss))
    return params, losses


def _write_lm_inputs(world, tmp):
    """Each LM case's initial params (the port's init, seeded), written
    for the workers; returns {case: numpy tree} for the JAX side."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.utils.serialization import (
        tree_to_npz_bytes,
    )

    cases = [(c[0], c[1]) for c in LM_CASES[world]]
    if world == 2:
        cases.append(("sp_moe", SP_CFG))
    trees, blobs = {}, {}
    for name, kw in cases:
        key = tuple(sorted(kw.items()))
        if key not in blobs:
            params = pt.init_params(pt.TransformerConfig(**kw), device="cpu")
            tree = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.numpy())
                    for k, v in params.items()}
            blobs[key] = (tree, tree_to_npz_bytes(tree))
        trees[name] = blobs[key][0]
        with open(os.path.join(tmp, f"lm_{name}.npz"), "wb") as f:
            f.write(blobs[key][1])
    return trees


def _write_step0_inputs(world, tmp):
    """The clip cases' params in f64 and the bf16 cases' in f32 (the
    port's init, seeded), written for the workers."""
    from deeplearning4j_tpu_torch.models import transformer as pt
    from deeplearning4j_tpu_torch.utils.serialization import (
        tree_to_npz_bytes,
    )

    trees = {}
    cases = ([(c[0], c[1], np.float64) for c in CLIP_CASES[world]]
             + [(c[0], c[1], np.float32) for c in BF16_CASES[world]])
    for i, (name, kw, dt) in enumerate(cases):
        torch.manual_seed(100 + i)
        params = pt.init_params(pt.TransformerConfig(**kw), device="cpu")
        tree = {k: ({kk: vv.numpy().astype(dt) for kk, vv in v.items()}
                    if isinstance(v, dict) else v.numpy().astype(dt))
                for k, v in params.items()}
        trees[name] = tree
        with open(os.path.join(tmp, f"lm_{name}.npz"), "wb") as f:
            f.write(tree_to_npz_bytes(tree))
    return trees


class _JaxF64:
    """JAX's ``forward`` run with ``float32`` meaning ``float64`` (its
    final-LN and logits casts) and its compute dtype f64, while inside
    (``test_torch_transformer_train.py``'s ``f64`` fixture, undone on
    exit)."""

    def __enter__(self):
        import types

        import jax.numpy as jnp

        from deeplearning4j_tpu.models import transformer as jtr

        proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                         if not n.startswith("_")})
        proxy.float32 = jnp.float64
        self.saved = (jtr.forward, jtr.TransformerConfig.compute_dtype)
        jtr.forward = types.FunctionType(
            jtr.forward.__code__, dict(jtr.__dict__, jnp=proxy), "forward",
            jtr.forward.__defaults__, jtr.forward.__closure__)
        jtr.TransformerConfig.compute_dtype = property(
            lambda self: jnp.float64)
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu.models import transformer as jtr

        jtr.forward, jtr.TransformerConfig.compute_dtype = self.saved


def _jax_step0(world, trees):
    """JAX ``make_train_step(cfg, mesh)`` on the virtual mesh of each
    clip case's shape in f64 (the pipe cases: JAX's serial step, which
    its pipeline step equals for these dense configs, since JAX's
    pipeline forward keeps f32 casts the lift does not reach), and on
    each bf16 case's mesh in f32 under ``DL4J_TPU_BF16``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deeplearning4j_tpu.models import transformer as jtr
    from deeplearning4j_tpu.ops import lowprec as jlow

    devs = np.array(jax.devices()[:world])
    ref = {}
    with _JaxF64():
        for name, kw, shape, axes, _ in CLIP_CASES[world]:
            cfg = jtr.TransformerConfig(**dict(kw, clip_grad_norm=CLIP))
            params = jax.tree_util.tree_map(jnp.asarray, trees[name])
            step = (jtr.make_train_step(cfg) if "pipe" in axes else
                    jtr.make_train_step(cfg, Mesh(devs.reshape(shape), axes)))
            xs, ys = (jnp.asarray(a, jnp.int32)
                      for a in lm_batches(kw, 8, 1, seed=6))
            p, _, loss = step(params, jtr.init_opt_state(params), xs[0],
                              ys[0])
            ref[f"{name}/loss"] = float(loss)
            ref[f"{name}/p"] = flat(_np_tree(p))
            free = jtr.TransformerConfig(**kw)  # the same step unclipped
            q, _, _ = jtr.make_train_step(free)(
                params, jtr.init_opt_state(params), xs[0], ys[0])
            q = flat(_np_tree(q))
            ref[f"{name}/clip_effect"] = max(
                float(np.abs(v - q[k]).max())
                for k, v in ref[f"{name}/p"].items())
    saved = {k: os.environ.get(k) for k in ("DL4J_TPU_BF16",
                                             "DL4J_TPU_LOSS_SCALE")}
    os.environ.update(DL4J_TPU_BF16="1", DL4J_TPU_LOSS_SCALE="8:2")
    try:
        for name, kw, shape, axes in BF16_CASES[world]:
            cfg = jtr.TransformerConfig(**kw)
            mesh = Mesh(devs.reshape(shape), axes)
            step = jtr.make_train_step(cfg, mesh)
            tree = trees[name]
            params = jax.tree_util.tree_map(jnp.asarray, tree)
            opt = jtr.init_opt_state(params)
            xs, ys = (jnp.asarray(a, jnp.int32)
                      for a in lm_batches(kw, 8, BF16_CLEAN + 1, seed=8))
            states, losses = [], []
            for i in range(BF16_CLEAN + 1):
                if i == BF16_CLEAN:
                    poisoned = dict(_np_tree(params))
                    poisoned["embed"] = poisoned["embed"].copy()
                    poisoned["embed"][7, 0] = np.inf
                    params = jax.tree_util.tree_map(jnp.asarray, poisoned)
                params, opt, loss = step(params, opt, xs[i], ys[i])
                states.append([float(np.asarray(opt[k]))
                               for k in jlow.OPT_SCALE_KEYS])
                losses.append(float(loss))
            ref[f"{name}/states"] = np.asarray(states)
            ref[f"{name}/losses"] = np.asarray(losses)
            ref[f"{name}/t"] = int(np.asarray(opt["t"]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ref


def _jax_lm(world, serial_cache, trees):
    """JAX's serial step for each LM case (shared by the cases of one
    config; the accumulated step for the accumulation case) and, for the
    grouped MoE pipeline, JAX's pipelined step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deeplearning4j_tpu.models import transformer as jtr

    devs = np.array(jax.devices()[:world])
    ref = {}
    for name, kw, shape, axes, k, n_micro, n in LM_CASES[world]:
        cfg = jtr.TransformerConfig(**kw)
        params = jax.tree_util.tree_map(jnp.asarray, trees[name])
        seed = 4 if name == "accum_moe_pp" else 0
        xs, ys = (jnp.asarray(a, jnp.int32)
                  for a in lm_batches(kw, n, k, seed))
        if name == "accum_moe_pp":  # == JAX's pipeline at n_micro 2
            cfg_a = jtr.TransformerConfig(**dict(kw, accum_steps=2))
            p, c = _run_jax_steps(jtr.make_train_step(cfg_a), params,
                                  jtr.init_opt_state(params), xs, ys)
            ref[f"lm_{name}/mesh"] = ref[f"lm_{name}/serial"] = (
                flat(_np_tree(p)), c)
            ref["accum_moe/jax_loss"] = c[0]
            continue
        if name in GROUPED:  # the grouped objective: JAX's pipeline
            mesh = Mesh(devs.reshape(shape), axes)
            step = jtr.make_pipeline_train_step(cfg, mesh, n_micro=n_micro)
            placed = jtr.shard_params_pipeline(params, cfg, mesh)
            p, c = _run_jax_steps(step, placed, jtr.init_opt_state(placed),
                                  xs, ys)
            ref[f"lm_{name}/mesh"] = (flat(_np_tree(p)), c)
            continue
        ref[f"lm_{name}/serial"] = _serial(jtr, kw, params, xs, ys,
                                           serial_cache)
    if world == 2:
        params = jax.tree_util.tree_map(jnp.asarray, trees["sp_moe"])
        xs, ys = (jnp.asarray(a, jnp.int32)
                  for a in lm_batches(SP_CFG, 8, SP_STEPS))
        ref["sp_moe"] = _serial(jtr, SP_CFG, params, xs, ys, serial_cache)
    return ref


def _jax_generate(world, trees):
    """JAX's greedy transcripts on a (1, world) ('data', 'model') mesh with
    the cache and without (test_tp_mesh_kv_decode_equals_serial's
    setting), and its serial model's, with the top-2 logit margins of
    the serial transcript's steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deeplearning4j_tpu.models import transformer as jtr

    ref = {}
    kw = dict(temperature=GEN_TEMP, seed=GEN_SEED)
    prompt = jnp.asarray(GEN_PROMPT, jnp.int32)
    for name, lm_case, shape, axes in GEN_CASES[world]:
        cfg = jtr.TransformerConfig(**next(
            c[1] for c in LM_CASES[world] if c[0] == lm_case))
        params = jax.tree_util.tree_map(jnp.asarray, trees[lm_case])
        serial = jtr.TransformerLM(cfg)
        serial.params = params
        full = np.asarray(serial.generate(prompt, GEN_NEW, use_cache=False,
                                          **kw))
        ref[f"{name}/jax_serial"] = full
        seq = np.concatenate([np.asarray(GEN_PROMPT), full], axis=1)
        logits = np.asarray(jtr.forward(params, jnp.asarray(seq[:, :-1]),
                                        cfg)[0])[:, len(GEN_PROMPT[0]) - 1:]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        ref[f"{name}/jax_margin"] = float((top2[..., 1] - top2[..., 0]).min())
        if "model" in axes:
            mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape), axes)
            tp = jtr.TransformerLM(cfg, mesh=mesh)
            tp.params = jax.tree_util.tree_map(
                jax.device_put, params, jtr.param_shardings_for_mesh(cfg,
                                                                     mesh))
            for cache in (True, False):
                ref[f"{name}/jax_mesh_{'cache' if cache else 'full'}"] = \
                    np.asarray(tp.generate(prompt, GEN_NEW, use_cache=cache,
                                           **kw))
    return ref


def _serial(jtr, kw, params, xs, ys, cache):
    """JAX's serial steps of config ``kw`` on these batches, computed once
    per (config, batches)."""
    key = (tuple(sorted(kw.items())), xs.shape, float(xs.sum()))
    if key not in cache:
        cfg = jtr.TransformerConfig(**kw)
        p, c = _run_jax_steps(jtr.make_train_step(cfg), params,
                              jtr.init_opt_state(params), xs, ys)
        cache[key] = (flat(_np_tree(p)), c)
    return cache[key]


def _mlp_inputs(tmp):
    """The MLP's initial params (the port's init, in f64), written for
    the workers; returns them as numpy."""
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.serialization import (
        tree_to_npz_bytes,
    )

    net = MultiLayerNetwork(mlp_conf(pconf), device="cpu").init()
    init = {i: {k: v.double().numpy() for k, v in p.items()}
            for i, p in enumerate(net.params)}
    with open(os.path.join(tmp, "mlp.npz"), "wb") as f:
        f.write(tree_to_npz_bytes(init))
    return init


def _jax_data_parallel(world, init):
    """JAX's serial Nesterovs fits, its big-batch and gradient-sync SGD
    steps and its averaging on ``world`` devices, from ``init`` in
    f64."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.parallel import ParameterAveragingTrainer

    x, y = mlp_data()

    def net(updater):
        n = JNet(mlp_conf(jconf, updater)).init()
        n.params = [{k: jnp.asarray(v) for k, v in init[i].items()}
                    for i in range(len(n.params))]
        n.updater_state = n.updater.init(n.params)
        return n

    ref = {}
    n = net("nesterovs")
    for _ in range(3):
        n.fit(x, y)
    ref["pw"] = flat(_np_tree(n.params))
    n = net("sgd")
    n.fit(x, y)
    ref["big_batch"] = flat(_np_tree(n.params))
    n = net("sgd")
    tr = ParameterAveragingTrainer(n, num_workers=world,
                                   averaging_frequency=3)
    for _ in range(2):
        tr.fit(x, y)
    ref["avg_freq3"] = flat(_np_tree(n.params))
    n = net("sgd")  # gradient sync: each of the 6 minibatches whole
    for _ in range(2):
        for i in range(3):
            n.fit(x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)])
    ref["sync_freq3"] = flat(_np_tree(n.params))
    return ref


def run_world(world, tmp_path_factory):
    """(per-rank port results, JAX results, the workers' seconds, dir)
    of ``world``'s spawn: the inputs are written first, the JAX
    references computed while the workers run."""
    import pytest

    pytest.importorskip("jax")
    deadline = time.monotonic() + DEADLINE_S
    tmp = str(tmp_path_factory.mktemp(f"mesh{world}"))
    inp = _block_inputs(world, tmp)
    trees = _write_lm_inputs(world, tmp)
    trees0 = _write_step0_inputs(world, tmp)
    init = _mlp_inputs(tmp) if world == 4 else None
    ctx = start(world, tmp)
    try:
        ref = _jax_blocks(world, inp)
        ref.update(_jax_lm(world, {}, trees))
        ref.update(_jax_step0(world, trees0))
        ref.update(_jax_generate(world, trees))
        if world == 4:
            ref.update(_jax_data_parallel(world, init))
    finally:
        try:
            join(ctx, deadline)
        except TimeoutError:
            pytest.fail(f"the {world}-process gloo spawn did not end "
                        f"within {DEADLINE_S:.0f} s")
    ranks = [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
             for r in range(world)]
    return ranks, ref, max(float(r["seconds"]) for r in ranks), tmp


# ---------------------------------------------------------------------------
# the checks both worlds' tests make
# ---------------------------------------------------------------------------

LAYER_TOL, GRAD_TOL = 1e-5, 1e-4
CURVE_RTOL, PARAM_ATOL, GROUPED_PARAM_ATOL = 1e-4, 1e-5, 1e-4
F64_TOL = 1e-10


def check_spawn_ends_in_time_and_workers_import_no_jax(run):
    ranks, _, seconds, _ = run
    assert seconds < DEADLINE_S
    for r in ranks:
        assert r["foreign_modules"].tolist() == []


def check_tp_block_and_gradients_match_jax(run):
    ranks, ref, _, _ = run
    for r in ranks:  # the block's output is replicated
        np.testing.assert_allclose(r["tp_block/y"], ref["tp_block/y"],
                                   rtol=0, atol=LAYER_TOL)
        assert bool(r["tp_block/refused"])
    for key in (k for k in ref if k.startswith("tp_block/g/")):
        np.testing.assert_allclose(ranks[0][key], ref[key], rtol=0,
                                   atol=GRAD_TOL, err_msg=key)


def check_column_row_dense_roundtrip(run):
    ranks, ref, _, _ = run
    for r in ranks:
        # entries of magnitude ~50: a few f32 ulps, relative
        np.testing.assert_allclose(r["col_row/y"], ref["col_row/y"],
                                   rtol=1e-6, atol=LAYER_TOL)


def check_expert_parallel_matches_jax(run):
    ranks, ref, _, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["ep/y"], ref["ep/y"], rtol=0,
                                   atol=LAYER_TOL)
        np.testing.assert_allclose(r["ep/y_top1"], ref["ep/y_top1"], rtol=0,
                                   atol=LAYER_TOL)
    for key in (k for k in ref if k.startswith("ep/g/")):
        np.testing.assert_allclose(ranks[0][key], ref[key], rtol=0,
                                   atol=GRAD_TOL, err_msg=key)


def check_pipeline_matches_serial_and_jax(run, case):
    """More microbatches than stages; PP x DP on a 2 x 2 mesh (each rank
    returns its data rows)."""
    ranks, ref, _, _ = run
    got = ranks[0][f"{case}/y"]
    if case == "ppxdp":
        got = np.concatenate([ranks[0][f"{case}/y"].reshape(4, 1, 16),
                              ranks[1][f"{case}/y"].reshape(4, 1, 16)],
                             axis=1).reshape(8, 16)
    np.testing.assert_allclose(got, ref[f"{case}/y"], rtol=0, atol=LAYER_TOL)
    for k in ("W", "b"):
        np.testing.assert_allclose(ranks[0][f"{case}/g/{k}"],
                                   ref[f"{case}/g/{k}"], rtol=0,
                                   atol=GRAD_TOL, err_msg=k)


def check_lm_step_matches_jax(run, case):
    """Loss curve and every end param against JAX's serial step (which
    JAX's own tests hold its mesh steps to); the grouped MoE objectives
    against JAX's pipelined step of the same shape (the pipeline at
    n_micro 4) and accumulated step (accumulation at 2)."""
    ranks, ref, _, _ = run
    got = ranks[0]
    curve = got[f"lm_{case}/curve"]
    assert np.isfinite(curve).all()
    grouped = case in GROUPED
    want_p, want_c = ref[f"lm_{case}/mesh" if grouped
                         else f"lm_{case}/serial"]
    np.testing.assert_allclose(curve, want_c, rtol=CURVE_RTOL)
    keys = [k for k in got if k.startswith(f"lm_{case}/p/")]
    assert len(keys) == (17 if "moe" in case else 16)
    # f32 Adam turns a leaf entry's near-zero gradient into a full lr
    # step: the grouped aux's other summation order shows there first
    atol = GROUPED_PARAM_ATOL if grouped else PARAM_ATOL
    for key in keys:
        np.testing.assert_allclose(got[key], want_p[key.split("/p/")[1]],
                                   rtol=0, atol=atol, err_msg=key)


def check_replicas_bit_equal_on_every_rank(run, case):
    """Ranks that hold the same slice of a leaf hold the same bits."""
    from deeplearning4j_tpu_torch.models import transformer as pt

    ranks, _, _, _ = run
    world = len(ranks)
    spec_case = next(c for c in LM_CASES[world] if c[0] == case)
    _, kw, shape, axes = spec_case[:4]
    specs = pt.param_specs_for_mesh(pt.TransformerConfig(**kw),
                                    _FakeMesh(axes, shape))
    coords = np.unravel_index(np.arange(world), shape)
    n = 0
    for key in (k for k in ranks[0] if k.startswith(f"lm_{case}/local/")):
        leaf = key.split("/local/")[1]
        spec = (specs["blocks"][leaf.split(".")[1]]
                if leaf.startswith("blocks.") else specs[leaf])
        split = [axes.index(a) for a in spec if a is not None]
        for r in range(1, world):
            same = [q for q in range(r)
                    if all(coords[i][q] == coords[i][r] for i in split)]
            if same:
                assert np.array_equal(ranks[r][key], ranks[same[0]][key]), \
                    (key, r)
                n += 1
    assert n > 0


def check_clip_on_sharded_mesh_matches_jax(run, case):
    """One f64 step with a binding clip: loss and every param at the f64
    bar on every rank. The clip moves the step's result by far more than
    the bar (JAX's unclipped step against its clipped one), so a norm
    that missed a shard would show."""
    ranks, ref, _, _ = run
    for r in ranks:
        assert abs(float(r[f"{case}/loss"]) - ref[f"{case}/loss"]) <= F64_TOL
        want = ref[f"{case}/p"]
        keys = [k for k in r if k.startswith(f"{case}/p/")]
        assert len(keys) == len(want)
        for key in keys:
            np.testing.assert_allclose(r[key], want[key.split("/p/")[1]],
                                       rtol=0, atol=F64_TOL, err_msg=key)
    assert ref[f"{case}/clip_effect"] > 1e4 * F64_TOL


def check_bf16_on_megatron_mesh_follows_jax(run, case):
    """The (scale, good, skipped) state step for step equal to JAX's, the
    losses within 1e-3 (bf16 products in another order), the poisoned step
    skipped on every rank (scale halved, t and the params kept), and a
    flag that only rank 0 saw false agreed false on every rank."""
    ranks, ref, _, _ = run
    for r in ranks:
        np.testing.assert_array_equal(r[f"{case}/states"],
                                      ref[f"{case}/states"])
        np.testing.assert_allclose(r[f"{case}/losses"][:BF16_CLEAN],
                                   ref[f"{case}/losses"][:BF16_CLEAN],
                                   rtol=0, atol=1e-3)
        assert r[f"{case}/states"][-1][2] == 1
        assert r[f"{case}/states"][-1][0] == r[f"{case}/states"][-2][0] / 2
        assert int(r[f"{case}/t"]) == ref[f"{case}/t"] == BF16_CLEAN
        assert bool(r[f"{case}/kept"])
        assert not bool(r[f"{case}/agreed"])


def check_generate_on_mesh_matches_jax(run, case):
    """Every rank returns the same greedy transcript, with the cache and
    with the group's default (the full-forward sampler, as JAX defaults
    on a mesh); the Megatron transcripts equal JAX's on its (1, world)
    ('data', 'model') mesh, with and without the cache, and the pipeline
    ones the port's serial model's. JAX's serial transcript has no top-2
    logit margin below 1e-4 (no tie that f32 sums could split)."""
    ranks, ref, _, _ = run
    assert ref[f"{case}/jax_margin"] > 1e-4
    for r in ranks:
        assert r[f"{case}/samplers"].tolist() == ["_sample_kv_fn",
                                                  "_sample_fn"]
        for key in ("cache", "default"):
            np.testing.assert_array_equal(r[f"{case}/{key}"],
                                          ranks[0][f"{case}/{key}"])
            np.testing.assert_array_equal(r[f"{case}/{key}"],
                                          r[f"{case}/serial"])
    if case == "gen_tp":
        np.testing.assert_array_equal(ranks[0]["gen_tp/cache"],
                                      ref["gen_tp/jax_mesh_cache"])
        np.testing.assert_array_equal(ranks[0]["gen_tp/default"],
                                      ref["gen_tp/jax_mesh_full"])
    np.testing.assert_array_equal(ranks[0][f"{case}/serial"],
                                  ref[f"{case}/jax_serial"])


class _FakeMesh:
    """The axes of a mesh, for reading ``param_specs_for_mesh``."""

    def __init__(self, axes, shape):
        self.axis_names, self.shape = tuple(axes), tuple(shape)

    def has(self, axis):
        return axis in self.axis_names
