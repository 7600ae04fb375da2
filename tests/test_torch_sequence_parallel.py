"""The port's sequence parallelism against the JAX package, on the CPU.

One ``torch.multiprocessing`` spawn per world size (2 and 4) runs every
case: each worker joins a ``gloo`` group through a ``FileStore`` under
the test's temporary directory, computes its own shard of every case and
writes it to a file; a worker imports torch and the port only (it
records whether ``jax`` or the JAX package got into its
``sys.modules``). The spawn must end within ``DEADLINE_S`` or its
workers are killed and the file's tests fail. The parent holds the JAX
side: ``ring_attention_sharded`` (its einsum body; the kernel-backed body
computes the same function), ``ulysses_attention_sharded`` and
``ring_forward`` on the conftest's virtual CPU mesh of the same size, and
``multi_head_attention`` on the whole sequence.

  * the port's ring (its flash body, through K5's plain version here),
    causal and not, with and without a key mask (one batch row with a
    whole shard of keys masked, so some ring steps see no key), against
    the JAX ring and against the JAX dense attention of the unsharded
    sequence; Ulysses causal and not: N=2, T=96, H=4, D=16, f32, at 1e-5
    abs;
  * ``ring_forward`` of a TransformerLM (2 layers, d_model 64, 8 heads,
    T=512, f32 strict) loaded from the JAX package's zip, ring and
    Ulysses, against the JAX ``ring_forward``: logits at 1e-4 abs.

The JAX side stays at forward comparisons at these small shapes (the JAX
package's own ``tests/test_sequence_parallel.py`` covers its gradients).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLDS = (2, 4)
DEADLINE_S = 120.0
N, T, H, D = 2, 96, 4, 16
TOL = 1e-5
LM_TOL = 1e-4
LM_T = 512
LM_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=8, d_ff=128,
             max_len=LM_T, seed=5)
REFS = ("jax_ring", "jax_dense")
ATT_CASES = [(causal, masked) for causal in (True, False)
             for masked in (False, True)]
ULY_CASES = [True, False]


def _att_name(causal, masked):
    return f"ring_{'causal' if causal else 'full'}_" \
           f"{'mask' if masked else 'nomask'}"


def _inputs(world):
    rng = np.random.default_rng(100 + world)
    q, k, v = (rng.standard_normal((N, T, H, D)).astype(np.float32)
               for _ in range(3))
    km = (rng.random((N, T)) < 0.75).astype(np.float32)
    km[1, :T // world] = 0.0      # row 1: the first shard's keys all masked
    tokens = rng.integers(0, LM_KW["vocab_size"], (1, LM_T))
    return {"q": q, "k": k, "v": v, "km": km, "tokens": tokens}


def _worker(rank, world, tmp):
    """One rank: every case on its shard, results to ``out<rank>.npz``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.parallel.mesh import init_seq_group
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        ring_attention_sharded,
        ulysses_attention_sharded,
    )

    torch.set_num_threads(1)
    group = init_seq_group(os.path.join(tmp, "store"), rank, world,
                           backend="gloo", timeout_s=60.0)
    data = np.load(os.path.join(tmp, "inputs.npz"))
    tl = T // world
    shard = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[:, rank * tl:(rank + 1) * tl]))
    q, k, v, km = (shard(data[x]) for x in ("q", "k", "v", "km"))
    out = {}
    for causal, masked in ATT_CASES:
        out[_att_name(causal, masked)] = ring_attention_sharded(
            q, k, v, group, causal=causal,
            key_mask=km if masked else None).numpy()
    for causal in ULY_CASES:
        out[f"ulysses_{causal}"] = ulysses_attention_sharded(
            q, k, v, group, causal=causal).numpy()
    lm = TransformerLM.load(os.path.join(tmp, "lm.zip"), device="cpu")
    ltl = LM_T // world
    toks = torch.from_numpy(data["tokens"][:, rank * ltl:(rank + 1) * ltl])
    for strategy in ("ring", "ulysses"):
        out[f"lm_{strategy}"] = lm.ring_logits(toks, group,
                                               strategy).numpy()
    out["foreign_modules"] = np.asarray(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")),
        dtype=str)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    dist.destroy_process_group()


def _spawn(world, tmp):
    ctx = mp.start_processes(_worker, args=(world, tmp), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the {world}-process gloo spawn did not end within "
                        f"{DEADLINE_S:.0f} s")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def run(request, tmp_path_factory):
    """(world, port results, JAX results): every case through both."""
    jax = pytest.importorskip("jax")  # the JAX reference side, parent only
    from jax.sharding import Mesh

    from deeplearning4j_tpu.models.transformer import (
        TransformerConfig,
        TransformerLM,
        ring_forward,
    )
    from deeplearning4j_tpu.parallel.sequence_parallel import (
        multi_head_attention,
        ring_attention_sharded,
        ulysses_attention_sharded,
    )

    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"sp{world}"))
    data = _inputs(world)
    np.savez(os.path.join(tmp, "inputs.npz"), **data)
    jlm = TransformerLM(TransformerConfig(**LM_KW))
    jlm.save(os.path.join(tmp, "lm.zip"))
    t0 = time.monotonic()
    _spawn(world, tmp)
    spawn_s = time.monotonic() - t0
    parts = [np.load(os.path.join(tmp, f"out{r}.npz")) for r in range(world)]
    port = {name: np.concatenate([p[name] for p in parts], axis=1)
            for name in parts[0].files if name != "foreign_modules"}
    port["foreign_modules"] = sorted(
        set().union(*(p["foreign_modules"].tolist() for p in parts)))

    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    q, k, v = (jax.numpy.asarray(data[x]) for x in ("q", "k", "v"))
    ref = {}
    for causal in (True, False):
        for masked in (False, True):
            km = data["km"] if masked else None
            ref["jax_ring", _att_name(causal, masked)] = np.asarray(
                ring_attention_sharded(q, k, v, mesh, causal=causal,
                                       key_mask=km, use_flash=False))
            ref["jax_dense", _att_name(causal, masked)] = np.asarray(
                multi_head_attention(q, k, v, causal=causal, key_mask=km))
        ref[f"ulysses_{causal}"] = np.asarray(ulysses_attention_sharded(
            q, k, v, mesh, causal=causal))
    toks = jax.numpy.asarray(data["tokens"])
    for strategy in ("ring", "ulysses"):
        ref[f"lm_{strategy}"] = np.asarray(ring_forward(
            jlm.params, toks, jlm.cfg, mesh, strategy=strategy))
    return world, port, ref, spawn_s


def test_spawn_ends_in_time_and_workers_import_no_jax(run):
    world, port, _, spawn_s = run
    assert spawn_s < DEADLINE_S
    assert port["foreign_modules"] == [], port["foreign_modules"]


@pytest.mark.parametrize("causal,masked", ATT_CASES,
                         ids=[_att_name(*c) for c in ATT_CASES])
@pytest.mark.parametrize("reference", REFS)
def test_ring_attention_matches_jax(run, reference, causal, masked):
    _, port, ref, _ = run
    name = _att_name(causal, masked)
    got, want = port[name], ref[reference, name]
    assert got.shape == want.shape == (N, T, H, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if masked:  # batch row 1 saw no key of the first shard; still finite
        assert np.isfinite(got).all()


@pytest.mark.parametrize("causal", ULY_CASES, ids=["causal", "full"])
def test_ulysses_matches_jax(run, causal):
    _, port, ref, _ = run
    got, want = port[f"ulysses_{causal}"], ref[f"ulysses_{causal}"]
    assert got.shape == want.shape == (N, T, H, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_ring_forward_matches_jax(run, strategy):
    _, port, ref, _ = run
    got, want = port[f"lm_{strategy}"], ref[f"lm_{strategy}"]
    assert got.shape == want.shape == (1, LM_T, LM_KW["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=LM_TOL)
