"""The port's tensor, expert, pipeline and data parallelism and its
sharded checkpoint across 4 ranks, against the JAX package on the CPU
(``tests/test_model_parallel.py``, ``test_pipeline_training.py``,
``test_transformer.py``'s mesh cases and ``test_data_parallel.py``,
case by case; the 2-rank cases are in ``test_torch_moe.py``).

One module fixture runs the 4-process ``gloo`` spawn of
``test_torch_mesh_spawn.py`` (a ``FileStore`` group) and, while it runs,
computes each case's JAX references on the same params and batches: the
serial function, which JAX's own tests hold its mesh functions to (each
JAX mesh function compiles anew: all of them would not fit this file's
time). Cases: a TP 4 block, the column/row dense pair, EP over 4 (top 2
and top 1; 6 experts refused), GPipe over 4 stages with 8 microbatches
and PP x DP on 2 x 2; TransformerLM steps (Adam, f32) at TP 4, DP x TP
2 x 2, TP x EP 2 x 2 and DP x EP 2 x 2 with MoE, PP 4 and PP x DP 2 x 2;
save_lm on the pipe x data mesh restored onto data x model and onto one
device; ParallelWrapper over a 4-rank ``'data'`` group and parameter
averaging with each rank a worker, on an f64 MLP. Bars: f32 layer
outputs 1e-5 abs, layer gradients 1e-4; LM curves rtol 1e-4 and every
end param 1e-5 abs; f64 data parallelism 1e-10; ranks holding the same
slice of a leaf bit-equal; a group's averaging workers against the same
workers in one process at 1e-12.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_mesh_spawn as ms

CASES = [c[0] for c in ms.LM_CASES[4]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank port results, JAX results, seconds, dir)."""
    return ms.run_world(4, tmp_path_factory)


def test_spawn_ends_in_time_and_workers_import_no_jax(run):
    ms.check_spawn_ends_in_time_and_workers_import_no_jax(run)


def test_tp_block_and_gradients_match_jax(run):
    ms.check_tp_block_and_gradients_match_jax(run)


def test_column_row_dense_roundtrip(run):
    ms.check_column_row_dense_roundtrip(run)


def test_expert_parallel_matches_jax(run):
    ms.check_expert_parallel_matches_jax(run)


def test_experts_not_divisible_raises(run):
    ranks, _, _, _ = run
    assert all(bool(r["ep/refused"]) for r in ranks)


@pytest.mark.parametrize("case", ["pp", "ppxdp"])
def test_pipeline_matches_serial(run, case):
    """8 microbatches over 4 stages; PP x DP on a 2 x 2 mesh (each rank
    returns its data rows)."""
    ms.check_pipeline_matches_serial_and_jax(run, case)


@pytest.mark.parametrize("case", CASES)
def test_lm_step_matches_jax(run, case):
    ms.check_lm_step_matches_jax(run, case)


@pytest.mark.parametrize("case", CASES)
def test_replicas_bit_equal_on_every_rank(run, case):
    ms.check_replicas_bit_equal_on_every_rank(run, case)


def test_sharded_checkpoint_pipe_restores_onto_tp(run):
    """save_lm from a pipe 2 x data 2 mesh, restore_lm onto data 2 x
    model 2 in the spawn and onto one device here: the same logits."""
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc

    ranks, _, _, tmp = run
    want = ranks[0]["lm_ppxdp/logits"]
    for r in ranks:
        np.testing.assert_allclose(r["restore_pp_to_tp/logits"], want,
                                   rtol=0, atol=ms.LAYER_TOL)
        assert int(r["restore_pp_to_tp/iteration"]) == ms.K_STEPS
    lm = sc.restore_lm(os.path.join(tmp, "ckpt_ppxdp"), device="cpu")
    xs, _ = ms.lm_batches(ms.PP_CFG, 8, 1)
    np.testing.assert_allclose(lm.logits(xs[0][:2]).numpy(), want, rtol=0,
                               atol=ms.LAYER_TOL)


def test_parallel_wrapper_group_equals_serial_f64(run):
    """3 Nesterovs fits of the 48-row batch over a 4-rank ``'data'``
    group against JAX's serial fits (JAX's ``ParallelWrapper`` computes
    its serial step)."""
    ranks, ref, _, _ = run
    for r in ranks:
        for key, want in ref["pw"].items():
            np.testing.assert_allclose(r[f"pw/p/{key}"], want, rtol=0,
                                       atol=ms.F64_TOL, err_msg=key)


def test_averaging_ranks_equal_jax_and_in_process_workers(run):
    """Frequency 1 with SGD is the big-batch step; frequency 3 (2
    rounds) equals JAX's averaging over 4 devices and the port's 4
    in-process workers, and differs from gradient sync."""
    from deeplearning4j_tpu_torch.nn import conf as pconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParameterAveragingTrainer,
    )
    from deeplearning4j_tpu_torch.utils.serialization import (
        npz_bytes_to_tree,
    )

    ranks, ref, _, tmp = run
    for r in ranks:
        for key, want in ref["big_batch"].items():
            np.testing.assert_allclose(r[f"avg_freq1/p/{key}"], want,
                                       rtol=0, atol=ms.F64_TOL, err_msg=key)
        for key, want in ref["avg_freq3"].items():
            np.testing.assert_allclose(r[f"avg_freq3/p/{key}"], want,
                                       rtol=0, atol=ms.F64_TOL, err_msg=key)
        assert int(r["avg_freq3/iteration"]) == 6
    with open(os.path.join(tmp, "mlp.npz"), "rb") as f:
        init = npz_bytes_to_tree(f.read())
    net = MultiLayerNetwork(ms.mlp_conf(pconf, "sgd"), device="cpu").init()
    net.params = [{k: torch.from_numpy(np.array(v)) for k, v in
                   init[i].items()} for i in range(2)]
    net.updater_state = net.updater.init(net.params)
    tr = ParameterAveragingTrainer(net, num_workers=4, averaging_frequency=3,
                                   device="cpu")
    x, y = ms.mlp_data()
    for _ in range(2):
        tr.fit(x, y)
    for key, a in ms.flat(net.params).items():
        np.testing.assert_allclose(a, ranks[0][f"avg_freq3/p/{key}"],
                                   rtol=0, atol=1e-12, err_msg=key)
    diff = max(np.abs(ranks[0][f"avg_freq3/p/{k}"]
                      - ref["sync_freq3"][k]).max()
               for k in ref["sync_freq3"])
    assert diff > 1e-6


@pytest.mark.parametrize("case", [c[0] for c in ms.CLIP_CASES[4]])
def test_clip_grad_norm_on_sharded_mesh_matches_jax(run, case):
    """``clip_grad_norm`` on a sharded mesh is computed, not refused: the
    global norm's squared sums meet over each split leaf's shard groups
    (JAX ``make_train_step(cfg, mesh)``, f64, at 1e-10)."""
    ms.check_clip_on_sharded_mesh_matches_jax(run, case)


@pytest.mark.parametrize("case", [c[0] for c in ms.BF16_CASES[4]])
def test_bf16_loss_scaling_on_megatron_mesh_follows_jax(run, case):
    """``DL4J_TPU_BF16`` on a ``'model'``/``'expert'`` mesh is computed:
    the finite flag agrees over the shard groups before the select."""
    ms.check_bf16_on_megatron_mesh_follows_jax(run, case)


@pytest.mark.parametrize("case", [c[0] for c in ms.GEN_CASES[4]])
def test_generate_on_mesh_matches_jax(run, case):
    """``generate`` in the Megatron and pipeline modes: the same greedy
    tokens on every rank, JAX's on its TP mesh, the serial model's."""
    ms.check_generate_on_mesh_matches_jax(run, case)
