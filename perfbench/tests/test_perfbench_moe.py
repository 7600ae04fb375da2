"""The files of the ``mellum2-12b-ep8.train-8k`` and
``gpt2-medium.train-dp4`` cells: the work counts against hand counts, the
windowed pair count against brute force, the traffic's determinism, the
data mesh's split of the global batch, the new reference's imports, and
whole runs of both cells at a tiny size on the CPU (the four-card cell on
two ``gloo`` processes): a sound program reads correct, a broken one
not."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_MODEL, cpu_context
from perfbench import flops, flops_moe, harness, weights_mellum
from perfbench.traffic import markov

MELLUM = "mellum2-12b-ep8.train-8k"
DP = "gpt2-medium.train-dp4"
SLIDE, FULL = "sliding_attention", "full_attention"
TINY_MELLUM = dict(vocab_size=211, d_model=64, n_layers=4, n_heads=8,
                   n_kv_heads=2, head_dim=16, d_ff=32, experts=16,
                   experts_held=4, expert_offset=4, top_k=4, max_len=32,
                   sliding_window=8, layer_types=[SLIDE] * 3 + [FULL])


def tiny_mellum(spec):
    cell = harness.resolve_cell(spec, MELLUM)
    cell.config["model"].update(TINY_MELLUM)
    cell.config["model"]["rope"][FULL][
        "original_max_position_embeddings"] = 16
    cell.traffic.update(rows=4, seq=32, pool_batches=4, reference_rows=2)
    return cell


def tiny_dp(spec, world=2):
    cell = harness.resolve_cell(spec, DP)
    cell.chips = world
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(rows=8, seq=32, pool_batches=4, reference_rows=4,
                        timeout_s=60)
    return cell


def _run(cell, **kw):
    ctx = cpu_context(cell, **kw)
    oc, device = harness.run_cell(cell, ctx)
    return harness.result_line(cell, ctx, oc, device), oc


# -- counts ------------------------------------------------------------------


def test_windowed_pairs_against_brute_force():
    for t in (1, 7, 64, 100):
        for w in (0, 1, 3, 64, 99, 100, 500):
            qi, ki = np.arange(t)[:, None], np.arange(t)[None]
            seen = (ki <= qi) & ((qi - ki < w) if w else True)
            assert flops_moe.windowed_pairs(t, w) == int(seen.sum()), (t, w)
    # the Mellum row: 1024-key windows over 8192 positions
    assert flops_moe.windowed_pairs(8192, 1024) == 1024 * 1025 // 2 \
        + 7168 * 1024


def test_moe_train_step_against_hand_counts():
    m = dict(TINY_MELLUM, n_layers=4)
    # q 64x128, k and v 64x32, o 128x64, router 64x16 per token and layer
    per_token = 2 * (64 * 128 + 2 * 64 * 32 + 128 * 64 + 64 * 16)
    assert flops_moe.per_token(m) == per_token
    assert flops_moe.per_routed_row(m) == 3 * 2 * 64 * 32
    pairs = flops_moe.layer_pairs(m, 2, 32)
    assert pairs == [2 * flops_moe.windowed_pairs(32, 8)] * 3 \
        + [2 * flops.causal_pairs(32)]
    tokens, routed = 64, 200.0
    want = 3 * (tokens * 4 * per_token + routed * 6 * 64 * 32
                + tokens * 2 * 64 * 211 + 4 * 16 * 8 * sum(pairs))
    assert flops_moe.train_step(m, tokens, routed, sum(pairs)) == want
    assert flops_moe.attn_fwd_bound(32, 128, 10) == 4 * 128 * 32 * 10


def test_mellum_weights_have_the_held_shapes_and_count():
    cell = harness.load_json(ROOT / "perfbench" / "configs"
                             / "mellum2-12b-ep8.json")
    m = cell["model"]
    # published widths: 2.44 B parameters held on this card
    assert weights_mellum.count(m) == pytest.approx(2.44e9, rel=0.01)
    a = weights_mellum.make(TINY_MELLUM, 5, torch.device("cpu"))
    b = weights_mellum.make(TINY_MELLUM, 5, torch.device("cpu"))
    assert torch.equal(a["blocks"]["W1"], b["blocks"]["W1"])
    assert a["blocks"]["W1"].shape == (4, 4, 64, 64)
    assert a["blocks"]["W2"].shape == (4, 4, 32, 64)
    assert a["blocks"]["Wr"].shape == (4, 64, 16)
    assert a["lm_head"].shape == (211, 64)


def test_the_configuration_keeps_the_published_keys():
    cfg = harness.load_json(ROOT / "perfbench" / "configs"
                            / "mellum2-12b-ep8.json")
    m = cfg["model"]
    assert cfg["num_experts"] == 8 == m["experts_held"]
    assert m["experts"] == 64 == cfg["deployment"]["published_num_experts"]
    assert cfg["reduced"] == ["num_experts"]
    assert m["layer_types"] == cfg["layer_types"]
    assert (m["d_model"], m["head_dim"], m["d_ff"], m["top_k"]) == (
        cfg["hidden_size"], cfg["head_dim"], cfg["moe_intermediate_size"],
        cfg["num_experts_per_tok"])
    assert m["rope"] == cfg["rope_parameters"]


# -- traffic -----------------------------------------------------------------


def test_traffic_repeats_by_seed():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    for cell in (tiny_mellum(spec), tiny_dp(spec)):
        driver = harness.load_module(
            cell.files / "drivers" / f"{cell.traffic['driver']}.py")
        m, t = cell.config["model"], cell.traffic
        a = driver.batches(t, m, 2**31 + 11, torch.device("cpu"))
        b = driver.batches(t, m, 2**31 + 11, torch.device("cpu"))
        c = driver.batches(t, m, 2**31 + 12, torch.device("cpu"))
        assert len(a) == t["checked_steps"] + t["pool_batches"]
        assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                   for x, y in zip(a, b))
        assert not torch.equal(a[0][0], c[0][0])
        assert a[0][0].shape == (t["rows"], t["seq"])
        assert torch.equal(a[0][0][:, 1:], a[0][1][:, :-1])


def test_the_data_mesh_split_of_the_global_batch():
    from deeplearning4j_tpu_torch.models.transformer import _data_rows

    driver = harness.load_module(ROOT / "perfbench" / "drivers"
                                 / "lm_train_dp.py")

    class Mesh:
        def __init__(self, world, rank):
            self.world, self.rank = world, rank

        def size(self, axis):
            return self.world

        def index(self, axis):
            return self.rank

    batch = torch.arange(64)[:, None].expand(64, 3)
    seen = []
    for r in range(4):
        mine = driver.rank_rows(64, 4, r)
        assert torch.equal(batch[mine], _data_rows(batch, Mesh(4, r)))
        seen += list(range(64))[mine]
    assert seen == list(range(64))  # disjoint, in order, every row
    with pytest.raises(ValueError):
        driver.rank_rows(10, 4, 0)


def test_the_new_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.mellum2, perfbench.weights_mellum, "
            "perfbench.flops_moe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deeplearning4j_tpu', "
            "'deeplearning4j_tpu_torch')]; print(bad); "
            "sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- whole runs at a tiny size -------------------------------------------------


def test_a_sound_mellum_run_is_correct(spec):
    line, oc = _run(tiny_mellum(spec))
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"grad_gap", "change_gap", "routing_gap"}
    assert line["attempted"] > 0 and line["failed"] == 0
    c = oc.counters
    assert c["dropped_rows"] == 0.0 and c["routed_rows_per_step"] > 0
    run = harness.Run(cell=tiny_mellum(spec), counters=c, trace=None,
                      device_kind="H100", peaks={"bf16_flops": 989e12})
    got = harness.read_per_layer(tiny_mellum(spec), run)
    assert 0 < got["mfu.moe_lm.train"]["value"] < 100


@pytest.mark.parametrize("fault", ["frozen", "half"])
def test_a_broken_mellum_step_is_caught(spec, monkeypatch, fault):
    from deeplearning4j_tpu_torch.models import transformer

    orig = transformer.make_train_step

    def broken(*a, **k):
        step = orig(*a, **k)

        def run(params, opt, *batch):
            if fault == "frozen":
                return params, opt, step(params, opt, *batch)[2]
            n = batch[0].shape[0] // 2
            return step(params, opt, *(b[:n] for b in batch))
        run.loss_scaled = step.loss_scaled
        return run

    monkeypatch.setattr(transformer, "make_train_step", broken)
    line, _ = _run(tiny_mellum(spec))
    assert not line["correct"]


def test_the_data_parallel_cell_on_two_gloo_ranks(spec):
    t0 = time.perf_counter()
    line, oc = _run(tiny_dp(spec), seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2
    assert oc.counters["tokens_per_step"] == 4 * 32  # per rank
    assert time.perf_counter() - t0 < 120
