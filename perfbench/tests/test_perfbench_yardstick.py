"""The yardstick: traffic generators, operation counts, the trace's
reduction, and the import rules of the harness and the references."""

from __future__ import annotations

import ast

import numpy as np
import pytest

from conftest import ROOT
from perfbench import flops, tracing, weights
from perfbench.traffic import markov


# -- traffic ---------------------------------------------------------------


def test_markov_tokens_repeat_by_seed_and_follow_the_chain():
    a = markov.tokens(2**31 + 5, (3, 4, 17), 50)
    assert np.array_equal(a, markov.tokens(2**31 + 5, (3, 4, 17), 50))
    assert not np.array_equal(a, markov.tokens(2**31 + 6, (3, 4, 17), 50))
    succ = np.random.default_rng(1234).integers(0, 50, (50, 4))
    rows = a.reshape(-1, 17)
    for r in rows:
        for t in range(1, 17):
            assert r[t] in succ[r[t - 1]]


def test_padded_rows_same_lengths_every_seed():
    a = markov.padded_rows(1, 5, 8, 64, 16, 300)
    b = markov.padded_rows(2, 5, 8, 64, 16, 300)
    assert np.array_equal(a, markov.padded_rows(1, 5, 8, 64, 16, 300))
    la, lb = (a != 0).sum(-1), (b != 0).sum(-1)
    want = sorted(markov.spread_lengths(8, 16, 64))
    for batch in np.concatenate([la, lb]):
        assert sorted(batch) == want
    assert not np.array_equal(la, lb)
    assert a.min() >= 0 and a.max() < 300
    # pad only after each length
    for row, n in zip(a.reshape(-1, 64), la.reshape(-1)):
        assert (row[:n] > 0).all() and (row[n:] == 0).all()


def test_weights_repeat_by_seed_and_have_the_published_shapes():
    import torch

    m = dict(vocab_size=50, d_model=16, n_layers=3, n_heads=2, d_ff=24,
             max_len=10, init="transformer")
    a = weights.make(m, 7, torch.device("cpu"))
    b = weights.make(m, 7, torch.device("cpu"))
    c = weights.make(m, 8, torch.device("cpu"))
    na, nb, nc = weights.named(a), weights.named(b), weights.named(c)
    assert all(torch.equal(na[k], nb[k]) for k in na)
    assert not torch.equal(na["blocks.Wq"], nc["blocks.Wq"])
    assert na["embed"].shape == (50, 16) and na["blocks.W1"].shape == (3, 16, 24)
    assert na["blocks.W2"].shape == (3, 24, 16)
    assert float(na["embed"].std()) == pytest.approx(0.02, rel=0.2)


# -- operation counts ------------------------------------------------------


def test_counts_against_hand_counts():
    assert flops.causal_pairs(4) == 10
    assert flops.bidirectional_pairs([2, 3]) == 13
    # one block: q, k, v, o of 4x4 and the FFN 4x8, 8x4: 2 (64 + 64) per token
    assert flops.dense_per_token(4, 8) == 2 * (4 * 16 + 2 * 32)
    m = dict(d_model=4, d_ff=8, n_layers=2, n_heads=2, vocab_size=10)
    # 3 tokens, 2 through the head, 5 pairs: forward x 3, attention 12 D H L
    want = (3 * 3 * 2 * 256 + 3 * 2 * 2 * 4 * 10 + 12 * 2 * 2 * 2 * 5)
    assert flops.train_step(m, 3, 2, 5) == want
    assert flops.attn_bwd_bound(heads=2, head_dim=3, pairs=7) == 10 * 3 * 2 * 7
    # the GPT-2 medium step at 16 x 1024: ~37.2 TFLOP
    gpt = dict(d_model=1024, d_ff=4096, n_layers=24, n_heads=16,
               vocab_size=50257)
    step = flops.train_step(gpt, 16384, 16384, 16 * flops.causal_pairs(1024))
    assert 37.0e12 < step < 37.4e12


# -- the trace's reduction ----------------------------------------------


def _events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
         "ts": 100, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 100,
         "dur": 300},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 150, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void flash_bwd_dq<T, 64>(P)",
         "ts": 200, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void flash_bwd_dkdv<T, 64>(P)",
         "ts": 300, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "void flash_bwd_dq<T, 64>(P)",
         "ts": 520, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 600,
         "dur": 400},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 900,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000,
         "dur": 50},
    ]


def test_summary_of_a_trace():
    s = tracing.summarize(_events())
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(410e-6)
    assert s.idle_pct == pytest.approx(59.0)
    assert s.kernel_time("flash_bwd_dq") == (2, pytest.approx(160e-6))
    assert "outside" not in s.kernels
    # gaps: 100-200 under the launch call, 580-900 under aten::item,
    # 500-520 and 950-1100 under no traced event
    assert s.idle["cudaLaunchKernel"] == pytest.approx(100e-6)
    assert s.idle["aten::item"] == pytest.approx(320e-6)
    assert s.idle["host: no traced event"] == pytest.approx(170e-6)
    assert tracing.kernel_mean(s, ("flash_bwd_dq", "flash_bwd_dkdv")) == \
        pytest.approx(80e-6 + 200e-6)
    assert tracing.kernel_mean(s, ("missing",)) is None
    b = s.breakdown()
    assert b["device_ops"][0] == ["flash_bwd_dkdv<T, 64>(P)",
                                  pytest.approx(200e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tracing.summarize([e for e in _events()
                           if e["name"] != tracing.WINDOW])


# -- imports ----------------------------------------------------------------


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in (ROOT / "perfbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    forbidden = {"jax", "jaxlib", "flax", "deeplearning4j_tpu"}
    tops = set(_imports(ROOT / path))
    assert not tops & forbidden, path
    if path.startswith("perfbench/reference/"):
        assert "deeplearning4j_tpu_torch" not in tops, path
