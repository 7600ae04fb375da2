"""Shared pieces of the benchmark's tests: the repository root on the
path, the spec, and tiny versions of the cells for the CPU."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

# a model small enough for the CPU; the vocabulary holds BERT's [MASK] id
TINY_MODEL = dict(vocab_size=211, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                  max_len=32)
TINY_TRAFFIC = dict(rows=8, seq=32, pool_batches=4, reference_rows=4,
                    min_len=8)


@pytest.fixture(scope="session")
def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_cell(spec, name):
    """The cell ``name`` at the tiny size, its limits as committed."""
    cell = harness.resolve_cell(spec, name)
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items()
                         if k in cell.traffic})
    return cell


def cpu_context(cell, seed=2**31 + 77, seconds=0.3):
    import torch

    return harness.Context(cell=cell, seed=seed, seconds=seconds,
                           trace=False, device=torch.device("cpu"),
                           t_start=time.perf_counter())


@pytest.fixture
def card():
    """The CUDA card, decided here (never at import): skips without."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

