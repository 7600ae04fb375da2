"""The ``program_span`` metrics' readers (``perfbench/spans.py`` and the
four ``metrics/*_ms.train.py``) on rings of spans made by hand, and on
the ring a tiny ``BertMLM`` leaves under a CPU ``torch.profiler``."""

from __future__ import annotations

import pytest

from conftest import ROOT
from perfbench import harness, spans

DEVICE = {"forward_ms.train": "train.forward",
          "backward_ms.train": "train.backward",
          "optimizer_ms.train": "train.optimizer"}
ALL = [*DEVICE, "prepare_ms.train"]


class Ring:
    """The tracer's reading surface over a list of span dicts."""

    def __init__(self, items):
        self.items = items

    def spans(self):
        return list(self.items)


def step(span_id, steps=1):
    return {"name": "train.step", "span_id": span_id, "parent_id": None,
            "duration_s": 0.5, "device_s": 0.5, "attrs": {"steps": steps}}


def child(name, span_id, parent, device_s, duration_s=0.001):
    return {"name": name, "span_id": span_id, "parent_id": parent,
            "duration_s": duration_s, "device_s": device_s, "attrs": {}}


def one_step(first_id, forward, backward, optimizer, prepare=0.002,
             steps=1):
    """A ``train.step`` and its children, children first (finish order)."""
    sid = first_id
    return [child("train.prepare", sid + 1, sid, None, prepare),
            child("train.forward", sid + 2, sid, forward),
            child("train.backward", sid + 3, sid, backward),
            child("train.optimizer", sid + 4, sid, optimizer),
            step(sid, steps)]


@pytest.fixture
def ring(monkeypatch):
    from deeplearning4j_tpu_torch.obs import trace

    r = Ring([])
    monkeypatch.setattr(trace, "tracer", lambda: r)
    return r


def read_all(spec, cell="bert-base.mlm"):
    c = harness.resolve_cell(spec, cell)
    run = harness.Run(cell=c, counters={}, trace=None, device_kind="cpu",
                      peaks={})
    return {m: harness.load_module(
        ROOT / "perfbench" / "metrics" / f"{m}.py").read(run) for m in ALL}


def test_entries_read_by_these_files(spec):
    entries = {m["name"]: m for m in spec["per_layer"]}
    for m in ALL:
        e = entries[m]
        assert (e["source"], e["layer"], e["moves"], e["unit"],
                e["better"]) == ("program_span", "model step",
                                 "train_tokens_per_s", "ms", "lower")
    assert entries["prepare_ms.train"]["workloads"] == ["bert-base.mlm"]
    for m in DEVICE:
        assert entries[m]["workloads"] == ["gpt2-medium.train",
                                           "bert-base.mlm"]


def test_empty_ring_reads_none(spec, ring):
    assert read_all(spec) == {m: None for m in ALL}


def test_unresolved_device_time_reads_none(spec, ring):
    for i in range(3):
        ring.items += one_step(10 * i, 0.08, 0.15, 0.02)
    ring.items[-2]["device_s"] = None  # the last step's optimizer
    got = read_all(spec)
    assert got["optimizer_ms.train"] is None
    assert got["forward_ms.train"] == pytest.approx(80.0)
    assert got["backward_ms.train"] == pytest.approx(150.0)
    assert got["prepare_ms.train"] == pytest.approx(2.0)


def test_mean_covers_only_the_last_trace_steps_steps(spec, ring):
    # two earlier steps (set-up, say) far off, then the traced slice's 3
    ring.items += one_step(0, 9.0, 9.0, 9.0, prepare=9.0)
    ring.items += one_step(10, 9.0, 9.0, 9.0, prepare=9.0)
    for i, f in enumerate((0.07, 0.08, 0.09)):
        ring.items += one_step(20 + 10 * i, f, 2 * f, f / 4,
                               prepare=f / 10)
    assert harness.resolve_cell(
        spec, "bert-base.mlm").traffic["trace_steps"] == 3
    got = read_all(spec)
    assert got["forward_ms.train"] == pytest.approx(80.0)
    assert got["backward_ms.train"] == pytest.approx(160.0)
    assert got["optimizer_ms.train"] == pytest.approx(20.0)
    assert got["prepare_ms.train"] == pytest.approx(8.0)


def test_spans_outside_the_steps_are_ignored(spec, ring):
    # a forward with no parent, one under a serving span, and one nested
    # two deep under the last step (counted)
    ring.items += [child("train.forward", 900, None, 5.0),
                   {"name": "serve.batch", "span_id": 901,
                    "parent_id": None, "duration_s": 1.0, "attrs": {}},
                   child("train.forward", 902, 901, 5.0)]
    for i in range(3):
        ring.items += one_step(10 * i, 0.08, 0.15, 0.02)
    ring.items.insert(len(ring.items) - 1,
                      child("train.forward", 999, 24, 0.03))
    ring.items.append(child("train.forward", 998, None, 5.0))
    got = read_all(spec)
    assert got["forward_ms.train"] == pytest.approx(
        1e3 * (3 * 0.08 + 0.03) / 3)
    assert got["backward_ms.train"] == pytest.approx(150.0)


def test_steps_of_a_multi_step_span_divide_the_sum(spec, ring):
    ring.items += one_step(0, 0.16, 0.30, 0.04, steps=2)
    got = read_all(spec)
    assert got["forward_ms.train"] == pytest.approx(80.0)
    assert got["backward_ms.train"] == pytest.approx(150.0)
    assert got["optimizer_ms.train"] == pytest.approx(20.0)


def test_host_ring_of_a_cpu_fit_reads_prepare_only(spec):
    """Three ``BertMLM.fit`` steps under a CPU profiler: the host's
    ``train.prepare`` reads, the device metrics read None (no card, no
    device time is claimed)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.models.bert import BertConfig, BertMLM

    mlm = BertMLM(BertConfig(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=2, d_ff=64, max_len=32,
                             mask_token_id=63), device=torch.device("cpu"))
    toks = np.random.default_rng(3).integers(1, 63, (3, 4, 16))
    obs.tracer().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for b in toks:
            mlm.fit(b)
    got = read_all(spec)
    obs.tracer().clear()
    assert {m: got[m] for m in DEVICE} == {m: None for m in DEVICE}
    assert got["prepare_ms.train"] > 0
    assert spans.per_step_ms([], 3, "train.prepare", "duration_s") is None
