"""The training step's spans (``obs/trace.py``) on the CPU at a tiny
TransformerLM and BertMLM, and one card test:

  * the tree ``fit`` and ``fit_batches`` make: ``train.step`` over
    ``train.prepare``, ``train.forward``, ``train.backward``,
    ``train.optimizer`` (and BERT's ``train.readback``), with their
    attributes;
  * parameters and losses bit-equal with spans on and off;
  * the profiler's gate: with ``DL4J_TPU_OBS`` unset, a ``torch.profiler``
    session records the spans, and its Chrome trace holds them as
    ``user_annotation`` events around the ``aten::mm`` inside them; such a
    session writes no journal;
  * off (no env, no profiler), no ``Span``, no CUDA event and no
    ``record_function`` is made;
  * device times from stand-in CUDA events: ``None`` until the end event
    has completed, filled in by ``query()`` with no synchronize, the
    events reused from the pool, ``dl4j_span_device_seconds`` observed;
  * on the card (``gpu``): ``device_s`` resolves after a synchronize,
    the children's sum stays within the step's, and the spans add no
    synchronize to the trace of a fit.

This file imports no JAX; its card test runs from the repository root as

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_train_spans.py
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models.bert import BertConfig, BertMLM
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from deeplearning4j_tpu_torch.obs import journal as journal_mod
from deeplearning4j_tpu_torch.obs import trace
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
          max_len=32)
BERT = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
            max_len=32, mask_token_id=63)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


@pytest.fixture(autouse=True)
def journal(tmp_path, monkeypatch):
    """``DL4J_TPU_OBS`` unset, the gate not forced, a clear ring, and the
    process's journal made anew in ``tmp_path``, flushed at every
    append; the tracer's journal restored afterwards."""
    monkeypatch.delenv(obs.ENV_OBS, raising=False)
    monkeypatch.setenv("DL4J_TPU_OBS_JOURNAL", str(tmp_path / "flight.jsonl"))
    jr = obs.FlightRecorder(capacity=4096, flush_interval_s=0.0)
    monkeypatch.setattr(journal_mod, "_DEFAULT", jr)
    tr = obs.tracer()
    before = tr._journal
    tr.attach(journal=jr)
    obs.set_enabled(None)
    tr.clear()
    try:
        yield jr
    finally:
        obs.set_enabled(None)
        tr._journal = before


def lm_and_batches(device="cpu", k=3, **cfg):
    lm = TransformerLM(TransformerConfig(**{**LM, **cfg}), device=device)
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, LM["vocab_size"], (k, 4, 17)),
                          device=device)
    return lm, ids[:, :, :-1], ids[:, :, 1:]


def bert_and_batches(k=3):
    mlm = BertMLM(BertConfig(**BERT), device="cpu")
    rng = np.random.default_rng(6)
    return mlm, rng.integers(1, BERT["vocab_size"] - 1, (k, 4, 16))


def run(model, call, k=3):
    """``k`` steps of ``model`` ("lm" or "bert") by ``fit`` one at a time
    or by one ``fit_batches``: (the object, the losses as floats)."""
    if model == "lm":
        lm, x, y = lm_and_batches(k=k)
        if call == "fit":
            losses = [float(lm.fit(x[i], y[i])) for i in range(k)]
        else:
            losses = [float(v) for v in lm.fit_batches(x, y)]
        return lm, losses
    mlm, toks = bert_and_batches(k)
    if call == "fit":
        return mlm, [mlm.fit(toks[i]) for i in range(k)]
    return mlm, [mlm.fit_batches(toks)]


def tree(spans):
    """{train.step span id: [its children's names in finish order]}."""
    steps = [s for s in spans if s["name"] == "train.step"]
    return {s["span_id"]: [c["name"] for c in spans
                           if c["parent_id"] == s["span_id"]]
            for s in steps}


# ---------------------------------------------------------------------------
# the tree of spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["lm", "bert"])
@pytest.mark.parametrize("call", ["fit", "fit_batches"])
def test_fit_makes_the_tree_of_spans(model, call):
    obs.set_enabled(True)
    obj, _ = run(model, call, k=2)
    spans = obs.tracer().spans()
    steps = [s for s in spans if s["name"] == "train.step"]
    one = ["train.forward", "train.backward", "train.optimizer"]
    tail = ["train.readback"] if model == "bert" else []
    if call == "fit":
        assert len(steps) == 2
        want = ["train.prepare"] + one + tail
    else:
        assert len(steps) == 1
        want = ["train.prepare"] + one + one + tail
    assert list(tree(spans).values()) == [want] * len(steps)
    for s in steps:
        assert s["parent_id"] is None
        assert s["attrs"]["steps"] == (1 if call == "fit" else 2)
        per = s["attrs"]["steps"]
        assert s["attrs"]["rows"] == 4 * per
        assert s["attrs"]["tokens"] == 4 * 16 * per
    n = len(tree_leaves(obj.params))
    assert [o["attrs"] for o in obs.tracer().spans("train.optimizer")] == [
        {"leaves": n}] * 2
    # every span is a host span on the CPU: no device time is claimed
    assert all("device_s" not in s for s in spans)


@pytest.mark.parametrize("model", ["lm", "bert"])
def test_params_bit_equal_with_spans_on_and_off(model):
    obs.set_enabled(False)
    off, off_losses = run(model, "fit")
    assert obs.tracer().spans() == []
    obs.set_enabled(True)
    on, on_losses = run(model, "fit")
    assert len(obs.tracer().spans("train.step")) == 3
    assert on_losses == off_losses
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(on.opt["m"]), tree_leaves(off.opt["m"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the profiler's gate and its trace
# ---------------------------------------------------------------------------


def test_profiler_gate_and_forced_off():
    assert not trace.spans_live()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.spans_live() and not obs.obs_enabled()
        with obs.span("inside"):
            pass
        obs.set_enabled(False)
        with obs.span("forced_off"):
            pass
        obs.set_enabled(None)
    assert not trace.spans_live()
    with obs.span("after"):
        pass
    assert [s["name"] for s in obs.tracer().spans()] == ["inside"]


def test_profiler_trace_holds_the_spans_around_their_operators(tmp_path):
    lm, x, y = lm_and_batches(k=2)
    lm.fit(x[0], y[0])
    assert obs.tracer().spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.fit(x[1], y[1])
    assert list(tree(obs.tracer().spans()).values()) == [
        ["train.prepare", "train.forward", "train.backward",
         "train.optimizer"]]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.prepare", "train.forward",
            "train.backward", "train.optimizer"} <= set(notes)
    mms = [e for e in events
           if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]

    def inside(e, note):
        a = float(note["ts"])
        return a <= float(e["ts"]) and (float(e["ts"]) + float(e["dur"])
                                        <= a + float(note["dur"]))

    for name in ("train.forward", "train.backward"):
        assert any(inside(e, notes[name]) for e in mms), name
        assert inside(notes[name], notes["train.step"]), name
    assert not any(inside(e, notes["train.prepare"]) for e in mms)


def test_profiler_only_session_writes_no_journal(journal):
    lm, x, y = lm_and_batches(k=2)
    with profile(activities=[ProfilerActivity.CPU]):
        lm.fit(x[0], y[0])
    assert obs.tracer().spans("train.step")
    assert journal.events() == []
    assert journal.flush() is None
    assert not os.path.exists(journal.path)
    # the same journal receives the spans under DL4J_TPU_OBS
    obs.set_enabled(True)
    lm.fit(x[1], y[1])
    assert {e["name"] for e in journal.events("span")} >= {
        "train.step", "train.forward"}


def test_off_makes_no_span_event_or_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while the gate is off")

    monkeypatch.setattr(trace, "Span", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    run("lm", "fit", k=2)
    run("bert", "fit_batches", k=2)
    assert obs.tracer().spans() == []
    # the same stand-ins refuse a live span: the check above is real
    obs.set_enabled(True)
    with pytest.raises(AssertionError):
        run("lm", "fit", k=1)


# ---------------------------------------------------------------------------
# device times from stand-in events
# ---------------------------------------------------------------------------


class FakeEvent:
    """A CUDA timing event stand-in: ``record`` stamps the next tick of a
    shared clock (1 ms a tick); ``query`` is true once the test marks the
    clock as reached."""

    made = 0
    clock = 0
    reached = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def query(self):
        return self.t <= FakeEvent.reached

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return float(end.t - self.t)

    def synchronize(self):
        raise AssertionError("a span waited for the device")


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made = FakeEvent.clock = FakeEvent.reached = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", FakeEvent.synchronize)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return FakeEvent


def test_device_time_resolves_by_query_and_reuses_events(fake_cuda):
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    tr = obs.Tracer(capacity=64, registry=reg)
    with tr.span("outer", device=True):        # events at ticks 1 and 4
        with tr.span("inner", device=True):    # ticks 2 and 3
            pass
        with tr.span("host"):
            pass
    by = {s["name"]: s for s in tr.spans()}
    assert by["outer"]["device_s"] is None and by["inner"]["device_s"] is None
    assert "device_s" not in by["host"]
    fake_cuda.reached = 3                      # inner done, outer not
    by = {s["name"]: s for s in tr.spans()}
    assert by["inner"]["device_s"] == pytest.approx(1e-3)
    assert by["outer"]["device_s"] is None
    fake_cuda.reached = 4
    by = {s["name"]: s for s in tr.spans()}
    assert by["outer"]["device_s"] == pytest.approx(3e-3)
    assert fake_cuda.made == 4
    text = reg.render_prometheus()
    assert 'dl4j_span_device_seconds_count{span="inner"}' in text
    assert 'dl4j_span_device_seconds_count{span="outer"}' in text
    # the four events come back from the pool; none is made anew
    for _ in range(3):
        with tr.span("again", device=True):
            pass
        fake_cuda.reached = fake_cuda.clock
    tr.spans()
    assert fake_cuda.made == 4
    assert all(s["device_s"] == pytest.approx(1e-3)
               for s in tr.spans("again"))


def test_an_attribute_the_device_fills_reads_once_the_span_resolves(
        fake_cuda):
    """A host tensor given as an attribute (a copy on the span's stream
    fills it) reads None until the span's end event has completed, then
    its number; the journal-free ring holds no tensor."""
    tr = obs.Tracer(capacity=8)
    host = torch.zeros((), dtype=torch.int64)
    with tr.span("filled", device=True, kept=3) as sp:
        sp.set_attr("rows", host)
        host.fill_(7)  # the copy, before the span's end event
    first = tr.spans()[0]
    assert first["attrs"] == {"kept": 3, "rows": None}
    fake_cuda.reached = fake_cuda.clock
    assert tr.spans()[0]["attrs"] == {"kept": 3, "rows": 7}


def test_no_events_inside_a_graph_capture(fake_cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    tr = obs.Tracer(capacity=8)
    with tr.span("captured", device=True):
        pass
    assert fake_cuda.made == 0
    assert "device_s" not in tr.spans()[0]


def test_lm_fit_records_device_times_without_a_synchronize(fake_cuda):
    with profile(activities=[ProfilerActivity.CPU]):
        run("lm", "fit", k=2)
    pending = [s for s in obs.tracer().spans() if "device_s" in s]
    assert {s["name"] for s in pending} == {
        "train.step", "train.forward", "train.backward", "train.optimizer"}
    assert all(s["device_s"] is None for s in pending)
    fake_cuda.reached = fake_cuda.clock
    for s in obs.tracer().spans():
        if "device_s" in s:
            assert s["device_s"] > 0
    for sid, kids in tree(obs.tracer().spans()).items():
        step = next(s for s in obs.tracer().spans() if s["span_id"] == sid)
        inner = sum(s["device_s"] for s in obs.tracer().spans()
                    if s["parent_id"] == sid and "device_s" in s)
        assert inner <= step["device_s"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _sync_calls(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "cuda_runtime" and e["name"] in SYNCS)


@pytest.mark.gpu
def test_device_spans_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    lm, x, y = lm_and_batches(device=dev, k=3, use_flash=False)
    lm.fit(x[0], y[0])
    torch.cuda.synchronize()
    counts = {}
    for on, i in ((False, 1), (True, 2)):
        obs.set_enabled(None if on else False)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lm.fit(x[i], y[i])
        finally:
            obs.set_enabled(None)
        torch.cuda.synchronize()
        path = tmp_path / f"trace-{on}.json"
        prof.export_chrome_trace(str(path))
        counts[on] = _sync_calls(path)
    assert counts[True] == counts[False], counts
    spans = obs.tracer().spans()
    (step,) = [s for s in spans if s["name"] == "train.step"]
    kids = {s["name"]: s["device_s"] for s in spans
            if s["parent_id"] == step["span_id"] and "device_s" in s}
    assert set(kids) == {"train.forward", "train.backward",
                         "train.optimizer"}
    assert all(v is not None and v > 0 for v in kids.values()), kids
    assert step["device_s"] is not None and step["device_s"] > 0
    assert sum(kids.values()) <= step["device_s"]
