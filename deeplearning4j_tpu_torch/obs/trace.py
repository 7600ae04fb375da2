"""Structured span tracer: the default-off timeline of the serving and
training paths (counterpart: ``deeplearning4j_tpu/obs/trace.py``, all of
it, plus the profiler gate, the annotations and the device times below).

A Dapper-style span tracer over the seams the port instruments:

  serve.request    one per engine entry point (``/predict``, ``/embed``,
                   ``/search``, ``/generate`` and its stream,
                   ``/prefill``), with the request id ``rid``
  serve.batch      one per coalesced ``/predict`` or ``/embed`` dispatch
                   (its member ``request_ids``) and one per decode tick
                   (``kind`` "decode.paged" with ``lanes`` and ``tick_k``,
                   or "decode.spec" with ``spec_k``)
  fleet.*, etl.*,  the router, the elastic fleet, the input pipeline and
  ckpt.*           the checkpoint writer
  train.step       one per ``fit`` / ``fit_batches`` of ``TransformerLM``
                   and ``BertMLM`` (``steps``, ``rows``, ``tokens``: the
                   batch's positions, pad included), on the device too
  train.prepare    the step's input conversion: ``TransformerLM._tokens``,
                   ``BertMLM``'s host masking and copies to the card
  train.forward    ``value_and_grad``'s loss, on the device too
  train.backward   ``value_and_grad``'s ``torch.autograd.grad``, on the
                   device too
  train.optimizer  ``_adam_update``, the clip included (``leaves``), on
                   the device too
  train.allreduce  the mean of the loss and the gradients over a
                   ``'data'`` (or sequence, pipeline) group after the
                   backward (``leaves``, ``bytes``), on the device too
  train.moe        one expert layer's forward of the held-expert MoE
                   (``experts_held``, ``rows_routed``), on the device too;
                   none in an activation checkpoint's recompute
  train.readback   ``BertMLM``'s read of the loss

The ``train.*`` spans below ``train.step`` sit in the shared step code,
so every caller of ``value_and_grad`` and ``_adam_update`` (the MoE,
Megatron, ring and pipeline steps, BERT's classifier) records them too.

Gate, read at every call: a span is live while ``DL4J_TPU_OBS`` is on or
while a ``torch.profiler`` records in this process
(``torch.autograd.profiler._is_profiler_enabled``); :func:`set_enabled`
forces it either way. Off, :func:`span` returns a shared null context —
one flag read, one env read and one branch per call site: no Span, no
``record_function``, no CUDA event — so a fit or a ``/predict`` gives
the same bits with obs on and off (``tests/test_torch_obs.py``,
``tests/test_torch_train_spans.py``). Only ``DL4J_TPU_OBS`` feeds the
journal: a session where only the profiler records writes no file.

Each live span also opens ``torch.profiler.record_function(name)``: in a
profiler's trace it is a ``user_annotation`` event on the profiler's own
clock, beside the operators and kernels it encloses (and a
``gpu_user_annotation`` extent on the stream's row). A span opened with
``device=True`` records a CUDA timing event on the current stream when
it is entered and one when it exits (where CUDA is initialised and the
stream is not being captured into a graph; the events come from a small
pool); its ``device_s`` is the time between them, ``None`` until both
have completed. The host times on ``time.perf_counter``. An attribute
of a device span may be a host tensor that a copy on the span's stream
fills (``non_blocking``, into pinned memory, inside the span): it reads
as ``None`` until the span's end event has completed and as its number
(or list) from then on.

No span synchronizes. A device time is filled in by ``Event.query()``
when a later span finishes and when :meth:`Tracer.spans` is read, and
observed then into ``dl4j_span_device_seconds``, beside the host
``dl4j_span_seconds``; the serving paths' own read-backs (``.cpu()`` of
the answer) end the spans that wrap them. Ids are process-local
integers.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from deeplearning4j_tpu_torch.ops import env as envknob

ENV_OBS = "DL4J_TPU_OBS"
ENV_SPANS = "DL4J_TPU_OBS_SPANS"

_ON = ("1", "on", "true", "yes")

# programmatic override (tests and the chip smoke toggle without relying
# on env mutation ordering): None = defer to the env and the profiler
_forced: Optional[bool] = None


def obs_enabled() -> bool:
    """The observability gate (``DL4J_TPU_OBS``: the journal, events,
    spans), read at CALL time (per span) so a single process can measure
    with and without it honestly."""
    if _forced is not None:
        return _forced
    return envknob.raw(ENV_OBS).strip().lower() in _ON


def spans_live() -> bool:
    """The span gate: :func:`obs_enabled`, or a ``torch.profiler``
    recording in this process."""
    return (_forced is None and _profiler._is_profiler_enabled) \
        or obs_enabled()


def set_enabled(value: Optional[bool]) -> None:
    """Force the gate on/off programmatically, the profiler's half too;
    ``None`` restores the env and profiler decision."""
    global _forced
    _forced = value


class Span:
    """One timed operation: name, id, parent id, monotonic start/end,
    free-form attributes, and the device time of a ``device=True`` span
    once its events have completed. Mutable only through
    :meth:`set_attr` while open; finished spans live in the tracer ring
    as plain dicts."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "attrs",
                 "wall", "device_s")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.wall = time.time()  # correlation with external logs only
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.device_s: Optional[float] = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_wall": round(self.wall, 6),
            "t_mono": round(self.start, 6),
            "duration_s": (None if self.end is None
                           else round(self.end - self.start, 6)),
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The disabled-path span: every mutator is a no-op so call sites
    keep ONE code path (``with span(...) as sp: ... sp.set_attr(...)``)
    whether obs is on or off."""

    __slots__ = ()
    name = None
    span_id = None
    parent_id = None

    def set_attr(self, key, value):
        pass


NULL_SPAN = _NullSpan()


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Context manager for one live span; pushes/pops the thread-local
    parent stack so nested spans parent automatically (a span opened
    inside the batcher worker's ``serve.batch`` span on that same thread
    becomes its child), opens the span's ``record_function`` and, for a
    device span, records its two CUDA events."""

    __slots__ = ("_tracer", "_span", "_device", "_annotation", "_start")

    def __init__(self, tracer: "Tracer", span: Span, device: bool):
        self._tracer = tracer
        self._span = span
        self._device = device
        self._annotation = None
        self._start = None

    def __enter__(self) -> Span:
        sp = self._span
        self._tracer._stack().append(sp)
        self._annotation = _profiler.record_function(sp.name)
        self._annotation.__enter__()
        if self._device:
            self._start = self._tracer._record_event()
        sp.start = time.perf_counter()
        return sp

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        end = (self._tracer._record_event() if self._start is not None
               else None)
        sp.end = time.perf_counter()
        if exc_type is not None:
            sp.attrs["error"] = exc_type.__name__
        stack = self._tracer._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        try:
            self._tracer._finish(sp, self._start, end)
        finally:
            # the tracer's own work stays under the span's annotation
            self._annotation.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """Span factory + bounded ring of finished spans.

    Finished spans fan out to the flight-recorder journal (obs/journal,
    under ``DL4J_TPU_OBS`` only) and duration histograms in the metrics
    registry (obs/registry): ``dl4j_span_seconds`` at the finish,
    ``dl4j_span_device_seconds`` once a device span's events have
    completed — one instrumentation point, three read surfaces (ring for
    tests, debugging and the benchmark's readers, journal for post-mortem
    timelines, histograms for export). The journal keeps a span as it
    finished, before its device time is known.
    """

    def __init__(self, capacity: Optional[int] = None, *,
                 registry=None, journal=None):
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=capacity if capacity is not None
            else envknob.get_int(ENV_SPANS))
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._registry = registry
        self._journal = journal
        # device spans whose events have not completed, in finish order:
        # (Span, its ring dict, start event, end event)
        self._pending: deque = deque()
        # idle timing events by device index
        self._event_pool: Dict[int, List[Any]] = {}

    # -- wiring (lazy: obs/__init__ connects the default singletons) ------
    def attach(self, *, registry=None, journal=None) -> None:
        if registry is not None:
            self._registry = registry
        if journal is not None:
            self._journal = journal

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    # -- recording --------------------------------------------------------
    def span(self, name: str, device: bool = False, **attrs) -> _SpanCtx:
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        return _SpanCtx(self, Span(name, next(self._ids), parent, attrs),
                        device)

    def record_span(self, name: str, seconds: float, **attrs) -> None:
        """A completed span recorded after the fact — for waits measured
        inline, where wrapping the wait in a context manager would
        restructure the hot loop."""
        sp = Span(name, next(self._ids), None, attrs)
        sp.start -= float(seconds)
        sp.wall -= float(seconds)
        sp.end = sp.start + float(seconds)
        self._finish(sp)

    def _record_event(self):
        """A timing event from the pool recorded on the current stream,
        or None where CUDA is not initialised or the stream is being
        captured into a graph."""
        if (not torch.cuda.is_initialized()
                or torch.cuda.is_current_stream_capturing()):
            return None
        dev = torch.cuda.current_device()
        with self._lock:
            pool = self._event_pool.setdefault(dev, [])
            ev = pool.pop() if pool else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return (dev, ev)

    def _finish(self, sp: Span, start=None, end=None) -> None:
        """Ring, journal, histogram; a device span (``start`` and ``end``
        its ``(device, event)`` pairs) waits in ``_pending``."""
        d = sp.to_dict()
        filled = {k: v for k, v in d["attrs"].items()
                  if isinstance(v, torch.Tensor)}
        if filled:  # read once the device has filled them (_resolve)
            d["attrs"].update(dict.fromkeys(filled))
        with self._lock:
            self._ring.append(d)
            if end is not None:
                d["device_s"] = None
                self._pending.append((sp, d, start, end, filled))
        journal = self._journal
        if journal is not None and obs_enabled():
            # light-path append: the span dict is already timestamped
            journal.append(dict(d, kind="span"))
        registry = self._registry
        if registry is not None and sp.end is not None:
            registry.histogram("dl4j_span_seconds", sp.end - sp.start,
                               span=sp.name)
        self._resolve()

    def _resolve(self) -> None:
        """Fill in the device time of every pending span whose events
        have completed, oldest first, without waiting: stops at the first
        whose end event has not (the events of one stream complete in the
        order they were recorded)."""
        done = []
        with self._lock:
            while self._pending:
                sp, d, (dev, start), (_, end), filled = self._pending[0]
                if not end.query():
                    break
                self._pending.popleft()
                sp.device_s = d["device_s"] = (
                    start.elapsed_time(end) * 1e-3)
                d["attrs"].update({k: v.tolist() for k, v in filled.items()})
                self._event_pool.setdefault(dev, []).extend((start, end))
                done.append(sp)
        registry = self._registry
        if registry is not None:
            for sp in done:
                registry.histogram("dl4j_span_device_seconds", sp.device_s,
                                   span=sp.name)

    # -- reading ----------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        self._resolve()
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer, wired to the default registry/journal on
    first use (lazy so importing the instrumented modules never pays for
    the whole obs plane)."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                from deeplearning4j_tpu_torch.obs import journal as journal_mod
                from deeplearning4j_tpu_torch.obs import registry as registry_mod

                _TRACER = Tracer(
                    registry=registry_mod.default_registry(),
                    journal=journal_mod.default_journal())
    return _TRACER


def span(name: str, device: bool = False, **attrs):
    """THE instrumentation entry point: a context manager yielding a Span
    while :func:`spans_live`, the shared null context otherwise. The
    disabled path is one flag read, one env read and a branch — cheap
    enough for the per-dispatch and per-step hot paths this plane
    instruments. ``device=True`` also times the span on the card."""
    if not spans_live():
        return _NULL_CTX
    return tracer().span(name, device, **attrs)


def record_span(name: str, seconds: float, **attrs) -> None:
    """Gated after-the-fact span recording (see Tracer.record_span): a
    span recorded after the fact has no annotation in a profiler's
    trace, so only ``DL4J_TPU_OBS`` records it."""
    if obs_enabled():
        tracer().record_span(name, seconds, **attrs)
