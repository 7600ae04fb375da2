"""Structured span tracer: the default-off timeline of the serving path
(counterpart: ``deeplearning4j_tpu/obs/trace.py``, all of it).

A Dapper-style span tracer over the seams the port instruments:

  serve.request    one per engine entry point (``/predict``, ``/embed``,
                   ``/search``, ``/generate`` and its stream,
                   ``/prefill``), with the request id ``rid``
  serve.batch      one per coalesced ``/predict`` or ``/embed`` dispatch
                   (its member ``request_ids``) and one per decode tick
                   (``kind`` "decode.paged" with ``lanes`` and ``tick_k``,
                   or "decode.spec" with ``spec_k``)

Spans are HOST-SIDE events only: a span around a kernel launch measures
the host's side of it, never the device. No span calls
``torch.cuda.synchronize()`` (a per-dispatch sync would serialize the
very pipeline this tracer observes); the serving paths' own read-backs
(``.cpu()`` of the answer) already end the spans that wrap them. Timing
uses the monotonic clock (``time.perf_counter``); ids are process-local
integers.

Gate: ``DL4J_TPU_OBS`` (default OFF), read at every call. Disabled,
:func:`span` returns a shared null context — one env lookup and one
branch per call site, no Span objects, no ring writes — so a fit or a
``/predict`` gives the same bits with obs on and off
(``tests/test_torch_obs.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.ops import env as envknob

ENV_OBS = "DL4J_TPU_OBS"
ENV_SPANS = "DL4J_TPU_OBS_SPANS"

_ON = ("1", "on", "true", "yes")

# programmatic override (tests and the chip smoke toggle without relying
# on env mutation ordering): None = defer to the env
_forced: Optional[bool] = None


def obs_enabled() -> bool:
    """The observability gate, read at CALL time (per span) so a single
    process can measure with and without it honestly."""
    if _forced is not None:
        return _forced
    return envknob.raw(ENV_OBS).strip().lower() in _ON


def set_enabled(value: Optional[bool]) -> None:
    """Force the gate on/off programmatically; ``None`` restores the env
    decision."""
    global _forced
    _forced = value


class Span:
    """One timed operation: name, id, parent id, monotonic start/end,
    free-form attributes. Mutable only through :meth:`set_attr` while
    open; finished spans live in the tracer ring as plain dicts."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "attrs",
                 "wall")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.wall = time.time()  # correlation with external logs only
        self.start = time.perf_counter()
        self.end: Optional[float] = None

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
    becomes its child)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack().append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        sp.end = time.perf_counter()
        if exc_type is not None:
            sp.attrs["error"] = exc_type.__name__
        stack = self._tracer._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        self._tracer._finish(sp)
        return False


class Tracer:
    """Span factory + bounded ring of finished spans.

    Finished spans fan out to the flight-recorder journal (obs/journal)
    and a duration histogram in the metrics registry (obs/registry) —
    one instrumentation point, three read surfaces (ring for tests and
    debugging, journal for post-mortem timelines, histogram for export).
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
    def span(self, name: str, **attrs) -> _SpanCtx:
        parent = self._stack()[-1].span_id if self._stack() else None
        return _SpanCtx(self, Span(name, next(self._ids), parent, attrs))

    def record_span(self, name: str, seconds: float, **attrs) -> None:
        """A completed span recorded after the fact — for waits measured
        inline, where wrapping the wait in a context manager would
        restructure the hot loop."""
        sp = Span(name, next(self._ids), None, attrs)
        sp.start -= float(seconds)
        sp.wall -= float(seconds)
        sp.end = sp.start + float(seconds)
        self._finish(sp)

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _finish(self, sp: Span) -> None:
        d = sp.to_dict()
        with self._lock:
            self._ring.append(d)
        journal = self._journal
        if journal is not None:
            # light-path append: the span dict is already timestamped
            journal.append(dict(d, kind="span"))
        registry = self._registry
        if registry is not None and sp.end is not None:
            registry.histogram("dl4j_span_seconds", sp.end - sp.start,
                               span=sp.name)

    # -- reading ----------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
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


def span(name: str, **attrs):
    """THE instrumentation entry point: a context manager yielding a Span
    when obs is enabled, the shared null context otherwise. The disabled
    path is one env read + one branch — cheap enough for the per-dispatch
    hot path this plane instruments."""
    if not obs_enabled():
        return _NULL_CTX
    return tracer().span(name, **attrs)


def record_span(name: str, seconds: float, **attrs) -> None:
    """Gated after-the-fact span recording (see Tracer.record_span)."""
    if obs_enabled():
        tracer().record_span(name, seconds, **attrs)
