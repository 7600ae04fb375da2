"""MetricsRegistry: one sample space over the stats ledgers, exported as
Prometheus text (counterpart: ``deeplearning4j_tpu/obs/registry.py``, all
of it; ``PROMETHEUS_CONTENT_TYPE`` from ``obs/exporter.py`` :35).

Ledgers (anything with ``snapshot()``: ``serving_stats``,
``retrieval_stats``, a container's ``dispatch_stats``) register here and
become views the registry flattens at scrape time into gauges named
``dl4j_<ledger>_<path>`` with an ``owner`` label ("ServingEngine#0").
First-class counters, gauges and histograms exist for metrics born here
(the serving latency buckets, the tracer's span durations).
:func:`register_net` adopts every ``*_stats`` attribute of a container;
the MultiLayerNetwork, the ComputationGraph and ``QuantizedNet`` call it
at construction, as the JAX package's do.

:meth:`render_prometheus` emits text exposition format 0.0.4: label
escaping, cumulative buckets with ``+Inf``, ``_total`` counter naming,
HELP/TYPE metadata — served by the engine's ``/metrics`` and the
standalone :class:`~deeplearning4j_tpu_torch.obs.exporter.MetricsExporter`.
A scrape snapshots each ledger through its own lock and never mutates
it. Owners are held by weak reference and pruned when they die.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

# the Content-Type of text exposition format 0.0.4 (the JAX package's
# obs/exporter.py :35)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# serving latency / span duration ladder (seconds): sub-millisecond to
# 10 s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _sanitize(segment: str) -> str:
    out = []
    for ch in str(segment):
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    return s if (s and not s[0].isdigit()) else "_" + s


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline (exposition format spec, in this order — escaping the quote
    first would double-escape the backslashes it introduces)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(labels: _LabelKey, extra: Optional[str] = None) -> str:
    parts = [f'{k}="{escape_label_value(v)}"' for k, v in labels]
    if extra is not None:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class _LedgerEntry:
    __slots__ = ("owner_ref", "owner_label", "name", "ledger")

    def __init__(self, owner_ref, owner_label: str, name: str, ledger):
        self.owner_ref = owner_ref
        self.owner_label = owner_label
        self.name = name
        self.ledger = ledger


class MetricsRegistry:
    """See module docstring. Thread-safe; one instance is the process
    default (:func:`default_registry`) that nets, stores and serving
    engines register into, so ONE scrape covers the whole process."""

    def __init__(self) -> None:
        # RLock, not Lock: weakref.finalize callbacks (_drop_owner) can
        # fire during a gc triggered by an allocation INSIDE a locked
        # section on the same thread — a plain Lock would self-deadlock
        self._lock = threading.RLock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], _Histogram] = {}
        self._help: Dict[str, str] = {}
        # (id(owner), ledger name) -> entry; owner held weakly
        self._ledgers: Dict[Tuple[int, str], _LedgerEntry] = {}
        self._owner_labels: Dict[int, str] = {}
        self._owner_seq: Dict[str, int] = {}

    # -- first-class metrics ----------------------------------------------
    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        """Increment a monotonic counter (negative increments raise — the
        monotonicity contract the Prometheus scraper depends on)."""
        if value < 0:
            raise ValueError(f"counter {name} increment must be >= 0")
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = float(value)

    def histogram(self, name: str, value: float,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = _Histogram(tuple(buckets) if buckets is not None
                               else DEFAULT_BUCKETS)
                self._hists[key] = h
            h.observe(value)

    def set_help(self, name: str, text: str) -> None:
        with self._lock:
            self._help[name] = text

    # -- ledger adoption ---------------------------------------------------
    def register_ledger(self, owner, name: str, ledger) -> None:
        """Adopt an existing stats ledger (anything with ``snapshot()``
        or a plain dict) as a registry view. Idempotent per (owner,
        name); re-registering replaces the ledger object."""
        with self._lock:
            oid = id(owner)
            label = self._owner_labels.get(oid)
            if label is None:
                cls = type(owner).__name__
                seq = self._owner_seq.get(cls, 0)
                self._owner_seq[cls] = seq + 1
                label = f"{cls}#{seq}"
                self._owner_labels[oid] = label
                # prune the label map when the owner dies (id() values
                # are reused after gc — a stale entry would mislabel the
                # next object allocated at the same address)
                try:
                    weakref.finalize(owner, self._drop_owner, oid)
                except TypeError:
                    pass  # non-weakrefable owners just stay keyed by id
            try:
                ref = weakref.ref(owner)
            except TypeError:
                ref = lambda _o=owner: _o  # noqa: E731 — strong fallback
            self._ledgers[(oid, name)] = _LedgerEntry(ref, label, name,
                                                      ledger)

    def _drop_owner(self, oid: int) -> None:
        with self._lock:
            self._owner_labels.pop(oid, None)
            for key in [k for k in self._ledgers if k[0] == oid]:
                del self._ledgers[key]

    def register_net(self, net) -> None:
        """Register every ``*_stats`` ledger currently attached to a
        container — the one adoption hook the containers call, so a NEW
        ledger following the naming convention is picked up without
        touching this module (tests/test_torch_obs.py asserts the
        convention holds)."""
        for attr, val in list(vars(net).items()):
            if attr.endswith("_stats") and val is not None:
                self.register_ledger(net, attr, val)

    def ledgers(self, owner=None) -> Dict[str, Any]:
        """name -> ledger for one owner (or 'label/name' -> ledger for
        all) — the registration-assertion surface for tests."""
        with self._lock:
            if owner is not None:
                return {e.name: e.ledger for (oid, _), e in
                        self._ledgers.items() if oid == id(owner)}
            return {f"{e.owner_label}/{e.name}": e.ledger
                    for e in self._ledgers.values()}

    # -- collection --------------------------------------------------------
    @staticmethod
    def _ledger_snapshot(ledger) -> Dict[str, Any]:
        if hasattr(ledger, "snapshot"):
            return ledger.snapshot()
        return dict(ledger)

    @staticmethod
    def _flatten(prefix: str, obj, out: List[Tuple[str, float]]) -> None:
        """Numeric leaves of a snapshot dict -> (metric_name, value),
        path segments sanitized and joined with '_'. Strings/None and
        other non-numerics are dropped (provenance labels ride the JSON
        surface, not the sample space)."""
        if isinstance(obj, bool):
            out.append((prefix, 1.0 if obj else 0.0))
        elif isinstance(obj, (int, float)):
            out.append((prefix, float(obj)))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                MetricsRegistry._flatten(f"{prefix}_{_sanitize(k)}", v, out)

    def collect_ledger_samples(self) -> List[Tuple[str, _LabelKey, float]]:
        with self._lock:
            entries = list(self._ledgers.items())
        out: List[Tuple[str, _LabelKey, float]] = []
        dead: List[Tuple[int, str]] = []
        for key, e in entries:
            if e.owner_ref() is None:
                dead.append(key)
                continue
            base = e.name[:-len("_stats")] if e.name.endswith("_stats") \
                else e.name
            flat: List[Tuple[str, float]] = []
            try:
                self._flatten(f"dl4j_{_sanitize(base)}",
                              self._ledger_snapshot(e.ledger), flat)
            except Exception:  # noqa: BLE001 — a scrape never crashes its owner
                continue
            labels = _labels_key({"owner": e.owner_label})
            out.extend((name, labels, v) for name, v in flat)
        if dead:
            with self._lock:
                for key in dead:
                    self._ledgers.pop(key, None)
        return out

    # -- export ------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4. One atomic pass: first-class
        metrics are copied under the lock, ledger views snapshot through
        their own locks — the rendered page is internally consistent per
        metric family."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (h.buckets, h.cumulative(), h.sum, h.count)
                     for k, h in self._hists.items()}
            helps = dict(self._help)
        lines: List[str] = []

        def emit_meta(name: str, mtype: str) -> None:
            if name in helps:
                text = helps[name].replace("\\", "\\\\").replace("\n",
                                                                 "\\n")
                lines.append(f"# HELP {name} {text}")
            lines.append(f"# TYPE {name} {mtype}")

        by_name: Dict[str, List[Tuple[_LabelKey, float]]] = {}
        for (name, labels), v in sorted(counters.items()):
            by_name.setdefault(name, []).append((labels, v))
        for name in sorted(by_name):
            emit_meta(name, "counter")
            for labels, v in by_name[name]:
                lines.append(f"{name}_total{_render_labels(labels)} "
                             f"{_fmt(v)}")

        by_name = {}
        for (name, labels), v in sorted(gauges.items()):
            by_name.setdefault(name, []).append((labels, v))
        for name in sorted(by_name):
            emit_meta(name, "gauge")
            for labels, v in by_name[name]:
                lines.append(f"{name}{_render_labels(labels)} {_fmt(v)}")

        by_hist: Dict[str, List[Tuple[_LabelKey, tuple]]] = {}
        for (name, labels), data in sorted(hists.items()):
            by_hist.setdefault(name, []).append((labels, data))
        for name in sorted(by_hist):
            emit_meta(name, "histogram")
            for labels, (buckets, cum, total, count) in by_hist[name]:
                for b, c in zip(buckets, cum[:-1]):
                    le = _render_labels(labels, f'le="{_fmt(b)}"')
                    lines.append(f"{name}_bucket{le} {c}")
                le = _render_labels(labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{le} {cum[-1]}")
                lines.append(f"{name}_sum{_render_labels(labels)} "
                             f"{_fmt(total)}")
                lines.append(f"{name}_count{_render_labels(labels)} "
                             f"{count}")

        ledger_by_name: Dict[str, List[Tuple[_LabelKey, float]]] = {}
        for name, labels, v in self.collect_ledger_samples():
            ledger_by_name.setdefault(name, []).append((labels, v))
        for name in sorted(ledger_by_name):
            # ledger views export as gauges: a snapshot holds monotone
            # counts and levels (queue_depth) alike, and a ledger
            # replaced mid-run may reset — gauge is the honest claim
            emit_meta(name, "gauge")
            for labels, v in sorted(ledger_by_name[name]):
                lines.append(f"{name}{_render_labels(labels)} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able full dump (the exporter's /metrics.json surface)."""
        with self._lock:
            counters = {name: {"+".join(f"{k}={v}" for k, v in labels)
                               or "_": val
                               for (n2, labels), val in
                               self._counters.items() if n2 == name}
                        for name in {n for n, _ in self._counters}}
            gauges = {name: {"+".join(f"{k}={v}" for k, v in labels)
                             or "_": val
                             for (n2, labels), val in self._gauges.items()
                             if n2 == name}
                      for name in {n for n, _ in self._gauges}}
            hists = {}
            for (name, labels), h in self._hists.items():
                hists.setdefault(name, {})[
                    "+".join(f"{k}={v}" for k, v in labels) or "_"] = {
                        "buckets": list(h.buckets),
                        "counts": list(h.counts),
                        "sum": h.sum,
                        "count": h.count,
                }
            entries = list(self._ledgers.values())
        ledgers: Dict[str, Dict[str, Any]] = {}
        for e in entries:
            if e.owner_ref() is None:
                continue
            try:
                snap = self._ledger_snapshot(e.ledger)
            except Exception:  # noqa: BLE001 — a scrape never crashes its owner
                continue
            ledgers.setdefault(e.owner_label, {})[e.name] = snap
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "ledgers": ledgers}


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT


def register_net(net) -> None:
    """Module-level convenience the containers call (nn/multilayer.py,
    nn/graph.py and ops/lowprec.QuantizedNet at construction)."""
    default_registry().register_net(net)
