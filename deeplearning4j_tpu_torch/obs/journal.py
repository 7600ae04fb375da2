"""Flight-recorder journal: the last-N-events timeline a dead process
leaves (counterpart: ``deeplearning4j_tpu/obs/journal.py``, all of it).

A preempted or crashed serving process takes its in-memory telemetry
with it — the ledgers and the span ring die with the interpreter. This
module keeps a bounded in-memory ring of JSONL-able events that is

  * CHEAP to append (lock + deque append; no IO on the hot path),
  * periodically flushed (at most every ``DL4J_TPU_OBS_FLUSH_S``
    seconds, piggybacked on appends — an idle process writes nothing),
  * FSYNC'd where it matters: the engine's drain and a wedged dispatch
    flush it with ``fsync=True``,

so the post-mortem of a dead process starts from a readable timeline:
the last N spans, health transitions, drains, publishes, preemption.

Writes are atomic (tmp + rename) and flush-serialized: a crash
mid-flush leaves the previous journal, never a torn one. The file is
the RING, rewritten whole each flush — bounded size by construction
(``DL4J_TPU_OBS_JOURNAL_N`` events, default 4096, plus a small pinned
side ring). Rare MARKER events (any non-span kind: health transitions,
drains, publishes, preemption) are pinned in that side ring so a flood
of per-dispatch spans cannot evict the anchors a post-mortem needs.

Gated like the tracer: :func:`event` is a no-op unless ``DL4J_TPU_OBS``
is on, so instrumented modules call it unconditionally.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.ops import env as envknob

ENV_JOURNAL = "DL4J_TPU_OBS_JOURNAL"
ENV_JOURNAL_N = "DL4J_TPU_OBS_JOURNAL_N"
ENV_FLUSH_S = "DL4J_TPU_OBS_FLUSH_S"


def default_journal_path() -> str:
    """Env path wins verbatim; the default gains a per-process suffix
    when ``DL4J_TPU_PROCESS_ID`` names this process's rank: N processes
    sharing one cwd must not last-writer-wins clobber each other's
    timelines."""
    v = envknob.raw(ENV_JOURNAL).strip()
    if v:
        return v
    pid = envknob.raw("DL4J_TPU_PROCESS_ID").strip()
    suffix = f".p{pid}" if pid else ""
    return os.path.join(os.getcwd(), f".obs_journal{suffix}.jsonl")


class FlightRecorder:
    """Bounded event ring + crash-safe JSONL persistence."""

    def __init__(self, path: Optional[str] = None,
                 capacity: Optional[int] = None,
                 flush_interval_s: Optional[float] = None):
        self.path = path or default_journal_path()
        self.capacity = (capacity if capacity is not None
                         else max(16, envknob.get_int(ENV_JOURNAL_N)))
        self.flush_interval_s = (
            flush_interval_s if flush_interval_s is not None
            else envknob.get_float(ENV_FLUSH_S))
        self._lock = threading.Lock()
        # serializes the tmp-write+rename: concurrent flushes (a periodic
        # background flush racing the preemption fsync) share one tmp
        # path per pid — unserialized they would truncate each other's
        # half-written file and install a torn journal at the exact
        # moment it matters
        self._flush_lock = threading.Lock()
        self._bg_pending = False
        self._ring: deque = deque(maxlen=self.capacity)
        # non-span MARKER events (health transitions, drains, publishes,
        # preemption) ride a pinned side ring: per-dispatch spans enter
        # at hundreds/sec and would turn the main ring over in under a
        # minute, evicting exactly the rare events a post-mortem needs
        # to anchor the timeline
        self._markers: deque = deque(
            maxlen=min(self.capacity, max(16, self.capacity // 16)))
        self._seq = 0
        self._dirty = False
        self._last_flush = time.monotonic()
        self.flushes = 0

    # -- recording --------------------------------------------------------
    def record(self, kind: str, **fields) -> Dict[str, Any]:
        """Append one event to the ring. ``t`` is wall-clock (timeline
        correlation with external logs), ``mono`` the monotonic clock
        (durations across events of one process)."""
        ev = {"seq": None, "kind": kind, "t": round(time.time(), 6),
              "mono": round(time.perf_counter(), 6)}
        ev.update(fields)
        self.append(ev)
        return ev

    def append(self, ev: Dict[str, Any]) -> None:
        """Light-path append for PRE-stamped events — the tracer's
        finished spans already carry ``t_wall``/``t_mono``, so re-reading
        both clocks and merging a second dict would be pure hot-path
        waste. Assigns ``seq`` and rings; same flush policy as record."""
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            if ev.get("kind") != "span":
                self._markers.append(ev)
            self._dirty = True
            due = (time.monotonic() - self._last_flush
                   >= self.flush_interval_s and not self._bg_pending)
            if due:
                self._bg_pending = True
        if due:
            # periodic persistence runs on a short-lived daemon thread —
            # the recording thread (a batcher worker, a decode tick)
            # must never pay the multi-ms JSONL rewrite; only the
            # explicit drain/wedge flush is synchronous
            try:
                threading.Thread(target=self._bg_flush, daemon=True,
                                 name="obs-journal-flush").start()
            except RuntimeError:
                # interpreter teardown / thread exhaustion: journaling
                # is evidence, never a crash — and the pending flag must
                # not wedge shut or periodic flushing dies for good
                with self._lock:
                    self._bg_pending = False

    def _bg_flush(self) -> None:
        try:
            self.flush()
        finally:
            with self._lock:
                self._bg_pending = False

    # -- persistence ------------------------------------------------------
    def flush(self, fsync: bool = False) -> Optional[str]:
        """Rewrite the journal file from the ring (tmp + rename, optional
        fsync — the drain and wedge paths pass ``fsync=True`` so the
        timeline survives a power-off). Returns the path written, or None
        when there was nothing new."""
        with self._flush_lock:
            # ring snapshot INSIDE the flush lock: two racing flushes
            # must not let an older snapshot land after a newer one
            # (the file would regress to a stale timeline)
            with self._lock:
                if not self._dirty and not fsync:
                    return None
                events = self._merged_locked()
                self._dirty = False
                self._last_flush = time.monotonic()
            tmp = f"{self.path}.tmp-{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    for ev in events:
                        f.write(json.dumps(ev, default=str) + "\n")
                    f.flush()
                    if fsync:
                        os.fsync(f.fileno())
                os.replace(tmp, self.path)
                if fsync:
                    try:
                        fd = os.open(os.path.dirname(self.path) or ".",
                                     os.O_RDONLY)
                        try:
                            os.fsync(fd)
                        finally:
                            os.close(fd)
                    except OSError:
                        pass
            except OSError:
                # journaling is evidence, never a crash; no tmp litter
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
        with self._lock:
            self.flushes += 1
        return self.path

    def _merged_locked(self) -> List[Dict[str, Any]]:
        """Main ring + pinned markers, seq-ordered and deduped (a recent
        marker sits in both rings) — the one timeline every read surface
        and every flush presents."""
        merged = {e["seq"]: e for e in self._markers}
        merged.update({e["seq"]: e for e in self._ring})
        return [merged[s] for s in sorted(merged)]

    # -- reading ----------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = self._merged_locked()
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        """Read a journal back (post-mortem). Tolerates a torn final line
        (should not happen under the atomic flush, but a journal is the
        one file you read AFTER something already went wrong)."""
        out = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            return []
        return out


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_journal() -> FlightRecorder:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
    return _DEFAULT


def event(kind: str, **fields) -> None:
    """Gated event append: no-op unless DL4J_TPU_OBS is on, so the
    instrumented seams (health transitions, drain, publish, preemption)
    call it unconditionally."""
    from deeplearning4j_tpu_torch.obs.trace import obs_enabled

    if obs_enabled():
        default_journal().record(kind, **fields)


def flush(fsync: bool = False) -> Optional[str]:
    """Gated flush — the drain and wedge paths' one-liner."""
    from deeplearning4j_tpu_torch.obs.trace import obs_enabled

    if obs_enabled():
        return default_journal().flush(fsync=fsync)
    return None
