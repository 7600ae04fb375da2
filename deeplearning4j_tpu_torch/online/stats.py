"""Online telemetry: the ``online_stats`` ledger (counterpart:
``deeplearning4j_tpu/online/stats.py``, all of it).

One thread-safe counter surface for the continuous loop (stream ingest
-> drift verdicts, and the fit/shadow/promotion counters the online
training slice writes), shaped like every other ledger in the port:
plain counters behind a lock, ``snapshot()`` as the JSON-able read
surface the ``obs.MetricsRegistry`` flattens into Prometheus samples.
In this slice its writers are ``StreamSource`` and ``DriftMonitor``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class OnlineStats:
    """Counters for the ingest -> fit -> drift -> shadow -> promote loop.
    Writers here: the stream producer and consumer and the drift monitor
    (the fit, shadow and promotion counters wait for the online
    training slice). One lock — every field is a scalar bump, never a
    device sync."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # stream plane
        self.pushed_batches = 0
        self.delivered_batches = 0
        self.backpressure_waits = 0
        self.idle_windows = 0
        # fit plane
        self.rounds = 0
        self.round_batches = 0
        self.snapshots = 0
        # drift plane
        self.drift_checks = 0
        self.drift_alarms = 0
        self.last_drift_z = 0.0
        # shadow/promotion plane
        self.mirrored = 0
        self.mirror_skipped = 0
        self.mirror_dropped = 0
        self.mirror_errors = 0
        self.mirror_disagreements = 0
        self.promotions = 0
        self.promotion_refusals = 0
        self.rollbacks = 0

    def bump(self, field: str, by: float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def set(self, field: str, value: float) -> None:
        with self._lock:
            setattr(self, field, value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pushed_batches": self.pushed_batches,
                "delivered_batches": self.delivered_batches,
                "backpressure_waits": self.backpressure_waits,
                "idle_windows": self.idle_windows,
                "rounds": self.rounds,
                "round_batches": self.round_batches,
                "snapshots": self.snapshots,
                "drift_checks": self.drift_checks,
                "drift_alarms": self.drift_alarms,
                "last_drift_z": round(float(self.last_drift_z), 6),
                "mirrored": self.mirrored,
                "mirror_skipped": self.mirror_skipped,
                "mirror_dropped": self.mirror_dropped,
                "mirror_errors": self.mirror_errors,
                "mirror_disagreements": self.mirror_disagreements,
                "promotions": self.promotions,
                "promotion_refusals": self.promotion_refusals,
                "rollbacks": self.rollbacks,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"OnlineStats({self.snapshot()})"
