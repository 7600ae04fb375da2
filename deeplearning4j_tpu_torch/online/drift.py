"""DriftMonitor: live feature moments vs the training-time statistics
(counterpart: ``deeplearning4j_tpu/online/drift.py``, all of it).

The fitted normalizer that rides the model zip (``etl/normalize.py``,
reference NormalizerStandardize) IS the training-time distribution record
— mean/std per final-axis column. This monitor accumulates the SAME
streaming moments (count/sum/sumsq in float64,
``NormalizerStandardize._acc_one``) over the live feed and renders a
z-score verdict:

    z_j = |live_mean_j - base_mean_j| / base_std_j
    alarm  when  max_j z_j > DL4J_TPU_ONLINE_DRIFT_Z
           once  live rows >= DL4J_TPU_ONLINE_DRIFT_MIN

The alarm is LATCHED (``alarmed`` stays up until ``reset()``): drift is a
state, not an event — ``VectorStore.publish(drift=...)`` refuses to
publish while it holds. Alarms ride the obs journal
(``online.drift_alarm``) and the ``online_stats`` ledger.

Host-side float64 arithmetic on the observed batches: a scripted shift
alarms identically every run.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.etl.normalize import NormalizerStandardize
from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.ops import env as envknob

DRIFT_Z_ENV = "DL4J_TPU_ONLINE_DRIFT_Z"
DRIFT_MIN_ENV = "DL4J_TPU_ONLINE_DRIFT_MIN"


class DriftMonitor:
    def __init__(self, baseline, *, z_threshold: Optional[float] = None,
                 min_rows: Optional[int] = None, stats=None) -> None:
        """``baseline`` is a FITTED NormalizerStandardize (the record's
        serving normalizer — the training-time statistics travelling
        with the model) or an explicit ``(mean, std)`` pair."""
        if hasattr(baseline, "mean"):
            if not getattr(baseline, "is_fit", False):
                raise ValueError("baseline normalizer is not fitted")
            mean, std = baseline.mean, baseline.std
        else:
            mean, std = baseline
        self.base_mean = np.asarray(mean, np.float64)
        self.base_std = np.where(
            np.asarray(std, np.float64) == 0, 1.0,
            np.asarray(std, np.float64))
        self.z_threshold = float(
            z_threshold if z_threshold is not None
            else envknob.get_float(DRIFT_Z_ENV))
        self.min_rows = int(min_rows if min_rows is not None
                            else envknob.get_int(DRIFT_MIN_ENV))
        self.stats = stats  # optional OnlineStats ledger
        self._lock = threading.Lock()
        self._acc = None   # [n, sum, sumsq] per column
        self._rows = 0
        self.alarmed = False
        self.last_z = 0.0

    def observe(self, features) -> None:
        """Accumulate one live batch's moments (float64 streaming sums —
        array work OUTSIDE the lock, scalar/array adds inside)."""
        x64 = np.asarray(features, np.float64)
        contrib = NormalizerStandardize._acc_one(None, x64)
        rows = int(x64.shape[0]) if x64.ndim else 1
        with self._lock:
            if self._acc is None:
                self._acc = contrib
            else:
                self._acc[0] += contrib[0]
                self._acc[1] += contrib[1]
                self._acc[2] += contrib[2]
            self._rows += rows

    def check(self) -> Dict[str, Any]:
        """Render the verdict for the window observed so far. Idempotent
        and side-effect-free except the FIRST crossing, which latches the
        alarm, journals ``online.drift_alarm`` and bumps the ledger."""
        with self._lock:
            acc = None if self._acc is None else list(self._acc)
            rows = self._rows
            alarmed = self.alarmed
        if self.stats is not None:
            self.stats.bump("drift_checks")
        if acc is None or rows < self.min_rows:
            return {"verdict": "pending", "rows": rows,
                    "min_rows": self.min_rows, "alarmed": alarmed}
        live_mean, _live_std = NormalizerStandardize._fin_one(acc)
        z = np.abs(live_mean - self.base_mean) / self.base_std
        max_z = float(np.max(z))
        worst = int(np.argmax(z))
        fresh_alarm = False
        with self._lock:
            self.last_z = max_z
            if max_z > self.z_threshold and not self.alarmed:
                self.alarmed = fresh_alarm = True
            alarmed = self.alarmed
        if self.stats is not None:
            self.stats.set("last_drift_z", max_z)
            if fresh_alarm:
                self.stats.bump("drift_alarms")
        if fresh_alarm:
            obs_journal.event("online.drift_alarm", max_z=round(max_z, 4),
                              threshold=self.z_threshold, column=worst,
                              rows=rows)
        return {"verdict": "alarm" if alarmed else "ok", "rows": rows,
                "max_z": max_z, "column": worst,
                "threshold": self.z_threshold, "alarmed": alarmed}

    def reset(self) -> None:
        """Drop the live window AND the latched alarm (the operator's
        acknowledge — e.g. after retraining on the shifted stream)."""
        with self._lock:
            self._acc = None
            self._rows = 0
            self.alarmed = False
            self.last_z = 0.0
