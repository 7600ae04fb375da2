"""Serving counters (counterpart: ``deeplearning4j_tpu/serving/telemetry.py``
``ServingStats``).

The fields the ported paths record: requests, answers, rejections,
timeouts, tokens, worker deaths, arena occupancy, prefix-cache hits,
preemptions, per-class sheds, queue depths, a latency ring, and the
``/predict`` batcher's batch fill (``record_batch``: dispatched batches,
real rows and pad rows), the prefill/decode handoff
(``record_prefix_export`` :190, ``record_prefix_import`` :194) and the
speculative rounds' acceptance (``record_draft`` :199), and the
resilience plane's counters (:128-175): breaker opens, closes and probes,
503 fast-fails, wedged batches, watchdog restarts, load and warmup
failures, drains. ``on_latency`` feeds completed-request latencies to the
engine's Prometheus histogram (``obs/registry.py``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional

import numpy as np


class ServingStats:
    """Thread-safe serving counters + a ring of recent latencies."""

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._lat = deque(maxlen=int(window))
        # optional latency sink (the engine's histogram), called outside
        # the lock
        self.on_latency = None
        self.requests = 0          # submitted
        self.completed = 0         # answered successfully
        self.errors = 0            # model/payload errors
        self.rejected = 0          # backpressure (HTTP 429)
        self.timeouts = 0          # per-request deadline expired (504)
        self.batches = 0           # /predict batches dispatched
        self.batched_rows = 0      # real rows in them
        self.padded_rows = 0       # bucket pad rows added to them
        self.generated_tokens = 0  # decode output tokens
        self.breaker_opens = 0     # SERVING/DEGRADED -> BROKEN transitions
        self.breaker_closes = 0    # successful half-open probe recoveries
        self.breaker_probes = 0    # half-open probe requests admitted
        self.fast_fails_503 = 0    # requests shed by an open breaker
        self.wedged_batches = 0    # watchdog-expired in-flight dispatches
        self.watchdog_restarts = 0  # worker threads replaced after a wedge
        self.worker_deaths = 0     # worker dead from an uncaught error
        self.slot_crashes = 0      # lanes evicted by a crashed admission
        self.load_failures = 0     # registry.load exceptions (isolated)
        self.warmup_failures = 0   # registry.warmup exceptions (isolated)
        self.drains_started = 0    # graceful drains begun
        self.drains_completed = 0  # drains that emptied the queues in time
        self.kv_blocks_total = 0   # arena size (allocatable blocks)
        self.kv_blocks_in_use = 0  # gauge: blocks held by lanes + cache
        self.prefix_lookups = 0    # prompt blocks consulted in the cache
        self.prefix_hits = 0       # prompt blocks served from the cache
        self.preemptions = 0       # lanes evicted-and-requeued
        self.prefix_exports = 0        # /prefill exports run
        self.prefix_imports = 0        # /prime adoptions applied
        self.prefix_import_blocks = 0  # blocks adopted across adoptions
        self.draft_proposed = 0    # draft tokens proposed to the target
        self.draft_accepted = 0    # proposals the target agreed with
        self.draft_rejected = 0    # proposals the target overruled
        self.shed_by_class: Dict[str, int] = {}  # 429s per SLO class
        self.queue_depths: Dict[str, int] = {}

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self.completed += 1
            self._lat.append(float(seconds))
        hook = self.on_latency
        if hook is not None:
            hook(float(seconds))

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def record_batch(self, real_rows: int, padded_to: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_rows += int(real_rows)
            self.padded_rows += int(padded_to) - int(real_rows)

    def record_tokens(self, n: int) -> None:
        with self._lock:
            self.generated_tokens += int(n)

    def record_breaker_open(self) -> None:
        with self._lock:
            self.breaker_opens += 1

    def record_breaker_close(self) -> None:
        with self._lock:
            self.breaker_closes += 1

    def record_breaker_probe(self) -> None:
        with self._lock:
            self.breaker_probes += 1

    def record_fast_fail(self) -> None:
        with self._lock:
            self.fast_fails_503 += 1

    def record_wedged(self) -> None:
        with self._lock:
            self.wedged_batches += 1

    def record_watchdog_restart(self) -> None:
        with self._lock:
            self.watchdog_restarts += 1

    def record_load_failure(self) -> None:
        with self._lock:
            self.load_failures += 1

    def record_warmup_failure(self) -> None:
        with self._lock:
            self.warmup_failures += 1

    def record_drain(self, completed: bool) -> None:
        with self._lock:
            self.drains_started += 1
            if completed:
                self.drains_completed += 1

    def record_worker_death(self) -> None:
        with self._lock:
            self.worker_deaths += 1

    def record_slot_crash(self) -> None:
        with self._lock:
            self.slot_crashes += 1

    def set_kv_blocks(self, in_use: int, total: int) -> None:
        with self._lock:
            self.kv_blocks_in_use = int(in_use)
            self.kv_blocks_total = int(total)

    def record_prefix(self, hits: int, lookups: int) -> None:
        with self._lock:
            self.prefix_hits += int(hits)
            self.prefix_lookups += int(lookups)

    def record_preemption(self) -> None:
        with self._lock:
            self.preemptions += 1

    def record_prefix_export(self) -> None:
        with self._lock:
            self.prefix_exports += 1

    def record_prefix_import(self, blocks: int) -> None:
        with self._lock:
            self.prefix_imports += 1
            self.prefix_import_blocks += int(blocks)

    def record_draft(self, proposed: int, accepted: int) -> None:
        """One lane's speculative round: ``proposed`` draft tokens, of
        which the target's greedy argmax agreed with the first
        ``accepted``."""
        with self._lock:
            self.draft_proposed += int(proposed)
            self.draft_accepted += int(accepted)
            self.draft_rejected += int(proposed) - int(accepted)

    def record_shed(self, slo_class: str) -> None:
        with self._lock:
            self.shed_by_class[slo_class] = \
                self.shed_by_class.get(slo_class, 0) + 1

    def set_queue_depth(self, depth: int, component: str = "decode") -> None:
        with self._lock:
            self.queue_depths[component] = int(depth)

    def latency_ms(self) -> Dict[str, Optional[float]]:
        """p50/p95/p99 of the recent-latency ring, in milliseconds."""
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
        if lat.size == 0:
            return {"p50": None, "p95": None, "p99": None, "count": 0}
        return {
            "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p95": round(float(np.percentile(lat, 95)) * 1e3, 3),
            "p99": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "count": int(lat.size),
        }

    def batch_fill_ratio(self) -> Optional[float]:
        """Real rows over dispatched rows (real + pad), None before the
        first batch."""
        with self._lock:
            total = self.batched_rows + self.padded_rows
            if total == 0:
                return None
            return round(self.batched_rows / total, 4)

    def snapshot(self) -> Dict[str, Any]:
        lat = self.latency_ms()
        with self._lock:
            out = {
                "requests": self.requests,
                "completed": self.completed,
                "errors": self.errors,
                "rejected_429": self.rejected,
                "timeouts": self.timeouts,
                "batches": self.batches,
                "batched_rows": self.batched_rows,
                "padded_rows": self.padded_rows,
                "generated_tokens": self.generated_tokens,
                "breaker_opens": self.breaker_opens,
                "breaker_closes": self.breaker_closes,
                "breaker_probes": self.breaker_probes,
                "fast_fails_503": self.fast_fails_503,
                "wedged_batches": self.wedged_batches,
                "watchdog_restarts": self.watchdog_restarts,
                "worker_deaths": self.worker_deaths,
                "slot_crashes": self.slot_crashes,
                "load_failures": self.load_failures,
                "warmup_failures": self.warmup_failures,
                "drains_started": self.drains_started,
                "drains_completed": self.drains_completed,
                "kv_blocks_total": self.kv_blocks_total,
                "kv_blocks_in_use": self.kv_blocks_in_use,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "preemptions": self.preemptions,
                "prefix_exports": self.prefix_exports,
                "prefix_imports": self.prefix_imports,
                "prefix_import_blocks": self.prefix_import_blocks,
                "draft_proposed": self.draft_proposed,
                "draft_accepted": self.draft_accepted,
                "draft_rejected": self.draft_rejected,
                "acceptance_rate": (
                    round(self.draft_accepted / self.draft_proposed, 4)
                    if self.draft_proposed else None),
                "shed_by_class": dict(self.shed_by_class),
                "queue_depth": sum(self.queue_depths.values()),
                "queue_depths": dict(self.queue_depths),
            }
        out["latency_ms"] = lat
        out["batch_fill_ratio"] = self.batch_fill_ratio()
        return out
