"""Serving counters (counterpart: ``deeplearning4j_tpu/serving/telemetry.py``
``ServingStats``).

The fields the paged ``/generate`` path records: requests, answers,
rejections, timeouts, tokens, worker deaths, arena occupancy, prefix-cache
hits, preemptions, per-class sheds, queue depth and a latency ring. The
batcher, breaker and speculative-decode counters come with the slices
that port those planes; Prometheus exposition is not ported.
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
        self.requests = 0          # submitted
        self.completed = 0         # answered successfully
        self.errors = 0            # model/payload errors
        self.rejected = 0          # backpressure (HTTP 429)
        self.timeouts = 0          # per-request deadline expired (504)
        self.generated_tokens = 0  # decode output tokens
        self.worker_deaths = 0     # decode worker dead from uncaught error
        self.slot_crashes = 0      # lanes evicted by a crashed admission
        self.kv_blocks_total = 0   # arena size (allocatable blocks)
        self.kv_blocks_in_use = 0  # gauge: blocks held by lanes + cache
        self.prefix_lookups = 0    # prompt blocks consulted in the cache
        self.prefix_hits = 0       # prompt blocks served from the cache
        self.preemptions = 0       # lanes evicted-and-requeued
        self.shed_by_class: Dict[str, int] = {}  # 429s per SLO class
        self.queue_depths: Dict[str, int] = {}

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self.completed += 1
            self._lat.append(float(seconds))

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def record_tokens(self, n: int) -> None:
        with self._lock:
            self.generated_tokens += int(n)

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

    def snapshot(self) -> Dict[str, Any]:
        lat = self.latency_ms()
        with self._lock:
            out = {
                "requests": self.requests,
                "completed": self.completed,
                "errors": self.errors,
                "rejected_429": self.rejected,
                "timeouts": self.timeouts,
                "generated_tokens": self.generated_tokens,
                "worker_deaths": self.worker_deaths,
                "slot_crashes": self.slot_crashes,
                "kv_blocks_total": self.kv_blocks_total,
                "kv_blocks_in_use": self.kv_blocks_in_use,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "preemptions": self.preemptions,
                "shed_by_class": dict(self.shed_by_class),
                "queue_depth": sum(self.queue_depths.values()),
                "queue_depths": dict(self.queue_depths),
            }
        out["latency_ms"] = lat
        return out
