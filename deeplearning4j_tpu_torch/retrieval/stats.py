"""Retrieval telemetry: the ``retrieval_stats`` ledger (counterpart:
``deeplearning4j_tpu/retrieval/stats.py``, all of it).

One thread-safe counter surface for the embedding and vector-search
plane, shaped like the other ledgers (``serving_stats``): plain counters
behind a lock and ``snapshot()`` as the JSON-able read the metrics
registry flattens into Prometheus samples. The port's engine bumps the
embed counters per answered ``/embed``; each ``VectorStore`` bumps its
own ledger's mutation, publish, search and recall counters.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class RetrievalStats:
    """Counters for the embed -> upsert -> publish -> search loop.
    Writers: the serving embed path, the store mutation path, the
    publisher, the search path, the recall probe. One lock — every field
    is a scalar bump, never a device sync."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # embed plane (bumped by the serving engine per answered /embed)
        self.embed_requests = 0
        self.embed_rows = 0
        # mutation plane
        self.upserts = 0
        self.deletes = 0
        self.feed_batches = 0
        self.feed_windows = 0
        # publish plane
        self.publishes = 0
        self.publish_vetoes = 0
        self.generation = 0
        self.rows = 0
        # search plane
        self.search_requests = 0
        self.search_rows = 0
        # recall probe (measured against the exact oracle, never assumed)
        self.recall_probes = 0
        self.last_recall = 0.0

    def bump(self, field: str, by: float = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def set(self, field: str, value: float) -> None:
        with self._lock:
            setattr(self, field, value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "embed_requests": self.embed_requests,
                "embed_rows": self.embed_rows,
                "upserts": self.upserts,
                "deletes": self.deletes,
                "feed_batches": self.feed_batches,
                "feed_windows": self.feed_windows,
                "publishes": self.publishes,
                "publish_vetoes": self.publish_vetoes,
                "generation": self.generation,
                "rows": self.rows,
                "search_requests": self.search_requests,
                "search_rows": self.search_rows,
                "recall_probes": self.recall_probes,
                "last_recall": round(float(self.last_recall), 6),
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"RetrievalStats({self.snapshot()})"
