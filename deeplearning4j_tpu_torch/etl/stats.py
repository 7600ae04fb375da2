"""Pipeline telemetry (counterpart: ``deeplearning4j_tpu/etl/stats.py`` —
``dataset_nbytes``, ``dataset_num_examples`` and ``PipelineStats``).

Every delivered batch is counted (batches, records, bytes) and the two
kinds of waiting are kept apart:

  ``stall_seconds``           the consumer (the training thread) blocked
                              waiting for a staged batch: the input
                              pipeline is the bottleneck;
  ``producer_stall_seconds``  the producers blocked on full buffers: the
                              trainer is the bottleneck (healthy).

``snapshot()`` derives the rates and ``stall_fraction``. Shared by
``etl/pipeline.InputPipeline`` and
``datasets/iterator.AsyncDataSetIterator``, adopted by the containers as
``net.pipeline_stats``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _nbytes(a) -> int:
    """Bytes of one array from its shape and dtype alone: a staged CUDA
    tensor is never read back to the host."""
    if isinstance(a, torch.Tensor):
        return int(a.numel()) * int(a.element_size())
    if isinstance(a, np.ndarray):
        return int(a.nbytes)
    return int(np.asarray(a).nbytes)


def dataset_nbytes(ds) -> int:
    """Bytes of one delivered minibatch (features + labels + masks;
    MultiDataSet lists included), the payload the pipeline moved."""
    total = 0

    def add(a):
        nonlocal total
        if a is not None:
            total += _nbytes(a)

    if hasattr(ds, "features_list"):  # MultiDataSet
        for a in ds.features_list:
            add(a)
        for a in ds.labels_list:
            add(a)
        for group in (ds.features_masks, ds.labels_masks):
            for a in group or []:
                add(a)
    else:
        add(getattr(ds, "features", None))
        add(getattr(ds, "labels", None))
        add(getattr(ds, "features_mask", None))
        add(getattr(ds, "labels_mask", None))
    return total


def dataset_num_examples(ds) -> int:
    try:
        return int(ds.num_examples())
    except Exception:  # noqa: BLE001 — telemetry must never break delivery
        return 0


class PipelineStats:
    """Thread-safe ingest counters. Producers (dispatcher/worker/stager
    threads) and the consumer update concurrently; ``snapshot()`` is the
    read surface (JSON-able, like ``DispatchStats.snapshot``)."""

    def __init__(self, workers: int = 0, queue_capacity: int = 0) -> None:
        self._lock = threading.Lock()
        self.workers = int(workers)
        self.queue_capacity = int(queue_capacity)
        self.batches = 0
        self.records = 0
        self.bytes = 0
        self.stall_seconds = 0.0
        self.producer_stall_seconds = 0.0
        self.wall_seconds = 0.0
        self.queue_depth = 0  # staged batches ready at the last delivery
        self.epochs = 0  # completed passes
        self.restores = 0  # restore_state() calls (resilience resumes)
        self._pass_start: Optional[float] = None

    # -- producer/consumer hooks -----------------------------------------
    def start_pass(self) -> None:
        with self._lock:
            self._pass_start = time.perf_counter()

    def end_pass(self) -> None:
        with self._lock:
            if self._pass_start is not None:
                self.wall_seconds += time.perf_counter() - self._pass_start
                self._pass_start = None
            self.epochs += 1

    def record_delivered(self, nbytes: int, records: int,
                         queue_depth: int = 0) -> None:
        """One batch reached the consumer. ``nbytes``/``records`` are
        measured on the host arrays before device staging: the telemetry
        adds no sync point to the hot path."""
        with self._lock:
            self.batches += 1
            self.records += int(records)
            self.bytes += int(nbytes)
            self.queue_depth = int(queue_depth)

    def add_consumer_stall(self, seconds: float) -> None:
        with self._lock:
            self.stall_seconds += float(seconds)

    def add_producer_stall(self, seconds: float) -> None:
        with self._lock:
            self.producer_stall_seconds += float(seconds)

    def record_restore(self) -> None:
        with self._lock:
            self.restores += 1

    # -- read surface ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            wall = self.wall_seconds
            if self._pass_start is not None:  # mid-pass snapshot stays live
                wall += time.perf_counter() - self._pass_start
            out = {
                "workers": self.workers,
                "queue_capacity": self.queue_capacity,
                "batches": self.batches,
                "records": self.records,
                "bytes": self.bytes,
                "epochs": self.epochs,
                "restores": self.restores,
                "queue_depth": self.queue_depth,
                "wall_seconds": round(wall, 6),
                "stall_seconds": round(self.stall_seconds, 6),
                "producer_stall_seconds": round(
                    self.producer_stall_seconds, 6),
            }
        out["batches_per_sec"] = (
            round(out["batches"] / wall, 3) if wall > 0 else 0.0)
        out["records_per_sec"] = (
            round(out["records"] / wall, 1) if wall > 0 else 0.0)
        out["mb_per_sec"] = (
            round(out["bytes"] / 1e6 / wall, 3) if wall > 0 else 0.0)
        # fraction of the pass the training thread spent waiting on input
        # (0.0 = the device never starved)
        out["stall_fraction"] = (
            round(out["stall_seconds"] / wall, 4) if wall > 0 else 0.0)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"PipelineStats({self.snapshot()})"
