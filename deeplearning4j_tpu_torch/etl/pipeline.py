"""InputPipeline: overlapped, deterministic, checkpointable input staging
(counterpart: ``deeplearning4j_tpu/etl/pipeline.py`` — ``assemble_batch``,
``InputPipeline`` with ``from_reader``, ``from_native``, ``shard``,
``reshard`` and the delivered-batch cursor ``state`` :381 /
``restore_state`` :416, and ``maybe_wrap`` :766).

  dispatcher thread   reads the source in stream order (records from a
                      reader, or DataSets from a wrapped iterator),
                      applies the order- and count-sensitive
                      TransformProcess head (filters, rolling windows),
                      chunks into batches, keeps this process's shard
                      (every ``shard_count``-th batch) and hands
                      sequence-numbered work to the pool;
  N worker threads    the stateless transform tail, vectorized batch
                      assembly (one float64 parse of the chunk, then
                      float32: byte-equal to the per-record path) and
                      the fitted normalizer;
  reorder buffer      batches re-enter stream order whichever worker
                      finished first: the output is byte-equal to direct
                      iteration at any worker count;
  stager thread       hands each batch to :class:`Stager` in order; the
                      ``prefetch`` queue bounds batches in flight.

:class:`Stager` is the port's own design in place of the JAX package's
``jax.device_put`` (:674-697). For batch j+1 it copies every host array
into pinned host memory, issues ``.to(device, non_blocking=True)`` on a
side ``torch.cuda.Stream`` the stager owns and records an event after
the copies; the pinned sources stay referenced until that event has
completed. Before the consumer touches the batch, ``take`` makes the
consumer's current stream wait on the event and calls ``record_stream``
on the card's tensors, so the caching allocator does not hand their
memory to another tensor while the consumer's work on them is queued.
The training step's kernels stay on the consumer's stream; only the
copies use the side stream. ``device="cpu"`` (or ``device_put=False``)
stages nothing: the batches are the host arrays.

Telemetry rides in :class:`~deeplearning4j_tpu_torch.etl.stats.PipelineStats`
(``pipeline.pipeline_stats``, adopted by the containers as
``net.pipeline_stats``); the ``etl.wait`` span records how long the
training thread waited for each batch and ``etl.stage`` the stager's
half of each copy.

The pipeline counts batches delivered, not dispatched: a cursor rides
with each batch through the pool, so a resumed run consumes exactly the
remaining stream (``ResilientTrainer``'s exact resume), and the cursor's
dict form is the JAX package's, so either package resumes from the
other's.

Knobs: ``DL4J_TPU_PIPELINE_WORKERS`` (workers, and the opt-in for
``maybe_wrap``), ``DL4J_TPU_PREFETCH`` (the staged-batch queue depth,
shared with ``AsyncDataSetIterator``), and the process id and count that
``shard="auto"`` reads.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterator import (
    DataSet,
    DataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.etl.stats import PipelineStats, dataset_nbytes
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device

WORKERS_ENV = "DL4J_TPU_PIPELINE_WORKERS"
PREFETCH_ENV = "DL4J_TPU_PREFETCH"

_SENTINEL = object()
_NO_PENDING = object()

#: reshard() value for a member that LEFT the fleet: the pipeline owns
#: nothing from the boundary on (None would mean "own everything")
DROP_SHARD = "drop"


PROCESS_ID_ENV = "DL4J_TPU_PROCESS_ID"
NUM_PROCESSES_ENV = "DL4J_TPU_NUM_PROCESSES"


def default_prefetch() -> int:
    """Staged-batch queue depth: DL4J_TPU_PREFETCH, default 2 (one batch
    on the card under compute, one staging)."""
    return max(1, envknob.get_int(PREFETCH_ENV))


def _auto_shard() -> Optional[Tuple[int, int]]:
    """(process_id, num_processes) from the multihost env contract
    (``DL4J_TPU_PROCESS_ID``, ``DL4J_TPU_NUM_PROCESSES``), or None for
    one process."""
    pid = envknob.get_opt_int(PROCESS_ID_ENV)
    count = envknob.get_opt_int(NUM_PROCESSES_ENV)
    if pid is None or count is None or count <= 1:
        return None
    return pid, count


# ---------------------------------------------------------------------------
# Vectorized batch assembly (byte-identical to the per-record path)
# ---------------------------------------------------------------------------


def assemble_batch(records: List, label_index: Optional[int],
                   num_possible_labels: int, regression: bool,
                   label_index_to: Optional[int]) -> DataSet:
    """Records -> DataSet with ``RecordReaderDataSetIterator`` semantics
    (datasets/records.py:167 ``_split``/``_make``) but ONE vectorized
    parse: the whole chunk goes through numpy's C float64 parser and is
    cast to float32 afterwards — the same double-rounding as
    ``float(v)`` per element then ``np.asarray(..., np.float32)``, so the
    output is BYTE-identical while parsing ~2x faster (the measured
    1-core win the ``input_pipeline`` bench leg commits). Falls back to
    the per-record path for chunks numpy cannot batch-parse (ragged or
    non-numeric leftovers)."""
    try:
        arr = np.asarray(records, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError("not a flat record chunk")
    except (ValueError, TypeError):
        return _assemble_per_record(records, label_index,
                                    num_possible_labels, regression,
                                    label_index_to)
    if label_index is None:
        x = arr.astype(np.float32)
        return DataSet(features=x, labels=x)  # AE pretrain: y is x
    li = label_index if label_index >= 0 else arr.shape[1] + label_index
    if label_index_to is not None:
        hi = label_index_to + 1
        y = arr[:, li:hi].astype(np.float32)
        x = np.concatenate([arr[:, :li], arr[:, hi:]], axis=1).astype(
            np.float32)
        return DataSet(features=x, labels=y)
    x = np.concatenate([arr[:, :li], arr[:, li + 1:]], axis=1).astype(
        np.float32)
    if regression or num_possible_labels <= 0:
        return DataSet(features=x, labels=arr[:, li:li + 1].astype(
            np.float32))
    idx = arr[:, li].astype(np.int64)  # truncation == int(label_val)
    y = np.zeros((arr.shape[0], num_possible_labels), np.float32)
    y[np.arange(arr.shape[0]), idx] = 1.0
    return DataSet(features=x, labels=y)


def _assemble_per_record(records, label_index, num_possible_labels,
                         regression, label_index_to) -> DataSet:
    from deeplearning4j_tpu_torch.datasets.records import (
        RecordReaderDataSetIterator,
    )

    proto = RecordReaderDataSetIterator(
        reader=None, batch_size=len(records), label_index=label_index,
        num_possible_labels=num_possible_labels, regression=regression,
        label_index_to=label_index_to)
    feats, labels = [], []
    for rec in records:
        f, l = proto._split(rec)
        feats.append(f)
        labels.append(l)
    return proto._make(feats, labels)


# ---------------------------------------------------------------------------
# Shared coordination state
# ---------------------------------------------------------------------------


class _Coordination:
    """The reorder buffer plus the end-of-stream/error handshake all four
    thread roles share. ``buf`` maps LOCAL (post-shard, dense) batch
    index -> finished payload; ``total`` is the local batch count, known
    once the dispatcher exhausts the source."""

    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.buf: Dict[int, Any] = {}
        self.capacity = max(1, int(capacity))
        self.next_needed = 0
        self.total: Optional[int] = None
        self.workers_done = 0
        self.error: Optional[BaseException] = None

    def fail(self, exc: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = exc
            self.cond.notify_all()


class _Staged:
    """A batch on its way to the card: the DataSet of device tensors,
    the event after its copies, and the device tensors to mark for the
    consumer's stream."""

    __slots__ = ("ds", "event", "tensors")

    def __init__(self, ds, event, tensors):
        self.ds, self.event, self.tensors = ds, event, tensors


class Stager:
    """Host-to-card staging on a side stream (see the module docstring).
    ``put`` runs on the producing thread, ``take`` on the consumer's;
    ``drain`` waits for every copy still in flight and frees its pinned
    sources (the end of a pass)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self._lock = threading.Lock()
        # (event, pinned host tensors) of copies that may be in flight
        self._inflight: deque = deque()
        self.batches = 0

    def _reap(self) -> None:
        with self._lock:
            while self._inflight and self._inflight[0][0].query():
                self._inflight.popleft()

    def put(self, ds):
        """Issue the copies of ``ds`` and return a staged batch."""
        self._reap()
        pinned, tensors = [], []

        def one(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                return a
            host = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a)
            pin = torch.empty(host.shape, dtype=host.dtype,
                              pin_memory=True)
            pin.copy_(host)
            pinned.append(pin)
            t = pin.to(self.device, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.stream(self.stream):
            if hasattr(ds, "features_list"):
                opt = lambda ms: None if ms is None else [one(m) for m in ms]
                out = MultiDataSet([one(f) for f in ds.features_list],
                                   [one(l) for l in ds.labels_list],
                                   opt(ds.features_masks),
                                   opt(ds.labels_masks))
            else:
                out = DataSet(one(ds.features), one(ds.labels),
                              one(ds.features_mask), one(ds.labels_mask))
            event = torch.cuda.Event()
            event.record(self.stream)
        with self._lock:
            self._inflight.append((event, pinned))
        self.batches += 1
        return _Staged(out, event, tensors)

    def take(self, staged: "_Staged"):
        """The staged batch, safe to use on the consumer's current
        stream."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(cur)
        return staged.ds

    def drain(self) -> None:
        with self._lock:
            pending, self._inflight = list(self._inflight), deque()
        for event, _ in pending:
            event.synchronize()


class InputPipeline(DataSetIterator):
    """See module docstring. Two source modes:

      * ``InputPipeline(iterator, ...)`` wraps any DataSetIterator (or
        MultiDataSet iterator): assembly already happened in the source;
        the pipeline moves it off the training thread and adds the
        normalizer, ordering, staging, telemetry and resume planes.
      * ``InputPipeline.from_reader(reader, batch_size, ...)`` builds
        batches straight from a RecordReader (+ optional
        TransformProcess), with assembly vectorized in the workers —
        equivalent to ``RecordReaderDataSetIterator`` over a
        ``TransformProcessRecordReader``, byte for byte.
    """

    def __init__(self, source, *, workers: Optional[int] = None,
                 prefetch: Optional[int] = None, normalizer=None,
                 device_put: bool = True, shard="auto", device=None,
                 _reader_cfg: Optional[dict] = None):
        self.source = source
        self.workers = max(1, workers if workers is not None
                           else envknob.get_int(WORKERS_ENV, 2))
        self.prefetch = max(1, prefetch if prefetch is not None
                            else default_prefetch())
        self.normalizer = normalizer
        self.device = resolve_device(device)
        self.device_put = device_put
        # batches reach the card through the stager; on the CPU, or with
        # device_put=False, they stay the host arrays
        self._staging = (Stager(self.device)
                        if device_put and self.device.type == "cuda"
                        else None)
        self.shard: Optional[Tuple[int, int]] = (
            _auto_shard() if shard == "auto" else shard)
        if self.shard is not None:
            idx, count = self.shard
            if not 0 <= idx < count:
                raise ValueError(f"shard index {idx} outside [0, {count})")
        # live resharding: a schedule of (at_seq, shard) entries over
        # absolute batch sequence numbers, changed at a boundary every
        # member agrees on, so the union of the members' pipelines still
        # covers every batch exactly once. Guarded by _shard_lock (the
        # dispatcher thread reads it per batch).
        self._shard_lock = threading.Lock()
        self._shard_schedule: List[Tuple[int, Any]] = [(0, self.shard)]
        self._pending_shard: Any = _NO_PENDING
        self._dispatch_seq = 0  # ownership decided for seqs below this
        self._consumed_seq = 0  # high-water mark of the last pass
        self._pass_active = False
        self._reader_cfg = _reader_cfg
        if _reader_cfg is not None:
            head, tail = (None, None)
            tp = _reader_cfg.get("transform")
            if tp is not None:
                head, tail = tp.split_for_pipeline()
            self._tp_head, self._tp_tail = head, tail
        # adopted and registered by the container at fit time
        self.pipeline_stats = PipelineStats(
            workers=self.workers, queue_capacity=self.prefetch)
        # resume plane (delivered-batch cursor; see state()/restore_state)
        self._last_state: Optional[dict] = None
        self._resume: Optional[dict] = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_reader(cls, reader, batch_size: int, *,
                    label_index: Optional[int] = None,
                    num_possible_labels: int = -1,
                    regression: bool = False,
                    label_index_to: Optional[int] = None,
                    transform=None, **kw) -> "InputPipeline":
        """Pipeline straight off a RecordReader: dispatcher applies the
        TransformProcess head + batch chunking, workers run the stateless
        transform tail + vectorized assembly (label semantics exactly
        ``RecordReaderDataSetIterator``'s)."""
        cfg = {"batch_size": int(batch_size), "label_index": label_index,
               "num_possible_labels": int(num_possible_labels),
               "regression": bool(regression),
               "label_index_to": label_index_to, "transform": transform}
        return cls(reader, _reader_cfg=cfg, **kw)

    @classmethod
    def from_native(cls, features, labels, batch: int, *, epochs: int = 1,
                    seed: int = 0, capacity: int = 4, **kw
                    ) -> "InputPipeline":
        """The native host feeder (``native.NativePrefetchIterator``: a
        splitmix64 shuffle per epoch and minibatch gathering in C++ on
        its own thread) as the source, with the normalizer, staging,
        telemetry and resume planes on top."""
        return cls(_NativeSource(features, labels, batch, epochs=epochs,
                                 seed=seed, capacity=capacity), **kw)

    # -- DataSetIterator surface ------------------------------------------
    def batch_size(self) -> int:
        if self._reader_cfg is not None:
            return int(self._reader_cfg["batch_size"])
        return self.source.batch_size()

    def total_examples(self) -> int:
        return self.source.total_examples()

    def reset(self) -> None:
        self._last_state = None
        self._resume = None
        if hasattr(self.source, "reset"):
            self.source.reset()

    # -- live resharding ---------------------------------------------------
    def reshard(self, shard, *, at_seq: Optional[int] = None) -> None:
        """Re-partition the multihost shard selection LIVE (the elastic
        fleet's membership-epoch hook). ``shard`` is ``(index, count)``,
        ``None`` (no sharding — own every batch), or :data:`DROP_SHARD`
        (a departed member: own nothing from the boundary on).

        ``at_seq`` anchors the change to an ABSOLUTE batch sequence
        number — every member must pass the same boundary (the agreed
        first batch of the next membership epoch), which is what keeps
        the union of the fleet's pipelines covering every batch exactly
        once, deterministically, with the delivered-batch cursor
        semantics intact (batches below the boundary keep the old
        partition; `state()` snapshots the schedule so a kill/resume
        replays the identical ownership). Raises when the dispatcher
        already decided ownership past the boundary — a retroactive
        reshard could double- or zero-own an in-flight batch.

        ``at_seq=None`` defers the change to the start of the NEXT pass
        (the between-epochs form)."""
        if shard is not None and shard != DROP_SHARD:
            idx, count = shard
            if not 0 <= idx < count:
                raise ValueError(f"shard index {idx} outside [0, {count})")
            shard = (int(idx), int(count))
        with self._shard_lock:
            if at_seq is None:
                self._pending_shard = shard
                return
            at_seq = int(at_seq)
            if self._pass_active and at_seq < self._dispatch_seq:
                raise ValueError(
                    f"reshard boundary {at_seq} already passed (dispatcher "
                    f"at {self._dispatch_seq}) — a retroactive reshard "
                    "would drop or double-own in-flight batches; pick a "
                    "boundary ahead of the stream")
            self._shard_schedule = (
                [(s, sh) for s, sh in self._shard_schedule if s < at_seq]
                + [(at_seq, shard)])

    def _owns(self, abs_seq: int) -> bool:
        """Shard ownership of batch `abs_seq` under the live schedule
        (last entry at or below the sequence number wins)."""
        with self._shard_lock:
            self._dispatch_seq = max(self._dispatch_seq, abs_seq + 1)
            shard = self._shard_schedule[0][1]
            for s, sh in self._shard_schedule:
                if s <= abs_seq:
                    shard = sh
                else:
                    break
        if shard == DROP_SHARD:
            return False
        return shard is None or abs_seq % shard[1] == shard[0]

    def _begin_pass(self, resumed: bool) -> None:
        """Fresh passes compact the boundaries the PREVIOUS pass consumed
        (they must not re-fire at the restarted sequence numbers) down to
        their final effective shard, while boundaries scheduled ahead of
        the stream stay armed; a pending next-pass reshard lands now.
        Resumed passes keep the restored schedule verbatim — ownership
        must replay identically."""
        with self._shard_lock:
            if not resumed:
                if self._pending_shard is not _NO_PENDING:
                    self._shard_schedule = [(0, self._pending_shard)]
                    self._pending_shard = _NO_PENDING
                else:
                    cut = self._consumed_seq
                    past = [e for e in self._shard_schedule if e[0] <= cut]
                    future = [e for e in self._shard_schedule if e[0] > cut]
                    self._shard_schedule = [(0, past[-1][1])] + future
            self._dispatch_seq = 0
            self._pass_active = True

    def _shard_schedule_snapshot(self) -> list:
        with self._shard_lock:
            return [[s, list(sh) if isinstance(sh, tuple) else sh]
                    for s, sh in self._shard_schedule]

    def _restore_shard_schedule(self, snap) -> None:
        with self._shard_lock:
            self._shard_schedule = [
                (int(s), tuple(sh) if isinstance(sh, list) else sh)
                for s, sh in snap]

    # -- resume protocol ---------------------------------------------------
    def state(self) -> Optional[dict]:
        """Cursor of the last batch DELIVERED to the consumer (never the
        dispatcher's read-ahead position — those batches would be
        silently skipped on resume). Two forms: ``source`` rides the
        wrapped iterator's own exact cursor; ``replay`` (readers and
        stateless sources) re-reads the stream and skips the delivered
        prefix — deterministic either way."""
        if self._last_state is not None:
            out = dict(self._last_state)
        elif self._resume is not None:  # restored but not yet iterated
            out = dict(self._resume)
        elif self._reader_cfg is None and hasattr(self.source, "state"):
            # pass not started: defer to a resumable source's own cursor
            snap = self.source.state()
            out = ({"mode": "source", "source": snap, "next_seq": 0}
                   if snap is not None
                   else {"mode": "replay", "next_seq": 0})
        else:
            out = {"mode": "replay", "next_seq": 0}
        # the live shard schedule rides the cursor: resumed ownership
        # must replay identically across a membership-epoch reshard —
        # including a deferred (next-pass) reshard not yet applied.
        # ONE lock acquisition for both reads: a reshard landing between
        # two acquisitions would leave the cursor missing a boundary the
        # surviving pipelines applied
        with self._shard_lock:
            out["shard_schedule"] = [
                [s, list(sh) if isinstance(sh, tuple) else sh]
                for s, sh in self._shard_schedule]
            if self._pending_shard is not _NO_PENDING:
                sh = self._pending_shard
                out["pending_shard"] = (list(sh) if isinstance(sh, tuple)
                                        else sh)
        return out

    def restore_state(self, state: dict) -> None:
        self._resume = dict(state)
        self._last_state = None
        self.pipeline_stats.record_restore()
        if state.get("shard_schedule"):
            self._restore_shard_schedule(state["shard_schedule"])
        if "pending_shard" in state:
            sh = state["pending_shard"]
            with self._shard_lock:
                self._pending_shard = (tuple(sh) if isinstance(sh, list)
                                       else sh)
        if (state.get("mode") == "source"
                and state.get("source") is not None):
            self.source.restore_state(state["source"])

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        resume, self._resume = self._resume, None
        self._begin_pass(resumed=resume is not None)
        seq_base = 0
        skip_below = 0
        if resume is not None:
            if resume.get("mode") == "source":
                # source already repositioned (restore_state); keep the
                # absolute sequence numbering so sharding stays aligned
                seq_base = int(resume.get("next_seq", 0))
            else:
                skip_below = int(resume.get("next_seq", 0))
            # a resumed pass that delivers ZERO batches (an idle live
            # stream — the poll window closed empty) must keep answering
            # the restored position from state(), not fall back to a
            # next_seq-0 snapshot; keep only the cursor keys — the shard
            # schedule/pending reshard are re-read LIVE by state()
            self._last_state = {k: resume[k]
                                for k in ("mode", "next_seq", "source")
                                if k in resume}
        stats = self.pipeline_stats
        stats.start_pass()
        coord = _Coordination(self.prefetch + self.workers)
        stop = threading.Event()
        work_q: "queue.Queue" = queue.Queue(maxsize=2 * self.workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        threads = [threading.Thread(
            target=self._dispatcher, name="etl-dispatch",
            args=(coord, stop, work_q, seq_base, skip_below), daemon=True)]
        threads += [threading.Thread(
            target=self._worker, name=f"etl-worker-{k}",
            args=(coord, stop, work_q), daemon=True)
            for k in range(self.workers)]
        threads.append(threading.Thread(
            target=self._stager, name="etl-stage",
            args=(coord, stop, out_q), daemon=True))
        for t in threads:
            t.start()
        delivered_clean = False
        try:
            while True:
                waited = 0.0  # consumer-side wait for THIS delivery
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = out_q.get(timeout=0.5)
                    except queue.Empty:
                        waited += time.perf_counter() - t0
                        stats.add_consumer_stall(time.perf_counter() - t0)
                        if coord.error is not None:
                            raise coord.error
                        continue
                    waited += time.perf_counter() - t0
                    stats.add_consumer_stall(time.perf_counter() - t0)
                    break
                if item is _SENTINEL:
                    if coord.error is not None:
                        raise coord.error
                    delivered_clean = True
                    break
                ds, cursor, nbytes, n = item
                if self._staging is not None:
                    ds = self._staging.take(ds)
                self._last_state = cursor
                stats.record_delivered(nbytes, n, out_q.qsize())
                # staging-wait span: how long the TRAINING thread starved
                # before this batch arrived — the per-delivery view of
                # pipeline_stats.stall_seconds (recorded after the fact so
                # the hot loop keeps its shape; obs off = no-op)
                obs_trace.record_span("etl.wait", waited,
                                      seq=cursor.get("next_seq"),
                                      bytes=nbytes, records=n)
                yield ds
        finally:
            stop.set()
            with coord.cond:
                coord.cond.notify_all()
            for t in threads:
                t.join(timeout=5.0)
            with self._shard_lock:
                self._pass_active = False
                self._consumed_seq = self._dispatch_seq
            if self._staging is not None:
                self._staging.drain()
            stats.end_pass()
        if delivered_clean and hasattr(self.source, "reset") \
                and self._reader_cfg is not None:
            self.source.reset()

    # -- thread roles ------------------------------------------------------
    def _local_batches(self, seq_base: int, skip_below: int):
        """(local_idx, abs_seq, payload, cursor) for every batch this
        process owns. Reads the SOURCE serially — the only stream-order-
        dependent stage — and snapshots the resume cursor per batch.
        Ownership consults the LIVE shard schedule per batch (reshard)."""
        local = 0
        if self._reader_cfg is not None:
            cfg = self._reader_cfg
            bs = cfg["batch_size"]
            head_fn = (self._tp_head.compile()
                       if self._tp_head is not None else None)
            chunk: list = []
            abs_seq = seq_base

            def emit(chunk, abs_seq, local):
                cursor = {"mode": "replay", "next_seq": abs_seq + 1}
                return (local, abs_seq, chunk, cursor)

            for rec in self.source:
                if head_fn is not None:
                    rec = head_fn(rec)
                    if rec is None:
                        continue
                chunk.append(rec)
                if len(chunk) == bs:
                    if self._owns(abs_seq) and abs_seq >= skip_below:
                        yield emit(chunk, abs_seq, local)
                        local += 1
                    abs_seq += 1
                    chunk = []
            if chunk:
                if self._owns(abs_seq) and abs_seq >= skip_below:
                    yield emit(chunk, abs_seq, local)
        else:
            abs_seq = seq_base
            can_state = hasattr(self.source, "state")
            for ds in self.source:
                snap = self.source.state() if can_state else None
                if self._owns(abs_seq) and abs_seq >= skip_below:
                    if snap is not None:
                        cursor = {"mode": "source", "source": snap,
                                  "next_seq": abs_seq + 1}
                    else:
                        cursor = {"mode": "replay", "next_seq": abs_seq + 1}
                    yield (local, abs_seq, ds, cursor)
                    local += 1
                abs_seq += 1

    def _dispatcher(self, coord, stop, work_q, seq_base, skip_below):
        stats = self.pipeline_stats
        count = 0
        try:
            for item in self._local_batches(seq_base, skip_below):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        work_q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
                stats.add_producer_stall(time.perf_counter() - t0)
                count += 1
            with coord.cond:
                coord.total = count
                coord.cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            coord.fail(e)
        finally:
            for _ in range(self.workers):
                while not stop.is_set():
                    try:
                        work_q.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def _process(self, payload):
        """The record-parallel stage: transform tail + assembly (reader
        mode) or normalizer passthrough (wrap mode). Returns the finished
        HOST-side batch plus its byte/record counts (counted before
        device staging)."""
        if self._reader_cfg is not None:
            cfg = self._reader_cfg
            records = payload
            if self._tp_tail is not None:
                tail_fn = self._tp_tail.compile()  # stateless: fresh is free
                records = [tail_fn(r) for r in records]
            ds = assemble_batch(records, cfg["label_index"],
                                cfg["num_possible_labels"],
                                cfg["regression"], cfg["label_index_to"])
        else:
            ds = payload
        if self.normalizer is not None:
            ds = self._normalized_copy(ds)
        return ds, dataset_nbytes(ds), self._num_examples(ds)

    @staticmethod
    def _num_examples(ds) -> int:
        try:
            return int(ds.num_examples())
        except Exception:  # noqa: BLE001 — telemetry only
            return 0

    def _normalized_copy(self, ds):
        """PURE normalizer application: wrapped sources often yield VIEWS
        of their backing arrays (ListDataSetIterator slices); in-place
        transform would corrupt the source for later epochs."""
        norm = self.normalizer
        if hasattr(ds, "features_list"):  # MultiDataSet: features only
            return MultiDataSet(
                [norm.transform_array(f) for f in ds.features_list],
                list(ds.labels_list), ds.features_masks, ds.labels_masks)
        labels = ds.labels
        if norm._fit_labels and labels is not None:
            labels = norm.transform_array(labels, labels=True)
        return DataSet(norm.transform_array(ds.features), labels,
                       ds.features_mask, ds.labels_mask)

    def _worker(self, coord, stop, work_q):
        stats = self.pipeline_stats
        try:
            while not stop.is_set():
                try:
                    item = work_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _SENTINEL:
                    break
                local_idx, abs_seq, payload, cursor = item
                ds, nbytes, n = self._process(payload)
                t0 = time.perf_counter()
                with coord.cond:
                    # the batch the stager needs next must always get in
                    # (capacity back-pressure would deadlock otherwise)
                    while (len(coord.buf) >= coord.capacity
                           and local_idx != coord.next_needed
                           and not stop.is_set() and coord.error is None):
                        coord.cond.wait(timeout=0.1)
                    if stop.is_set() or coord.error is not None:
                        return
                    coord.buf[local_idx] = (ds, cursor, nbytes, n)
                    coord.cond.notify_all()
                stats.add_producer_stall(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001
            coord.fail(e)
        finally:
            with coord.cond:
                coord.workers_done += 1
                coord.cond.notify_all()

    def _stage(self, ds):
        """The stager thread's half of host-to-card staging: batch j+1's
        copy runs on the side stream while the trainer computes on batch
        j (``Stager.put``); the consumer's half is ``Stager.take``."""
        if self._staging is None:
            return ds
        with obs_trace.span("etl.stage"):
            return self._staging.put(ds)

    def _stager(self, coord, stop, out_q):
        stats = self.pipeline_stats
        try:
            while not stop.is_set():
                with coord.cond:
                    while (coord.next_needed not in coord.buf
                           and not stop.is_set() and coord.error is None
                           and not (coord.total is not None
                                    and coord.next_needed >= coord.total
                                    and coord.workers_done >= self.workers)):
                        coord.cond.wait(timeout=0.1)
                    if stop.is_set() or coord.error is not None:
                        return
                    if coord.next_needed not in coord.buf:
                        return  # stream complete
                    ds, cursor, nbytes, n = coord.buf.pop(coord.next_needed)
                    coord.next_needed += 1
                    coord.cond.notify_all()
                staged = self._stage(ds)
                t0 = time.perf_counter()
                while not stop.is_set():
                    try:
                        out_q.put((staged, cursor, nbytes, n), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
                stats.add_producer_stall(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001
            coord.fail(e)
        finally:
            # the consumer's end-of-pass signal, errors included (it
            # re-raises coord.error on receipt)
            while True:
                try:
                    out_q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break


class _NativeSource(DataSetIterator):
    """``native.NativePrefetchIterator`` as a DataSet source."""

    def __init__(self, features, labels, batch: int, *, epochs: int = 1,
                 seed: int = 0, capacity: int = 4):
        from deeplearning4j_tpu_torch.native import NativePrefetchIterator

        self._it = NativePrefetchIterator(
            np.asarray(features), np.asarray(labels), batch,
            epochs=epochs, seed=seed, capacity=capacity)

    def __iter__(self):
        for x, y in self._it:
            yield DataSet(features=x, labels=y)

    def batch_size(self) -> int:
        return self._it.batch

    def total_examples(self) -> int:
        return int(len(self._it.features)) * self._it.epochs


def maybe_wrap(iterator, device=None):
    """``fit_iterator``'s adoption hook: when ``DL4J_TPU_PIPELINE_WORKERS``
    opts in (> 0), a plain iterator is wrapped in an
    :class:`InputPipeline` staging to ``device`` (the net's); staged
    iterators (anything with ``pipeline_stats``) and non-iterables pass
    through. With the knob unset this is the identity.

    ``shard=None`` on purpose: an iterator handed to ``fit_iterator`` is
    already this process's stream, so sharding it again would drop
    batches."""
    n = envknob.get_int(WORKERS_ENV)
    if n <= 0:
        return iterator
    if getattr(iterator, "pipeline_stats", None) is not None:
        return iterator
    if not hasattr(iterator, "__iter__"):
        return iterator
    return InputPipeline(iterator, workers=n, shard=None, device=device)
