"""DataSet and the iterators (counterpart:
``deeplearning4j_tpu/datasets/iterator.py`` — ``DataSet`` and its
utilities :36-133, ``SplitTestAndTrain`` :134, ``MultiDataSet``,
``DataSetIterator``, ``ListDataSetIterator`` :193,
``AsyncDataSetIterator`` :255, ``MultipleEpochsIterator`` :395 and
``SamplingDataSetIterator`` :438).

A ``DataSet`` holds one minibatch (features, labels and their optional
masks) as numpy arrays or tensors. Its utilities (standardize,
normalize, scale, shuffle, sample, split) work on the host with numpy's
``default_rng``, so their results are the JAX package's bit for bit.
Every iterator can resume mid-pass: ``state()`` is a JSON-able cursor in
the JAX package's dict form and ``restore_state`` makes the next pass
continue from it.

``AsyncDataSetIterator`` prefetches on a background thread and stages
each batch to the card through the input pipeline's stager
(``etl/pipeline.Stager``: a pinned host copy, an async copy on a side
stream, an event the consumer's stream waits on); its cursor is the
batch delivered, not the batch prefetched.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

import numpy as np


def _float_dtype_of(a) -> np.dtype:
    """A floating dtype survives the in-place utilities (an f64 pipeline
    stays f64); integer and bool inputs standardize to float32."""
    dt = np.asarray(a).dtype
    return dt if np.issubdtype(dt, np.floating) else np.dtype(np.float32)


@dataclass
class DataSet:
    """One minibatch: features and labels with optional masks."""

    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def normalize_zero_mean_zero_unit_variance(self) -> "DataSet":
        """Per-COLUMN standardization of the features, in place (the
        reference's column-wise mean/std over the batch dim); zero-std
        columns divide by 1 instead of exploding."""
        f = np.asarray(self.features, np.float64)
        axis = 0
        mean = f.mean(axis=axis, keepdims=True)
        std = f.std(axis=axis, keepdims=True)
        std = np.where(std == 0, 1.0, std)
        self.features = ((f - mean) / std).astype(_float_dtype_of(
            self.features))
        return self

    def normalize(self) -> "DataSet":
        """Scale features into [0, 1] by the global min/max (the
        reference's normalize())."""
        f = np.asarray(self.features, np.float64)
        lo, hi = f.min(), f.max()
        span = (hi - lo) or 1.0
        self.features = ((f - lo) / span).astype(_float_dtype_of(
            self.features))
        return self

    def scale(self, by: float = 0.0) -> "DataSet":
        """Divide features by `by` (default: the max absolute value —
        the reference's scale() divides by max)."""
        f = np.asarray(self.features, np.float64)
        d = by if by else (np.abs(f).max() or 1.0)
        self.features = (f / d).astype(_float_dtype_of(self.features))
        return self

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        """Permute examples in place (features/labels/masks together)."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = np.asarray(self.features)[idx]
        self.labels = np.asarray(self.labels)[idx]
        if self.features_mask is not None:
            self.features_mask = np.asarray(self.features_mask)[idx]
        if self.labels_mask is not None:
            self.labels_mask = np.asarray(self.labels_mask)[idx]
        return self

    def sample(self, n: int, seed: Optional[int] = None,
               with_replacement: bool = False) -> "DataSet":
        """A new DataSet of n examples drawn from this one (the
        reference's sample(numSamples[, rng, withReplacement]))."""
        rng = np.random.default_rng(seed)
        total = self.num_examples()
        if with_replacement:
            idx = rng.integers(0, total, n)
        else:
            if n > total:
                raise ValueError(
                    f"sample({n}) without replacement from {total}")
            idx = rng.permutation(total)[:n]
        take = lambda a: None if a is None else np.asarray(a)[idx]
        return DataSet(take(self.features), take(self.labels),
                       take(self.features_mask), take(self.labels_mask))

    def split_test_and_train(self, n_train: int) -> "SplitTestAndTrain":
        """First n_train examples -> train, rest -> test (the reference's
        contiguous split; shuffle() first for a random split)."""
        total = self.num_examples()
        if not 0 < n_train < total:
            raise ValueError(f"n_train {n_train} outside (0, {total})")
        cut = lambda a, s: None if a is None else np.asarray(a)[s]
        mk = lambda s: DataSet(cut(self.features, s), cut(self.labels, s),
                               cut(self.features_mask, s),
                               cut(self.labels_mask, s))
        return SplitTestAndTrain(mk(slice(0, n_train)),
                                 mk(slice(n_train, total)))


@dataclass
class SplitTestAndTrain:
    """What ``DataSet.split_test_and_train`` returns (reference org.nd4j
    SplitTestAndTrain: getTrain()/getTest())."""

    train: "DataSet"
    test: "DataSet"


@dataclass
class MultiDataSet:
    """A multi-input, multi-output minibatch (reference org.nd4j
    MultiDataSet, consumed by ``ComputationGraph.fit``)."""

    features_list: List[Any]
    labels_list: List[Any]
    features_masks: Optional[List[Optional[Any]]] = None
    labels_masks: Optional[List[Optional[Any]]] = None

    def num_examples(self) -> int:
        return int(np.asarray(self.features_list[0]).shape[0])


class DataSetIterator:
    """Protocol: iterate DataSets; ``reset`` starts a new pass."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def state(self) -> Optional[dict]:
        """A JSON-able resume cursor, or None when this iterator cannot
        resume exactly."""
        return None

    def restore_state(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support exact resume")


class ListDataSetIterator(DataSetIterator):
    """Minibatches of an in-memory array pair, in order; the last short
    batch is kept unless ``drop_partial``."""

    def __init__(self, features, labels, batch: int, masks=None,
                 label_masks=None, drop_partial: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.masks = None if masks is None else np.asarray(masks)
        self.label_masks = (None if label_masks is None
                            else np.asarray(label_masks))
        self._batch = int(batch)
        self.drop_partial = drop_partial
        self._cursor = 0       # batches yielded in the current pass
        self._resume_skip = 0  # one-shot start offset (restore_state)

    def __iter__(self):
        start, self._resume_skip = self._resume_skip, 0
        self._cursor = start
        n = self.features.shape[0]
        for i in range(start * self._batch, n, self._batch):
            if self.drop_partial and i + self._batch > n:
                break
            sl = slice(i, min(i + self._batch, n))
            # the cursor moves before the yield: a checkpoint taken after
            # fitting batch j resumes at j + 1
            self._cursor += 1
            yield DataSet(
                self.features[sl], self.labels[sl],
                None if self.masks is None else self.masks[sl],
                None if self.label_masks is None else self.label_masks[sl])

    def reset(self):
        self._cursor = 0
        self._resume_skip = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return int(self.features.shape[0])

    def state(self):
        return {"cursor": self._cursor}

    def restore_state(self, state):
        self._resume_skip = int(state["cursor"])
        self._cursor = self._resume_skip


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference
    AsyncDataSetIterator.java:30): host batch assembly and the copy to
    the card overlap the training step.

    The queue depth defaults from ``DL4J_TPU_PREFETCH`` (an explicit
    ``queue_size`` wins). Batches go to ``device`` (the card unless
    ``device="cpu"``; with no card it raises) through the input
    pipeline's :class:`~deeplearning4j_tpu_torch.etl.pipeline.Stager`;
    ``device="cpu"`` or ``device_put=False`` stages nothing.
    ``pipeline_stats`` has the input pipeline's shape: the producer stall
    is the prefetch thread blocked on a full queue, the consumer stall the
    training thread waiting on it."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator,
                 queue_size: Optional[int] = None, device_put: bool = True,
                 device=None):
        from deeplearning4j_tpu_torch.etl.pipeline import (
            Stager,
            default_prefetch,
        )
        from deeplearning4j_tpu_torch.etl.stats import PipelineStats
        from deeplearning4j_tpu_torch.ops.device import resolve_device

        if queue_size is None:
            queue_size = default_prefetch()
        self.base = base
        self.queue_size = max(1, int(queue_size))
        self.device = resolve_device(device)
        self.device_put = device_put
        self._stager = (Stager(self.device)
                        if device_put and self.device.type == "cuda"
                        else None)
        self.pipeline_stats = PipelineStats(workers=1,
                                            queue_capacity=self.queue_size)
        # the cursor of the batch last delivered to the consumer, not
        # base.state(), which runs ahead by the batches in the queue: the
        # producer snapshots base.state() after pulling each batch and the
        # snapshot rides the queue with it
        self._last_state: Optional[dict] = None

    def _put(self, q: "queue.Queue", stop: threading.Event, item,
             timed: bool = True) -> bool:
        """A bounded put that gives up when the consumer left. Time
        blocked on a full queue is the producer stall; the end-of-stream
        sentinel waits for the consumer to drain the queue, which is not
        a stall (``timed=False``)."""
        t0 = time.perf_counter()
        try:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            if timed:
                self.pipeline_stats.add_producer_stall(
                    time.perf_counter() - t0)

    def _producer(self, q: "queue.Queue", stop: threading.Event,
                  failed: list):
        from deeplearning4j_tpu_torch.etl.stats import dataset_nbytes

        try:
            for ds in self.base:
                if stop.is_set():
                    return
                # the resume snapshot of this batch (the base is only
                # touched from this thread)
                snap = self.base.state()
                nbytes = dataset_nbytes(ds)
                n = ds.num_examples()
                staged = (ds if self._stager is None
                          else self._stager.put(ds))
                if not self._put(q, stop, (staged, snap, nbytes, n)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised to the consumer
            failed.append(e)
        finally:
            self._put(q, stop, self._SENTINEL, timed=False)

    def __iter__(self):
        # before any delivery the resume point is wherever the base
        # stands (a fresh pass or a restored cursor)
        self._last_state = self.base.state()
        stats = self.pipeline_stats
        stats.start_pass()
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        failed: list = []
        t = threading.Thread(target=self._producer, args=(q, stop, failed),
                             daemon=True, name="async-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                stats.add_consumer_stall(time.perf_counter() - t0)
                if item is self._SENTINEL:
                    if failed:
                        raise failed[0]
                    break
                staged, snap, nbytes, n = item
                ds = (staged if self._stager is None
                      else self._stager.take(staged))
                self._last_state = snap
                stats.record_delivered(nbytes, n, q.qsize())
                yield ds
        finally:
            stop.set()
            t.join(timeout=5.0)
            if self._stager is not None:
                self._stager.drain()
            stats.end_pass()

    def reset(self):
        self._last_state = None
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples()

    def state(self):
        return (self._last_state if self._last_state is not None
                else self.base.state())

    def restore_state(self, state):
        self.base.restore_state(state)
        self._last_state = dict(state)


class MultipleEpochsIterator(DataSetIterator):
    """A base iterator repeated for N epochs (reference
    MultipleEpochsIterator); the cursor is the epoch and the base's."""

    def __init__(self, num_epochs: int, base: DataSetIterator):
        self.num_epochs = int(num_epochs)
        self.base = base
        self._epoch = 0
        self._resume: Optional[dict] = None

    def __iter__(self):
        resume, self._resume = self._resume, None
        start = 0
        if resume is not None:
            start = int(resume.get("epoch", 0))
            if resume.get("base") is not None:
                self.base.restore_state(resume["base"])
        for ep in range(start, self.num_epochs):
            self._epoch = ep
            yield from self.base
            self.base.reset()

    def reset(self):
        self._epoch = 0
        self._resume = None
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples() * self.num_epochs

    def state(self):
        base = self.base.state()
        if base is None:
            return None
        return {"epoch": self._epoch, "base": base}

    def restore_state(self, state):
        self._resume = dict(state)
        self._epoch = int(state.get("epoch", 0))


class SamplingDataSetIterator(DataSetIterator):
    """Minibatches sampled with replacement (reference
    SamplingDataSetIterator), by numpy's ``default_rng(seed)``; the cursor
    carries the bit generator's state, so a resume replays the same
    remaining indices."""

    def __init__(self, features, labels, batch: int, total_batches: int,
                 seed: int = 0):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self._batch = int(batch)
        self.total_batches = int(total_batches)
        self._rng = np.random.default_rng(seed)
        self._cursor = 0
        self._resume_skip = 0

    def __iter__(self):
        start, self._resume_skip = self._resume_skip, 0
        self._cursor = start
        n = self.features.shape[0]
        for _ in range(start, self.total_batches):
            idx = self._rng.integers(0, n, size=self._batch)
            self._cursor += 1
            yield DataSet(self.features[idx], self.labels[idx])

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return self._batch * self.total_batches

    def state(self):
        return {"cursor": self._cursor,
                "rng_state": self._rng.bit_generator.state}

    def restore_state(self, state):
        self._resume_skip = int(state["cursor"])
        self._cursor = self._resume_skip
        if state.get("rng_state") is not None:
            self._rng = np.random.default_rng()
            self._rng.bit_generator.state = state["rng_state"]
