"""Dynamic request batching for ``/predict``, plus the backpressure and
deadline errors both serving paths raise (counterpart:
``deeplearning4j_tpu/serving/batcher.py``, the contract of
``DynamicBatcher`` :123-489).

A bounded queue coalesces concurrent row-wise requests into one batch per
dispatch; the model's ``output`` pads the batch to its bucket
(``ops/dispatch.bucket_size``), so the steady state meets the small set of
shapes the registry's warm-up covers. Flow control, in order:

  * bucket-full flush   — ``max_batch`` real rows waiting: dispatch now;
  * deadline flush      — the oldest queued request has waited
                          ``max_wait_ms``: dispatch whatever is here;
  * backpressure        — past ``queue_capacity`` queued rows ``submit``
                          raises QueueFullError (HTTP 429); an empty queue
                          always admits, so one oversize request runs as
                          its own batch;
  * per-request timeout — a request past its deadline is answered with
                          RequestTimeoutError (HTTP 504), never dropped;
  * shape guard         — a request whose row shape differs from the
                          batch's heads the next batch, so one malformed
                          request fails alone.

An uncaught error in the worker loop fails every queued and in-flight
request and marks the batcher dead (``submit`` then raises
WorkerDeadError). ``drain`` waits for the queue and the in-flight batch to
empty; ``stop`` fails whatever remains. The hung-dispatch watchdog, the
wedge handler with its worker generations, the circuit-breaker hooks and
tracing spans wait for a later slice.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.serving.resilience import WorkerDeadError
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity (HTTP 429)."""


class RequestTimeoutError(TimeoutError):
    """The request's deadline expired before it was answered (HTTP 504)."""


def _resolve(fut: Future, result=None, exception=None) -> bool:
    """Resolve a future if its client is still waiting; False for a future
    already done or cancelled by a timed-out waiter (the done() check races
    the waiter's cancel(), hence the except)."""
    try:
        if fut.done():
            return False
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
        return True
    except Exception:  # noqa: BLE001 — InvalidStateError/CancelledError race
        return False


class _Request:
    __slots__ = ("rows", "future", "deadline", "enqueued")

    def __init__(self, rows: np.ndarray, deadline: float) -> None:
        self.rows = rows
        self.future: Future = Future()
        self.deadline = deadline
        self.enqueued = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent row-wise inference requests into batches.

    ``infer_fn(batch [N, ...]) -> np.ndarray [N, ...]`` is the model call.
    It runs on the single worker thread, so a model whose output path is
    not thread-safe needs no lock of its own."""

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 64, max_wait_ms: float = 10.0,
                 queue_capacity: int = 512,
                 default_timeout_s: float = 60.0,
                 stats: Optional[ServingStats] = None) -> None:
        if max_batch < 1 or queue_capacity < 1:
            raise ValueError("max_batch and queue_capacity must be >= 1")
        self._infer = infer_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self.default_timeout_s = float(default_timeout_s)
        self.stats = stats if stats is not None else ServingStats()
        self._q: deque = deque()
        self._q_rows = 0
        self._cond = threading.Condition(threading.Lock())
        self._running = True
        self._inflight: Optional[List[_Request]] = None
        self._dead: Optional[str] = None  # uncaught worker error
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dynamic-batcher")
        self._worker.start()

    # -- client side ------------------------------------------------------
    def submit(self, rows, timeout_s: Optional[float] = None) -> Future:
        """Enqueue ``rows`` ([k, ...]: one request may carry several rows)
        and return a Future of the [k, ...] outputs. Raises QueueFullError
        at capacity."""
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] < 1:
            raise ValueError("submit() needs at least one row")
        self.stats.record_request()
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.default_timeout_s)
        req = _Request(rows, deadline)
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is stopped")
            if self._dead is not None:
                raise WorkerDeadError(
                    f"batcher worker died ({self._dead}); requests would "
                    "queue forever")
            if (self._q_rows > 0
                    and self._q_rows + rows.shape[0] > self.queue_capacity):
                self.stats.record_rejected()
                raise QueueFullError(
                    f"queue at capacity ({self._q_rows}/"
                    f"{self.queue_capacity} rows)")
            self._q.append(req)
            self._q_rows += rows.shape[0]
            self.stats.set_queue_depth(self._q_rows, "batcher")
            self._cond.notify_all()
        return req.future

    def predict(self, rows, timeout_s: Optional[float] = None) -> np.ndarray:
        """submit() + wait; raises RequestTimeoutError past the deadline."""
        budget = timeout_s if timeout_s is not None else self.default_timeout_s
        fut = self.submit(rows, timeout_s=budget)
        try:
            return fut.result(timeout=budget + self.max_wait_s)
        except RequestTimeoutError:
            raise  # expired in the queue — counted in _take_batch
        except (TimeoutError, FutureTimeoutError) as e:
            # cancel so a batch finishing later records no phantom answer
            fut.cancel()
            self.stats.record_timeout()
            raise RequestTimeoutError("request timed out") from e

    def drain(self, timeout_s: float = 20.0) -> bool:
        """Wait (bounded) for the queue and the in-flight batch to empty.
        True when everything admitted was answered in time."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._cond:
            while (self._q or self._inflight is not None) \
                    and self._dead is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return self._dead is None

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the worker and fail whatever is still queued or in flight."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)
        with self._cond:
            victims = list(self._q) + list(self._inflight or [])
            self._q.clear()
            self._inflight = None
            self._q_rows = 0
            self.stats.set_queue_depth(0, "batcher")
        for req in victims:
            _resolve(req.future, exception=RuntimeError("batcher stopped"))

    # -- worker side ------------------------------------------------------
    def _take_batch(self) -> Optional[List[_Request]]:
        """Under the lock: wait for work, honour the flush rules and pop
        whole requests up to max_batch rows. None when stopped and empty.
        A non-empty take is recorded as in flight before the lock drops."""
        with self._cond:
            while self._running and not self._q:
                self._cond.wait()
            if not self._q:
                return None
            flush_at = self._q[0].enqueued + self.max_wait_s
            while (self._running and self._q_rows < self.max_batch
                   and time.monotonic() < flush_at):
                self._cond.wait(timeout=max(0.0,
                                            flush_at - time.monotonic()))
            now = time.monotonic()
            taken, rows = [], 0
            while self._q:
                req = self._q[0]
                if req.deadline < now:
                    self._q.popleft()
                    self._q_rows -= req.rows.shape[0]
                    if _resolve(req.future, exception=RequestTimeoutError(
                            "request expired before its batch ran")):
                        self.stats.record_timeout()
                    continue
                if taken and rows + req.rows.shape[0] > self.max_batch:
                    break
                if taken and req.rows.shape[1:] != taken[0].rows.shape[1:]:
                    break  # the odd shape heads the next batch
                self._q.popleft()
                self._q_rows -= req.rows.shape[0]
                taken.append(req)
                rows += req.rows.shape[0]
            self.stats.set_queue_depth(self._q_rows, "batcher")
            if taken:
                self._inflight = taken
            return taken

    def _clear_inflight(self) -> None:
        with self._cond:
            self._inflight = None
            self._cond.notify_all()  # drain() waiters

    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — worker loop boundary
            self._worker_died(e)

    def _worker_died(self, exc: Exception) -> None:
        with self._cond:
            self._dead = f"{type(exc).__name__}: {exc}"
            victims = list(self._inflight or []) + list(self._q)
            self._inflight = None
            self._q.clear()
            self._q_rows = 0
            self.stats.set_queue_depth(0, "batcher")
            self._cond.notify_all()
        self.stats.record_worker_death()
        err = WorkerDeadError(f"batcher worker died: {self._dead}")
        for req in victims:
            _resolve(req.future, exception=err)

    def _run_inner(self) -> None:
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            if not taken:
                continue  # everything in the window had expired
            batch = (taken[0].rows if len(taken) == 1
                     else np.concatenate([r.rows for r in taken], axis=0))
            n = batch.shape[0]
            # the pad rows the model's own bucketing adds (output())
            padded_to = (n if dispatch.bucketing_mode() == "off"
                         else max(dispatch.bucket_size(n), n))
            self.stats.record_batch(n, padded_to)
            try:
                out = np.asarray(self._infer(batch))
            except Exception as e:  # noqa: BLE001 — serving boundary
                for req in taken:
                    _resolve(req.future, exception=e)
                self._clear_inflight()
                continue
            i = 0
            for req in taken:
                k = req.rows.shape[0]
                if _resolve(req.future, result=out[i:i + k]):
                    self.stats.record_latency(time.monotonic() - req.enqueued)
                i += k
            self._clear_inflight()
