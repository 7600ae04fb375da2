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

Failure semantics (the JAX batcher's :109-170 and :285-410):

  * hung dispatch       — ``watchdog_s > 0`` arms an ``InferenceWatchdog``
                          around every ``infer_fn`` call (its answer is
                          already on the host when it returns). On expiry
                          the in-flight futures fail with
                          ModelWedgedError, the hung worker thread is
                          abandoned behind a generation fence (its late
                          return resolves nothing and takes no batch) and
                          a fresh worker takes over the queue;
  * dead worker         — an uncaught error in the worker loop fails every
                          queued and in-flight request and marks the
                          batcher dead (``submit`` then raises
                          WorkerDeadError);
  * per-dispatch hooks  — ``on_outcome(ok, exc)`` feeds the engine's
                          circuit breaker, ``on_wedged(info)`` lets it
                          trip the breaker on the watchdog's verdict.

``drain`` waits for the queue and the in-flight batch to empty; ``stop``
fails whatever remains, the in-flight batch included. Each dispatch runs
inside a ``serve.batch`` span (``obs/trace.py``, under ``DL4J_TPU_OBS``)
listing the engine's request ids of its members (JAX :459-462).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.serving.resilience import (
    InferenceWatchdog,
    ModelWedgedError,
    WorkerDeadError,
)
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
    __slots__ = ("rows", "future", "deadline", "enqueued", "rid")

    def __init__(self, rows: np.ndarray, deadline: float,
                 rid: Optional[int] = None) -> None:
        self.rows = rows
        self.future: Future = Future()
        self.deadline = deadline
        self.enqueued = time.monotonic()
        # the engine's observability request id: it rides the queue and
        # surfaces in the serve.batch span of the dispatch it joins
        self.rid = rid


class DynamicBatcher:
    """Coalesce concurrent row-wise inference requests into batches.

    ``infer_fn(batch [N, ...]) -> np.ndarray [N, ...]`` is the model call.
    It runs on the worker thread, one at a time, so a model whose output
    path is not thread-safe needs no lock of its own."""

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 64, max_wait_ms: float = 10.0,
                 queue_capacity: int = 512,
                 default_timeout_s: float = 60.0,
                 stats: Optional[ServingStats] = None,
                 watchdog_s: float = 0.0,
                 on_wedged: Optional[Callable[[dict], None]] = None,
                 on_outcome: Optional[Callable] = None) -> None:
        if max_batch < 1 or queue_capacity < 1:
            raise ValueError("max_batch and queue_capacity must be >= 1")
        self._infer = infer_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self.default_timeout_s = float(default_timeout_s)
        self.stats = stats if stats is not None else ServingStats()
        self._on_outcome = on_outcome
        self._on_wedged = on_wedged
        self._q: deque = deque()
        self._q_rows = 0
        self._cond = threading.Condition(threading.Lock())
        self._running = True
        # the worker-generation fence: each worker thread carries the
        # generation it was born with; a wedge or stop() bumps it, so a
        # hung worker that wakes later takes no batch and resolves
        # nothing. _inflight is (gen, requests) inside infer_fn.
        self._gen = 0
        self._inflight: Optional[tuple] = None
        self._dead: Optional[str] = None  # uncaught worker error
        self.watchdog = (InferenceWatchdog(watchdog_s, self._wedge_handler)
                         if watchdog_s > 0 else None)
        self._worker = self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._run, args=(self._gen,),
                             daemon=True,
                             name=f"dynamic-batcher-g{self._gen}")
        t.start()
        return t

    # -- client side ------------------------------------------------------
    def submit(self, rows, timeout_s: Optional[float] = None,
               rid: Optional[int] = None) -> Future:
        """Enqueue ``rows`` ([k, ...]: one request may carry several rows)
        and return a Future of the [k, ...] outputs. Raises QueueFullError
        at capacity. ``rid`` is the engine's observability request id."""
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] < 1:
            raise ValueError("submit() needs at least one row")
        self.stats.record_request()
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.default_timeout_s)
        req = _Request(rows, deadline, rid=rid)
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is stopped")
            if self._dead is not None:
                raise WorkerDeadError(
                    f"batcher worker died ({self._dead}); requests would "
                    "queue forever")
            if not self._worker.is_alive():
                self._dead = "worker thread not alive"
                self.stats.record_worker_death()
                raise WorkerDeadError(
                    "batcher worker thread is dead; requests would queue "
                    "forever")
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

    def predict(self, rows, timeout_s: Optional[float] = None,
                rid: Optional[int] = None) -> np.ndarray:
        """submit() + wait; raises RequestTimeoutError past the deadline."""
        budget = timeout_s if timeout_s is not None else self.default_timeout_s
        fut = self.submit(rows, timeout_s=budget, rid=rid)
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
        """Stop the worker and fail whatever is still queued or in flight
        (a hung dispatch holds its requests outside the queue)."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)
        if self.watchdog is not None:
            self.watchdog.stop()
        with self._cond:
            inflight = self._inflight
            self._inflight = None
            self._gen += 1  # fence a still-running worker out
            victims = list(self._q)
            self._q.clear()
            self._q_rows = 0
            self.stats.set_queue_depth(0, "batcher")
        for req in victims:
            _resolve(req.future, exception=RuntimeError("batcher stopped"))
        if inflight is not None:
            for req in inflight[1]:
                _resolve(req.future, exception=RuntimeError(
                    "batcher stopped with this request in flight"))

    # -- worker side ------------------------------------------------------
    def _take_batch(self, gen: int) -> Optional[List[_Request]]:
        """Under the lock: wait for work, honour the flush rules and pop
        whole requests up to max_batch rows. None when this worker should
        exit (stopped, or fenced out). A non-empty take is recorded as in
        flight before the lock drops."""
        with self._cond:
            while self._running and self._gen == gen and not self._q:
                self._cond.wait()
            if not self._q or self._gen != gen:
                return None
            flush_at = self._q[0].enqueued + self.max_wait_s
            while (self._running and self._gen == gen
                   and self._q_rows < self.max_batch
                   and time.monotonic() < flush_at):
                self._cond.wait(timeout=max(0.0,
                                            flush_at - time.monotonic()))
            if self._gen != gen:
                return None
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
                self._inflight = (gen, taken)
            return taken

    def _clear_inflight(self, gen: int) -> None:
        with self._cond:
            if self._inflight is not None and self._inflight[0] == gen:
                self._inflight = None
                self._cond.notify_all()  # drain() waiters

    def _run(self, gen: int) -> None:
        try:
            self._run_inner(gen)
        except Exception as e:  # noqa: BLE001 — worker loop boundary
            self._worker_died(gen, e)

    def _worker_died(self, gen: int, exc: Exception) -> None:
        with self._cond:
            if self._gen != gen or not self._running:
                return  # a fenced worker's death is not news
            self._dead = f"{type(exc).__name__}: {exc}"
            inflight = self._inflight
            self._inflight = None
            victims = list(inflight[1]) if inflight is not None else []
            victims.extend(self._q)
            self._q.clear()
            self._q_rows = 0
            self.stats.set_queue_depth(0, "batcher")
            self._cond.notify_all()
        self.stats.record_worker_death()
        err = WorkerDeadError(f"batcher worker died: {self._dead}")
        for req in victims:
            _resolve(req.future, exception=err)
        if self._on_outcome is not None:
            self._on_outcome(False, err)

    def _wedge_handler(self, meta: dict) -> None:
        """The watchdog's verdict, on its thread: fence the hung worker out
        behind a generation bump, report upward (the engine trips the
        breaker there, before a client unblocked by its failed future can
        retry), start a fresh worker, then fail the in-flight futures with
        a diagnosis."""
        gen = meta["gen"]
        with self._cond:
            if not self._running or self._gen != gen:
                return  # stop() or an earlier wedge superseded this
            if self._inflight is None or self._inflight[0] != gen:
                return  # completed inside the race window
            taken = self._inflight[1]
            self._inflight = None
            self._gen += 1
            self._cond.notify_all()
        self.stats.record_wedged()
        err = ModelWedgedError(
            f"inference dispatch exceeded the "
            f"{self.watchdog.timeout_s:.2f}s watchdog deadline with "
            f"{meta['rows']} rows in flight (a hung device call: no "
            "error, no progress); worker replaced")
        if self._on_wedged is not None:
            try:
                self._on_wedged({
                    "rows": int(meta["rows"]),
                    "failed_requests": len(taken),
                    "watchdog_s": self.watchdog.timeout_s,
                    "error": str(err),
                })
            except Exception:  # noqa: BLE001 — reporting never re-wedges
                pass
        # the fresh worker (and its count) before the futures fail: a
        # client that reads /metrics after its 503 sees the restart (the
        # JAX batcher counts it after, a race its own watchdog test hits)
        with self._cond:
            if self._running:
                self._worker = self._spawn_worker()
                self.stats.record_watchdog_restart()
        for req in taken:
            _resolve(req.future, exception=err)

    def _run_inner(self, gen: int) -> None:
        while True:
            taken = self._take_batch(gen)
            if taken is None:
                return
            if not taken:
                continue  # everything in the window had expired
            try:
                batch = (taken[0].rows if len(taken) == 1
                         else np.concatenate([r.rows for r in taken],
                                             axis=0))
            except Exception as e:  # noqa: BLE001 — batch-prep boundary
                for req in taken:
                    _resolve(req.future, exception=e)
                self._clear_inflight(gen)
                continue
            n = batch.shape[0]
            # the pad rows the model's own bucketing adds (output())
            padded_to = (n if dispatch.bucketing_mode() == "off"
                         else max(dispatch.bucket_size(n), n))
            self.stats.record_batch(n, padded_to)
            wd = self.watchdog
            token = (wd.arm({"gen": gen, "rows": n}) if wd is not None
                     else None)
            try:
                # the coalesced-batch span lists every member's request
                # id; the infer fn's host read-back of the answer ends it
                with obs_trace.span(
                        "serve.batch", rows=int(n),
                        padded_to=int(padded_to),
                        request_ids=[r.rid for r in taken]):
                    out = np.asarray(self._infer(batch))
            except Exception as e:  # noqa: BLE001 — serving boundary
                live = wd.disarm(token) if wd is not None else True
                if not live:
                    return  # the watchdog already answered and replaced us
                for req in taken:
                    _resolve(req.future, exception=e)
                self._clear_inflight(gen)
                if self._on_outcome is not None:
                    self._on_outcome(False, e)
                continue
            live = wd.disarm(token) if wd is not None else True
            if not live:
                return  # fenced: the fresh worker owns the queue now
            if self._on_outcome is not None:
                self._on_outcome(True, None)
            i = 0
            for req in taken:
                k = req.rows.shape[0]
                if _resolve(req.future, result=out[i:i + k]):
                    self.stats.record_latency(time.monotonic() - req.enqueued)
                i += k
            self._clear_inflight(gen)
