"""StreamSource: an unbounded live feed with monotone offsets
(counterpart: ``deeplearning4j_tpu/online/stream.py``, all of it).

The reference ingests live data through its scaleout streaming module
(Camel/Kafka routes): records arrive on a topic at their own pace and the
consumer reads from a MONOTONE OFFSET it can commit and seek back to.
This class is that consumer contract shrunk to one process:

  push(ds)    the producer side: assigns the next monotone offset and
              buffers the batch. BLOCKS while ``watermark`` batches sit
              undelivered (backpressure — a slow consumer must slow the
              feed, not exhaust the host; ``StreamBackpressure`` on a
              push timeout so a producer can shed instead of hang).
  __iter__    ONE POLL WINDOW, not the whole stream: yields buffered
              batches in offset order, waits up to ``idle_s`` for the
              next arrival, and ends the pass when the stream idles
              (``idle_s=0`` blocks until close). The end of a pass is
              "the feed went quiet", which bounds one
              ``VectorStore.feed_once`` window.
  state()     ``{"offset": next_to_deliver}``, and ``restore_state``
              seeks to a committed offset (the Kafka committed-offset
              model).

Deliberately NO ``reset()``: a live feed cannot rewind.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.ops import env as envknob

WATERMARK_ENV = "DL4J_TPU_ONLINE_WATERMARK"
IDLE_ENV = "DL4J_TPU_ONLINE_IDLE_S"


class StreamClosed(RuntimeError):
    """push() after close() — the feed is shut down."""


class StreamBackpressure(RuntimeError):
    """push() timed out waiting for watermark headroom."""


class StreamSource:
    def __init__(self, *, watermark: Optional[int] = None,
                 idle_s: Optional[float] = None, stats=None) -> None:
        self.watermark = max(1, int(
            watermark if watermark is not None
            else envknob.get_int(WATERMARK_ENV)))
        self.idle_s = float(idle_s if idle_s is not None
                            else envknob.get_float(IDLE_ENV))
        self.stats = stats  # optional OnlineStats ledger
        self._cond = threading.Condition()
        self._buf: Dict[int, Any] = {}   # offset -> DataSet
        self._read = 0                   # next offset to DELIVER
        self._next_push = 0              # next offset push() assigns
        self._closed = False
        self._last_batch_rows = 0

    # -- producer side -----------------------------------------------------
    def push(self, ds, timeout_s: Optional[float] = None) -> int:
        """Buffer one batch; returns its assigned stream offset. Blocks
        while ``watermark`` batches sit undelivered; ``timeout_s`` bounds
        the wait (``StreamBackpressure`` past it)."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + float(timeout_s))
        with self._cond:
            while (not self._closed
                   and self._next_push - self._read >= self.watermark):
                if self.stats is not None:
                    self.stats.bump("backpressure_waits")
                wait = 0.2
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        raise StreamBackpressure(
                            f"{self._next_push - self._read} batches "
                            f"undelivered >= watermark {self.watermark}")
                self._cond.wait(timeout=wait)
            if self._closed:
                raise StreamClosed("stream is closed")
            off = self._next_push
            self._buf[off] = ds
            self._next_push += 1
            try:
                self._last_batch_rows = int(ds.num_examples())
            except Exception:  # noqa: BLE001 — telemetry only
                pass
            if self.stats is not None:
                self.stats.bump("pushed_batches")
            self._cond.notify_all()
            return off

    def close(self) -> None:
        """Stop the feed: buffered batches still deliver, then iteration
        ends permanently; further push() raises StreamClosed."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def backlog(self) -> int:
        """Undelivered buffered batches (the backpressure quantity)."""
        with self._cond:
            return self._next_push - self._read

    # -- consumer side -----------------------------------------------------
    def __iter__(self):
        idle = self.idle_s
        while True:
            with self._cond:
                deadline = (None if idle <= 0
                            else time.monotonic() + idle)
                while self._read not in self._buf and not self._closed:
                    wait = 0.2
                    if deadline is not None:
                        wait = min(wait, deadline - time.monotonic())
                        if wait <= 0:
                            break
                    self._cond.wait(timeout=wait)
                if self._read not in self._buf:
                    if not self._closed and self.stats is not None:
                        self.stats.bump("idle_windows")
                    return  # idle window expired, or closed and drained
                ds = self._buf.pop(self._read)
                self._read += 1
                if self.stats is not None:
                    self.stats.bump("delivered_batches")
                self._cond.notify_all()
            yield ds

    # -- resume protocol ---------------------------------------------------
    def state(self) -> Dict[str, int]:
        with self._cond:
            return {"offset": self._read}

    def restore_state(self, state: Dict[str, int]) -> None:
        """Seek to a committed offset. Buffered batches below it are
        dropped (already consumed); on a FRESH source the producer
        re-pushes from the committed offset and the monotone numbering
        continues from there — the Kafka seek-to-committed replay."""
        k = int(state["offset"])
        with self._cond:
            for off in [o for o in self._buf if o < k]:
                del self._buf[off]
            self._read = k
            self._next_push = max(self._next_push, k)
            self._cond.notify_all()

    # -- DataSetIterator surface ------------------------------------------
    def batch_size(self) -> int:
        return self._last_batch_rows

    def total_examples(self) -> int:
        return 0  # unbounded stream — no total exists
