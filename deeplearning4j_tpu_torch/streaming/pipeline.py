"""Streaming training pipeline (counterpart:
``deeplearning4j_tpu/streaming/pipeline.py``): an in-process bounded queue
stands in for the broker; a consumer thread assembles fixed-size
minibatches and fits the network (``net.fit`` per minibatch, on the net's
own device). ``publish`` is the producer side."""

from __future__ import annotations

import logging
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.streaming.conversion import record_to_array

logger = logging.getLogger("deeplearning4j_tpu_torch")


class StreamingTrainingPipeline:
    def __init__(self, net, num_classes: int, batch_size: int = 32,
                 max_queue: int = 10_000):
        self.net = net
        self.num_classes = num_classes
        self.batch_size = batch_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.batches_fit = 0
        self.losses: List[float] = []
        self.error: Optional[BaseException] = None

    # -- producer side (Kafka topic write) ---------------------------------
    def publish(self, record: Sequence, label: int) -> None:
        if self.error is not None:
            raise RuntimeError(
                "streaming pipeline consumer died"
            ) from self.error
        self._queue.put((record_to_array(record), int(label)))

    # -- consumer side -----------------------------------------------------
    def _consume(self):
        feats, labels = [], []
        while not self._stop.is_set() or not self._queue.empty():
            try:
                f, l = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            feats.append(f)
            labels.append(l)
            if len(feats) == self.batch_size:
                try:
                    self._fit_batch(feats, labels)
                except Exception as e:  # noqa: BLE001 — surface to producer
                    logger.exception("streaming pipeline: fit failed, stopping")
                    self.error = e
                    self._stop.set()
                    return
                feats, labels = [], []
        if feats and self._stop.is_set():
            # a drain-time partial batch is dropped (every fit sees the
            # same batch shape); callers control batch sizing
            pass

    def _fit_batch(self, feats, labels):
        x = np.stack(feats)
        y = np.eye(self.num_classes, dtype=np.float32)[np.asarray(labels)]
        loss = float(self.net.fit(x, y))
        self.losses.append(loss)
        self.batches_fit += 1

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StreamingTrainingPipeline":
        if self.net.params is None:
            self.net.init()
        self._stop.clear()
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
