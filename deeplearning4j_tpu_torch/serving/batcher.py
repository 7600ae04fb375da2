"""Backpressure and deadline errors (counterpart:
``deeplearning4j_tpu/serving/batcher.py``). The ``/predict`` dynamic
batcher itself waits for the MultiLayerNetwork serving slice."""

from __future__ import annotations


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity (HTTP 429)."""


class RequestTimeoutError(TimeoutError):
    """The request's deadline expired before it was answered (HTTP 504)."""
