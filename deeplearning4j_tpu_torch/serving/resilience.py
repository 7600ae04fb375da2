"""Client, worker and drain failure types (counterpart:
``deeplearning4j_tpu/serving/resilience.py``). The circuit breaker and the
watchdog wait for a later slice."""

from __future__ import annotations


class ClientRequestError(ValueError):
    """A malformed request, raised before any device work: 400-class
    client evidence."""


class WorkerDeadError(RuntimeError):
    """The decode worker thread is dead: submit fast-fails instead of
    queueing requests nobody will ever serve (HTTP 503)."""


class DrainingError(RuntimeError):
    """The engine is draining or stopped: admission is closed (HTTP 503)."""
