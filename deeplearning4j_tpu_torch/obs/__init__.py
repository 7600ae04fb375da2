"""Observability (counterpart: ``deeplearning4j_tpu/obs/``): spans, one
metrics registry, the flight-recorder journal and Prometheus export.

The ledgers (``serving_stats``, ``retrieval_stats``, each container's
``dispatch_stats``) register into ONE :class:`MetricsRegistry`; a
default-off span tracer threads request ids from ``serve.request``
through ``serve.batch`` and splits a training step into ``train.step``,
``train.prepare``, ``train.forward``, ``train.backward``,
``train.optimizer`` and ``train.readback``; a bounded journal keeps the
last events on disk; the engine's ``/metrics`` and the standalone
:class:`MetricsExporter` serve the text exposition.

Spans are live under ``DL4J_TPU_OBS`` or while a ``torch.profiler``
records (only the first feeds the journal). A live span is also a
``record_function`` annotation in the profiler's trace, on the clock of
the kernels it encloses; the training spans marked ``device`` time
themselves on the card with two CUDA events each, read back into
``device_s`` by ``Event.query()`` once they have completed. No span
synchronizes the device (``obs/trace.py``).
"""

from deeplearning4j_tpu_torch.obs.exporter import MetricsExporter
from deeplearning4j_tpu_torch.obs.journal import (
    FlightRecorder,
    default_journal,
    default_journal_path,
)
from deeplearning4j_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
    register_net,
)
from deeplearning4j_tpu_torch.obs.trace import (
    ENV_OBS,
    Span,
    Tracer,
    obs_enabled,
    record_span,
    set_enabled,
    span,
    spans_live,
    tracer,
)

__all__ = [
    "ENV_OBS",
    "FlightRecorder",
    "MetricsExporter",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "default_journal",
    "default_journal_path",
    "default_registry",
    "obs_enabled",
    "record_span",
    "register_net",
    "set_enabled",
    "span",
    "spans_live",
    "tracer",
]
