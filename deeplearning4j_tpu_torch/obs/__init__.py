"""Observability (counterpart: ``deeplearning4j_tpu/obs/``): spans, one
metrics registry, the flight-recorder journal and Prometheus export.

The ledgers (``serving_stats``, ``retrieval_stats``, each container's
``dispatch_stats``) register into ONE :class:`MetricsRegistry`; a
default-off span tracer (``DL4J_TPU_OBS``) threads request ids from
``serve.request`` through ``serve.batch``; a bounded journal keeps the
last events on disk; the engine's ``/metrics`` and the standalone
:class:`MetricsExporter` serve the text exposition.

Everything here is host-side and stdlib-only: no device syncs.
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
    "tracer",
]
