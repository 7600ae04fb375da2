"""Observability (counterpart: ``deeplearning4j_tpu/obs/``): the metrics
registry and its Prometheus exposition, which the engine's ``/metrics``
renders. The journal, trace spans, ``register_net`` and the exporter
wait for the tooling slice."""
