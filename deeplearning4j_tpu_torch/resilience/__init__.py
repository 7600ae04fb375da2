"""Fault injection (counterpart: ``deeplearning4j_tpu/resilience/``). Only
the speculative-decode chaos is ported; the rest waits for a later
slice."""

from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    SpecChaos,
    SpecChaosConfig,
)
