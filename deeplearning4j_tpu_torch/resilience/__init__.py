"""Fault injection (counterpart: ``deeplearning4j_tpu/resilience/``). The
serving and speculative-decode chaos are ported; the training, fleet and
checkpoint planes wait for a later slice."""

from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    InjectedServingFault,
    ServingChaos,
    ServingChaosConfig,
    SpecChaos,
    SpecChaosConfig,
)
