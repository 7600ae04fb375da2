"""The fault-tolerant training runtime and fault injection (counterpart:
``deeplearning4j_tpu/resilience/``): ``checkpoint`` (the async atomic
``CheckpointManager``), ``trainer`` (``ResilientTrainer``: preemption,
restore-and-continue, retry) and ``chaos`` (the training, low-precision,
serving, speculative-decode, elastic-fleet, router and autoscaler fault
plans)."""

from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    AutoscaleChaos,
    AutoscaleChaosConfig,
    ChaosConfig,
    ChaosMonkey,
    CoordinatorPartitioned,
    FleetChaos,
    FleetChaosConfig,
    InjectedKill,
    InjectedServingFault,
    LowPrecChaos,
    LowPrecChaosConfig,
    ReplicaPartitioned,
    RouterChaos,
    RouterChaosConfig,
    ServingChaos,
    ServingChaosConfig,
    SpecChaos,
    SpecChaosConfig,
    TransientDeviceError,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import (  # noqa: F401
    CheckpointCorrupt,
    CheckpointManager,
)
from deeplearning4j_tpu_torch.resilience.trainer import (  # noqa: F401
    Preempted,
    ResilientTrainer,
)
