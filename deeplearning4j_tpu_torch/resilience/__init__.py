"""The fault-tolerant training runtime and fault injection (counterpart:
``deeplearning4j_tpu/resilience/``): ``checkpoint`` (the async atomic
``CheckpointManager``), ``trainer`` (``ResilientTrainer``: preemption,
restore-and-continue, retry) and ``chaos`` (the training, low-precision,
serving and speculative-decode fault plans). The fleet and autoscale
chaos wait for the slices that port those planes."""

from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosMonkey,
    InjectedKill,
    InjectedServingFault,
    LowPrecChaos,
    LowPrecChaosConfig,
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
