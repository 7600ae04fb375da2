"""Early stopping (counterpart: ``deeplearning4j_tpu/earlystopping/``,
its modules but ``distributed.py``, which waits for slice 12): the
configuration, the terminations, the score calculator, the savers and
the trainer (reference BaseEarlyStoppingTrainer.java:82-160)."""

from deeplearning4j_tpu_torch.earlystopping.config import (  # noqa: F401
    EarlyStoppingConfiguration,
)
from deeplearning4j_tpu_torch.earlystopping.result import (  # noqa: F401
    EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.earlystopping.savers import (  # noqa: F401
    CheckpointManagerSaver,
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.scorecalc import (  # noqa: F401
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.earlystopping.terminations import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (  # noqa: F401
    EarlyStoppingTrainer,
)
