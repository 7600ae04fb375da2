"""Evaluation of the port (counterpart: ``deeplearning4j_tpu/eval/``)."""

from deeplearning4j_tpu_torch.eval.evaluation import (
    ROC,
    ConfusionMatrix,
    Evaluation,
    RegressionEvaluation,
)
