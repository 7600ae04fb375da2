"""Termination conditions (counterpart:
``deeplearning4j_tpu/earlystopping/terminations.py`` :21-138; reference
earlystopping/termination/).

Epoch terminations are checked once per epoch with its score
(MaxEpochs, ScoreImprovement, BestScore); iteration terminations after
every minibatch with its loss (MaxTime, MaxScore, InvalidScore)."""

from __future__ import annotations

import math
import time


# ---------------------------------------------------------------------------
# epoch termination conditions
# ---------------------------------------------------------------------------


class MaxEpochsTerminationCondition:
    """Stop after N epochs (reference MaxEpochsTerminationCondition.java)."""

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def initialize(self):
        pass

    def terminate(self, epoch_num: int, score: float) -> bool:
        return epoch_num + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition:
    """Stop when no score improvement for N consecutive epochs
    (reference ScoreImprovementEpochTerminationCondition.java)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.best_score = None
        self.epochs_without = 0

    def initialize(self):
        self.best_score = None
        self.epochs_without = 0

    def terminate(self, epoch_num: int, score: float) -> bool:
        if self.best_score is None or self.best_score - score > self.min_improvement:
            self.best_score = score if self.best_score is None else min(
                self.best_score, score
            )
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without > self.patience

    def __repr__(self):
        return (
            f"ScoreImprovementEpochTerminationCondition({self.patience}, "
            f"{self.min_improvement})"
        )


class BestScoreEpochTerminationCondition:
    """Stop once score reaches a target value (reference
    BestScoreEpochTerminationCondition.java)."""

    def __init__(self, best_expected_score: float):
        self.target = float(best_expected_score)

    def initialize(self):
        pass

    def terminate(self, epoch_num: int, score: float) -> bool:
        return score < self.target

    def __repr__(self):
        return f"BestScoreEpochTerminationCondition({self.target})"


# ---------------------------------------------------------------------------
# iteration termination conditions
# ---------------------------------------------------------------------------


class MaxTimeIterationTerminationCondition:
    """Wall-clock budget (reference MaxTimeIterationTerminationCondition.java)."""

    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, last_score: float) -> bool:
        if self._start is None:
            self.initialize()
        return (time.monotonic() - self._start) >= self.max_seconds

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition:
    """Stop if score exceeds a ceiling — divergence guard (reference
    MaxScoreIterationTerminationCondition.java)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition:
    """Stop on NaN/Inf score (reference
    InvalidScoreIterationTerminationCondition.java — the failure-detection
    hook noted in SURVEY.md section 5)."""

    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"
