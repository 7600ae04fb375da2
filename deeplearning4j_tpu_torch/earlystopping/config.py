"""EarlyStoppingConfiguration (counterpart:
``deeplearning4j_tpu/earlystopping/config.py``; reference
earlystopping/EarlyStoppingConfiguration.java): the score calculator,
the epoch and iteration terminations, the saver and the evaluation
cadence, with a builder."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    epoch_terminations: List[Any] = field(default_factory=list)
    iteration_terminations: List[Any] = field(default_factory=list)
    model_saver: Any = None
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def score_calculator(self, sc):
            self._c.score_calculator = sc
            return self

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_terminations = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_terminations = list(conds)
            return self

        def model_saver(self, saver):
            self._c.model_saver = saver
            return self

        def save_last_model(self, b: bool = True):
            self._c.save_last_model = bool(b)
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._c.evaluate_every_n_epochs = int(n)
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return self._c

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()
