"""Iteration listeners (counterpart:
``deeplearning4j_tpu/optimize/listeners.py`` — ``IterationListener``,
``ScoreIterationListener`` and ``CollectScoresIterationListener``, :18-45).

A network calls ``iteration_done(model, iteration, score)`` on each of its
listeners after every optimizer iteration (one TBPTT window is one
iteration). Reading ``score`` as a float waits for the card, so a fit
with no listeners never synchronizes. The stats listeners wait for the
ledgers they read.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int, score) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, int(print_iterations))

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d is %s", iteration,
                        float(score))


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs every N iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))
