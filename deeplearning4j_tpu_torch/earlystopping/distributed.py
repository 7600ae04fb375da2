"""Distributed early stopping (counterpart:
``deeplearning4j_tpu/earlystopping/distributed.py`` —
``DistributedEarlyStoppingTrainer``).

The local trainer's epoch loop, terminations, scoring and best-model
saving, with each epoch's fitting delegated to one TrainingMaster round
(a full pass of parameter-averaged training) in place of serial
minibatch fits; the round's final score feeds the iteration
terminations, so NaN and divergence conditions still fire.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingTrainer,
)
from deeplearning4j_tpu_torch.parallel.training_master import TrainingMaster


class DistributedEarlyStoppingTrainer(EarlyStoppingTrainer):
    """``EarlyStoppingTrainer`` whose epoch is one
    ``training_master.execute_training`` over ``train_iterator``.
    ``device`` is where ``net`` lives: the card unless the caller passes
    ``device="cpu"``."""

    def __init__(self, config: EarlyStoppingConfiguration,
                 training_master: TrainingMaster, net, train_iterator,
                 device=None):
        super().__init__(config, net, train_iterator, device=device)
        self.training_master = training_master

    def _epoch_losses(self):
        self.training_master.execute_training(self.net, self.train_iterator)
        yield float(self.net.score_value)
