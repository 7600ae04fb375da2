"""EarlyStoppingTrainer: the epoch loop with termination checks and
best-model saving (counterpart:
``deeplearning4j_tpu/earlystopping/trainer.py`` — ``fit_dataset``,
``score_dataset`` and ``EarlyStoppingTrainer`` :41; reference
BaseEarlyStoppingTrainer.java:82-160).

Per epoch: fit every minibatch (checking the iteration terminations
after each), score with the calculator every N epochs, keep or save the
best model, check the epoch terminations; a training exception ends the
run with the best model saved so far (reference :119-124). It runs a
MultiLayerNetwork or a ComputationGraph (DataSets or MultiDataSets).
"""

from __future__ import annotations

import logging

from deeplearning4j_tpu_torch.earlystopping.config import EarlyStoppingConfiguration
from deeplearning4j_tpu_torch.earlystopping.result import EarlyStoppingResult
from deeplearning4j_tpu_torch.ops.device import resolve_device

logger = logging.getLogger("deeplearning4j_tpu_torch")


def fit_dataset(net, ds) -> float:
    """Fit one DataSet or MultiDataSet on either container."""
    if hasattr(ds, "features_list"):
        return float(
            net.fit(ds.features_list, ds.labels_list, ds.features_masks, ds.labels_masks)
        )
    return float(net.fit(ds.features, ds.labels, ds.features_mask, ds.labels_mask))


def score_dataset(net, ds) -> float:
    """Score one DataSet or MultiDataSet on either container."""
    if hasattr(ds, "features_list"):
        return float(
            net.score(ds.features_list, ds.labels_list, ds.features_masks, ds.labels_masks)
        )
    return float(net.score(ds.features, ds.labels, ds.features_mask, ds.labels_mask))


class EarlyStoppingTrainer:
    """See the module docstring. ``device`` is where ``net`` lives: the
    card unless ``device="cpu"`` (with no card it raises); a net on
    another device is refused."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, device=None):
        self.device = resolve_device(device)
        if getattr(net, "device", self.device).type != self.device.type:
            raise ValueError(f"the net lives on {net.device}, the trainer "
                             f"was given {self.device}")
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def _epoch_losses(self):
        """One loss per minibatch of the epoch (a distributed trainer
        overrides it)."""
        for ds in self.train_iterator:
            yield fit_dataset(self.net, ds)

    def fit(self, max_epochs: int = 1_000_000) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_terminations + cfg.iteration_terminations:
            c.initialize()
        if self.net.params is None:
            self.net.init()

        result = EarlyStoppingResult("epoch", "max_epochs loop bound reached")
        best_score = float("inf")
        epoch = 0
        try:
            for epoch in range(max_epochs):
                stop_iter = None
                for loss in self._epoch_losses():
                    for c in cfg.iteration_terminations:
                        if c.terminate(loss):
                            stop_iter = c
                            break
                    if stop_iter is not None:
                        break
                if hasattr(self.train_iterator, "reset"):
                    self.train_iterator.reset()

                if stop_iter is not None:
                    result.termination_reason = "iteration"
                    result.termination_details = repr(stop_iter)
                    break

                if epoch % max(1, cfg.evaluate_every_n_epochs) == 0:
                    if cfg.score_calculator is not None:
                        score = float(cfg.score_calculator.calculate_score(self.net))
                    else:
                        score = float(self.net.score_value)
                    result.score_vs_epoch[epoch] = score
                    if score < best_score:
                        best_score = score
                        result.best_model_epoch = epoch
                        result.best_model_score = score
                        if cfg.model_saver is not None:
                            cfg.model_saver.save_best_model(self.net, score)
                        else:
                            result.best_model = self.net.clone()
                    if cfg.save_last_model and cfg.model_saver is not None:
                        cfg.model_saver.save_latest_model(self.net, score)

                    stop_epoch = None
                    for c in cfg.epoch_terminations:
                        if c.terminate(epoch, score):
                            stop_epoch = c
                            break
                    if stop_epoch is not None:
                        result.termination_reason = "epoch"
                        result.termination_details = repr(stop_epoch)
                        break
        except Exception as e:  # noqa: BLE001 — reference catches Exception too
            logger.exception("early stopping: training failed, using best model")
            result.termination_reason = "error"
            result.termination_details = f"{type(e).__name__}: {e}"

        result.total_epochs = epoch + 1
        if result.best_model is None and cfg.model_saver is not None:
            result.best_model = cfg.model_saver.get_best_model()
        if result.best_model is None:
            result.best_model = self.net
        return result
