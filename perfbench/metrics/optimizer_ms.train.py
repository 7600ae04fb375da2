"""optimizer_ms.train — layer: model step. The device milliseconds per
step of the port's ``train.optimizer`` spans (``_adam_update``, the clip
included, timed by two CUDA events) under the traced slice's
``train.step`` spans (``perfbench/spans.py``): the yardstick of a fused
Adam. Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(run):
    return spans.read(run, "train.optimizer", "device_s")
