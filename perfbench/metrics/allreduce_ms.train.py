"""allreduce_ms.train — layer: device. The device milliseconds per step
of rank 0's ``train.allreduce`` spans (the ``'data'`` mesh step's
all-reduce of the loss and of every gradient leaf after the backward,
timed by two CUDA events on the step's stream) under the traced slice's
``train.step`` spans (``perfbench/spans.py``). Moves
``train_tokens_per_s``."""

from perfbench import spans


def read(run):
    return spans.read(run, "train.allreduce", "device_s")
