"""backward_ms.train — layer: model step. The device milliseconds per
step of the port's ``train.backward`` spans (``value_and_grad``'s
``torch.autograd.grad``, timed by two CUDA events) under the traced
slice's ``train.step`` spans (``perfbench/spans.py``). Moves
``train_tokens_per_s``."""

from perfbench import spans


def read(run):
    return spans.read(run, "train.backward", "device_s")
