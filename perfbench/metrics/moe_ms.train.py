"""moe_ms.train — layer: model step. The device milliseconds per step of
the port's ``train.moe`` spans (each expert layer's forward, router
through combine, timed by two CUDA events; the activation checkpoint's
recompute in the backward is not spanned) under the traced slice's
``train.step`` spans (``perfbench/spans.py``). Moves
``train_tokens_per_s``."""

from perfbench import spans


def read(run):
    return spans.read(run, "train.moe", "device_s")
