"""prepare_ms.train — layer: model step. The host milliseconds per step
of the port's ``train.prepare`` spans (``BertMLM``'s masking on the host
and its copies to the card) under the traced slice's ``train.step``
spans (``perfbench/spans.py``). Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(run):
    return spans.read(run, "train.prepare", "duration_s")
