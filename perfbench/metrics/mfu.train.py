"""mfu.train — layer: model step. The training step's model operations
(``flops.train_step``: non-pad tokens, visible attention pairs, the head
on the tokens whose loss counts), forward and backward, times the steps
of the measured window, over the window's seconds (host clock), as a
share of the configuration's peak (bf16 989 TFLOP/s; f32 67 TFLOP/s).
Moves ``train_tokens_per_s``."""

from perfbench import flops


def read(run):
    c = run.counters
    peak = run.peaks.get(c.get("peak"))
    if not peak or not c.get("window_steps"):
        return None
    work = flops.train_step(c["model"], c["tokens_per_step"],
                            c["head_tokens_per_step"], c["pairs_per_step"])
    return 100.0 * work * c["window_steps"] / c["window_s"] / peak
