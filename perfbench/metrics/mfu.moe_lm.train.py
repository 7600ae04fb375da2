"""mfu.moe_lm.train — layer: model step. The training step's model
operations of a ``mellum_lm`` cell (``flops_moe.train_step``: GQA
projections and the router on every token, three expert products on each
row the held experts computed, the port's ``moe.routed_rows`` over the
window's steps, the untied head, 12·D a visible pair and query head with
each sliding layer's window), forward and backward, times the steps of
the measured window, over the window's seconds (host clock), as a share
of the configuration's peak (bf16 989 TFLOP/s). Moves
``train_tokens_per_s``."""

from perfbench import flops_moe


def read(run):
    c = run.counters
    peak = run.peaks.get(c.get("peak"))
    if not peak or not c.get("window_steps") \
            or "routed_rows_per_step" not in c:
        return None
    work = flops_moe.train_step(c["model"], c["tokens_per_step"],
                                c["routed_rows_per_step"],
                                c["pairs_per_step"])
    return 100.0 * work * c["window_steps"] / c["window_s"] / peak
