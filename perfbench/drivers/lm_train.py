"""Training a ``transformer_lm`` configuration through the port's
``TransformerLM.fit``, one step after another on rows of Markov tokens
(``traffic``: ``rows`` x ``seq`` a step).

Set-up makes the weights and ``checked_steps`` + ``pool_batches`` batches
from the seed, builds the LM around the weights and runs the checked
steps; the window then calls ``fit`` on the pool's batches in turn. The
reference (``reference/gpt2.py``) follows the checked steps afterwards.
"""

from __future__ import annotations

import torch

from perfbench import checks, flops, training, weights
from perfbench.programs import transformer_lm
from perfbench.harness import Outcome
from perfbench.reference import gpt2
from perfbench.traffic import markov


def batches(traffic, model, seed, device):
    n = traffic["checked_steps"] + traffic["pool_batches"]
    ids = markov.tokens(seed, (n, traffic["rows"], traffic["seq"] + 1),
                        model["vocab_size"], traffic["successors"])
    ids = torch.from_numpy(ids).to(device)
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]


def counters(model, traffic, win, precision):
    rows, t = traffic["rows"], traffic["seq"]
    pairs = rows * flops.causal_pairs(t)
    return {"model": model, "tokens_per_step": rows * t,
            "head_tokens_per_step": rows * t, "pairs_per_step": pairs,
            "window_steps": win["steps"], "window_s": win["seconds"],
            "peak": precision["peak"],
            "attn_bwd_call": {"heads": model["n_heads"],
                              "head_dim": model["d_model"] // model["n_heads"],
                              "pairs": pairs,
                              "peak": precision["attention_peak"]}}


def setup(cfg, traffic, seed, device):
    """Set-up: the batches, the LM, and its checked first steps' readings
    -> (the LM's step call, the batches, the readings)."""
    model, k = cfg["model"], traffic["checked_steps"]
    data = batches(traffic, model, seed, device)
    lm = transformer_lm(model, seed, device,
                        weights.make(model, seed, device))
    fit = lambda b: lm.fit(b[0], b[1])  # noqa: E731
    prog = training.setup_steps(
        fit, data[:k], lambda: lm.opt["m"], lambda: lm.params,
        lambda: weights.make(model, seed, device))
    return fit, data, prog


def reference(cfg, traffic, seed, device, data, precision=None,
              keep_rows=None):
    """The reference's readings of the checked steps (``precision``: the
    configuration's reference precision, or the control's)."""
    return gpt2.train_readings(
        weights.make(cfg["model"], seed, device),
        data[:traffic["checked_steps"]], cfg["model"],
        precision or cfg["precision"]["reference"],
        rows=traffic["reference_rows"], keep_rows=keep_rows)


def run(ctx) -> Outcome:
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    fit, data, prog = setup(cfg, traffic, ctx.seed, dev)
    pool = data[traffic["checked_steps"]:]
    at = lambda i: pool[i % len(pool)]  # noqa: E731
    ctx.window_opened()
    win = training.window(fit, at, ctx.seconds, dev)
    summary = None
    if ctx.trace:
        summary = training.traced_slice(fit, at, win["steps"],
                                        traffic["trace_steps"], ctx.scratch)
    peak = training.peak_bytes(dev)
    del fit
    training.free_device(dev)
    ref = reference(cfg, traffic, ctx.seed, dev, data)
    return Outcome(
        e2e={"train_tokens_per_s":
             win["steps"] * traffic["rows"] * traffic["seq"] / win["seconds"]},
        attempted=win["steps"], failed=win["nonfinite"],
        checks=checks.training_checks(prog, ref, ctx.cell.limits["limits"]),
        counters=counters(cfg["model"], traffic, win, cfg["precision"]),
        memory_peak_bytes=peak, trace=summary)
