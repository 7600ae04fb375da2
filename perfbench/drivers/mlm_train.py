"""Masked-LM training of a ``bert_mlm`` configuration through the port's
``BertMLM.fit``, one step after another on padded rows
(``traffic``: ``rows`` x ``seq``, each batch's lengths spread evenly over
[``min_len``, ``seq``] and permuted by the seed, pad after each length).

``BertMLM.fit`` masks each batch itself (the 80/10/10 recipe, from a
generator seeded with the configuration's seed, which is the run's); the
reference (``reference/bert.py``) draws the same masks from the same
seed by its own copy of the recipe and follows the checked steps.
"""

from __future__ import annotations

from perfbench import checks, flops, training, weights
from perfbench.programs import bert_mlm
from perfbench.harness import Outcome
from perfbench.reference import bert
from perfbench.traffic import markov


def batches(traffic, model, seed):
    n = traffic["checked_steps"] + traffic["pool_batches"]
    return markov.padded_rows(seed, n, traffic["rows"], traffic["seq"],
                              traffic["min_len"], model["vocab_size"],
                              model["pad_token_id"], traffic["successors"])


def counters(model, traffic, win, precision):
    lengths = markov.spread_lengths(traffic["rows"], traffic["min_len"],
                                    traffic["seq"])
    tokens = int(lengths.sum())
    pairs = flops.bidirectional_pairs(lengths)
    return {"model": model, "tokens_per_step": tokens,
            # the head on the selected positions only (their expected count)
            "head_tokens_per_step": model["mlm_prob"] * tokens,
            "pairs_per_step": pairs,
            "window_steps": win["steps"], "window_s": win["seconds"],
            "peak": precision["peak"],
            "attn_bwd_call": {"heads": model["n_heads"],
                              "head_dim": model["d_model"] // model["n_heads"],
                              "pairs": pairs,
                              "peak": precision["attention_peak"]}}


def setup(cfg, traffic, seed, device):
    """Set-up: the batches, the BertMLM, and its checked first steps'
    readings -> (its step call, the batches, the readings)."""
    model, k = cfg["model"], traffic["checked_steps"]
    data = batches(traffic, model, seed)
    mlm = bert_mlm(model, seed, device, weights.make(model, seed, device))
    prog = training.setup_steps(
        mlm.fit, list(data[:k]), lambda: mlm.opt["m"], lambda: mlm.params,
        lambda: weights.make(model, seed, device))
    return mlm.fit, data, prog


def reference(cfg, traffic, seed, device, data, precision=None,
              keep_rows=None):
    """The reference's readings of the checked steps (``precision``: the
    configuration's reference precision, or the control's)."""
    return bert.train_readings(
        weights.make(cfg["model"], seed, device),
        list(data[:traffic["checked_steps"]]), cfg["model"], seed % 2**63,
        device, precision or cfg["precision"]["reference"],
        rows=traffic["reference_rows"], keep_rows=keep_rows)


def run(ctx) -> Outcome:
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    model, dev = cfg["model"], ctx.device
    k = traffic["checked_steps"]
    fit, data, prog = setup(cfg, traffic, ctx.seed, dev)
    pool = data[k:]
    at = lambda i: pool[i % len(pool)]  # noqa: E731
    ctx.window_opened()
    win = training.window(fit, at, ctx.seconds, dev)
    summary = None
    if ctx.trace:
        summary = training.traced_slice(fit, at, win["steps"],
                                        traffic["trace_steps"], ctx.scratch)
    peak = training.peak_bytes(dev)
    tokens = int((pool[0] != model["pad_token_id"]).sum())
    del fit
    training.free_device(dev)
    ref = reference(cfg, traffic, ctx.seed, dev, data)
    return Outcome(
        e2e={"train_tokens_per_s": win["steps"] * tokens / win["seconds"]},
        attempted=win["steps"], failed=win["nonfinite"],
        checks=checks.training_checks(prog, ref, ctx.cell.limits["limits"]),
        counters=counters(model, traffic, win, cfg["precision"]),
        memory_peak_bytes=peak, trace=summary)
