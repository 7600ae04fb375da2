"""Training a ``mellum_lm`` configuration through the port's
``TransformerLM.fit``, one step after another on rows of Markov tokens
(``traffic``: ``rows`` x ``seq`` a step), with ``lm_train``'s interface
(``setup``, ``reference``, ``run``), so ``calibrate.py`` takes it too.

Set-up makes the weights and ``checked_steps`` + ``pool_batches`` batches
from the seed, builds the LM around the weights and runs the checked
steps, recording the experts the program chose in the first one; the
window then calls ``fit`` on the pool's batches in turn. The reference
(``reference/mellum2.py``) follows the checked steps afterwards, in
blocks of ``reference_rows`` rows. Besides ``lm_train``'s comparison,
``routing_gap``: the share of the first step's (token, choice) pairs,
over every layer, whose expert is not among the reference's top k for
that token.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import checks, flops_moe, programs_moe, training
from perfbench import weights_mellum
from perfbench.drivers.lm_train import batches
from perfbench.harness import Outcome
from perfbench.reference import mellum2


def routing_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The share of (layer, token, choice) of the program's top k whose
    expert is not in the reference's top k for that layer and token."""
    if len(prog) != len(ref) or not prog:
        return float("inf")
    missed, total = 0, 0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return float("inf")
        hit = (p[:, :, None] == r.to(p.device)[:, None, :]).any(-1)
        missed += int((~hit).sum())
        total += hit.numel()
    return missed / total


def counters(model, traffic, win, precision, routed):
    rows, t = traffic["rows"], traffic["seq"]
    pairs = flops_moe.layer_pairs(model, rows, t)
    call = sum(pairs) / len(pairs)  # one layer's attention call, on average
    per_call = {"heads": model["n_heads"], "head_dim": model["head_dim"],
                "pairs": call, "peak": precision["attention_peak"]}
    return {"model": model, "tokens_per_step": rows * t,
            "routed_rows_per_step": routed / max(1, win["steps"]),
            "pairs_per_step": sum(pairs),
            "window_steps": win["steps"], "window_s": win["seconds"],
            "peak": precision["peak"], "attn_fwd_call": per_call,
            "attn_bwd_call": per_call,
            "dropped_rows": programs_moe.dropped_rows()}


def setup(cfg, traffic, seed, device):
    """Set-up: the batches, the LM, and its checked first steps' readings
    (with ``routes``, the program's chosen experts of the first step) ->
    (the LM's step call, the batches, the readings)."""
    model, k = cfg["model"], traffic["checked_steps"]
    data = batches(traffic, model, seed, device)
    lm = programs_moe.mellum_lm(model, seed, device,
                                weights_mellum.make(model, seed, device))
    fit = lambda b: lm.fit(b[0], b[1])  # noqa: E731
    with programs_moe.RecordRoutes() as rec:
        prog = training.setup_steps(
            fit, data[:k], lambda: lm.opt["m"], lambda: lm.params,
            lambda: weights_mellum.make(model, seed, device))
    prog["routes"] = rec.routes[:model["n_layers"]]  # the first step's
    return fit, data, prog


def reference(cfg, traffic, seed, device, data, precision=None,
              keep_rows=None):
    """The reference's readings of the checked steps (``precision``: the
    configuration's reference precision, or the control's)."""
    model = cfg["model"]
    return mellum2.train_readings(
        lambda: weights_mellum.make(model, seed, device),
        data[:traffic["checked_steps"]], model,
        precision or cfg["precision"]["reference"],
        rows=traffic["reference_rows"], keep_rows=keep_rows)


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``checks.training_numbers`` and ``routing_gap``."""
    out = checks.training_numbers(prog, ref)
    out["routing_gap"] = routing_gap(prog["routes"], ref["routes"])
    return out


def run(ctx) -> Outcome:
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    fit, data, prog = setup(cfg, traffic, ctx.seed, dev)
    pool = data[traffic["checked_steps"]:]
    at = lambda i: pool[i % len(pool)]  # noqa: E731
    ctx.window_opened()
    routed0 = programs_moe.routed_rows()
    win = training.window(fit, at, ctx.seconds, dev)
    routed = programs_moe.routed_rows() - routed0
    summary = None
    if ctx.trace:
        summary = training.traced_slice(fit, at, win["steps"],
                                        traffic["trace_steps"], ctx.scratch)
    peak = training.peak_bytes(dev)
    del fit
    training.free_device(dev)
    ref = reference(cfg, traffic, ctx.seed, dev, data)
    limits = ctx.cell.limits["limits"]
    nums = numbers(prog, ref)
    return Outcome(
        e2e={"train_tokens_per_s":
             win["steps"] * traffic["rows"] * traffic["seq"] / win["seconds"]},
        attempted=win["steps"], failed=win["nonfinite"],
        checks=[(k, nums[k], float(limits[k])) for k in sorted(limits)],
        counters=counters(cfg["model"], traffic, win, cfg["precision"],
                          routed),
        memory_peak_bytes=peak, trace=summary)
