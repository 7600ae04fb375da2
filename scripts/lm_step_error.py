#!/usr/bin/env python3
"""Where a TransformerLM step on one CUDA card departs from the same step
on the CPU: the step of ``tests/test_torch_gpu.py::
test_transformer_step_on_card_reaches_wq_wk_wv_and_matches_cpu`` (d_model
128, 2 layers, 2 heads, vocab 128, 4 x 96 tokens, bf16 compute with f32
masters), run on the card twice, with the attention backward by K7
(``flash_bwd``) and by its plain version (``flash_block_bwd``, swapped in
for ``flash_bwd``), each held against the CPU step: the error of each
gradient leaf is of its largest entry, as the test measures it. During
the K7 run each K7 call is also held against the plain version on the
same inputs (dq, dk, dv).

    python3 scripts/lm_step_error.py [--out PATH] [--seeds N]

The first seed pair is the test's (params seed 4, tokens seed 0); the
others are (4 + i, i).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.models import transformer as pt  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402


def rel(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def step(cfg, params, x, y):
    loss, grads = pt.value_and_grad(lambda p: pt.loss_fn(p, x, y, cfg),
                                    params)
    return float(loss), pt._named(grads)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    kernel = fa.flash_bwd
    k7_calls = []

    def checked(*a):
        got = kernel(*a)
        want = fa.flash_block_bwd(*a)
        k7_calls.append({n: rel(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                         got, want)})
        return got

    checked.launches = 0  # the wrapper counts under its module name
    out = {"cases": []}
    for i in range(args.seeds):
        cfg = pt.TransformerConfig(vocab_size=128, d_model=128, n_layers=2,
                                   n_heads=2, d_ff=256, max_len=128,
                                   dtype_policy="performance", seed=4 + i)
        params = pt.init_params(cfg, device="cpu")
        ids = np.random.default_rng(i).integers(0, 128, (4, 97))
        x, y = torch.from_numpy(ids[:, :-1]), torch.from_numpy(ids[:, 1:])
        want_loss, want = step(cfg, params, x, y)
        on_card = pt.tree_map(lambda a: a.to(dev), params)
        case = {"seed": 4 + i, "tokens_seed": i}
        for mode, bwd in (("k7", checked), ("plain_bwd", fa.flash_block_bwd)):
            k7_calls.clear()
            fa.flash_bwd = bwd
            try:
                loss, got = step(cfg, on_card, x.to(dev), y.to(dev))
            finally:
                fa.flash_bwd = kernel
            case[mode] = {"loss_rel": abs(loss - want_loss) / want_loss,
                          "leaves": {n: rel(got[n], w) for n, w in
                                     zip(got, pt.tree_leaves(want))}}
            if mode == "k7":
                case["k7_vs_plain_per_call"] = list(k7_calls)
        out["cases"].append(case)
        for mode in ("k7", "plain_bwd"):
            leaves = case[mode]["leaves"]
            worst = max(leaves, key=leaves.get)
            print(f"seed {4 + i}/{i} {mode}: loss {case[mode]['loss_rel']:.3e}"
                  f", worst leaf {worst} {leaves[worst]:.4e}; "
                  + ", ".join(f"{n} {e:.3e}" for n, e in leaves.items()))
        print(f"seed {4 + i}/{i} K7 vs plain per call: "
              + "; ".join(", ".join(f"{n} {e:.3e}" for n, e in c.items())
                          for c in case["k7_vs_plain_per_call"]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
