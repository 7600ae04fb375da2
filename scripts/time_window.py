#!/usr/bin/env python3
"""Times K4 (``flash_attention``) and K7 (``flash_bwd``) of the checkout
this script runs from, on one CUDA card, with and without a sliding
window, so two trees can be compared in one run: copy the script into
each tree's ``scripts/`` and run it from each tree's root, in turns
(parent, change, change, parent).

    python3 scripts/time_window.py [--out PATH]

Cases (bf16, causal, inputs from a seeded generator): GPT-2-medium's
training layer (N=16, T=1024, H=16, D=64, no window), and Mellum 2's
(N=2, T=8192, H=32, D=128): a full layer and a sliding layer of window
1024 (on a tree whose kernels take a window). Each line gives the device
time a call (calls queued behind a sleep kernel, CUDA events), the
visible pairs' bound (4·D flops a pair and head forward, 10·D backward,
at 989 TFLOP/s: H100 SXM data sheet) and its share.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_bwd,
)

PEAK = 989e12
CASES = [("gpt2", 16, 1024, 16, 64, 0), ("mellum_full", 2, 8192, 32, 128, 0),
         ("mellum_sliding", 2, 8192, 32, 128, 1024)]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def pairs(t: int, w: int) -> int:
    if not w or w >= t:
        return t * (t + 1) // 2
    return w * (w + 1) // 2 + (t - w) * w


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    windowed = "window" in inspect.signature(flash_attention).parameters
    dev = torch.device("cuda")
    rows = []
    for name, n, t, h, d, w in CASES:
        if w and not windowed:
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn((n, t, h, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        kw = {"window": w} if w else {}
        o, lse = flash_attention(q, k, v, causal=True, **kw)
        fwd = device_ms(lambda: flash_attention(q, k, v, causal=True, **kw))
        bwd = device_ms(lambda: flash_bwd(q, k, v, None, 0, o, lse, do,
                                          **kw))
        work = n * h * pairs(t, w) * d
        row = {"case": name, "shape": [n, t, h, d], "window": w,
               "fwd_ms": fwd, "bwd_ms": bwd,
               "fwd_share": 100 * 4 * work / PEAK / (fwd * 1e-3),
               "bwd_share": 100 * 10 * work / PEAK / (bwd * 1e-3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"tree": os.getcwd(), "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
