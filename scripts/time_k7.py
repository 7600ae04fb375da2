#!/usr/bin/env python3
"""Times K7 (the flash-attention backward, ``csrc/flash_bwd.cu``) of the
checkout this script runs from, on one CUDA card, so two trees can be
compared in one run: copy the script into each tree's ``scripts/`` and run
it from each tree's root, in turns (parent, change, change, parent).

    python3 scripts/time_k7.py [--out PATH]

Cases, with the inputs of the tree's own ``chip_smoke.py`` (seed 0): the
LM's training layer (N=16, T=1024, H=32, D=64, bf16, causal), K5's masked
case b (N=4, T=2048, H=8, D=64, bf16, causal, ~80 % of keys kept, an lse
cotangent) and case h, the masked MHA fit's layer (N=32, T=512, H=8, D=64,
f32, lengths 64-512, offset T). Each line gives K7's device time (calls
queued behind a sleep kernel, CUDA events), the back-to-back time (host
included), the device time of the backward of
``scaled_dot_product_attention`` on the same inputs (TF32 off), the bound
(q, k, v, O, dO read and dq, dk, dv written once, lse and the mask once,
at 3.35 TB/s; 10·D flops of five products per visible (query, key) pair
at 989 TFLOP/s bf16 or the 3xTF32 rate, 165 TFLOP/s, for f32: H100 SXM
data sheet), the error against the plain version ``flash_block_bwd`` (of
each gradient's largest entry), whether two launches give the same bits,
and the kernel launches of one call with each kernel's time
(``torch.profiler``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_block_bwd,
    flash_bwd,
)


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


def b2b_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def launches_per_call(fn, tries: int = 3):
    """The kernels one call launches and each one's device time, from
    torch.profiler sessions of one call (the most kernels over ``tries``
    sessions: a dropped record only lowers a count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.device_time_total > 0]
        if sum(r[1] for r in rows) > sum(r[1] for r in best):
            best = rows
    return best


def cases(dev):
    import chip_smoke as cs

    cfg = cs.lm_cfg(0)
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    n, t, hh, dd = cs.EXT_MASKED
    return (("train", cs.bwd_inputs(cs.LM_BATCH, cs.LM_T, cs.LM_T, h, d, 0,
                                    dev), True),
            ("b", cs.bwd_inputs(n, t, t, hh, dd, 0, dev, keep=cs.EXT_KEEP,
                                with_glse=True), True),
            ("h", cs.mha_bwd_inputs(0, dev), False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k7: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False  # strict f32 (case h)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {os.getcwd()}")
    report = {"card": card, "tree": os.getcwd(), "cases": {}}
    dev = torch.device("cuda")
    for name, a, causal in cases(dev):
        q, k, v, km, off, o, lse, g, _ = a
        got = flash_bwd(*a)
        again = flash_bwd(*a)
        want = flash_block_bwd(*a)
        torch.cuda.synchronize()
        err = cs.bwd_error(got, want)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del got, again, want
        call = lambda: flash_bwd(*a)
        ms, back = device_ms(call), b2b_ms(call)
        sdpa = device_ms(cs.sdpa_backward(q, k, v, g, km, causal))
        b_ms, b_by, pairs = cs.ext_bound(q, km, off, tensors=8, flops=10.0)
        rows = launches_per_call(call)
        gflop = 10.0 * q.shape[3] * pairs / 1e9
        report["cases"][name] = dict(
            shape=list(q.shape), dtype=str(q.dtype), offset=off,
            masked=km is not None, ms=ms, back_to_back_ms=back,
            sdpa_backward_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
            gflop=gflop, max_err=err, two_launches_bit_equal=same,
            launches=sum(r[1] for r in rows),
            kernels=[dict(name=r[0][:120], calls=r[1], ms=r[2])
                     for r in rows])
        print(f"{name} {tuple(q.shape)} {q.dtype} off={off}: device "
              f"{ms:.4f} ms, back to back {back:.4f} ms, sdpa backward "
              f"{sdpa:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {gflop:.2f} "
              f"GFLOP), {gflop / ms:.1f} TFLOP/s; max err {err:.2e}; two "
              f"launches bit-equal: {same}; {sum(r[1] for r in rows)} "
              "launches (" + ", ".join(f"{r[0][:48]} {r[2]:.4f} ms"
                                       for r in rows) + ")")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
