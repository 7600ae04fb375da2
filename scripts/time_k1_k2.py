#!/usr/bin/env python3
"""Times K1 (the peephole-LSTM forward scan) and K2 (its backward) of the
checkout this script runs from, on one CUDA card, so two trees can be
compared in one run: copy the script into each tree's root and run it
there, in turns (parent, change, change, parent).

    python3 scripts/time_k1_k2.py [--out PATH]

K1 is timed at ``chip_smoke.py``'s shapes: (N, T, H) = (64, 100, 200),
the char-RNN's ``output()`` at batch 64, and the three shape classes of
``benchmarks/pallas_lstm_bench.py`` (32, 128, 128), (64, 256, 256) and
(128, 512, 512); with the cell sequence at (32, 50, 200), the training
window. K2 at (32, 50, 200), (64, 100, 200) and the three classes. Each
time is a device time (the calls queued behind a sleep kernel, timed with
CUDA events), with the back-to-back time (host launches included) beside
it; the sequential floor is T times the per-step time of a one-row
launch (the slope between T=8 and T=8+t at N=1). Each kernel's output is
checked against its plain version once per shape. The bound is the
larger of the bytes (each input read once, each output written once, at
3.35 TB/s) and the flops (2*N*T*H*4H for K1, three times that for K2) at
165 TFLOP/s, the 3xTF32 rate (H100 SXM data sheet).

Where the tree has a layout planner (``ops/lstm_scan.plan_scan``), each
line names the plan it ran, and K1 at (64, 100, 200) and (1, 100, 200)
and K2 at (32, 50, 200) and (1, 50, 200) are also timed at every cluster
size and rows-per-block the layout allows, the planner's choice marked.

K2's dU and dp pass: on a tree whose ``csrc/lstm_scan_bwd.cu`` computes
them in the sweep kernel's tail (marked ``---- dU[:, this CTA's
columns]``), the script builds that source with the tail cut off and
times it beside the whole kernel; on a tree where they are launches of
their own, ``torch.profiler`` gives each launch's device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_scan as lstm_mod  # noqa: E402
from deeplearning4j_tpu_torch.ops.lstm_scan import (  # noqa: E402
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_plain,
    lstm_scan_plain,
)

K1_SHAPES = ((64, 100, 200), (32, 128, 128), (64, 256, 256),
             (128, 512, 512))
K1_CS_SHAPE = (32, 50, 200)
K2_SHAPES = ((32, 50, 200), (64, 100, 200), (32, 128, 128),
             (64, 256, 256), (128, 512, 512))
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_TC_FLOPS = 495e12 / 3
DU_MARK = "// ---- dU[:, this CTA's columns]"


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def events_ms(fn, iters: int = 20) -> float:
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


def iters_for(n: int, t: int, h: int) -> int:
    return 5 if n * t * h * h > 1e9 else 20


def lstm_inputs(n: int, t: int, h: int, seed: int, dev):
    """chip_smoke.lstm_inputs: gate pre-activations of order 1."""
    g = torch.Generator(device=dev).manual_seed(seed + n + t + h)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return (r(n, t, 4 * h), r(h, 4 * h) / h ** 0.5, 0.1 * r(3, h),
            0.1 * r(n, h), 0.1 * r(n, h))


def lstm_bwd_inputs(n: int, t: int, h: int, seed: int, dev):
    """chip_smoke.lstm_bwd_inputs: K1's inputs, cs and hs, cotangents."""
    x, u, p, h0, c0 = lstm_inputs(n, t, h, seed, dev)
    hs, _, _, cs = lstm_scan(x, u, p, h0, c0, emit_cs=True)
    g = torch.Generator(device=dev).manual_seed(seed + 7 * n + t + h)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return x, u, p, h0, c0, cs, hs, r(n, t, h), r(n, h), r(n, h)


def bound_ms(n: int, t: int, h: int, backward: bool, emit_cs: bool = False):
    if backward:
        nbytes = 4.0 * (2 * n * t * 4 * h + 3 * n * t * h + 2 * 4 * h * h
                        + 6 * h + 6 * n * h)
        flops = 3 * 2.0 * n * t * h * 4 * h
    else:
        nbytes = 4.0 * (n * t * 4 * h + n * t * h + 4 * h * h + 3 * h
                        + 4 * n * h + (n * t * h if emit_cs else 0))
        flops = 2.0 * n * t * h * 4 * h
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / PEAK_F32_TC_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(out, ref, rel=()) -> float:
    errs = []
    for i, (a, b) in enumerate(zip(out, ref)):
        if a is None:
            continue
        e = (a - b).abs().max().item()
        errs.append(e / max(b.abs().max().item(), 1e-30) if i in rel else e)
    return max(errs)


def plan_of(n: int, t: int, h: int, backward: bool):
    """The plan the wrapper ran at this shape, where the tree plans."""
    for key, plan in getattr(lstm_mod, "_plans", {}).items():
        if (key[2], key[4]) == (n, h) and key[3] in (t, None) \
                and ("bwd" in key[0]) == backward:
            return plan
    return None


def floor_us(make, call, t: int, h: int, seed: int, dev) -> float:
    """Per-step time of a one-row launch: the slope between T=8 and
    T=8+t at N=1."""
    short, long_ = (device_ms(lambda a=make(1, tt, h, seed, dev): call(a))
                    for tt in (8, 8 + t))
    return (long_ - short) / t * 1e3


def time_k1(dev, seed: int = 0):
    res = {}
    for (n, t, h), cs in [(s, False) for s in K1_SHAPES] + [(K1_CS_SHAPE,
                                                              True)]:
        args = lstm_inputs(n, t, h, seed, dev)
        err = max_err(lstm_scan(*args, emit_cs=cs),
                      lstm_scan_plain(*args, emit_cs=cs))
        same = all(a is None or torch.equal(a, b) for a, b in zip(
            lstm_scan(*args, emit_cs=cs), lstm_scan(*args, emit_cs=cs)))
        call = lambda a=args: lstm_scan(*a, emit_cs=cs)
        it = iters_for(n, t, h)
        ms, ev = device_ms(call, it), events_ms(call, it)
        step = floor_us(lstm_inputs, lambda a: lstm_scan(*a), t, h, seed, dev)
        b, by = bound_ms(n, t, h, False, cs)
        key = f"{n}x{t}x{h}" + ("_cs" if cs else "")
        plan = plan_of(n, t, h, False)
        res[key] = dict(ms=ms, events_ms=ev, bound_ms=b, bound_by=by,
                        step_floor_us=step, floor_ms=step * t / 1e3,
                        max_abs_err=err, bit_equal=same, plan=str(plan))
        print(f"K1 {key}: {ms:.4f} ms on the device ({ev:.4f} back to "
              f"back), bound {b:.4f} ms ({by}), floor {step * t / 1e3:.4f} "
              f"ms ({step:.2f} us/step at N=1), max|d| {err:.2e}, two "
              f"launches bit-equal: {same}; {plan}")
    return res


def time_k2(dev, seed: int = 0):
    res = {}
    for n, t, h in K2_SHAPES:
        args = lstm_bwd_inputs(n, t, h, seed, dev)
        out = lstm_scan_bwd(*args)
        err = max_err(out, lstm_scan_bwd_plain(*args), rel=(1, 2))
        same = all(torch.equal(a, b) for a, b in zip(out,
                                                     lstm_scan_bwd(*args)))
        call = lambda a=args: lstm_scan_bwd(*a)
        it = iters_for(n, t, h)
        ms, ev = device_ms(call, it), events_ms(call, it)
        step = floor_us(lstm_bwd_inputs, lambda a: lstm_scan_bwd(*a), t, h,
                        seed, dev)
        b, by = bound_ms(n, t, h, True)
        key = f"{n}x{t}x{h}"
        plan = plan_of(n, t, h, True)
        res[key] = dict(ms=ms, events_ms=ev, bound_ms=b, bound_by=by,
                        step_floor_us=step, floor_ms=step * t / 1e3,
                        max_err=err, bit_equal=same, plan=str(plan))
        print(f"K2 {key}: {ms:.4f} ms on the device ({ev:.4f} back to "
              f"back), bound {b:.4f} ms ({by}), floor {step * t / 1e3:.4f} "
              f"ms ({step:.2f} us/step at N=1), max err {err:.2e} (abs; "
              f"of the largest entry on dU, dp), two launches bit-equal: "
              f"{same}; {plan}")
    return res


def time_rows(dev, seed: int = 0):
    """K1 at (64, 100, 200) and (1, 100, 200), K2 at (32, 50, 200) and
    (1, 50, 200), at every cluster size and rows-per-block the layout
    allows, by replacing the wrapper's cached plan."""
    res = {}
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin",
                    lstm_mod.SMEM_OPTIN_H100)
    for backward, (n, t, h) in ((False, (64, 100, 200)),
                                (False, (1, 100, 200)),
                                (True, (32, 50, 200)), (True, (1, 50, 200))):
        if backward:
            args = lstm_bwd_inputs(n, t, h, seed, dev)
            call = lambda: lstm_scan_bwd(*args)
        else:
            args = lstm_inputs(n, t, h, seed, dev)
            call = lambda: lstm_scan(*args)
        call()
        key = next(k for k, p in lstm_mod._plans.items()
                   if p is plan_of(n, t, h, backward))
        chosen = lstm_mod._plans[key]
        name = f"K{2 if backward else 1} {n}x{t}x{h}"
        try:
            for cluster in lstm_mod.CLUSTER_SIZES:
                for rows in lstm_mod.ROW_BLOCKS:
                    lay = lstm_mod._layout(n, t, h, rows, cluster, backward,
                                           limit,
                                           props.multi_processor_count)
                    if lay is None or (rows > 1 and rows >= 2 * n):
                        continue
                    lstm_mod._plans[key] = lay
                    ms = device_ms(call)
                    res[f"{name} cluster={cluster} rows={rows}"] = dict(
                        ms=ms, plan=str(lay))
                    print(f"{name} at {rows} rows per block ({lay.blocks} "
                          f"clusters of {cluster}): {ms:.4f} ms"
                          + (" (the planner's)" if lay == chosen else ""))
        finally:
            lstm_mod._plans[key] = chosen
    return res


def du_share_tail(dev, seed: int = 0):
    """A tree whose sweep kernel ends in the dU/dp tail: the same source
    with the tail cut off, built as a variant, timed beside the whole."""
    src = build.sources("lstm_scan_bwd")[0]
    text = src.read_text()
    cut = build.BUILD_DIR / "variants" / "no_du" / src.name
    cut.parent.mkdir(parents=True, exist_ok=True)
    cut.write_text(text.replace(DU_MARK, "return;\n  " + DU_MARK, 1))
    sources, load = build.sources, build.load

    def variant_load(name, fns, flags=()):
        return load(name, fns, tuple(flags) + (
            ("-DLSTM_BWD_NO_DU",) if name == "lstm_scan_bwd" else ()))

    res = {}
    for n, t, h in K2_SHAPES[:2]:
        args = lstm_bwd_inputs(n, t, h, seed, dev)
        whole = device_ms(lambda: lstm_scan_bwd(*args))
        build.sources = lambda name: ([cut] if name == "lstm_scan_bwd"
                                      else sources(name))
        lstm_mod.build.load = variant_load
        try:
            sweep = device_ms(lambda: lstm_scan_bwd(*args))
        finally:
            build.sources, lstm_mod.build.load = sources, load
        key = f"{n}x{t}x{h}"
        res[key] = dict(ms=whole, without_du_ms=sweep,
                        du_ms=whole - sweep, du_share=1 - sweep / whole)
        print(f"K2 {key}: {whole:.4f} ms, without the dU/dp tail "
              f"{sweep:.4f} ms: the tail {whole - sweep:.4f} ms "
              f"({1 - sweep / whole:.1%})")
    return res


def du_share_profile(dev, seed: int = 0, calls: int = 10):
    """A tree whose K2 launches its passes separately: torch.profiler's
    device time per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for n, t, h in K2_SHAPES[:2]:
        args = lstm_bwd_inputs(n, t, h, seed, dev)
        lstm_scan_bwd(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                lstm_scan_bwd(*args)
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "lstm_bwd" in e.key:
                name = e.key.split("lstm_bwd_")[1].split("<")[0].split("(")[0]
                parts[name] = e.device_time_total / calls / 1e3
        total = sum(parts.values())
        key = f"{n}x{t}x{h}"
        du = parts.get("du", 0.0) + parts.get("finish", 0.0)
        res[key] = dict(parts_ms=parts, sum_ms=total, du_ms=du,
                        du_share=du / total if total else None)
        print(f"K2 {key}: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in parts.items())
              + f" (sum {total:.4f}); dU and dp passes {du:.4f} ms "
              f"({du / max(total, 1e-12):.1%})")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k1_k2: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    tail = DU_MARK in build.sources("lstm_scan_bwd")[0].read_text()
    with torch.inference_mode():
        res = {"card": card, "tree": os.getcwd(), "k1": time_k1(dev),
               "k2": time_k2(dev),
               "k2_du": du_share_tail(dev) if tail
               else du_share_profile(dev)}
        if hasattr(lstm_mod, "plan_scan"):
            res["rows"] = time_rows(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
