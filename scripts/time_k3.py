#!/usr/bin/env python3
"""Times K3 (the fused skip-gram negative-sampling step, ``csrc/sgns.cu``)
of the checkout this script runs from, on one CUDA card, so two trees can
be compared in one run: copy the script into each tree's ``scripts/`` and
run it from each tree's root, in turns (parent, change, change, parent).

    python3 scripts/time_k3.py [--out PATH]

Shapes (V, D, B, K+1), f32: ``chip_smoke.py``'s word2vec (71290, 128,
2048, 6) with the rows of the smoke fit's first batch (its corpus,
vocabulary, pairs and unigram negatives, from the tree's own
``chip_smoke.py``; tables random), with uniform rows and with
Zipf-distributed rows (s = 1.1, a batch far hotter than the fit's), the
hot class of ``bench.py:764`` (100000, 100, 1024, 6), and V=64 (~190
hits on every syn1neg row). Each
line gives the device time of a call (calls queued behind a sleep
kernel, timed with CUDA events), the back-to-back time (host included),
the kernel launches per call (``torch.profiler``), the bound (each
distinct row a live pair touches read and written once, the indices,
labels and liveness read once, at 3.35 TB/s; 6*D flops per live entry at
67 TFLOP/s f32, H100 SXM data sheet), the error against the plain step in
f64 (of the largest entry of each table's update) and whether two
launches give the same bits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.ops.sgns import (  # noqa: E402
    sgns_step,
    sgns_step_plain,
)

SHAPES = (("fit-batch", (71290, 128, 2048, 6), None),
          ("smoke", (71290, 128, 2048, 6), 0.0),
          ("smoke-zipf", (71290, 128, 2048, 6), 1.1),
          ("hot-class", (100_000, 100, 1024, 6), 0.0),
          ("v64", (64, 128, 2048, 6), 0.0))
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def device_ms(fn, iters: int = 50, warmup: int = 3) -> float:
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


def b2b_ms(fn, iters: int = 50, warmup: int = 3) -> float:
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


def launches_per_call(fn, n: int = 10):
    """Kernel launches per call (the kernels seen; each launches once a
    call) and each kernel's device time, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / n, e.device_time_total / n / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    return len(rows), rows


def fit_batch(dev):
    """The rows of the smoke fit's first batch: contexts and centres of
    its pairs, negatives from its unigram table."""
    import chip_smoke as cs

    corpus = cs.topic_corpus(0)
    model = cs.w2v_model(0, dev)
    model.build_vocab(corpus)
    chunk = cs.w2v_chunk(model, corpus, 0, dev)
    cen, draws = chunk["cens"][0], chunk["draws"][0]
    return chunk["cxs"][0], torch.cat([cen[:, None], draws], dim=1)


def inputs(v, d, b, k1, zipf, seed=0, dev="cuda"):
    g = torch.Generator(device=dev).manual_seed(seed + v + d + b)
    syn0 = torch.randn((v, d), generator=g, device=dev) * 0.1
    syn1neg = torch.randn((v, d), generator=g, device=dev) * 0.1
    if zipf is None:
        cx, tgt = fit_batch(dev)
    elif zipf:
        w = torch.arange(1, v + 1, device=dev, dtype=torch.float64) ** -zipf
        perm = torch.randperm(v, generator=g, device=dev)
        draw = lambda n: perm[torch.multinomial(w, n, replacement=True,
                                                generator=g)]
        cx, tgt = draw(b), draw(b * k1).reshape(b, k1)
    else:
        cx = torch.randint(0, v, (b,), generator=g, device=dev)
        tgt = torch.randint(0, v, (b, k1), generator=g, device=dev)
    labels = torch.zeros((b, k1), device=dev)
    labels[:, 0] = 1.0
    live = torch.ones((b, k1), device=dev)
    live[:, 1:] = (tgt[:, 1:] != tgt[:, :1]).float()  # a negative = centre
    return syn0, syn1neg, cx, tgt, labels, live


def bound_ms(syn0, cx, tgt, live):
    d = syn0.shape[1]
    b, k1 = tgt.shape
    n0 = torch.unique(cx[live.sum(1) > 0]).numel()
    n1 = torch.unique(tgt[live > 0]).numel()
    nbytes = 4.0 * 2 * d * (n0 + n1) + 8.0 * (b + b * k1) + 4.0 * 2 * b * k1
    flops = 6.0 * d * live.count_nonzero().item()
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3, \
        n0, n1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k3: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {os.getcwd()}")
    report = {"card": card, "tree": os.getcwd(), "shapes": {}}
    for name, (v, d, b, k1), zipf in SHAPES:
        syn0, syn1neg, cx, tgt, labels, live = inputs(v, d, b, k1, zipf)
        k0, kk1 = syn0.clone(), syn1neg.clone()
        sgns_step(k0, kk1, cx, tgt, labels, live, 0.025)
        a0, a1 = syn0.clone(), syn1neg.clone()
        sgns_step(a0, a1, cx, tgt, labels, live, 0.025)
        p0, p1 = syn0.double(), syn1neg.double()
        sgns_step_plain(p0, p1, cx, tgt, labels.double(), live.double(),
                        0.025)
        err = max(((k - p).abs().max() / (p - o.double()).abs().max()).item()
                  for k, p, o in ((k0, p0, syn0), (kk1, p1, syn1neg)))
        same = bool(torch.equal(k0, a0) and torch.equal(kk1, a1))
        t0, t1 = syn0.clone(), syn1neg.clone()
        call = lambda: sgns_step(t0, t1, cx, tgt, labels, live, 0.0125)
        dev_ms = device_ms(call)
        back_ms = b2b_ms(call)
        n_launch, rows = launches_per_call(call)
        bnd, n0, n1 = bound_ms(syn0, cx, tgt, live)
        hits = torch.bincount(tgt[live > 0], minlength=v).max().item()
        report["shapes"][name] = dict(
            shape=[v, d, b, k1], ms=dev_ms, back_to_back_ms=back_ms,
            launches=n_launch, kernels=[dict(name=r[0][:100], calls=r[1],
                                             ms=r[2]) for r in rows],
            bound_ms=bnd, distinct_rows=[n0, n1], hottest_syn1neg_row=hits,
            max_err=err, two_launches_bit_equal=same)
        print(f"{name} (V={v} D={d} B={b} K+1={k1}): device {dev_ms:.4f} ms"
              f", back to back {back_ms:.4f} ms, {n_launch:g} launches ("
              + ", ".join(f"{r[0][:40]} {r[2] * 1e3:.1f} us" for r in rows)
              + f"), bound {bnd:.5f} ms ({n0} syn0 + {n1} syn1neg rows, "
              f"hottest syn1neg row {hits} hits); max err {err:.2e}; two "
              f"launches bit-equal: {same}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
