#!/usr/bin/env python3
"""Times K6 (paged decode attention) and K5 in f32 (flash attention with a
key bias) of the checkout this script runs from, on one CUDA card, so
two trees can be compared in one run: copy the script into each tree's
root and run it there, in turns.

    python3 scripts/time_k5_k6.py [--out PATH]

K6 is timed at the decode tick's shape (64 lanes, bt=16, table width 64,
H=32, D=64, bf16 arena and query) under four mixes of contexts: the
smoke's (``chip_smoke.paged_inputs`` at seed 1, mean 458 tokens), one
lane at the full 1024-token window among 63 at 16 tokens, every lane at
458 and every lane at 1024. K5 in f32 is timed at the masked MHA fit's
layer (N=32, T=512, H=8, D=64, a seeded length mask, offset 512) beside
``scaled_dot_product_attention`` in f32 with TF32 off. Every time is a
device time: the calls queued behind a sleep kernel, timed with CUDA
events. Each kernel's output is checked against its plain version. The
bound is the bytes each input read once and each output written once at
3.35 TB/s (K6), or the visible pairs' flops at 165 TFLOP/s (K5 f32:
3xTF32), H100 SXM data sheet.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())

from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_block,
    flash_attention_block_plain,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)

H, HD, BT, M, LANES, BLOCKS = 32, 64, 16, 64, 64, 4096
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_TC_FLOPS = 495e12 / 3


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


def smoke_pos(rng):
    """chip_smoke.paged_inputs's positions."""
    t_max = M * BT
    pos = rng.integers(0, t_max, LANES).astype(np.int32)
    pos[:8] = rng.integers(0, BT, 8)
    pos[8:12] = t_max - 1
    return pos


def arena(pos, seed, dev):
    """An arena of BLOCKS blocks (+ trash) and distinct blocks per lane,
    as chip_smoke.paged_inputs lays them out."""
    rng = np.random.default_rng(seed)
    tables = np.zeros((LANES, M), np.int32)
    perm = rng.permutation(np.arange(1, BLOCKS + 1))
    nxt = 0
    for i in range(LANES):
        used = int(pos[i]) // BT + 1
        tables[i, :used] = perm[nxt:nxt + used]
        nxt += used
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (BLOCKS + 1, BT, H, HD)
    ck = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    cv = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn((LANES, H, HD), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return (q, ck, cv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def time_k6(dev):
    mixes = {
        "smoke": smoke_pos(np.random.default_rng(1)),
        "one_long_63_short": np.array([M * BT - 1] + [15] * (LANES - 1),
                                      np.int32),
        "uniform_458": np.full(LANES, 457, np.int32),
        "uniform_1024": np.full(LANES, M * BT - 1, np.int32),
    }
    res = {}
    for name, pos in mixes.items():
        args = arena(pos, 1, dev)
        out = paged_attention(*args)
        err = (out - paged_attention_plain(*args)).abs().max().item()
        ms = device_ms(lambda: paged_attention(*args))
        vis = float(pos.astype(np.int64).sum() + LANES)
        nbytes = vis * H * HD * 2 * 2 + LANES * H * HD * (2 + 4) \
            + LANES * M * 4 + LANES * 4
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        res[name] = dict(ms=ms, bound_ms=b_ms, gb_per_s=nbytes / ms / 1e6,
                         mean_context=vis / LANES, max_abs_err=err)
        print(f"K6 {name}: mean context {vis / LANES:.1f}, {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, bound {b_ms:.4f} ms "
              f"({b_ms / ms:.1%} of it), max|d| vs plain {err:.2e}")
    return res


def time_k5_f32(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    n, t, h, d = 32, 512, 8, 64
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((n, t, h, d), generator=g, device=dev)
               for _ in range(3))
    lens = torch.randint(64, t + 1, (n,), generator=g, device=dev)
    km = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    o, lse = flash_attention_block(q, k, v, offset=t, key_mask=km)
    ro, rlse = flash_attention_block_plain(q, k, v, offset=t, key_mask=km)
    err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    ms = device_ms(lambda: flash_attention_block(q, k, v, offset=t,
                                                 key_mask=km))
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allowed = (km > 0)[:, None, None, :]
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=allowed))
    flops = 4.0 * d * float(km.sum().item()) * t * h
    b_ms = flops / PEAK_F32_TC_FLOPS * 1e3
    print(f"K5 f32 N={n} T={t} H={h} D={d} (length mask, offset {t}): "
          f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s of visible pairs, "
          f"sdpa f32 {sdpa:.4f} ms, bound {b_ms:.4f} ms, max|d| vs plain "
          f"{err:.2e}")
    return dict(ms=ms, library_ms=sdpa, bound_ms=b_ms, gflop=flops / 1e9,
                max_abs_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k5_k6: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        res = {"card": card, "k6": time_k6(dev), "k5_f32": time_k5_f32(dev)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
