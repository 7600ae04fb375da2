#!/usr/bin/env python3
"""Drive the PyTorch port's paged ``/generate`` path on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

What it does, in order (any failure raises and exits non-zero):

1. prints the card (``nvidia-smi`` name and power limit, and
   ``torch.cuda.get_device_name``); with no CUDA device it exits 2;
2. builds both kernels from ``deeplearning4j_tpu_torch/csrc/`` with
   ``nvcc`` (one process per source, started together) and prints each
   function's ptxas register and spill line;
3. holds each kernel against its plain PyTorch version on the card at the
   slice's shapes — flash prefill (K4): causal bf16, N=1, H=32, hd=64,
   T in {192, 512, 1024}, max abs error <= 2e-2 on O and <= 1e-3 on lse;
   paged decode (K6): 64 lanes, bt=16, m=64, H=32, hd=64, bf16 arena,
   positions inside block 0, across blocks and at the full window, max abs
   error <= 1e-3, and a trash block poisoned with 1e6 in K and -1e6 in V
   moves no active lane's output by a single bit;
4. serves the full-width transformer the repo benchmarks (d_model 2048,
   4 layers, 32 heads, d_ff 8192, vocab 8192, max_len 1024, bf16, flash
   on; random weights from ``--seed``) through ``ServingEngine``: 16 HTTP
   ``POST /generate`` requests from 8 client threads plus one streamed
   request, prompts of 64-900 tokens, 32-64 new tokens, greedy and
   temperature 0.8, after a warm-up request per prefill width. It checks
   every answer, stream == non-stream, solo == co-scheduled, and that both
   kernels' launch counters rose from 0 during the burst and checks while
   both plain versions' counters stayed at 0;
5. times each kernel, its plain version and (K4) PyTorch's
   ``scaled_dot_product_attention`` with CUDA events beside the bound
   (max of bytes / 3.35 TB/s and flops / 989 TFLOP/s, H100 SXM data
   sheet), and the main path: prefill ms per width, decode-tick ms at 64
   lanes, generated tokens/s, peak device memory;
6. prints one ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Phase 5 also breaks a decode tick and a width-1024 prefill down by kernel
with ``torch.profiler``. ``--out PATH`` also writes the whole report as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerLM,
    prefill_cache,
)
from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size  # noqa: E402
from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from deeplearning4j_tpu_torch.serving.decode import _sample_step  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.paged import (  # noqa: E402
    paged_decode_step,
)

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores (data sheet)
TOL_FLASH_O = 2e-2           # bf16 in, f32 math, O rounded to bf16
TOL_FLASH_LSE = 1e-3         # f32 lse from bf16 inputs
TOL_PAGED = 1e-3             # f32 output from a bf16 arena
FLASH_WIDTHS = (192, 512, 1024)
H, HD, BT, M_TABLE, LANES = 32, 64, 16, 64, 64
N_REQUESTS, N_CLIENTS = 16, 8  # plus one streamed request
KERNELS = (flash_attention, flash_attention_plain, paged_attention,
           paged_attention_plain)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def short_name(mangled: str) -> str:
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10)
        name = out.stdout.strip() or mangled
    except OSError:
        name = mangled
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .replace("__nv_bfloat16", "bf16")


def phase_build():
    print("== build (nvcc -gencode arch=compute_90a,code=sm_90a) ==")
    for res in build.build(["flash_attention", "paged_attention"]):
        print(f"built {res.name}: {res.seconds:.1f} s -> "
              f"{os.path.relpath(res.path)}")
        fn = None
        for line in res.log.splitlines():
            if "Compiling entry function" in line:
                fn = short_name(line.split("'")[1])
            elif "Used" in line and "registers" in line and fn:
                print(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
            elif "spill stores" in line and fn:
                print(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")


def flash_inputs(t: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed + t)
    return [torch.randn((1, t, H, HD), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(3)]


def paged_inputs(seed: int, dev, n_blocks: int = 4096):
    """64 lanes over a bf16 arena of ``n_blocks`` (+ trash): positions
    inside block 0, across blocks, and at the full window."""
    rng = np.random.default_rng(seed)
    t_max = M_TABLE * BT
    pos = rng.integers(0, t_max, LANES).astype(np.int32)
    pos[:8] = rng.integers(0, BT, 8)      # inside block 0
    pos[8:12] = t_max - 1                 # the full window
    tables = np.zeros((LANES, M_TABLE), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    nxt = 0
    for i in range(LANES):
        used = int(pos[i]) // BT + 1
        tables[i, :used] = perm[nxt:nxt + used]
        nxt += used
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_blocks + 1, BT, H, HD)
    ck = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    cv = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn((LANES, H, HD), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return (q, ck, cv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def phase_kernels(seed: int, dev):
    print("== kernels against their plain versions ==")
    err_o = err_lse = 0.0
    for t in FLASH_WIDTHS:
        q, k, v = flash_inputs(t, seed, dev)
        o, lse = flash_attention(q, k, v, causal=True)
        ro, rlse = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"flash_attention T={t}: max|dO| {eo:.3e} (tol "
              f"{TOL_FLASH_O}), max|dlse| {el:.3e} (tol {TOL_FLASH_LSE})")
        check(eo <= TOL_FLASH_O and el <= TOL_FLASH_LSE,
              f"flash_attention disagrees with its plain version at T={t}")
        err_o, err_lse = max(err_o, eo), max(err_lse, el)
    q, ck, cv, tables, pos = paged_inputs(seed, dev)
    out = paged_attention(q, ck, cv, tables, pos)
    ref = paged_attention_plain(q, ck, cv, tables, pos)
    torch.cuda.synchronize()
    err_p = (out - ref).abs().max().item()
    print(f"paged_attention S={LANES} m={M_TABLE} pos in "
          f"[{int(pos.min())}, {int(pos.max())}]: max|d| {err_p:.3e} "
          f"(tol {TOL_PAGED})")
    check(err_p <= TOL_PAGED,
          "paged_attention disagrees with its plain version")
    ck[0], cv[0] = 1e6, -1e6
    poisoned = paged_attention(q, ck, cv, tables, pos)
    torch.cuda.synchronize()
    check(torch.equal(out, poisoned),
          "a poisoned trash block moved an active lane's output")
    print("paged_attention: trash block poisoned (K=1e6, V=-1e6): "
          "outputs bit-equal")
    return {"flash_attention": {"max_abs_err": err_o,
                                "max_abs_err_lse": err_lse},
            "paged_attention": {"max_abs_err": err_p}}


def _post(url: str, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _tokens(payload: dict, status: int, body: str):
    if payload.get("stream"):
        lines = [json.loads(x) for x in body.strip().splitlines()]
        check("done" in lines[-1], f"stream did not finish: {lines[-1]}")
        toks = [x["token"] for x in lines[:-1]]
        check(toks == lines[-1]["tokens"], "stream lines != its summary")
        return toks
    return json.loads(body)["tokens"][0]


def phase_serve(cfg: TransformerConfig, seed: int, dev):
    print("== serving: ServingEngine /generate ==")
    lm = TransformerLM(cfg, device=dev)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(N_REQUESTS):
        n_prompt = int(rng.integers(64, 901))
        reqs.append({"tokens": [rng.integers(0, cfg.vocab_size, n_prompt)
                                .tolist()],
                     "n_new": int(rng.integers(32, 65)),
                     "temperature": 0.0 if i % 2 == 0 else 0.8,
                     "seed": int(seed * 1000 + i)})
    stream_req = dict(reqs[1], stream=True)
    widths = sorted({min(max(bucket_size(k), k), cfg.max_len) for k in (
        min(len(r["tokens"][0]), cfg.max_len - r["n_new"]) for r in reqs)})
    print(f"prompt lengths {sorted(len(r['tokens'][0]) for r in reqs)}; "
          f"admission prefill widths {widths}")
    eng = ServingEngine(lm, device=dev).start()
    d = eng.decoder
    print(f"decoder: {d.lanes} lanes, {d.n_blocks} blocks of "
          f"{d.block_tokens} tokens, table width {d.table_width}")
    try:
        # warm-up: one short request per admission width, so the timed
        # burst does not pay first-call costs (CUDA module loads, GEMM
        # heuristics) for its shapes
        first = {}
        for r in reqs:
            k = min(len(r["tokens"][0]), cfg.max_len - r["n_new"])
            first.setdefault(min(max(bucket_size(k), k), cfg.max_len), r)
        for r in first.values():
            _post(eng.url, dict(r, n_new=2, temperature=0.0))
        for fn in KERNELS:  # counts from the timed burst on
            fn.launches = 0
        ticks0, tick_s0 = d.decode_ticks, d.tick_seconds
        adm0, adm_s0 = d.admissions, d.admit_seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as ex:
            answers = list(ex.map(lambda p: (p, *_post(eng.url, p)),
                                  reqs + [stream_req]))
        wall = time.perf_counter() - t0
        ticks = d.decode_ticks - ticks0
        tick_ms = (d.tick_seconds - tick_s0) / max(ticks, 1) * 1e3
        adm = d.admissions - adm0
        adm_ms = (d.admit_seconds - adm_s0) / max(adm, 1) * 1e3
        toks = []
        for p, status, body in answers:
            check(status == 200, f"HTTP {status}: {body[:200]}")
            t = _tokens(p, status, body)
            check(len(t) == p["n_new"],
                  f"{len(t)} tokens for n_new {p['n_new']}")
            toks.append(t)
        generated = sum(len(t) for t in toks)
        print(f"{len(answers)} requests answered (HTTP 200, right token "
              f"counts) in {wall:.3f} s: {generated} tokens, "
              f"{generated / wall:.1f} tokens/s, {ticks} decode ticks "
              f"({tick_ms:.3f} ms host wall each), {adm} admissions "
              f"({adm_ms:.3f} ms each), peak {d.peak_active} active lanes")
        _, body = _post(eng.url, reqs[1])
        check(_tokens(reqs[1], 200, body) == toks[-1],
              "streamed tokens != the same request without streaming")
        print("stream == non-stream (temperature 0.8): ok")
        _, body = _post(eng.url, reqs[0])
        check(_tokens(reqs[0], 200, body) == toks[0],
              "greedy request alone != the same request co-scheduled")
        _, body = _post(eng.url, reqs[3])
        check(_tokens(reqs[3], 200, body) == toks[3],
              "sampled request alone != the same request co-scheduled")
        print("solo == co-scheduled (greedy and temperature 0.8): ok")
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        print(f"launches during serving: {counts}")
        check(counts["flash_attention"] > 0 and
              counts["paged_attention"] > 0,
              "a kernel of the path was not launched while serving")
        check(counts["flash_attention_plain"] == 0 and
              counts["paged_attention_plain"] == 0,
              "a plain version ran while serving on the card")
    finally:
        eng.stop()
    return lm, widths, counts, {"requests": len(answers), "wall_s": wall,
                                "generated_tokens": generated,
                                "tokens_per_s": generated / wall,
                                "decode_ticks": ticks,
                                "tick_wall_ms": tick_ms,
                                "admissions": adm,
                                "admit_wall_ms": adm_ms}


def profile_ms(fn, n: int = 5):
    """Device time per call of each CUDA kernel ``fn`` launches (sorted,
    from torch.profiler) and their sum, the device-busy time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / n / 1e3, e.count // n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    return sum(r[0] for r in rows), rows


def phase_times(lm: TransformerLM, widths, seed: int, dev):
    print("== times (CUDA events) ==")
    cfg = lm.cfg
    res = {"flash_attention": {}, "paged_attention": {}, "main_path": {}}
    for t in FLASH_WIDTHS:
        q, k, v = flash_inputs(t, seed, dev)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        iters=5)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))
        nbytes = 4 * t * H * HD * 2 + H * t * 4
        flops = 2.0 * HD * t * (t + 1) * H
        b_ms, b_by = bound(nbytes, flops)
        res["flash_attention"][t] = dict(ms=ms, plain_ms=plain,
                                         library_ms=lib, bound_ms=b_ms,
                                         bound_by=b_by)
        print(f"flash_attention T={t}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    q, ck, cv, tables, pos = paged_inputs(seed + 1, dev)
    ms = time_ms(lambda: paged_attention(q, ck, cv, tables, pos))
    plain = time_ms(lambda: paged_attention_plain(q, ck, cv, tables, pos),
                    iters=5)
    vis = float((pos.long() + 1).sum().item())
    nbytes = vis * H * HD * 2 * 2 + LANES * H * HD * (2 + 4) \
        + tables.numel() * 4 + LANES * 4
    flops = 4.0 * vis * H * HD
    b_ms, b_by = bound(nbytes, flops)
    res["paged_attention"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                  bound_ms=b_ms, bound_by=b_by,
                                  mean_context=vis / LANES)
    print(f"paged_attention S={LANES} mean context {vis / LANES:.1f}: "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    with torch.inference_mode():
        for w in widths:
            toks = torch.randint(0, cfg.vocab_size, (1, w), device=dev)
            p_ms = time_ms(lambda: prefill_cache(lm.compute_params, toks,
                                                 cfg), iters=5)
            res["main_path"][f"prefill_ms_w{w}"] = p_ms
            print(f"prefill width {w}: {p_ms:.3f} ms")
        n_blocks = 4096
        shape = (cfg.n_layers, n_blocks + 1, BT, cfg.n_heads,
                 cfg.d_model // cfg.n_heads)
        arena = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        tok = torch.randint(0, cfg.vocab_size, (LANES,), device=dev,
                            dtype=torch.int32)
        temps = [0.0] * LANES
        gens = [None] * LANES

        def tick():
            _, logits = paged_decode_step(lm.compute_params, arena, tok,
                                          pos, tables, cfg)
            return _sample_step(logits, temps, gens)

        t_ms = time_ms(tick, iters=10)
        res["main_path"]["decode_tick_ms_64_lanes"] = t_ms
        print(f"decode tick, {LANES} lanes, mean context "
              f"{vis / LANES:.1f}: {t_ms:.3f} ms")
        busy, rows = profile_ms(tick)
        res["main_path"]["tick_profile"] = dict(
            device_busy_ms=busy,
            kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                     for r in rows[:12]])
        print(f"decode tick profile: {busy:.3f} ms of kernels per tick "
              f"({busy / t_ms:.1%} of the {t_ms:.3f} ms tick)")
        for ms_, calls, name in rows[:12]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
        toks = torch.randint(0, cfg.vocab_size, (1, max(widths)),
                             device=dev)
        busy, rows = profile_ms(
            lambda: prefill_cache(lm.compute_params, toks, cfg))
        p_ms = res["main_path"][f"prefill_ms_w{max(widths)}"]
        res["main_path"]["prefill_profile"] = dict(
            width=max(widths), device_busy_ms=busy,
            kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                     for r in rows[:12]])
        print(f"prefill width {max(widths)} profile: {busy:.3f} ms of "
              f"kernels ({busy / p_ms:.1%} of the {p_ms:.3f} ms "
              "prefill)")
        for ms_, calls, name in rows[:8]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build()
    with torch.inference_mode():
        errs = phase_kernels(args.seed, dev)
    cfg = TransformerConfig(vocab_size=8192, d_model=2048, n_layers=4,
                            n_heads=32, d_ff=8192, max_len=1024,
                            dtype_policy="performance", use_flash=True,
                            seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    lm, widths, launches, serve = phase_serve(cfg, args.seed, dev)
    with torch.inference_mode():
        times = phase_times(lm, widths, args.seed, dev)
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory allocated: {peak / 2**30:.3f} GiB; "
          f"whole run {time.perf_counter() - t_start:.1f} s")
    f4 = times["flash_attention"][max(FLASH_WIDTHS)]
    p6 = times["paged_attention"]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:117",
         "launches": launches["flash_attention"],
         "max_abs_err": errs["flash_attention"]["max_abs_err"],
         "max_abs_err_lse": errs["flash_attention"]["max_abs_err_lse"],
         "tolerance": TOL_FLASH_O,
         "ms": f4["ms"], "plain_ms": f4["plain_ms"],
         "bound_ms": f4["bound_ms"], "bound_by": f4["bound_by"],
         "library_ms": f4["library_ms"],
         "shape": f"N=1 T={max(FLASH_WIDTHS)} H={H} hd={HD} bf16 causal"},
        {"name": "paged_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_paged.py:145",
         "launches": launches["paged_attention"],
         "max_abs_err": errs["paged_attention"]["max_abs_err"],
         "tolerance": TOL_PAGED,
         "ms": p6["ms"], "plain_ms": p6["plain_ms"],
         "bound_ms": p6["bound_ms"], "bound_by": p6["bound_by"],
         "library_ms": None,
         "shape": f"S={LANES} bt={BT} m={M_TABLE} H={H} hd={HD} bf16, "
                  f"mean context {p6['mean_context']:.1f}"},
    ]
    if args.out:
        report = {"card": card, "kind": kind, "kernels": kernels,
                  "serving": serve, "times": times,
                  "peak_memory_bytes": peak}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
