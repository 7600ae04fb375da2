"""Readings for the limits of a training cell's comparison (not run by
the benchmark's own runs):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out PATH]

For each seed it runs the cell's set-up (the program's checked steps at
the cell's own size) and the reference, and prints the comparison's
numbers of the program (the lower readings). For each control seed it
also reads the control (the reference put in the program's place, in the
precision below the configuration's: ``precision.control``) and the
half-batch fault (the reference on the first half of each batch, the
mean over those rows), each against the reference. A state left
unchanged reads 1 on ``change_gap`` and needs no run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def training_row(driver, cfg, traffic, seed, dev, control):
    from perfbench import checks, training

    fit, data, prog = driver.setup(cfg, traffic, seed, dev)
    del fit
    training.free_device(dev)
    ref = driver.reference(cfg, traffic, seed, dev, data)
    row = {"seed": seed, "program": checks.training_numbers(prog, ref),
           "losses": {"program": prog["losses"],
                      "reference": ref["losses"]}}
    if control:
        ctl = driver.reference(cfg, traffic, seed, dev, data,
                               precision=cfg["precision"]["control"])
        half = driver.reference(cfg, traffic, seed, dev, data,
                                keep_rows=traffic["rows"] // 2)
        row["control"] = checks.training_numbers(ctl, ref)
        row["fault_half_batch"] = checks.training_numbers(half, ref)
    training.free_device(dev)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.resolve_cell(spec, args.workload)
    driver = harness.load_module(
        cell.files / "drivers" / f"{cell.traffic['driver']}.py")
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    cfg, traffic = cell.config, cell.traffic
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = {"cell": cell.name, "device": str(dev), "rows": []}
    for seed in seeds:
        t0 = time.perf_counter()
        row = training_row(driver, cfg, traffic, seed, dev,
                           seed in controls)
        row["seconds"] = time.perf_counter() - t0
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    for kind in ("program", "control", "fault_half_batch"):
        got = [r[kind] for r in out["rows"] if kind in r]
        if got:
            summary = {k: [min(g[k] for g in got), max(g[k] for g in got)]
                       for k in got[0]}
            out[kind] = summary
            print(kind, "min/max", json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
