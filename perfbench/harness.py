"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its driver, reads its per-layer metrics and prints the result line.

A driver (``drivers/<name>.py``) exposes ``run(ctx) -> Outcome``. It sets
up, calls ``ctx.window_opened()`` right before the first timed step or
request (the end of set-up), measures for ``ctx.seconds``, and, once the
window has closed, decides ``correct`` by comparing with the plain
reference. A per-layer metric (``metrics/<name>.py``) exposes
``read(run) -> float | None``; None leaves the metric out of the line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
PB = ROOT / "perfbench"
SCRATCH = ROOT / "build" / "perfbench"
# top-level module names that may not be loaded in a run (compared whole:
# the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


class CellError(RuntimeError):
    """A cell, or one of its files, is missing or malformed."""


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------


def load_json(path: Path) -> Any:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """A module of the benchmark loaded from its file (metric readers'
    file names hold dots, so they are not importable by name)."""
    if not path.is_file():
        raise CellError(f"missing file {path}")
    name = name or "perfbench_file_" + path.stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path = ROOT  # the checkout whose perfbench/ holds its files

    @property
    def files(self) -> Path:
        return self.root / "perfbench"


def metrics_of(spec: Dict[str, Any], cell: str
               ) -> Tuple[List[dict], List[dict]]:
    """The end-to-end metrics a cell reports (those without a
    ``workloads`` key, and those that list it) and its per-layer metrics
    (those that list it; without the key, those whose ``moves`` it
    reports)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def resolve_cell(spec: Dict[str, Any], name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits read
    from their files under ``perfbench/``."""
    pb = root / "perfbench"
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have: {', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise CellError(f"workload {name} names unknown config "
                        f"{w['config']!r}")
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(pb / "traffic" / f"{w['traffic']}.json")
    limits = load_json(pb / "limits" / f"{name}.json")
    e2e, per = metrics_of(spec, name)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per, root=root)


# ---------------------------------------------------------------------------
# what a driver gets and gives back
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_start: float
    scratch: Path = SCRATCH
    setup_s: Optional[float] = None

    def window_opened(self) -> None:
        """Set-up ends here: the first timed step or request follows."""
        self.setup_s = time.perf_counter() - self.t_start

    def limit(self, name: str) -> float:
        return float(self.cell.limits["limits"][name])


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    # (short name, value, limit): correct when every value <= its limit
    checks: List[Tuple[str, float, float]]
    counters: Dict[str, Any]
    memory_peak_bytes: int
    trace: Any = None  # tracing.Summary of the traced slice, or None


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader sees."""
    cell: Cell
    counters: Dict[str, Any]
    trace: Any
    device_kind: str
    peaks: Dict[str, Any]


def peaks_for(kind: str) -> Optional[Dict[str, Any]]:
    """The published peaks of the card named ``kind`` (``peaks.json``),
    or None for a card the table does not hold."""
    table = load_json(PB / "peaks.json")
    return table["cards"].get(kind)


def is_correct(checks: List[Tuple[str, float, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)


def read_per_layer(cell: Cell, run: Run) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.files / "metrics" / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, ctx: Context, oc: Outcome, device: Dict,
                per_layer: Optional[Dict] = None,
                breakdown: Optional[Dict] = None) -> Dict[str, Any]:
    """The result's JSON object; ``checks`` comes last."""
    if per_layer is None:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in oc.e2e.items() if k in units}
        metrics["setup_s"] = {"value": float(ctx.setup_s), "unit": "s"}
    else:
        metrics = per_layer
    line = {"correct": is_correct(oc.checks), "attempted": int(oc.attempted),
            "failed": int(oc.failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": float(v), "limit": float(lim)}
                      for n, v, lim in oc.checks}
    return line


def forbidden_loaded() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name is forbidden."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: Cell, ctx: Context) -> Tuple[Outcome, Dict[str, Any]]:
    """The cell's driver, then the device's record of the run."""
    import torch

    driver = load_module(cell.files / "drivers"
                         / f"{cell.traffic['driver']}.py")
    oc = driver.run(ctx)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": int(oc.memory_peak_bytes)}
    if oc.trace is not None:
        device["busy_s"] = oc.trace.busy_s
        device["window_s"] = oc.trace.window_s
    return oc, device


def main(argv: List[str], t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        spec = load_json(ROOT / "BENCHMARK.json")
        cell = resolve_cell(spec, args.workload)
    except CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "false); no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 3
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=t_start)
    return report(cell, ctx)


def report(cell: Cell, ctx: Context) -> int:
    """Runs the cell, reads its per-layer metrics and prints the result
    line; 4 and no result where a forbidden module is loaded by then (the
    metric readers included)."""
    oc, device = run_cell(cell, ctx)
    per_layer = breakdown = None
    if ctx.trace:
        run = Run(cell=cell, counters=oc.counters, trace=oc.trace,
                  device_kind=device["kind"],
                  peaks=peaks_for(device["kind"]) or {})
        per_layer = read_per_layer(cell, run)
        breakdown = oc.trace.breakdown() if oc.trace is not None else None
    line = result_line(cell, ctx, oc, device, per_layer, breakdown)
    card = power_limit()
    if card:
        # the card's name and power limit, beside every number kept
        line = {**{k: v for k, v in line.items() if k != "checks"},
                "card": card, "checks": line["checks"]}
        print(f"card: {card}", file=sys.stderr)
    bad = forbidden_loaded()
    if bad:
        print("perfbench: forbidden modules loaded in this process: "
              + ", ".join(bad) + "; no result", file=sys.stderr)
        return 4
    for name, value, limit in oc.checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
