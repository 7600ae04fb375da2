"""The traced slice of a run: a ``torch.profiler`` trace (CPU and CUDA
activity) around a few more steps or ticks after the measured window, and
its reduction to what the per-layer metrics and the ``breakdown`` read.

The slice is marked by a ``perfbench.window`` annotation; device time is
the union of kernel, memcpy and memset records inside it (CUPTI has been
seen to drop some kernel records on the card, so a busy share may read
low and a kernel's mean time per launch is taken over the launches that
were recorded). An idle gap is named by the deepest host event (operator,
CUDA runtime call or annotation) that covers its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    # kernel name -> (launches recorded, seconds)
    kernels: Dict[str, Tuple[int, float]]
    # host activity -> idle seconds of the device under it
    idle: Dict[str, float]

    @property
    def idle_pct(self) -> float:
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)

    def kernel_time(self, pattern: str) -> Tuple[int, float]:
        """(launches, seconds) of every kernel whose name holds
        ``pattern`` as a word part (``flash_bwd_dq`` matches
        ``void flash_bwd_dq<__nv_bfloat16, 64, 256>(Params)``)."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if pattern in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(((k, t) for k, (_, t) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[short(k), t] for k, t in ops],
                "idle_gaps": [[short(k), t] for k, t in gaps]}


def short(name: str) -> str:
    """A kernel or host event's name, stable and bounded: no leading
    ``void``, at most ``NAME_CHARS`` characters."""
    if name.startswith("void "):
        name = name[5:]
    return name[:NAME_CHARS]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float, scan: int = 4096) -> str:
    """The deepest host event covering time ``t``: of those that cover
    it, the one that started last (``host`` sorted by start)."""
    j = bisect.bisect_right(starts, t) - 1
    for k in range(j, max(-1, j - scan), -1):
        if host[k][1] >= t:
            return host[k][2]
    return "host: no traced event"


def summarize(events: List[dict]) -> Summary:
    """Reduce a Chrome trace's events (times in microseconds) to a
    :class:`Summary` of the ``perfbench.window`` annotation's span."""
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation" and "dur" in e]
    if not wins:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev: List[Tuple[float, float]] = []
    kernels: Dict[str, Tuple[int, float]] = {}
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            if cat == "kernel":
                c, t = kernels.get(e["name"], (0, 0.0))
                kernels[e["name"]] = (c + 1, t + (b - a) * 1e-6)
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union(dev)
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        idle_by = _host_at(host, starts, 0.5 * (a + b))
        idle[idle_by] = idle.get(idle_by, 0.0) + (b - a) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   kernels=kernels, idle=idle)


def capture(body: Callable[[], None], scratch: Path) -> Summary:
    """Run ``body`` (a few steps or ticks, ending in a synchronize) under
    the profiler and reduce its trace; the trace file is written to
    ``scratch`` and removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch.mkdir(parents=True, exist_ok=True)
    path = scratch / f"trace-{os.getpid()}.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            body()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return summarize(events)


def kernel_mean(summary: Optional[Summary], patterns) -> Optional[float]:
    """Seconds per call of an operation made of one launch of each
    kernel in ``patterns``: the sum over the patterns of each one's mean
    time per recorded launch. None where the trace recorded none of one
    of them."""
    if summary is None:
        return None
    total = 0.0
    for p in patterns:
        n, s = summary.kernel_time(p)
        if n == 0:
            return None
        total += s / n
    return total
