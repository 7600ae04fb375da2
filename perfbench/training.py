"""What the training drivers share: the checked first steps of set-up,
the measured window, the traced slice and the comparison with the
reference.

Set-up builds ONE training object from the seed, drives it through its
first ``checked_steps`` steps by the window's own call on rows that all
differ, and hands that same object to the window. Of those steps it
keeps each loss, the first gradient's norm per leaf (from Adam's first
moment after one step) and each leaf's change after the last; the
reference follows the same steps once the window has closed and the
program is gone.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List

import torch

from perfbench import tracing, weights
from perfbench.reference.adam import B1


def norms(tree: Dict, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) * scale
            for k, v in weights.named(tree).items()}


def setup_steps(fit: Callable, batches: List, first_moment: Callable,
                params_now: Callable, params0: Callable) -> Dict:
    """Run ``fit`` on each checked batch and read the program's state:
    the losses, the first gradient's norms (``first_moment()`` after one
    step, over 1 - b1) and the change of each leaf from ``params0()``
    (the seed's weights made again) after the last step."""
    losses, grads = [], None
    for i, b in enumerate(batches):
        losses.append(fit(b))
        if i == 0:
            grads = norms(first_moment(), 1.0 / (1.0 - B1))
    start = weights.named(params0())
    now = weights.named(params_now())
    change = {k: float((now[k].detach() - start[k]).norm()) for k in start}
    del start
    return {"losses": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": change}


def window(fit: Callable, batch_at: Callable, seconds: float,
           device) -> Dict:
    """Steps one after another until ``seconds`` have passed, then wait
    for the device: the steps, the seconds, and the losses that are not
    finite (each loss read once the window has closed)."""
    sync(device)
    losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(fit(batch_at(len(losses))))
    sync(device)
    wall = time.perf_counter() - t0
    vals = torch.as_tensor([float(x) for x in losses])
    return {"steps": len(losses), "seconds": wall,
            "nonfinite": int((~torch.isfinite(vals)).sum())}


def traced_slice(fit: Callable, batch_at: Callable, first: int, steps: int,
                 scratch):
    def body():
        for i in range(steps):
            fit(batch_at(first + i))
    return tracing.capture(body, scratch)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
