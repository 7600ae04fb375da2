"""The comparisons that decide ``correct``.

Training (the first steps of the object the window then drives, against
the plain reference from the same weights and rows):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the program's norm of the
  first gradient (from Adam's first moment after one step: m = (1-b1) g)
  and the reference's, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change after the
  last checked step, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a leaf with no gradient moves under
  Adam by round-off alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

SMALL_GRAD = 1e-3


def _gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        denom = max(ref[k], med)
        if denom <= 0.0:
            continue
        worst = max(worst, _finite(abs(prog[k] - ref[k]) / denom))
    return worst


def _finite(x: float) -> float:
    """A gap that is not a number reads as infinitely large."""
    return x if math.isfinite(x) else math.inf


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers of :mod:`checks`' docstring from two readings
    (``losses``, ``grad_norms``, ``change_norms``)."""
    loss = max(_finite(abs(p - r) / abs(r))
               for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= SMALL_GRAD * med]
    return {"loss_gap": loss,
            "grad_gap": _gap(prog["grad_norms"], g, g.keys()),
            "change_gap": _gap(prog["change_norms"], ref["change_norms"],
                               moved)}


def training_checks(prog: Dict, ref: Dict, limits: Dict[str, float]
                    ) -> List[Tuple[str, float, float]]:
    nums = training_numbers(prog, ref)
    return [(k, nums[k], float(limits[k])) for k in sorted(limits)
            if k in nums]
