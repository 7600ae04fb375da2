"""SLO classes for the ``/generate`` scheduler (counterpart:
``deeplearning4j_tpu/serving/slo.py``; tenant quotas wait for a later
slice).

Each class carries a default per-request deadline (its 504 budget); class
order in the spec is admission priority — highest class first, FIFO
within a class; when the pending queue is full a new request sheds the
youngest request of the lowest class strictly below it, else is itself
rejected 429.

Spec format: ``name:deadline_s`` pairs, comma-separated, highest priority
first — e.g. ``interactive:5,batch:60``. Empty spec = one implicit
``default`` class at the engine's request timeout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class SLOClass:
    name: str
    deadline_s: float
    priority: int  # 0 = highest (spec order)


def parse_slo_classes(spec: str) -> List[SLOClass]:
    """``"interactive:5,batch:60"`` -> [SLOClass, ...] in priority order.
    Raises ValueError on malformed entries."""
    out: List[SLOClass] = []
    spec = (spec or "").strip()
    if not spec:
        return out
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, deadline = part.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"bad SLO class {part!r}: expected name:deadline_s")
        if name in seen:
            raise ValueError(f"duplicate SLO class {name!r}")
        try:
            deadline_s = float(deadline)
        except ValueError:
            raise ValueError(
                f"bad SLO deadline {deadline!r} for class {name!r}") \
                from None
        if deadline_s <= 0:
            raise ValueError(f"SLO deadline for {name!r} must be > 0")
        seen.add(name)
        out.append(SLOClass(name, deadline_s, len(out)))
    return out


def default_classes(request_timeout_s: float) -> List[SLOClass]:
    """The implicit single-class policy."""
    return [SLOClass("default", float(request_timeout_s), 0)]
