"""SLO classes for the ``/generate`` scheduler and tenant quotas
(counterpart: ``deeplearning4j_tpu/serving/slo.py`` — ``SLOClass``,
``parse_slo_classes`` and ``default_classes`` :1-84, ``TenantQuota``,
``parse_tenant_quotas`` and ``TenantBucket`` :87-170). The router that
meters tenants waits for the fleet slice; the quotas are pure.

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

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple


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


@dataclass(frozen=True)
class TenantQuota:
    name: str
    rate_per_s: float  # sustained admissions per second (refill rate)
    burst: float       # bucket capacity (peak back-to-back admissions)


def parse_tenant_quotas(spec: str) -> List[TenantQuota]:
    """``"acme:10,free:2:5"`` -> [TenantQuota, ...]: ``name:rate_per_s``
    or ``name:rate_per_s:burst``, burst defaulting to ``max(1,
    rate_per_s)``. Raises ValueError on malformed entries, so a typo'd
    spec fails at construction instead of admitting a tenant
    unmetered."""
    out: List[TenantQuota] = []
    spec = (spec or "").strip()
    if not spec:
        return out
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = [f.strip() for f in part.split(":")]
        if len(fields) not in (2, 3) or not fields[0]:
            raise ValueError(
                f"bad tenant quota {part!r}: expected "
                "name:rate_per_s[:burst]")
        name = fields[0]
        if name in seen:
            raise ValueError(f"duplicate tenant quota {name!r}")
        try:
            rate = float(fields[1])
            burst = (float(fields[2]) if len(fields) == 3
                     else max(1.0, rate))
        except ValueError:
            raise ValueError(
                f"bad tenant quota numbers in {part!r}") from None
        if rate <= 0 or burst < 1:
            raise ValueError(
                f"tenant quota {name!r} needs rate > 0 and burst >= 1")
        seen.add(name)
        out.append(TenantQuota(name, rate, burst))
    return out


class TenantBucket:
    """One tenant's token bucket: ``burst`` capacity refilled at
    ``rate_per_s``, one token per admitted request. The clock
    (``now_fn``) is injectable, so admission verdicts replay
    deterministically. Thread-safe."""

    def __init__(self, quota: TenantQuota,
                 now_fn: Callable[[], float] = time.monotonic) -> None:
        self.quota = quota
        self._now = now_fn
        self._lock = threading.Lock()
        self._tokens = float(quota.burst)
        self._last: Optional[float] = None  # the first take starts refill

    def try_take(self) -> Tuple[bool, float]:
        """(admitted, retry_after_s): one token if available, else the
        seconds until the bucket holds one again (a 429's Retry-After)."""
        with self._lock:
            now = self._now()
            if self._last is not None and now > self._last:
                self._tokens = min(
                    self.quota.burst,
                    self._tokens + (now - self._last)
                    * self.quota.rate_per_s)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True, 0.0
            return False, (1.0 - self._tokens) / self.quota.rate_per_s

    def tokens(self) -> float:
        with self._lock:
            return self._tokens
