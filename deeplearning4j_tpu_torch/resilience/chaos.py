"""Serving and speculative-decode chaos (counterpart:
``deeplearning4j_tpu/resilience/chaos.py`` — ``InjectedServingFault``,
``ServingChaosConfig`` and ``ServingChaos`` :265-397, ``SpecChaosConfig``
:529 and ``SpecChaos`` :545). The training, fleet, low-precision and
autoscale chaos of that module wait for a later slice.

``ServingChaos`` injects serving faults deterministically, keyed on
1-based counts of engine-side events: batcher dispatches for the infer
faults (a raise, a hang, a slow call), decode admissions for the
admission fault, and record names for the load and warmup faults. It is
config-driven only: an engine without one is the engine without faults.

``SpecChaos`` forces all-reject speculative rounds deterministically: at
acceptance-comparison time, after the verify ran on the true proposals,
each proposal of a chosen round becomes (target greedy + 1) % vocab,
which can never match. An all-reject round commits only the target's own
first token, a function of the last committed token alone, so the stream
stays byte-equal to target-only greedy decode.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


class InjectedServingFault(RuntimeError):
    """A chaos-injected serving failure (inference, load, warmup, decode
    admission)."""


@dataclass
class ServingChaosConfig:
    """The serving fault plan. Indices are 1-based counts of the event
    they key on:

      infer_raise_at    dispatches [k, k + infer_raise_count) raise
                        :class:`InjectedServingFault` (a flaky model:
                        consecutive failures walk the breaker open);
      infer_hang_at     dispatch k blocks for ``infer_hang_s`` seconds, or
                        until :meth:`ServingChaos.release_hangs`, with no
                        error and no CPU (the hung device call the
                        watchdog must diagnose); it then returns, after
                        the watchdog has failed its futures and fenced its
                        worker, so the late completion must change
                        nothing;
      slow_infer_at     dispatch k sleeps ``slow_infer_s`` then succeeds
                        (latency without failure: no breaker vote);
      load_fail_name    registry.load(name) raises (a bad rollout);
      warmup_fail_name  registry.warmup(name) raises;
      admit_raise_at    the k-th decode admission raises (its lane is
                        evicted, co-residents untouched).
    """

    infer_raise_at: Optional[int] = None
    infer_raise_count: int = 1
    infer_hang_at: Optional[int] = None
    infer_hang_s: float = 3600.0
    slow_infer_at: Optional[int] = None
    slow_infer_s: float = 0.0
    load_fail_name: Optional[str] = None
    warmup_fail_name: Optional[str] = None
    admit_raise_at: Optional[int] = None


class ServingChaos:
    """Stateful executor of a :class:`ServingChaosConfig`, consulted by
    the engine's batcher call (per dispatch), the registry (load, warmup)
    and the decoders (per admission). ``log`` keeps (index or name,
    fault)."""

    def __init__(self, config: ServingChaosConfig):
        if isinstance(config, dict):
            config = ServingChaosConfig(**config)
        self.config = config
        self._dispatches = 0
        self._admits = 0
        self._lock = threading.Lock()
        self._hang_release = threading.Event()
        self.log: list = []

    def release_hangs(self) -> None:
        """End every injected hang now (a test's teardown)."""
        self._hang_release.set()

    def on_infer(self) -> None:
        """At each batcher dispatch, before the model call."""
        c = self.config
        with self._lock:
            self._dispatches += 1
            k = self._dispatches
        if c.slow_infer_at is not None and k == c.slow_infer_at:
            self.log.append((k, "slow_infer"))
            time.sleep(c.slow_infer_s)
        if c.infer_hang_at is not None and k == c.infer_hang_at:
            self.log.append((k, "infer_hang"))
            self._hang_release.wait(timeout=c.infer_hang_s)
            return
        if (c.infer_raise_at is not None
                and c.infer_raise_at <= k
                < c.infer_raise_at + c.infer_raise_count):
            self.log.append((k, "infer_raise"))
            raise InjectedServingFault(
                f"injected inference failure at dispatch {k}")

    def on_load(self, name: str) -> None:
        """Inside registry.load, before the record is installed."""
        if (self.config.load_fail_name is not None
                and name == self.config.load_fail_name):
            self.log.append((name, "load_fail"))
            raise InjectedServingFault(f"injected load failure for {name!r}")

    def on_warmup(self, name: str) -> None:
        """At the head of registry.warmup."""
        if (self.config.warmup_fail_name is not None
                and name == self.config.warmup_fail_name):
            self.log.append((name, "warmup_fail"))
            raise InjectedServingFault(
                f"injected warmup failure for {name!r}")

    def on_admit(self) -> None:
        """Per decode admission, before its prefill."""
        c = self.config
        with self._lock:
            self._admits += 1
            k = self._admits
        if c.admit_raise_at is not None and k == c.admit_raise_at:
            self.log.append((k, "admit_raise"))
            raise InjectedServingFault(
                f"injected decode-slot crash at admission {k}")


@dataclass
class SpecChaosConfig:
    """Corrupt the proposals of rounds ``reject_at_round`` ..
    ``reject_at_round + count - 1`` (the decoder's round counter)."""

    reject_at_round: Optional[int] = None
    count: int = 1     # consecutive corrupted rounds from reject_at_round

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("count must be >= 1")


class SpecChaos:
    """Stateful executor of a :class:`SpecChaosConfig`; ``log`` keeps
    (round, fault) for tests."""

    def __init__(self, config: SpecChaosConfig):
        if isinstance(config, dict):
            config = SpecChaosConfig(**config)
        self.config = config
        self.log: list = []

    def corrupt(self, round_idx: int, proposed, target_greedy,
                vocab_size: int):
        """The proposals to compare for round ``round_idx``: a corrupted
        copy on fault rounds (the caller's array is never changed), else
        ``proposed`` itself."""
        c = self.config
        if (c.reject_at_round is None
                or not (c.reject_at_round <= round_idx
                        < c.reject_at_round + c.count)):
            return proposed
        bad = np.array(proposed, dtype=np.int32, copy=True)
        g = np.asarray(target_greedy, np.int32).reshape(-1)[:bad.size]
        bad[:] = (g + 1) % int(vocab_size)
        self.log.append((round_idx, "reject_all"))
        return bad
