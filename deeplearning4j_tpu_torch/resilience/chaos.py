"""Deterministic fault injection (counterpart:
``deeplearning4j_tpu/resilience/chaos.py`` — the training side:
``InjectedKill`` and ``TransientDeviceError`` :46-54, ``ChaosConfig`` and
``ChaosMonkey`` :55-148, ``LowPrecChaosConfig`` and ``LowPrecChaos``
:482-528, ``truncate_file`` and ``bitflip_file`` :641-660; the serving
side: ``InjectedServingFault``, ``ServingChaosConfig`` and
``ServingChaos`` :265-397, ``SpecChaosConfig`` :529 and ``SpecChaos``
:545). The fleet and autoscale chaos wait for the slices that port
those planes.

``ChaosMonkey`` injects the faults the training runtime claims to
survive, at exact 1-based step counts: a kill after step k (an
``InjectedKill`` raise, or a real SIGTERM to this process that the
trainer answers with a checkpoint before it dies), a stall and a
transient device error before step k, and a truncated or bit-flipped
payload of the checkpoint committed for step k (the manager calls
``on_checkpoint_written``). ``LowPrecChaos`` poisons the features of a
step so a bf16 loss-scaled step halves its scale and skips.

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

import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


class InjectedKill(RuntimeError):
    """A chaos-injected hard crash (no cleanup, no goodbye checkpoint)."""


class TransientDeviceError(RuntimeError):
    """A chaos-injected transient accelerator failure (retryable)."""


@dataclass
class ChaosConfig:
    """Declarative fault plan. Steps are 1-based counts of COMPLETED
    trainer steps (kill_at_step=k dies after the k-th step's update has
    been applied; stall/transient fire before the step runs)."""

    kill_at_step: Optional[int] = None
    kill_mode: str = "exception"  # "exception" | "sigterm"
    stall_at_step: Optional[int] = None
    stall_seconds: float = 0.0
    transient_error_at_step: Optional[int] = None
    transient_error_count: int = 1
    # {"at_step": int, "mode": "truncate"|"bitflip"} applied to the
    # checkpoint the manager just committed for that step
    corrupt_checkpoint: Optional[dict] = None

    def __post_init__(self):
        if self.kill_mode not in ("exception", "sigterm"):
            raise ValueError(f"unknown kill_mode {self.kill_mode!r}")
        if self.corrupt_checkpoint is not None:
            mode = self.corrupt_checkpoint.get("mode", "truncate")
            if mode not in ("truncate", "bitflip"):
                raise ValueError(f"unknown corruption mode {mode!r}")


class ChaosMonkey:
    """Stateful executor of a :class:`ChaosConfig`, consulted by
    ResilientTrainer (before/after each step) and CheckpointManager
    (after each committed checkpoint). Deterministic: the same config
    against the same step sequence injects the same faults."""

    def __init__(self, config: ChaosConfig):
        if isinstance(config, dict):
            config = ChaosConfig(**config)
        self.config = config
        self._transient_left = int(config.transient_error_count)
        self.log: list = []  # (step, fault) audit trail for tests

    # ------------------------------------------------------------ step hooks
    def before_step(self, step: int) -> None:
        """`step` is the 1-based index of the step ABOUT to run."""
        c = self.config
        if c.stall_at_step is not None and step == c.stall_at_step:
            self.log.append((step, "stall"))
            time.sleep(c.stall_seconds)
        if (c.transient_error_at_step is not None
                and step == c.transient_error_at_step
                and self._transient_left > 0):
            self._transient_left -= 1
            self.log.append((step, "transient_error"))
            raise TransientDeviceError(
                f"injected transient device error at step {step} "
                f"({self._transient_left} more before recovery)")

    def after_step(self, step: int) -> None:
        """`step` is the 1-based count of COMPLETED steps."""
        c = self.config
        if c.kill_at_step is not None and step == c.kill_at_step:
            self.log.append((step, f"kill:{c.kill_mode}"))
            if c.kill_mode == "sigterm":
                # a REAL signal, exactly like a preempting scheduler: the
                # trainer's handler sets the flag and the loop performs
                # checkpoint-before-death at the next boundary
                os.kill(os.getpid(), signal.SIGTERM)
                return
            raise InjectedKill(f"injected kill after step {step}")

    # ------------------------------------------------- checkpoint corruption
    def on_checkpoint_written(self, path: str, step: int) -> None:
        """Called by CheckpointManager after committing `path` for `step`."""
        c = self.config.corrupt_checkpoint
        if c is None or int(c.get("at_step", -1)) != step:
            return
        target = os.path.join(path, "model.zip")
        if not os.path.exists(target):  # sharded layout: hit any payload
            for root, _, files in os.walk(path):
                for f in files:
                    if f != "MANIFEST.json":
                        target = os.path.join(root, f)
                        break
        mode = c.get("mode", "truncate")
        self.log.append((step, f"corrupt:{mode}"))
        if mode == "truncate":
            truncate_file(target, keep=int(c.get("keep_bytes", 16)))
        else:
            bitflip_file(target, offset=c.get("at_byte"))


@dataclass
class LowPrecChaosConfig:
    """Declarative overflow plan for the bf16 loss-scaling contract
    (ops/lowprec.py): poison the FEATURES of step ``overflow_at_step``
    (1-based) so the backward pass produces non-finite grads and the
    dynamic loss scale must halve-and-skip. Config-driven, never ambient
    — the test loop calls :meth:`LowPrecChaos.poison` explicitly."""

    overflow_at_step: Optional[int] = None
    mode: str = "inf"  # "inf" | "nan"
    count: int = 1     # consecutive poisoned steps from overflow_at_step

    def __post_init__(self):
        if self.mode not in ("inf", "nan"):
            raise ValueError(f"unknown overflow mode {self.mode!r}")
        if self.count < 1:
            raise ValueError("count must be >= 1")


class LowPrecChaos:
    """Stateful executor of a :class:`LowPrecChaosConfig` (the ChaosMonkey
    shape). Deterministic: poisons element [0, ...] of the feature batch
    for the configured step window, leaves every other step untouched."""

    def __init__(self, config: LowPrecChaosConfig):
        if isinstance(config, dict):
            config = LowPrecChaosConfig(**config)
        self.config = config
        self.log: list = []  # (step, fault) audit trail for tests

    def poison(self, step: int, features):
        """`step` is the 1-based index of the step about to run. Returns
        the features to feed it (a poisoned COPY on fault steps — the
        caller's array is never mutated)."""
        c = self.config
        if (c.overflow_at_step is None
                or not (c.overflow_at_step <= step
                        < c.overflow_at_step + c.count)):
            return features
        import numpy as np

        bad = np.array(features, dtype=np.float32, copy=True)
        bad.reshape(-1)[0] = np.inf if c.mode == "inf" else np.nan
        self.log.append((step, f"overflow:{c.mode}"))
        return bad


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


def truncate_file(path: str, keep: int = 16) -> None:
    """Write-then-truncate fault: keep only the first `keep` bytes (a
    crash mid-write that an atomic rename would normally prevent —
    simulates torn storage underneath the checkpoint)."""
    with open(path, "r+b") as f:
        f.truncate(keep)


def bitflip_file(path: str, offset: Optional[int] = None) -> None:
    """Flip one bit of `path` in place (silent media corruption). With no
    offset the middle byte is flipped — deterministic, no RNG."""
    size = os.path.getsize(path)
    if size == 0:
        return
    off = size // 2 if offset is None else int(offset) % size
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x01]))
