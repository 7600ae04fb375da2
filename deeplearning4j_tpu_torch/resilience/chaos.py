"""Deterministic fault injection (counterpart:
``deeplearning4j_tpu/resilience/chaos.py`` — the training side:
``InjectedKill`` and ``TransientDeviceError`` :46-54, ``ChaosConfig`` and
``ChaosMonkey`` :55-148, ``LowPrecChaosConfig`` and ``LowPrecChaos``
:482-528, ``truncate_file`` and ``bitflip_file`` :641-660; the serving
side: ``InjectedServingFault``, ``ServingChaosConfig`` and
``ServingChaos`` :265-397, ``SpecChaosConfig`` :529 and ``SpecChaos``
:545; the fleet's: ``CoordinatorPartitioned``, ``FleetChaosConfig`` and
``FleetChaos`` :149-264, ``ReplicaPartitioned``, ``RouterChaosConfig``
and ``RouterChaos`` :398-481, ``AutoscaleChaosConfig`` and
``AutoscaleChaos`` :580-640).

``FleetChaos`` kills a worker at a job poll or while it holds a split,
stalls a split's heartbeats past the timeout (a zombie whose late
completion must be fenced out) and partitions the coordinator's
membership polls. ``RouterChaos`` decides a replica's hard kill after k
proxied requests (the fleet's hook enacts it) and partitions the
router's first k calls to a replica. ``AutoscaleChaos`` overlays the
scraped ``/signals`` snapshot with a scripted load wave.

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


# ---------------------------------------------------------------------------
# the elastic fleet, the serving router and the autoscaler
# ---------------------------------------------------------------------------


class CoordinatorPartitioned(ConnectionError):
    """A chaos-injected membership-plane partition: the coordinator's
    poll of the membership authority fails (the Hazelcast split-brain /
    ZooKeeper session-loss failure the reference inherits from its
    cluster substrate)."""


@dataclass
class FleetChaosConfig:
    """Declarative fleet fault plan. Rounds are 1-based averaging rounds;
    faults key on the ROUND (and, where executor identity is racy, on the
    SPLIT — whichever worker holds that split is the victim, which keeps
    the fault deterministic under free-for-all job scheduling while the
    round's numerics stay executor-independent by construction).

      kill_worker       — {"worker": id, "in_round": r}: the worker dies
                          at its first job poll of round r (holding its
                          job, if it got one) — heartbeat expiry detects
                          it, its split is reclaimed, the NEXT round
                          re-forms over the survivors.
      kill_split        — {"round": r, "split": s}: whoever takes split s
                          of round r dies HOLDING it (guaranteed reclaim
                          + re-execution path).
      stall_heartbeat   — {"round": r, "split": s, "sleep_s": x}: the
                          holder of split s goes silent for x seconds
                          (> the heartbeat timeout) while still alive —
                          the job is reclaimed and re-executed; the
                          zombie's late completion must be FENCED out
                          (StateTracker attempt fencing), after which the
                          zombie re-registers (rejoin).
      partition_coordinator — {"at_round": r, "polls": k}: the first k
                          membership polls of round r raise
                          :class:`CoordinatorPartitioned`; the
                          coordinator must retry / fall back to the
                          last-known membership instead of dying.
    """

    kill_worker: Optional[dict] = None
    kill_split: Optional[dict] = None
    stall_heartbeat: Optional[dict] = None
    partition_coordinator: Optional[dict] = None


class FleetChaos:
    """Stateful executor of a :class:`FleetChaosConfig`, consulted by the
    fleet coordinator (membership polls) and its workers (job polls /
    job receipt). Deterministic: the same config against the same round
    sequence injects the same faults exactly once each."""

    def __init__(self, config: FleetChaosConfig):
        if isinstance(config, dict):
            config = FleetChaosConfig(**config)
        self.config = config
        c = config.partition_coordinator or {}
        self._partition_polls_left = int(c.get("polls", 0))
        self._killed_worker = False
        self._killed_split = False
        self._stalled = False
        self.log: list = []  # (round, fault) audit trail for tests

    def kill_on_poll(self, worker_id: str, rnd: int) -> bool:
        """Worker-side, at each job poll: True -> the worker dies now."""
        c = self.config.kill_worker
        if (c is not None and not self._killed_worker
                and worker_id == c["worker"] and rnd >= int(c["in_round"])):
            self._killed_worker = True
            self.log.append((rnd, f"kill_worker:{worker_id}"))
            return True
        return False

    def kill_on_job(self, worker_id: str, rnd: int, split: int) -> bool:
        """Worker-side, after TAKING a job: True -> die holding it."""
        c = self.config.kill_split
        if (c is not None and not self._killed_split
                and rnd == int(c["round"]) and split == int(c["split"])):
            self._killed_split = True
            self.log.append((rnd, f"kill_split:{split}:{worker_id}"))
            return True
        return False

    def stall_on_job(self, worker_id: str, rnd: int,
                     split: int) -> Optional[float]:
        """Worker-side, after taking a job: seconds to go silent for
        (heartbeats suppressed by the silence itself), or None."""
        c = self.config.stall_heartbeat
        if (c is not None and not self._stalled
                and rnd == int(c["round"]) and split == int(c["split"])):
            self._stalled = True
            self.log.append((rnd, f"stall_heartbeat:{split}:{worker_id}"))
            return float(c.get("sleep_s", 1.0))
        return None

    def on_membership_poll(self, rnd: int) -> None:
        """Coordinator-side, before each membership poll."""
        c = self.config.partition_coordinator
        if (c is not None and rnd == int(c.get("at_round", -1))
                and self._partition_polls_left > 0):
            self._partition_polls_left -= 1
            self.log.append((rnd, "partition"))
            raise CoordinatorPartitioned(
                f"injected membership-plane partition at round {rnd} "
                f"({self._partition_polls_left} polls left)")


class ReplicaPartitioned(ConnectionError):
    """A chaos-injected router->replica partition: the router's HTTP call
    fails at connect time exactly as if the replica's port went away —
    the replica-breaker vote path, without any process actually dying."""


@dataclass
class RouterChaosConfig:
    """Declarative fleet-serving fault plan. Counts are 1-based over the
    router-side event they key on — PROXIED requests for kill_replica
    (deterministic under concurrency: the k-th request the router
    completes, whichever replica served it), per-replica CALL attempts
    for partition_replica.

      kill_replica      — {"replica": id, "after_proxied": k}: once the
                          router has completed k requests, replica `id`
                          is killed HARD (no drain, no goodbye — the
                          router's kill hook enacts it via
                          ServingFleet.kill_replica). Heartbeat expiry
                          and connect errors must between them detect
                          the death; every already-admitted /predict
                          must be answered by a survivor.
      partition_replica — {"replica": id, "calls": k}: the first k
                          router->replica calls addressed to `id` raise
                          :class:`ReplicaPartitioned` before any bytes
                          are sent; the breaker walks the replica to
                          ejection, then half-open probes re-admit it
                          once the partition heals (calls exhausted).
    """

    kill_replica: Optional[dict] = None
    partition_replica: Optional[dict] = None


class RouterChaos:
    """Stateful executor of a :class:`RouterChaosConfig`, consulted by
    the FleetRouter (per replica call and per completed proxy). The
    router never owns replica processes, so :meth:`kill_due` only
    RETURNS the victim id — the fleet's kill hook enacts it (the same
    decide-vs-enact split as FleetChaos.kill_on_poll). Deterministic:
    the same config against the same request sequence injects the same
    faults exactly once each."""

    def __init__(self, config: RouterChaosConfig):
        if isinstance(config, dict):
            config = RouterChaosConfig(**config)
        self.config = config
        c = config.partition_replica or {}
        self._partition_calls_left = int(c.get("calls", 0))
        self._killed = False
        self._proxied = 0
        self._lock = threading.Lock()
        self.log: list = []  # (count, fault) audit trail for tests

    def on_replica_call(self, replica_id: str) -> None:
        """Router-side, before each HTTP call to `replica_id`."""
        c = self.config.partition_replica
        if c is None or replica_id != c.get("replica"):
            return
        with self._lock:
            if self._partition_calls_left <= 0:
                return
            self._partition_calls_left -= 1
            left = self._partition_calls_left
            self.log.append((replica_id, "partition"))
        raise ReplicaPartitioned(
            f"injected router partition to {replica_id!r} "
            f"({left} calls left)")

    def kill_due(self) -> Optional[str]:
        """Router-side, after each COMPLETED proxy: the replica id to
        kill now, or None. Fires at most once."""
        c = self.config.kill_replica
        with self._lock:
            self._proxied += 1
            if (c is None or self._killed
                    or self._proxied < int(c.get("after_proxied", 1))):
                return None
            self._killed = True
            self.log.append((self._proxied, f"kill_replica:{c['replica']}"))
            return str(c["replica"])


@dataclass
class AutoscaleChaosConfig:
    """Declarative load-wave plan for the autoscaler's decision loop
    (serving/autoscale.py): overlay the SCRAPED /signals snapshot for a
    scripted tick window so scale decisions can be forced and replayed
    without generating real traffic. The chaos corrupts the DECISION
    INPUT only — the autoscaler still decides, and the fleet's
    spawn/depart hooks still enact (decide-vs-enact). Config-driven,
    never ambient.

      load_wave — {"at_tick": t, "ticks": n, "queue_depth": q[,
                  "sheds_per_tick": s]}: ticks t..t+n-1 (1-based) see
                  total queue depth q (and, optionally, s new router
                  sheds per tick) in place of the measured values;
                  outside the window the snapshot passes untouched.
    """

    load_wave: Optional[dict] = None

    def __post_init__(self):
        c = self.load_wave
        if c is None:
            return
        if int(c.get("ticks", 1)) < 1:
            raise ValueError("load_wave ticks must be >= 1")
        if "queue_depth" not in c:
            raise ValueError("load_wave needs queue_depth")


class AutoscaleChaos:
    """Stateful executor of an :class:`AutoscaleChaosConfig` (the
    LowPrecChaos shape): :meth:`on_signals` returns the snapshot to
    decide on — an overlaid COPY on wave ticks, the caller's dict
    untouched. Deterministic: the same config over the same tick
    sequence overlays the same values, so a replay of the recorded
    post-overlay signal log reproduces the decision list bit-exact."""

    def __init__(self, config: AutoscaleChaosConfig):
        if isinstance(config, dict):
            config = AutoscaleChaosConfig(**config)
        self.config = config
        self.log: list = []  # (tick, fault) audit trail for tests

    def on_signals(self, tick: int, signals: dict) -> dict:
        """``tick`` is the 1-based autoscaler tick about to decide."""
        c = self.config.load_wave
        if c is None:
            return signals
        at = int(c.get("at_tick", 1))
        if not (at <= tick < at + int(c.get("ticks", 1))):
            return signals
        out = dict(signals)
        out["queue_depth"] = int(c["queue_depth"])
        sheds = int(c.get("sheds_per_tick", 0))
        if sheds:
            # cumulative: the decision loop votes on per-tick DELTAS
            out["shed_total"] = (int(signals.get("shed_total", 0))
                                 + sheds * (tick - at + 1))
        self.log.append((tick, f"load_wave:q={out['queue_depth']}"))
        return out


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
