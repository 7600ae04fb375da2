"""FleetAutoscaler: signal-driven replica scaling over the serving fleet
(counterpart: ``deeplearning4j_tpu/serving/autoscale.py`` —
``ScaleConfig``, ``AutoscaleStats`` and ``FleetAutoscaler``).

A control loop scrapes the router's ``/signals`` snapshot each tick and
decides scale-up / scale-down / hold from the evidence — sustained queue
depth per ready replica, per-SLO-class p99 pressing its deadline, and the
shed-rate delta — then enacts through the fleet's lifecycle hooks
(``add_replica`` / ``depart_replica``: the drain + goodbye path), never
by reaching into replicas itself. ``resilience/chaos.AutoscaleChaos``
overlays the decision input; the decision layer between stays a pure
function.

Determinism: decisions are a pure function of the snapshot sequence.
Cooldowns and streak windows are counted in TICKS, not wall-clock; the
scale-down victim is the highest-rid ready replica; there is no RNG and
no clock read in :meth:`FleetAutoscaler.decide`. Feeding the recorded
``signals_log`` to a fresh instance through :meth:`FleetAutoscaler.replay`
reproduces the ``decisions`` list exactly.

Knobs (``ops/env.py``): ``DL4J_TPU_SERVE_SCALE_MIN`` / ``_MAX``,
``_UP_QUEUE``, ``_UP_P99_FRAC``, ``_UP_SHED`` (0 disables), ``_WINDOW``,
``_DOWN_QUEUE``, ``_COOLDOWN``.

Placement rides along: :meth:`FleetAutoscaler.plan_placement` runs the
``serving/placement.py`` pack over the live replica set and pushes the
plan to the router.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.serving.placement import (
    ModelFootprint,
    PlacementPlan,
    pack_models,
)


@dataclass(frozen=True)
class ScaleConfig:
    """The decision thresholds, frozen at autoscaler construction so a
    mid-run env flip can never fork a replay."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_queue: float = 8.0
    up_p99_frac: float = 0.8
    up_shed: int = 1
    window: int = 3
    down_queue: float = 0.0
    cooldown: int = 5

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")

    @classmethod
    def from_env(cls) -> "ScaleConfig":
        return cls(
            min_replicas=envknob.get_int("DL4J_TPU_SERVE_SCALE_MIN", 1),
            max_replicas=envknob.get_int("DL4J_TPU_SERVE_SCALE_MAX", 4),
            up_queue=envknob.get_float(
                "DL4J_TPU_SERVE_SCALE_UP_QUEUE", 8.0),
            up_p99_frac=envknob.get_float(
                "DL4J_TPU_SERVE_SCALE_UP_P99_FRAC", 0.8),
            up_shed=envknob.get_int("DL4J_TPU_SERVE_SCALE_UP_SHED", 1),
            window=envknob.get_int("DL4J_TPU_SERVE_SCALE_WINDOW", 3),
            down_queue=envknob.get_float(
                "DL4J_TPU_SERVE_SCALE_DOWN_QUEUE", 0.0),
            cooldown=envknob.get_int("DL4J_TPU_SERVE_SCALE_COOLDOWN", 5),
        )


class AutoscaleStats:
    """Counter ledger for the control loop, registered with the obs
    registry as ``autoscale_stats`` (the one export schema)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.holds = 0
        self.up_votes_queue = 0
        self.up_votes_p99 = 0
        self.up_votes_shed = 0
        self.down_votes = 0
        self.placements = 0
        self.enact_failures = 0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ticks": self.ticks,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "holds": self.holds,
                "up_votes_queue": self.up_votes_queue,
                "up_votes_p99": self.up_votes_p99,
                "up_votes_shed": self.up_votes_shed,
                "down_votes": self.down_votes,
                "placements": self.placements,
                "enact_failures": self.enact_failures,
            }

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)


class FleetAutoscaler:
    """See module docstring. ``fleet`` is a :class:`ServingFleet` (its
    router is the signal source and its add/depart hooks the enactment
    plane); pass ``fleet=None`` for a decide-only instance (what
    :meth:`replay` builds). Drive ticks manually (tests, bench) or via
    :meth:`start` (a daemon loop at ``interval_s``)."""

    def __init__(self, fleet=None, router=None, *,
                 config: Optional[ScaleConfig] = None,
                 chaos=None) -> None:
        self.fleet = fleet
        self.router = router if router is not None else (
            fleet.router if fleet is not None else None)
        self.config = config if config is not None else ScaleConfig.from_env()
        self.chaos = chaos
        self.stats = AutoscaleStats()
        obs_registry.default_registry().register_ledger(
            self, "autoscale_stats", self.stats)
        # decision state — ticks, streaks, cooldown, last shed counter.
        # All integers advanced only by decide(), so state after N
        # snapshots is a pure function of those snapshots.
        self._tick = 0
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._last_shed: Optional[int] = None
        # the replay record: post-chaos snapshots + the decisions made
        self.signals_log: List[Dict[str, Any]] = []
        self.decisions: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the pure decision layer -------------------------------------------
    def decide(self, snapshot: Dict[str, Any]) -> Dict[str, Any]:
        """One decision from one signals snapshot. PURE in the replay
        sense: no clock, no RNG, no I/O — only the snapshot and the
        tick-counted streak/cooldown state previous snapshots built."""
        cfg = self.config
        tick = self._tick
        self._tick += 1
        ready = list(snapshot.get("ready_replicas") or [])
        n_ready = len(ready)
        queue = float(snapshot.get("queue_depth") or 0)
        per_ready = queue / max(1, n_ready)
        shed_total = int(snapshot.get("shed_total") or 0)
        shed_delta = (0 if self._last_shed is None
                      else max(0, shed_total - self._last_shed))
        self._last_shed = shed_total

        votes: List[str] = []
        if per_ready >= cfg.up_queue:
            votes.append("queue")
            self.stats.bump("up_votes_queue")
        deadlines = {c["name"]: float(c["deadline_s"])
                     for c in snapshot.get("slo_classes") or []}
        for name in sorted(snapshot.get("per_class_latency_ms") or {}):
            lat = (snapshot.get("per_class_latency_ms") or {})[name]
            p99_ms = (lat or {}).get("p99")
            deadline = deadlines.get(name)
            if (p99_ms is not None and deadline
                    and p99_ms / 1000.0 >= cfg.up_p99_frac * deadline):
                votes.append("p99")
                self.stats.bump("up_votes_p99")
                break
        if cfg.up_shed > 0 and shed_delta >= cfg.up_shed:
            votes.append("shed")
            self.stats.bump("up_votes_shed")
        down_vote = (not votes and per_ready <= cfg.down_queue
                     and shed_delta == 0)
        if down_vote:
            self.stats.bump("down_votes")

        if votes:
            self._up_streak += 1
            self._down_streak = 0
        elif down_vote:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0

        action, reason, victim = "hold", "quiet", None
        if self._cooldown > 0:
            self._cooldown -= 1
            reason = "cooldown"
        elif self._up_streak >= cfg.window:
            self._up_streak = 0
            if n_ready < cfg.max_replicas:
                action, reason = "up", "+".join(votes)
                self._cooldown = cfg.cooldown
            else:
                # a bound hold still arms the cooldown: pinned at max,
                # re-litigating the same up verdict every tick is churn
                reason = "at_max"
                self._cooldown = cfg.cooldown
        elif self._down_streak >= cfg.window:
            self._down_streak = 0
            if n_ready > cfg.min_replicas:
                # victim = highest rid among ready (total order — the
                # deterministic twin of a chaos kill_replica verdict)
                action, reason, victim = "down", "idle", ready[-1]
                self._cooldown = cfg.cooldown
            else:
                reason = "at_min"
                self._cooldown = cfg.cooldown
        elif votes or down_vote:
            reason = "window"

        decision = {"tick": tick, "action": action, "reason": reason,
                    "votes": votes, "ready": n_ready,
                    "queue_per_ready": round(per_ready, 6),
                    "shed_delta": shed_delta}
        if victim is not None:
            decision["victim"] = victim
        self.stats.bump("ticks")
        if action == "hold":
            self.stats.bump("holds")
        return decision

    @classmethod
    def replay(cls, snapshots: Sequence[Dict[str, Any]], *,
               config: Optional[ScaleConfig] = None
               ) -> List[Dict[str, Any]]:
        """Re-run the decision layer over a recorded snapshot sequence
        (e.g. a prior run's ``signals_log``) with NO fleet attached.
        Same snapshots + same config => same decision list, bit-exact —
        the determinism contract tests/bench assert."""
        sim = cls(fleet=None, router=None,
                  config=config if config is not None else ScaleConfig())
        return [sim.decide(dict(s)) for s in snapshots]

    # -- the control loop ---------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """Scrape -> (chaos overlay) -> decide -> enact. Returns the
        decision (with an ``enacted`` field when a fleet hook ran)."""
        if self.router is None:
            raise ValueError("tick() needs a router to scrape "
                             "(decide-only instances use decide()/replay())")
        snapshot = self.router.signals()
        if self.chaos is not None:
            snapshot = self.chaos.on_signals(self._tick, snapshot)
        self.signals_log.append(snapshot)
        decision = self.decide(snapshot)
        if self.fleet is not None and decision["action"] != "hold":
            try:
                if decision["action"] == "up":
                    rid = self.fleet.add_replica()
                    decision["enacted"] = rid
                    self.stats.bump("scale_ups")
                    obs_journal.event("fleet.scale_up", tick=decision["tick"],
                                      replica=rid,
                                      reason=decision["reason"])
                else:
                    # cordon-then-drain: fence the victim out of NEW
                    # routing first so the drain's opening instants
                    # can't relay a 503 to a client the readiness poll
                    # hasn't caught up with yet
                    if self.router is not None:
                        self.router.cordon(decision["victim"])
                    self.fleet.depart_replica(decision["victim"])
                    decision["enacted"] = decision["victim"]
                    self.stats.bump("scale_downs")
                    obs_journal.event("fleet.scale_down",
                                      tick=decision["tick"],
                                      replica=decision["victim"],
                                      reason=decision["reason"])
            except Exception as e:  # noqa: BLE001 — enactment is I/O;
                # a failed enact is telemetry, never a crashed loop
                decision["enact_error"] = f"{type(e).__name__}: {e}"
                self.stats.bump("enact_failures")
        self.decisions.append(decision)
        return decision

    def start(self, interval_s: float = 1.0) -> "FleetAutoscaler":
        """Optional daemon loop (production shape); tests/bench drive
        :meth:`tick` directly for determinism."""
        if self._thread is not None:
            raise ValueError("autoscaler loop already started")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — a scrape hiccup
                    # (router restarting, transient socket) must not
                    # kill the loop; the next tick re-scrapes
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="fleet-autoscale")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- placement ----------------------------------------------------------
    def plan_placement(self, footprints: Sequence[ModelFootprint], *,
                       replica_ids: Optional[Sequence[str]] = None,
                       hbm_gb: Optional[float] = None,
                       copies: int = 1) -> PlacementPlan:
        """FFD-pack the given model footprints over the live replica set
        (or an explicit ``replica_ids``) and push the plan to the router
        (affinity routing + the /placement audit)."""
        if replica_ids is None:
            if self.fleet is None:
                raise ValueError("plan_placement needs replica_ids when "
                                 "no fleet is attached")
            replica_ids = sorted(self.fleet.engines())
        plan = pack_models(footprints, replica_ids, hbm_gb=hbm_gb,
                           copies=copies)
        if self.router is not None:
            self.router.set_placement(plan)
        self.stats.bump("placements")
        return plan
