"""FleetRouter: the health-routed HTTP front door over N serving
replicas (counterpart: ``deeplearning4j_tpu/serving/router.py`` — the
replica address files :134-173, ``RouterStats``, the errors :400-440 and
``FleetRouter`` with the predict walk and failover :760, the
prefill/decode handoff :811-964, ``rollout`` :965, ``signals`` :1083,
``cordon``, the placement filter, tenant quotas and the streaming
pass-through :1303). Host code over HTTP: the replicas are the port's
``ServingEngine``s (``serving/fleet.py``), in threads or OS processes.

Planes, and how they compose:

  membership   The router polls the ``FileMembershipBoard``
               (``parallel/fleet.py``): a replica joins by heartbeat file
               and a ``replica-<id>.addr`` JSON beside it; announced
               SIGTERM departure (drain + deregister) and heartbeat
               expiry both remove it. A board read failure is a
               PARTITION (the last-known membership kept and counted in
               ``membership_fallbacks``), never "fleet empty".
  readiness    Per replica the router probes ``/health?ready=1``: an
               ANSWERED 503 means alive but not ready (draining, every
               model broken) — no NEW traffic, no breaker vote; a
               connection-level failure means the process is gone.
  replica      A replica-level ``CircuitBreaker`` (``serving/
  breakers     resilience.py``) fed ONLY by the request path:
               consecutive connect/5xx failures eject the replica; after
               the cooldown one half-open probe request re-admits it.
  retry        /predict is idempotent: a replica that dies mid-request
               (no response bytes) has the request retried on a
               survivor, so admitted work is never lost. /generate
               retries ONLY while no bytes were exchanged.
  SLO shed     An in-flight cap with per-class headroom over the
               ``serving/slo.py`` classes: priority p of n classes is
               admitted while in-flight < ``cap * (n - p) / n``, so
               under overload the lowest class sheds (429 + Retry-After)
               while the highest keeps the full cap.
  rollout      Per replica load -> warmup -> serve, one replica at a
               time; any failure rolls the shifted replicas back to
               their recorded prior default and stops.
  tenant       Per-tenant token buckets (``serving/slo.TenantBucket``
  quotas       over ``DL4J_TPU_SERVE_TENANT_QUOTAS``) at the same
               admission gate, before the in-flight headroom: an empty
               bucket sheds 429 + Retry-After (seconds to one token).
  placement    A ``serving/placement.PlacementPlan`` (pushed by the
  affinity     autoscaler through :meth:`set_placement`): a request
               naming a placed model walks only the replicas that hold
               it; a placed model with no ready holder is a loud 503.

HTTP surface: POST /predict and /generate (proxied, the engine's wire
contract; streaming /generate chunks re-framed through), GET /health,
GET /metrics (JSON; Prometheus through the central registry), GET
/replicas (with each replica's device-memory report), GET /signals (the
autoscaler's input), GET /placement, POST /rollout.

Env knobs (``ops/env.py``): ``DL4J_TPU_SERVE_ROUTER_PORT`` (0 =
ephemeral), ``DL4J_TPU_SERVE_REPLICA_FAILS`` (0 disables replica
breakers), ``DL4J_TPU_SERVE_TENANT_QUOTAS``. Fault injection is
config-driven: ``resilience/chaos.RouterChaosConfig``.
"""

from __future__ import annotations

import http.client
import itertools
import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import urlsplit

import numpy as np

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.obs.exporter import PROMETHEUS_CONTENT_TYPE
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.serving.resilience import (
    BreakerOpenError,
    CircuitBreaker,
)
from deeplearning4j_tpu_torch.serving.slo import (
    TenantBucket,
    parse_slo_classes,
    parse_tenant_quotas,
)


def replica_fails_default() -> int:
    return int(envknob.get_int("DL4J_TPU_SERVE_REPLICA_FAILS", 3))


def router_port_default() -> int:
    return int(envknob.get_int("DL4J_TPU_SERVE_ROUTER_PORT", 0))


# ---------------------------------------------------------------------------
# Replica address files (the data half of the membership board: the
# heartbeat file proves liveness, the addr file says where to connect)
# ---------------------------------------------------------------------------


def _addr_path(root: str, replica_id: str) -> str:
    return os.path.join(root, f"replica-{replica_id}.addr")


def publish_replica_addr(root: str, replica_id: str, url: str,
                         role: str = "") -> None:
    """Atomic addr publish (tmp + os.replace — the board's own idiom): a
    router reading mid-write must see the old addr or the new one, never
    half a JSON. ``role`` is the prefill/decode disaggregation tag
    ('' serves both planes) — routing METADATA beside the
    addr, so the router learns the split from the same membership read."""
    path = _addr_path(root, replica_id)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"url": url, "pid": os.getpid(), "role": str(role)}, f)
    os.replace(tmp, path)


def read_replica_entry(root: str, replica_id: str) -> Optional[Dict[str, str]]:
    """The published addr record: {"url": ..., "role": ...}. Addr files
    written before the role field existed read as role '' (both planes)."""
    try:
        with open(_addr_path(root, replica_id), encoding="utf-8") as f:
            data = json.load(f)
        return {"url": str(data["url"]), "role": str(data.get("role", ""))}
    except (OSError, ValueError, KeyError):
        return None  # not published yet (join race) or mid-removal


def read_replica_addr(root: str, replica_id: str) -> Optional[str]:
    entry = read_replica_entry(root, replica_id)
    return entry["url"] if entry is not None else None


def remove_replica_addr(root: str, replica_id: str) -> None:
    try:
        os.remove(_addr_path(root, replica_id))
    except FileNotFoundError:
        pass


class RouterStats:
    """Thread-safe router counters + latency reservoir — the fleet-level
    ledger, registered in the central MetricsRegistry exactly like the
    engine's ``serving_stats`` (the reference route had no metrics at
    all; see serving/telemetry.py). Doubles as the replica breakers'
    stats sink: the breaker's ``record_breaker_*`` / ``record_fast_fail``
    hooks land in the fleet counters here."""

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._window = int(window)
        self.requests = 0            # requests admitted for proxying
        self.proxied_ok = 0          # answered 2xx by some replica
        self.retries = 0             # re-sends after a replica failure
        self.replica_failures = 0    # connect-level failures observed
        self.not_ready_skips = 0     # candidates skipped: not ready
        self.fleet_429 = 0           # fleet-wide overload sheds
        self.shed_by_class: Dict[str, int] = {}
        self.membership_fallbacks = 0  # board unreadable: kept last-known
        self.replicas_joined = 0
        self.replicas_left = 0
        self.rollouts = 0            # completed rolling rollouts
        self.rollbacks = 0           # rollouts auto-rolled back
        # prefill/decode disaggregation: /generate requests
        # whose prompt prefill ran on a prefill-role replica vs those
        # that fell back to the direct decode path (best-effort handoff)
        self.prefill_handoffs = 0
        self.prefill_fallbacks = 0
        # replica-breaker plane (CircuitBreaker stats hooks)
        self.breaker_opens = 0       # replicas ejected
        self.breaker_closes = 0      # half-open probes that re-admitted
        self.breaker_probes = 0
        self.fast_fails_503 = 0      # candidates skipped by open breaker
        # tenant-quota plane: admissions/sheds per metered
        # tenant — the fairness evidence (one tenant's 429 burst beside
        # another tenant's untouched admissions)
        self.tenant_admitted: Dict[str, int] = {}
        self.tenant_shed: Dict[str, int] = {}
        # placement-affinity plane: loud 503s for models with zero
        # ready holders (the never-silently-misroute contract)
        self.affinity_503 = 0
        # per-SLO-class latency rings: the autoscaler's p99-vs-deadline
        # pressure signal (the global ring cannot say WHICH class is
        # blowing its deadline)
        self._class_lat: Dict[str, List[float]] = {}

    # -- recording --------------------------------------------------------
    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_proxied(self, seconds: float) -> None:
        with self._lock:
            self.proxied_ok += 1
            self._lat.append(float(seconds))
            if len(self._lat) > self._window:
                del self._lat[:len(self._lat) - self._window]

    def record_class_latency(self, slo_class: str, seconds: float) -> None:
        with self._lock:
            ring = self._class_lat.setdefault(str(slo_class), [])
            ring.append(float(seconds))
            if len(ring) > self._window:
                del ring[:len(ring) - self._window]

    def record_tenant(self, tenant: str, admitted: bool) -> None:
        with self._lock:
            ledger = self.tenant_admitted if admitted else self.tenant_shed
            ledger[tenant] = ledger.get(tenant, 0) + 1

    def record_affinity_503(self) -> None:
        with self._lock:
            self.affinity_503 += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def record_replica_failure(self) -> None:
        with self._lock:
            self.replica_failures += 1

    def record_not_ready_skip(self) -> None:
        with self._lock:
            self.not_ready_skips += 1

    def record_shed(self, slo_class: str) -> None:
        with self._lock:
            self.fleet_429 += 1
            self.shed_by_class[slo_class] = \
                self.shed_by_class.get(slo_class, 0) + 1

    def record_membership_fallback(self) -> None:
        with self._lock:
            self.membership_fallbacks += 1

    def record_join(self) -> None:
        with self._lock:
            self.replicas_joined += 1

    def record_leave(self) -> None:
        with self._lock:
            self.replicas_left += 1

    def record_rollout(self, rolled_back: bool) -> None:
        with self._lock:
            if rolled_back:
                self.rollbacks += 1
            else:
                self.rollouts += 1

    def record_prefill_handoff(self) -> None:
        with self._lock:
            self.prefill_handoffs += 1

    def record_prefill_fallback(self) -> None:
        with self._lock:
            self.prefill_fallbacks += 1

    # -- CircuitBreaker stats-sink surface --------------------------------
    def record_breaker_open(self) -> None:
        with self._lock:
            self.breaker_opens += 1

    def record_breaker_close(self) -> None:
        with self._lock:
            self.breaker_closes += 1

    def record_breaker_probe(self) -> None:
        with self._lock:
            self.breaker_probes += 1

    def record_fast_fail(self) -> None:
        with self._lock:
            self.fast_fails_503 += 1

    # -- reading ----------------------------------------------------------
    def latency_ms(self) -> Dict[str, Optional[float]]:
        with self._lock:
            # graftlint: disable=host-sync-under-lock -- self._lat is a host-side list of floats; no device buffer ever enters this ring
            lat = np.asarray(self._lat, np.float64)
        if lat.size == 0:
            return {"p50": None, "p95": None, "p99": None, "count": 0}
        return {
            "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p95": round(float(np.percentile(lat, 95)) * 1e3, 3),
            "p99": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "count": int(lat.size),
        }

    def per_class_latency_ms(self) -> Dict[str, Dict[str, Optional[float]]]:
        """p50/p99 per SLO class — /signals' pressure input."""
        with self._lock:
            # graftlint: disable=host-sync-under-lock -- host-side float rings only; no device buffer ever enters them
            rings = {name: np.asarray(ring, np.float64)
                     for name, ring in self._class_lat.items()}
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name, lat in sorted(rings.items()):
            if lat.size == 0:
                out[name] = {"p50": None, "p99": None, "count": 0}
                continue
            out[name] = {
                "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p99": round(float(np.percentile(lat, 99)) * 1e3, 3),
                "count": int(lat.size),
            }
        return out

    def snapshot(self) -> Dict[str, Any]:
        lat = self.latency_ms()
        with self._lock:
            out = {
                "requests": self.requests,
                "proxied_ok": self.proxied_ok,
                "retries": self.retries,
                "replica_failures": self.replica_failures,
                "not_ready_skips": self.not_ready_skips,
                "fleet_429": self.fleet_429,
                "shed_by_class": dict(self.shed_by_class),
                "membership_fallbacks": self.membership_fallbacks,
                "replicas_joined": self.replicas_joined,
                "replicas_left": self.replicas_left,
                "rollouts": self.rollouts,
                "rollbacks": self.rollbacks,
                "prefill_handoffs": self.prefill_handoffs,
                "prefill_fallbacks": self.prefill_fallbacks,
                "breaker_opens": self.breaker_opens,
                "breaker_closes": self.breaker_closes,
                "breaker_probes": self.breaker_probes,
                "fast_fails_503": self.fast_fails_503,
                "tenant_admitted": dict(self.tenant_admitted),
                "tenant_shed": dict(self.tenant_shed),
                "affinity_503": self.affinity_503,
            }
        out["latency_ms"] = lat
        out["per_class_latency_ms"] = self.per_class_latency_ms()
        return out


class _Replica:
    """Router-side view of one replica: address, readiness verdict from
    the poll, and the replica-level breaker fed by the request path."""

    def __init__(self, rid: str, url: str, breaker: CircuitBreaker,
                 role: str = ""):
        self.rid = rid
        self.url = url
        self.breaker = breaker
        self.role = str(role)  # '' both planes | 'prefill' | 'decode'
        self.ready = True  # optimistic until the first probe says no
        # cordoned: routing-fenced ahead of an announced departure
        # (scale-down) so new traffic never races the drain's first
        # instants — the readiness poll would take up to poll_s to
        # notice the 503-when-draining flip, and a relayed 503 in that
        # window would be a failed admitted request. A NEW incarnation
        # (re-published addr) re-joins as a fresh _Replica, uncordoned.
        self.cordoned = False

    def describe(self) -> Dict[str, Any]:
        return {"url": self.url, "ready": self.ready, "role": self.role,
                "cordoned": self.cordoned,
                "breaker": self.breaker.snapshot()}


class FleetRouterError(RuntimeError):
    """No routable replica could answer: every candidate was not-ready,
    ejected, or failed. The HTTP layer answers 503 + Retry-After."""

    retry_after_s = 1.0


class FleetOverloadError(RuntimeError):
    """Fleet-wide SLO shed: the in-flight cap left no headroom for this
    request's class. 429 + Retry-After."""

    retry_after_s = 1.0


class TenantQuotaError(FleetOverloadError):
    """A metered tenant's token bucket is empty: shed THIS tenant with
    429 + Retry-After (seconds until one token refills) while every
    other tenant's admission proceeds untouched."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ModelUnplacedError(FleetRouterError):
    """The placement plan knows this model but zero READY replicas hold
    it (or it fit on no replica at all): a loud 503 naming the model —
    never a silent wrong-replica 500."""


class _PassThrough(Exception):
    """A replica answered with a status the router must relay verbatim
    (4xx client errors, 504 deadline spent, or the last 5xx once every
    survivor was tried)."""

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        super().__init__(f"replica answered {status}")
        self.status = int(status)
        self.headers = dict(headers)
        self.body = body


class FleetRouter:
    """See module docstring. ``replicas`` pins a static table
    ({id: url}) for board-less tests; ``fleet_dir`` points at a
    FileMembershipBoard directory and makes membership dynamic. The
    optional ``chaos`` is a resilience/chaos.RouterChaos — its
    kill-replica decision is enacted through ``on_kill`` (the fleet's
    hook), never by the router itself."""

    # response headers the proxy relays (hop-by-hop framing headers are
    # the router's own business)
    _RELAY_HEADERS = ("Content-Type", "Retry-After")

    def __init__(self, *, replicas: Optional[Dict[str, str]] = None,
                 fleet_dir: Optional[str] = None,
                 board=None,
                 port: Optional[int] = None,
                 replica_fails: Optional[int] = None,
                 breaker_cooldown_s: float = 1.0,
                 poll_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 request_timeout_s: Optional[float] = None,
                 queue_cap: Optional[int] = None,
                 slo_classes: Optional[str] = None,
                 tenant_quotas: Optional[str] = None,
                 tenant_now_fn: Optional[Callable[[], float]] = None,
                 chaos=None,
                 on_kill: Optional[Callable[[str], None]] = None) -> None:
        self.replica_fails = int(replica_fails if replica_fails is not None
                                 else replica_fails_default())
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.poll_s = float(poll_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else envknob.get_float("DL4J_TPU_SERVE_TIMEOUT_S", 60))
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else envknob.get_int(
                                 "DL4J_TPU_SERVE_QUEUE_CAP", 512))
        self.slo_classes = parse_slo_classes(
            slo_classes if slo_classes is not None
            else envknob.raw("DL4J_TPU_SERVE_SLO_CLASSES"))
        # per-tenant token buckets: built once at router
        # construction from the spec; tenant_now_fn injects a test clock
        # (deterministic fairness verdicts — the TenantBucket contract)
        quota_spec = (tenant_quotas if tenant_quotas is not None
                      else envknob.raw("DL4J_TPU_SERVE_TENANT_QUOTAS"))
        bucket_kw = ({"now_fn": tenant_now_fn}
                     if tenant_now_fn is not None else {})
        self.tenant_buckets: Dict[str, TenantBucket] = {
            q.name: TenantBucket(q, **bucket_kw)
            for q in parse_tenant_quotas(quota_spec)}
        # placement plan (serving/placement.py), pushed by the
        # autoscaler; None = every model everywhere (pre-placement
        # routing, byte-unchanged)
        self._placement = None
        self.chaos = chaos
        self.on_kill = on_kill
        self.stats = RouterStats()
        obs_registry.default_registry().register_ledger(
            self, "router_stats", self.stats)
        self.fleet_dir = fleet_dir
        if board is None and fleet_dir is not None:
            from deeplearning4j_tpu_torch.parallel.fleet import FileMembershipBoard

            board = FileMembershipBoard(fleet_dir)
        self.board = board
        if board is not None and fleet_dir is None:
            self.fleet_dir = board.root
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._rr = itertools.count()
        self._inflight = 0
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        for rid, url in sorted((replicas or {}).items()):
            # a static entry is a url string, or {"url":..., "role":...}
            # for role-tagged board-less tests
            if isinstance(url, dict):
                self._add_replica(rid, url["url"],
                                  role=url.get("role", ""))
            else:
                self._add_replica(rid, url)
        router_port = int(port if port is not None else router_port_default())
        self._httpd = ThreadingHTTPServer(("127.0.0.1", router_port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- membership + readiness (poll thread) -----------------------------
    def _add_replica(self, rid: str, url: str, role: str = "") -> None:
        def on_transition(old, new, reason, _rid=rid):
            obs_journal.event("fleet.replica_health", replica=_rid,
                              old=old, new=new, reason=reason)

        breaker = CircuitBreaker(
            fails=self.replica_fails, cooldown_s=self.breaker_cooldown_s,
            key=f"replica:{rid}", stats=self.stats,
            on_transition=on_transition)
        with self._lock:
            self._replicas[rid] = _Replica(rid, url, breaker, role=role)
        self.stats.record_join()
        obs_journal.event("fleet.replica_join", replica=rid, url=url,
                          role=role)

    def _remove_replica(self, rid: str) -> None:
        with self._lock:
            gone = self._replicas.pop(rid, None)
        if gone is not None:
            self.stats.record_leave()
            obs_journal.event("fleet.replica_leave", replica=rid)

    def refresh(self) -> None:
        """One membership + readiness pass (the poll thread's body; tests
        call it directly for a deterministic table)."""
        if self.board is not None:
            try:
                live = set(self.board.live_workers())
            except ConnectionError:
                # board unreadable: a shared-mount blip is a PARTITION —
                # keep routing over last-known membership (the request
                # path's breakers still catch truly dead replicas)
                self.stats.record_membership_fallback()
                live = None
            if live is not None:
                with self._lock:
                    known = set(self._replicas)
                for rid in sorted(live - known):
                    entry = read_replica_entry(self.fleet_dir, rid)
                    if entry is not None:  # addr lags the heartbeat briefly
                        self._add_replica(rid, entry["url"],
                                          role=entry["role"])
                for rid in sorted(known - live):
                    self._remove_replica(rid)
                # a restarted replica re-publishes its addr (new port)
                # BEFORE the corpse's heartbeat ever expired: that's a
                # NEW incarnation, and the old breaker's verdict belongs
                # to the dead process — re-join FRESH so the restart is
                # routable as soon as it probes ready, instead of
                # waiting broken for request traffic to half-open it
                for rid in sorted(live & known):
                    entry = read_replica_entry(self.fleet_dir, rid)
                    if entry is None:
                        continue
                    with self._lock:
                        rep = self._replicas.get(rid)
                        changed = rep is not None and rep.url != entry["url"]
                    if changed:
                        self._remove_replica(rid)
                        self._add_replica(rid, entry["url"],
                                          role=entry["role"])
        for rep in self._snapshot():
            self._probe_ready(rep)

    def _probe_ready(self, rep: _Replica) -> None:
        """Readiness probe: sets ``ready`` ONLY — never a breaker vote.
        An answered 503 is a draining/broken replica (alive); a connect
        failure leaves readiness False and lets the board expiry / the
        request path's breaker handle death (a health blip alone must
        not eject)."""
        try:
            status, _, _ = _http_call(rep.url, "GET", "/health?ready=1",
                                      timeout=self.probe_timeout_s)
        except OSError:
            rep.ready = False
            return
        rep.ready = status == 200

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.refresh()

    def _snapshot(self) -> List[_Replica]:
        with self._lock:
            return [self._replicas[rid] for rid in sorted(self._replicas)]

    # -- SLO admission -----------------------------------------------------
    def _class_of(self, payload) -> tuple:
        """(name, priority) of the request's SLO class. Unlabeled
        requests and unknown names ride the LOWEST class: under overload
        the router sheds what it cannot rank."""
        n = len(self.slo_classes)
        if n == 0:
            return "default", 0
        name = payload.get("slo") if isinstance(payload, dict) else None
        for c in self.slo_classes:
            if c.name == name:
                return c.name, c.priority
        return (name if isinstance(name, str)
                else self.slo_classes[-1].name), n - 1

    def _admit(self, payload) -> str:
        """Fleet-wide SLO shed: class priority p of n gets the in-flight
        headroom ``cap * (n - p) / n`` — the highest class keeps the full
        cap while lower classes shed progressively earlier. Returns the
        class name; the caller MUST pair with :meth:`_release`.

        Tenant quotas gate FIRST: a metered tenant with an
        empty bucket is shed before it can consume in-flight headroom,
        so its burst never displaces another tenant's admission. The
        shed carries the bucket's own refill time as Retry-After."""
        tenant = (payload.get("tenant") if isinstance(payload, dict)
                  else None)
        bucket = (self.tenant_buckets.get(tenant)
                  if isinstance(tenant, str) else None)
        if bucket is not None:
            ok, retry_s = bucket.try_take()
            self.stats.record_tenant(tenant, ok)
            if not ok:
                raise TenantQuotaError(
                    f"tenant {tenant!r} quota exhausted "
                    f"({bucket.quota.rate_per_s}/s, burst "
                    f"{bucket.quota.burst})", retry_after_s=retry_s)
        name, priority = self._class_of(payload)
        n = max(1, len(self.slo_classes))
        cap = max(1, math.ceil(self.queue_cap * (n - priority) / n))
        with self._lock:
            if self._inflight >= cap:
                shed = True
            else:
                shed = False
                self._inflight += 1
        if shed:
            self.stats.record_shed(name)
            raise FleetOverloadError(
                f"fleet overload: class {name!r} shed at in-flight cap "
                f"{cap} (queue_cap {self.queue_cap})")
        self.stats.record_request()
        return name

    def _release(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- routing -----------------------------------------------------------
    def _candidates(self, decode_only: bool = False,
                    model: Optional[str] = None) -> List[_Replica]:
        reps = self._snapshot()
        plan = self._placement
        if plan is not None and isinstance(model, str) and model \
                and model in plan.models():
            # model-affinity routing: a PLACED model only
            # walks the replicas that hold it; zero ready holders (or
            # unplaced — it fit nowhere) is a LOUD 503 naming the
            # model, never a silent wrong-replica answer. Models the
            # plan does not know keep the fleet-wide walk.
            holders = set(plan.replicas_of(model))
            reps = [r for r in reps if r.rid in holders]
            if not any(r.ready for r in reps):
                self.stats.record_affinity_503()
                where = (f"holders {sorted(holders)} not ready" if holders
                         else "UNPLACED — fits no replica's HBM budget")
                raise ModelUnplacedError(
                    f"model {model!r} is placed on zero ready replicas "
                    f"({where})")
        if decode_only:
            # role-aware /generate dispatch: a prefill-role
            # replica exists to run /prefill, not to hold decode lanes —
            # route decode traffic away from it. Availability beats the
            # split: when ONLY prefill replicas survive they still
            # answer /generate (the role declares intent, the engine
            # serves everything).
            decode = [r for r in reps if r.role != "prefill"]
            if decode:
                reps = decode
        ready = []
        for rep in reps:
            if rep.ready and not rep.cordoned:
                ready.append(rep)
            else:
                self.stats.record_not_ready_skip()
        if not ready:
            return []
        start = next(self._rr) % len(ready)
        return ready[start:] + ready[:start]

    def _after_proxy(self) -> None:
        """Chaos hook: after each completed proxy ask the configured
        RouterChaos whether a replica dies NOW; the fleet's on_kill
        enacts it (the router never owns replica processes)."""
        if self.chaos is None:
            return
        victim = self.chaos.kill_due()
        if victim is not None and self.on_kill is not None:
            self.on_kill(victim)

    def _proxy_once(self, rep: _Replica, method: str, path: str,
                    body: bytes) -> tuple:
        if self.chaos is not None:
            self.chaos.on_replica_call(rep.rid)
        return _http_call(rep.url, method, path, body=body,
                          timeout=self.request_timeout_s)

    def proxy_predict(self, body: bytes) -> tuple:
        """Route one idempotent /predict across the fleet: walk ready
        candidates round-robin; a connect failure or 5xx votes the
        replica's breaker and RETRIES on the next survivor (429/503
        retried without a vote — backpressure and drain are not
        death); 4xx/504 relay immediately. Returns (status, headers,
        body) of the winning response; raises FleetRouterError when no
        candidate answered."""
        payload = _parse_json(body)
        cls = self._admit(payload)
        start = time.monotonic()
        try:
            with obs_trace.span("fleet.route", kind="predict"):
                result = self._walk_predict(body, payload.get("model"))
            if result[0] < 400:
                self.stats.record_class_latency(
                    cls, time.monotonic() - start)
            return result
        finally:
            self._release()
            self._after_proxy()

    def _walk_predict(self, body: bytes,
                      model: Optional[str] = None) -> tuple:
        last_response: Optional[tuple] = None
        tried = 0
        for rep in self._candidates(model=model):
            try:
                rep.breaker.check()
            except BreakerOpenError:
                continue  # ejected; fast_fails_503 counted by the breaker
            if tried:
                self.stats.record_retry()
            tried += 1
            try:
                status, headers, data = self._proxy_once(
                    rep, "POST", "/predict", body)
            except OSError as e:
                # connection-level failure: the replica (or the path to
                # it) is gone mid-request — vote and retry the admitted
                # work on a survivor; nothing was lost
                self.stats.record_replica_failure()
                rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                continue
            if status < 400:
                rep.breaker.record_success()
                return status, headers, data
            if status in (429, 503):
                # honest backpressure/drain from a live replica: not a
                # health vote (the probe, if this was one, stays
                # unresolved and its TTL re-grants), but another replica
                # may still have room — keep walking
                last_response = (status, headers, data)
                continue
            if status == 504:
                # the request's OWN deadline expired at the replica:
                # retrying would double-spend a budget that is already
                # gone, and a timeout is deadline evidence, not death
                return status, headers, data
            if status >= 500:
                rep.breaker.record_failure(f"HTTP {status}")
                last_response = (status, headers, data)
                continue
            # 4xx: the request itself is the problem — relay verbatim;
            # the replica ANSWERED, which resolves a granted probe
            rep.breaker.record_success()
            return status, headers, data
        if last_response is not None:
            return last_response
        raise FleetRouterError("no routable replica (all not-ready, "
                               "ejected, or failed)")

    # -- prefill/decode disaggregation --------------------------
    def _prefill_payload(self, body: bytes) -> Optional[bytes]:
        """When a prefill-role replica is routable, run the prompt
        prefill THERE (/prefill) and return the /prime payload the
        chosen decode replica adopts before /generate. Best-effort BY
        CONSTRUCTION: every failure path returns None and the decode
        replica recomputes the same bytes itself — the handoff changes
        where the prefill dispatch runs, never what the client reads
        (byte-identical either way, tests/test_serving_mesh.py)."""
        payload = _parse_json(body)
        toks = payload.get("tokens")
        if not toks:
            return None
        pre_all = [rep for rep in self._snapshot()
                   if rep.role == "prefill"]
        if not pre_all:
            return None  # no prefill plane deployed: not a fallback
        # a DEPLOYED prefill plane with no ready member IS a fallback —
        # the loop below is empty and falls through to the counter
        pre = [rep for rep in pre_all if rep.ready]
        req = json.dumps({
            "model": payload.get("model"),
            "version": payload.get("version"),
            "tokens": toks,
            "n_new": int(payload.get("n_new", 16)),
        }).encode()
        for rep in pre:
            try:
                rep.breaker.check()
            except BreakerOpenError:
                continue
            try:
                status, _, data = self._proxy_once(rep, "POST",
                                                   "/prefill", req)
            except OSError as e:
                self.stats.record_replica_failure()
                rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                continue
            if status != 200:
                if status >= 500:
                    rep.breaker.record_failure(f"HTTP {status}")
                break  # an answered refusal: fall back to direct decode
            rep.breaker.record_success()
            out = _parse_json(data)
            if not out.get("digests"):
                # prompt shorter than one full block: nothing to hand
                # off — the direct path IS the whole computation
                return None
            self.stats.record_prefill_handoff()
            return json.dumps({
                "model": payload.get("model"),
                "version": payload.get("version"),
                "digests": out["digests"],
                "k": out["k"], "v": out["v"],
                "shape": out["shape"], "dtype": out["dtype"],
            }).encode()
        self.stats.record_prefill_fallback()
        return None

    def _prime_replica(self, rep: _Replica, prime: Optional[bytes]) -> None:
        """Best-effort /prime of the chosen decode replica with the
        handed-off blocks. NO breaker vote and failures are swallowed:
        the /generate that follows is both the real health evidence and
        the correctness fallback (a missed adoption only costs the
        recompute)."""
        if prime is None:
            return
        try:
            _http_call(rep.url, "POST", "/prime", body=prime,
                       timeout=self.request_timeout_s)
        except OSError:
            pass

    def proxy_generate(self, body: bytes) -> tuple:
        """Route one /generate: same candidate walk, but retry ONLY on a
        connect-phase failure (no bytes exchanged — sampling must never
        run twice for one request). Streaming requests are answered
        non-streamed by this method's caller contract; the HTTP layer
        uses :meth:`proxy_generate_stream` for ``"stream": true``."""
        payload = _parse_json(body)
        cls = self._admit(payload)
        start = time.monotonic()
        try:
            with obs_trace.span("fleet.route", kind="generate"):
                result = self._walk_generate(body, payload.get("model"))
            if result[0] < 400:
                self.stats.record_class_latency(
                    cls, time.monotonic() - start)
            return result
        finally:
            self._release()
            self._after_proxy()

    def _walk_generate(self, body: bytes,
                       model: Optional[str] = None) -> tuple:
        last_response: Optional[tuple] = None
        prime = self._prefill_payload(body)
        for rep in self._candidates(decode_only=True, model=model):
            try:
                rep.breaker.check()
            except BreakerOpenError:
                continue
            if self.chaos is not None:
                try:
                    self.chaos.on_replica_call(rep.rid)
                except ConnectionError as e:
                    self.stats.record_replica_failure()
                    rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                    continue
            self._prime_replica(rep, prime)
            u = urlsplit(rep.url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=self.request_timeout_s)
            try:
                try:
                    conn.connect()
                except OSError as e:
                    # connect phase: nothing sent — safe to try a survivor
                    self.stats.record_replica_failure()
                    rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                    continue
                # bytes are about to flow: from here the request is
                # committed to THIS replica (no retry — the sample may
                # already be burning seed state)
                conn.request("POST", "/generate", body=body, headers={
                    "Content-Type": "application/json",
                    "Content-Length": str(len(body))})
                resp = conn.getresponse()
                data = resp.read()
                status = int(resp.status)
                headers = {k: v for k, v in resp.getheaders()
                           if k in self._RELAY_HEADERS}
            finally:
                conn.close()
            if status < 400:
                rep.breaker.record_success()
                return status, headers, data
            if status in (429, 503):
                last_response = (status, headers, data)
                continue
            if status == 504:
                return status, headers, data  # deadline, not death
            if status >= 500:
                # committed to this replica (bytes flowed): relay the
                # failure rather than re-running a stateful sample
                rep.breaker.record_failure(f"HTTP {status}")
                return status, headers, data
            rep.breaker.record_success()
            return status, headers, data
        if last_response is not None:
            return last_response
        raise FleetRouterError("no routable replica (all not-ready, "
                               "ejected, or failed)")

    # -- rolling rollout ---------------------------------------------------
    def rollout(self, name: str, path: str, *,
                input_shape=None, max_batch: Optional[int] = None,
                gen_tokens: int = 0) -> Dict[str, Any]:
        """Rolling model rollout across the fleet, one replica at a time:
        load -> warmup (the bucket ladder runs BEFORE traffic — the
        registry's warmup contract) -> serve, in replica order. Any
        load/warmup/serve failure stops the roll and AUTO-ROLLS BACK the
        replicas already shifted (re-serving their recorded prior
        default); the failing replica's own default never moved — the
        registry's load/warmup isolation, now fleet-scoped. Returns a
        report dict; ``ok`` is False on rollback."""
        reps = self._snapshot()
        if not reps:
            raise FleetRouterError("rollout with no replicas")
        shifted: List[tuple] = []  # (rep, prior_name, prior_version)
        report: Dict[str, Any] = {"ok": True, "model": name,
                                  "replicas": [], "rolled_back": []}
        for rep in reps:
            prior = self._serving_default(rep)
            err = self._roll_one(rep, name, path, input_shape,
                                 max_batch, gen_tokens)
            if err is None:
                shifted.append((rep, prior))
                report["replicas"].append(rep.rid)
                obs_journal.event("fleet.rollout_step", replica=rep.rid,
                                  model=name)
                continue
            # failed mid-roll: the failing replica's default is intact
            # (registry isolation); un-shift everyone already moved
            for done_rep, done_prior in shifted:
                if done_prior is not None:
                    self._serve_version(done_rep, *done_prior)
                    report["rolled_back"].append(done_rep.rid)
            report.update(ok=False, failed_replica=rep.rid, error=err)
            self.stats.record_rollout(rolled_back=True)
            obs_journal.event("fleet.rollout_rollback", replica=rep.rid,
                              model=name, error=err)
            return report
        self.stats.record_rollout(rolled_back=False)
        obs_journal.event("fleet.rollout_complete", model=name,
                          replicas=len(reps))
        return report

    def _roll_one(self, rep: _Replica, name, path, input_shape,
                  max_batch, gen_tokens) -> Optional[str]:
        """load+warmup+serve on one replica via its public /models API.
        Returns an error string (first failing step) or None."""
        steps = [
            {"action": "load", "name": name, "path": path,
             "input_shape": input_shape},
            {"action": "warmup", "name": name,
             **({"max_batch": int(max_batch)} if max_batch else {}),
             "gen_tokens": int(gen_tokens)},
            {"action": "serve", "name": name},
        ]
        for step in steps:
            try:
                status, _, data = _http_call(
                    rep.url, "POST", "/models",
                    body=json.dumps(step).encode(),
                    timeout=max(self.request_timeout_s, 60.0))
            except OSError as e:
                return f"{step['action']}: {type(e).__name__}: {e}"
            if status != 200:
                return (f"{step['action']}: HTTP {status}: "
                        f"{data[:200].decode(errors='replace')}")
        return None

    def _serving_default(self, rep: _Replica) -> Optional[tuple]:
        """(name, version) currently served by default on a replica, read
        through its public /models listing."""
        try:
            status, _, data = _http_call(rep.url, "GET", "/models",
                                         timeout=self.probe_timeout_s)
        except OSError:
            return None
        if status != 200:
            return None
        key = json.loads(data).get("default")
        if not key or "@v" not in key:
            return None
        name, _, version = key.rpartition("@v")
        try:
            return name, int(version)
        except ValueError:
            return None

    def _serve_version(self, rep: _Replica, name: str, version: int) -> None:
        try:
            _http_call(rep.url, "POST", "/models",
                       body=json.dumps({"action": "serve", "name": name,
                                        "version": version}).encode(),
                       timeout=self.probe_timeout_s)
        except OSError:
            pass  # the replica died mid-rollback; membership will notice

    # -- introspection -----------------------------------------------------
    def describe_replicas(self, hbm: bool = False) -> Dict[str, Any]:
        """Per-replica table. ``hbm=True`` (the GET /replicas shape)
        also scrapes each READY replica's device-memory accounting
        (``engine.hbm_report`` — params + KV arena + index arenas); kept
        off the health() path, which must stay scrape-free."""
        out = {rep.rid: rep.describe() for rep in self._snapshot()}
        if hbm:
            for rep in self._snapshot():
                if not rep.ready:
                    continue
                try:
                    status, _, data = _http_call(
                        rep.url, "GET", "/metrics",
                        timeout=self.probe_timeout_s)
                except OSError:
                    continue  # readiness/board will notice; not a vote
                if status == 200:
                    out[rep.rid]["hbm"] = json.loads(data).get("hbm")
        return out

    def signals(self) -> Dict[str, Any]:
        """The autoscaler's one-endpoint decision input (GET /signals):
        per-replica queue depth (scraped from each ready engine's
        serving_stats) + ready/role/breaker state, the router's
        in-flight count, per-class p99 beside each class's deadline,
        and the shed + tenant ledgers. Scrape failures leave a
        replica's queue_depth None — visible, never a breaker vote."""
        replicas: Dict[str, Any] = {}
        queue_total = 0
        for rep in self._snapshot():
            entry = {"ready": rep.ready, "role": rep.role,
                     "cordoned": rep.cordoned,
                     "breaker": rep.breaker.snapshot()["state"],
                     "queue_depth": None}
            if rep.ready:
                try:
                    status, _, data = _http_call(
                        rep.url, "GET", "/metrics",
                        timeout=self.probe_timeout_s)
                    if status == 200:
                        serving = json.loads(data).get("serving", {})
                        entry["queue_depth"] = int(
                            serving.get("queue_depth", 0))
                        queue_total += entry["queue_depth"]
                except (OSError, ValueError):
                    pass
            replicas[rep.rid] = entry
        snap = self.stats.snapshot()
        with self._lock:
            inflight = self._inflight
        return {
            "replicas": replicas,
            "ready_replicas": sorted(
                rid for rid, e in replicas.items() if e["ready"]),
            "queue_depth": queue_total,
            "inflight": inflight,
            "shed_total": snap["fleet_429"],
            "shed_by_class": snap["shed_by_class"],
            "per_class_latency_ms": snap["per_class_latency_ms"],
            "slo_classes": [{"name": c.name, "deadline_s": c.deadline_s}
                            for c in self.slo_classes],
            "tenant_admitted": snap["tenant_admitted"],
            "tenant_shed": snap["tenant_shed"],
            "affinity_503": snap["affinity_503"],
        }

    def cordon(self, rid: str) -> None:
        """Fence a replica out of routing NOW — the step before an
        announced departure (the autoscaler's scale-down enactment).
        Admitted/in-flight work on the replica is untouched (the drain
        answers it); only NEW routing skips it. Unknown rids are a
        no-op (the replica may already have left)."""
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is not None:
            rep.cordoned = True
            obs_journal.event("fleet.cordon", replica=rid)

    # -- placement (serving/placement.py, pushed by the autoscaler) --------
    def set_placement(self, plan) -> None:
        """Adopt a PlacementPlan: from now on requests naming a placed
        model only walk its holders (None clears back to fleet-wide
        routing). Journaled — the placement timeline is part of the
        fleet's flight-recorder story."""
        self._placement = plan
        if plan is not None:
            obs_journal.event("fleet.placement",
                              models=len(plan.models()),
                              unplaced=len(plan.unplaced))

    def placement_report(self) -> Dict[str, Any]:
        plan = self._placement
        if plan is None:
            return {"placement": None}
        return {"placement": plan.describe()}

    def health(self) -> tuple:
        """(http_code, body): 200 iff at least one replica is routable
        (ready + breaker not open) — the fleet-level twin of the
        engine's honest /health."""
        desc = self.describe_replicas()
        routable = [rid for rid, d in desc.items()
                    if d["ready"] and d["breaker"]["state"] != "broken"]
        body = {"ok": bool(routable), "routable": routable,
                "replicas": desc}
        return (200 if routable else 503), body

    def metrics(self) -> Dict[str, Any]:
        return {"router": self.stats.snapshot(),
                "replicas": self.describe_replicas()}

    # -- HTTP --------------------------------------------------------------
    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_raw(self, code: int, headers: Dict[str, str],
                          body: bytes):
                self.send_response(code)
                ct = headers.get("Content-Type", "application/json")
                self.send_header("Content-Type", ct)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    if k in ("Content-Type",):
                        continue
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/health":
                    code, body = router.health()
                    self._send(code, body)
                elif path == "/replicas":
                    self._send(200, router.describe_replicas(hbm=True))
                elif path == "/signals":
                    self._send(200, router.signals())
                elif path == "/placement":
                    self._send(200, router.placement_report())
                elif path == "/metrics":
                    accept = self.headers.get("Accept", "")
                    if ("format=prometheus" in self.path
                            or "text/plain" in accept
                            or "openmetrics" in accept):
                        body = (obs_registry.default_registry()
                                .render_prometheus().encode())
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         PROMETHEUS_CONTENT_TYPE)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._send(200, router.metrics())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                start = time.monotonic()
                try:
                    if self.path == "/predict":
                        body = self._read_body()
                        status, headers, data = router.proxy_predict(body)
                    elif self.path == "/generate":
                        body = self._read_body()
                        if _parse_json(body).get("stream"):
                            self._stream_generate(body)
                            return
                        status, headers, data = router.proxy_generate(body)
                    elif self.path == "/rollout":
                        payload = json.loads(self._read_body())
                        report = router.rollout(
                            payload["name"], payload["path"],
                            input_shape=payload.get("input_shape"),
                            max_batch=payload.get("max_batch"),
                            gen_tokens=int(payload.get("gen_tokens", 0)))
                        self._send(200 if report["ok"] else 409, report)
                        return
                    else:
                        self._send(404, {"error": "not found"})
                        return
                except FleetOverloadError as e:
                    # RFC 9110 delta-seconds is an integer: round the
                    # bucket's fractional refill time UP to 1
                    self._send(429, {"error": f"{e}"},
                               headers={"Retry-After": str(max(
                                   1, math.ceil(e.retry_after_s)))})
                    return
                except FleetRouterError as e:
                    self._send(503, {"error": f"{e}"},
                               headers={"Retry-After": str(max(
                                   1, math.ceil(e.retry_after_s)))})
                    return
                except Exception as e:  # noqa: BLE001 — serving boundary
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if status < 400:
                    router.stats.record_proxied(time.monotonic() - start)
                self._send_raw(status, headers, data)

            def _stream_generate(self, body: bytes):
                """Streamed /generate: committed to ONE replica once the
                response begins; chunks re-framed through verbatim."""
                payload = _parse_json(body)
                try:
                    cls = router._admit(payload)
                except FleetOverloadError as e:
                    self._send(429, {"error": f"{e}"},
                               headers={"Retry-After": str(max(
                                   1, math.ceil(e.retry_after_s)))})
                    return
                try:
                    router._stream_through(self, body, slo_class=cls,
                                           model=payload.get("model"))
                finally:
                    router._release()
                    router._after_proxy()

        return Handler

    def _stream_through(self, handler, body: bytes,
                        slo_class: Optional[str] = None,
                        model: Optional[str] = None) -> None:
        """Proxy a streaming /generate to the first replica that ACCEPTS
        it (connect + response headers); after that the stream is
        committed (a half-relayed token stream cannot be replayed)."""
        prime = self._prefill_payload(body)
        try:
            candidates = self._candidates(decode_only=True, model=model)
        except FleetRouterError as e:
            handler._send(503, {"error": f"{e}"},
                          headers={"Retry-After": "1"})
            return
        for rep in candidates:
            try:
                rep.breaker.check()
            except BreakerOpenError:
                continue
            if self.chaos is not None:
                try:
                    self.chaos.on_replica_call(rep.rid)
                except ConnectionError as e:
                    self.stats.record_replica_failure()
                    rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                    continue
            self._prime_replica(rep, prime)
            u = urlsplit(rep.url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=self.request_timeout_s)
            try:
                try:
                    conn.connect()
                    conn.request("POST", "/generate", body=body, headers={
                        "Content-Type": "application/json",
                        "Content-Length": str(len(body))})
                    resp = conn.getresponse()
                except OSError as e:
                    self.stats.record_replica_failure()
                    rep.breaker.record_failure(f"{type(e).__name__}: {e}")
                    continue
                start = time.monotonic()
                if resp.status != 200:
                    data = resp.read()
                    handler._send_raw(resp.status, {
                        k: v for k, v in resp.getheaders()
                        if k in self._RELAY_HEADERS}, data)
                    if resp.status in (429, 503):
                        return  # backpressure relayed; no vote
                    if resp.status >= 500:
                        rep.breaker.record_failure(f"HTTP {resp.status}")
                    else:
                        rep.breaker.record_success()
                    return
                handler.send_response(200)
                handler.send_header("Content-Type",
                                    resp.getheader("Content-Type",
                                                   "application/x-ndjson"))
                handler.send_header("Transfer-Encoding", "chunked")
                handler.end_headers()
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    handler.wfile.write(b"%x\r\n" % len(line) + line
                                        + b"\r\n")
                    handler.wfile.flush()
                handler.wfile.write(b"0\r\n\r\n")
                handler.wfile.flush()
                rep.breaker.record_success()
                self.stats.record_proxied(time.monotonic() - start)
                if slo_class is not None:
                    self.stats.record_class_latency(
                        slo_class, time.monotonic() - start)
            finally:
                conn.close()
            return
        handler._send(503, {"error": "no routable replica"},
                      headers={"Retry-After": "1"})

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetRouter":
        self.refresh()  # a synchronous first pass: routable immediately
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True,
                                             name="fleet-router-poll")
        self._poll_thread.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="fleet-router-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)


def _parse_json(body: bytes):
    try:
        return json.loads(body)
    except ValueError:
        return {}


def _http_call(url: str, method: str, path: str, body: Optional[bytes] = None,
               timeout: float = 30.0) -> tuple:
    """One HTTP exchange with a replica: (status, relay-headers, body).
    Connection-level failures surface as OSError (the caller's breaker
    evidence); an answered response NEVER raises."""
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        headers = {}
        if body is not None:
            headers = {"Content-Type": "application/json",
                       "Content-Length": str(len(body))}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        relay = {k: v for k, v in resp.getheaders()
                 if k in FleetRouter._RELAY_HEADERS}
        return int(resp.status), relay, data
    finally:
        conn.close()
