"""ServingFleet: N ServingEngine replicas behind one FleetRouter
(counterpart: ``deeplearning4j_tpu/serving/fleet.py`` — ``goodbye_replica``,
``ServingFleet`` in thread mode, ``run_replica`` and ``main``). One
replica is one full ServingEngine — its own registry, batcher, breakers,
decoder and drain — and membership rides the authority the training fleet
uses: ``parallel/fleet.FileMembershipBoard`` heartbeat files, plus a
``replica-<id>.addr`` JSON beside them (``serving/router.py``) saying
where to connect and which role the replica plays.

Two deployment shapes, one contract:

  thread mode  :class:`ServingFleet` runs N engines in this process, each
               on its own ephemeral port with a heartbeat side thread,
               sharing one model object (the substrate for chaos:
               ``kill_replica`` enacts a ``RouterChaos`` verdict).
  process mode :func:`run_replica` is the OS-process entry, also
               ``python -m deeplearning4j_tpu_torch.serving.fleet``
               (``--cpu`` for the CPU): the engine with its SIGTERM drain,
               register + heartbeat, SIGTERM -> drain -> GOODBYE
               (announced departure) -> exit. A SIGKILL'd replica leaves
               only the board's expiry to speak.

A HARD kill stops the heartbeat and closes the HTTP socket without
deregistering: the router detects it by connect failure (breaker vote and
retry on a survivor) and by board expiry; admitted /predict requests are
never lost. A soft departure drains first and says goodbye.

On the card every replica's decoder sizes its KV arena from the budget it
is given (``kv_blocks``, or ``ops/memory.kv_arena_blocks`` on
``DL4J_TPU_HBM_GB`` through ``engine_kwargs``), never from the whole
card, so N replicas fit beside each other; the kernels are built once per
process (``ops/build``), before a replica's first request in practice.

Env knobs (``ops/env.py``): ``DL4J_TPU_SERVE_FLEET_REPLICAS`` (default
replica count), ``DL4J_TPU_SERVE_ROUTER_PORT``,
``DL4J_TPU_SERVE_REPLICA_FAILS``.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.router import (
    FleetRouter,
    publish_replica_addr,
    remove_replica_addr,
)


def fleet_replicas_default() -> int:
    return int(envknob.get_int("DL4J_TPU_SERVE_FLEET_REPLICAS", 2))


def goodbye_replica(board, fleet_dir: str, replica_id: str) -> None:
    """The announced-departure goodbye in the SAFE order: unlink the
    replica's addr JSON FIRST, then deregister from the board. The old
    order (deregister -> remove addr) had a crash window that left a
    permanently stale addr file — heartbeat entries self-heal via board
    expiry, but addr files have no expiry, so a crash between the two
    steps kept pointing the router at a dead socket forever. A crash in the new order leaves a board entry with no
    addr, which expiry reaps. try/finally: the board goodbye still
    lands even if the addr unlink raises."""
    try:
        remove_replica_addr(fleet_dir, replica_id)
    finally:
        board.deregister_worker(replica_id)


class _ReplicaHandle:
    """One in-process replica: engine + membership heartbeat thread.
    The heartbeat is a SIDE thread (the training fleet's _Heartbeater
    discipline — liveness and compute are separate planes)."""

    def __init__(self, rid: str, engine: ServingEngine, board,
                 fleet_dir: str, heartbeat_s: float):
        self.rid = rid
        self.engine = engine
        self.board = board
        self.fleet_dir = fleet_dir
        self.interval = max(0.01, min(0.25, heartbeat_s / 4.0))
        self.alive = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.board.register_worker(self.rid)
        # the engine's disaggregation role rides the addr JSON: the router learns the prefill/decode split from the same
        # membership read that tells it where to connect
        publish_replica_addr(self.fleet_dir, self.rid, self.engine.url,
                             role=self.engine.role)
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name=f"serve-hb-{self.rid}")
        self._thread.start()

    def _beat(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.board.heartbeat(self.rid)
            except OSError:
                return  # a dying transport ends beats (board expiry)

    def stop_heartbeat(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def kill(self) -> None:
        """HARD death (the thread-mode stand-in for SIGKILL): heartbeat
        stops beating and the HTTP socket closes NOW — no drain, no
        deregister, no addr removal. The router must detect this by
        connect failure / board expiry, never by a goodbye."""
        self.alive = False
        self.stop_heartbeat()
        self.engine.stop(drain=False)

    def depart(self) -> None:
        """Announced departure: drain (every admitted request answered),
        then the goodbye — deregister + addr removal — so the router
        sees a clean leave."""
        self.alive = False
        self.engine.stop(drain=True)
        self.stop_heartbeat()
        goodbye_replica(self.board, self.fleet_dir, self.rid)


class ServingFleet:
    """See module docstring. ``model`` (one object shared by the thread
    replicas: its ``output`` and decode paths keep no per-call state on
    the module, so answers stay byte-identical and the replicas run
    concurrently) or ``model_path`` (each replica loads its own copy, the
    OS-process shape) seeds every replica's default record. ``device``:
    ``cuda`` unless ``"cpu"``; a live ``model`` must live there."""

    def __init__(self, model=None, model_path: Optional[str] = None, *,
                 replicas: Optional[int] = None,
                 fleet_dir: Optional[str] = None,
                 router_port: Optional[int] = None,
                 input_shape=None, normalizer=None,
                 heartbeat_s: float = 1.0,
                 chaos=None,
                 roles: Optional[Dict[str, str]] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 router_kwargs: Optional[Dict[str, Any]] = None,
                 device=None) -> None:
        from deeplearning4j_tpu_torch.parallel.fleet import FileMembershipBoard

        self.device = resolve_device(device)
        if model is not None and getattr(model, "device", None) not in (
                None, self.device):
            raise ValueError(f"the model lives on {model.device}, the "
                             f"fleet on {self.device}")
        if model is not None and hasattr(model, "compute_params"):
            # the TransformerLM's decode weights, built once here: the
            # replicas' decoders read them each tick and must not race to
            # build their own copies
            model.compute_params  # noqa: B018

        self.n_replicas = int(replicas if replicas is not None
                              else fleet_replicas_default())
        if self.n_replicas < 1:
            raise ValueError("a serving fleet needs >= 1 replica")
        self._owns_dir = fleet_dir is None
        self.fleet_dir = (fleet_dir if fleet_dir is not None
                          else tempfile.mkdtemp(prefix="serve-fleet-"))
        self.board = FileMembershipBoard(self.fleet_dir,
                                         heartbeat_timeout=heartbeat_s)
        self.heartbeat_s = float(heartbeat_s)
        self.model = model
        self.model_path = model_path
        self.input_shape = input_shape
        self.normalizer = normalizer
        self.chaos = chaos
        # rid -> 'prefill'|'decode'|'' — the disaggregation split; a
        # restart re-spawns with the SAME role
        self.roles = dict(roles or {})
        self.engine_kwargs = dict(engine_kwargs or {})
        self._lock = threading.Lock()
        self._handles: Dict[str, _ReplicaHandle] = {}
        rkw = dict(router_kwargs or {})
        rkw.setdefault("poll_s", max(0.1, heartbeat_s / 4.0))
        # the router gets its OWN reader board (live_workers keeps
        # per-reader observation state) with the fleet's failure-
        # detection timeout — the default 5s board would keep a hard-
        # killed replica "live" for seconds after its beats stopped
        self.router = FleetRouter(
            board=FileMembershipBoard(self.fleet_dir,
                                      heartbeat_timeout=heartbeat_s),
            port=router_port, chaos=chaos,
            on_kill=self.kill_replica, **rkw)

    # -- replica lifecycle -------------------------------------------------
    def _build_engine(self, role: str = "") -> ServingEngine:
        kw = dict(self.engine_kwargs)
        if role:
            kw["role"] = role
        eng = ServingEngine(model=self.model, model_path=self.model_path,
                            port=0, input_shape=self.input_shape,
                            normalizer=self.normalizer, device=self.device,
                            **kw)
        return eng.start()

    def _spawn(self, rid: str) -> _ReplicaHandle:
        handle = _ReplicaHandle(rid,
                                self._build_engine(self.roles.get(rid, "")),
                                self.board,
                                self.fleet_dir, self.heartbeat_s)
        handle.start()
        with self._lock:
            self._handles[rid] = handle
        return handle

    def start(self) -> "ServingFleet":
        for i in range(self.n_replicas):
            self._spawn(f"r{i}")
        self.router.start()
        return self

    def kill_replica(self, rid: str) -> None:
        """HARD-kill one replica (chaos enactment / manual fault): see
        :meth:`_ReplicaHandle.kill`. Unknown or already-dead ids are
        ignored (a chaos verdict can race a natural death)."""
        with self._lock:
            handle = self._handles.get(rid)
        if handle is not None and handle.alive:
            handle.kill()

    def add_replica(self, role: str = "") -> str:
        """Scale-UP enactment (the autoscaler DECIDES, this ENACTS —
        the decide-vs-enact chaos discipline): spawn one fresh replica
        on the lowest free rid slot. Deterministic: the rid is a pure
        function of the current live membership, so a replayed decision
        schedule names the same replicas."""
        with self._lock:
            live = {rid for rid, h in self._handles.items() if h.alive}
        i = 0
        while f"r{i}" in live:
            i += 1
        rid = f"r{i}"
        if role:
            self.roles[rid] = role
        self._spawn(rid)
        return rid

    def depart_replica(self, rid: str) -> None:
        """Announced departure (drain + goodbye) for one replica."""
        with self._lock:
            handle = self._handles.get(rid)
        if handle is not None and handle.alive:
            handle.depart()

    def restart_replica(self, rid: str) -> None:
        """Bring a killed replica back (a fresh engine, fresh port): the
        addr file is re-published and the router's poll follows the new
        address — the time-to-recover path the bench leg measures."""
        with self._lock:
            handle = self._handles.get(rid)
        if handle is not None and handle.alive:
            raise ValueError(f"replica {rid!r} is still alive")
        self._spawn(rid)

    def replica_ids(self):
        with self._lock:
            return sorted(self._handles)

    def engines(self) -> Dict[str, ServingEngine]:
        """Live engines by replica id (tests reach through this for
        byte-identity against a solo engine)."""
        with self._lock:
            return {rid: h.engine for rid, h in self._handles.items()
                    if h.alive}

    @property
    def url(self) -> str:
        return self.router.url

    def stop(self) -> None:
        self.router.stop()
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
        for h in handles:
            if h.alive:
                h.depart()
        if self._owns_dir:
            # best-effort cleanup of the spool we created
            for name in os.listdir(self.fleet_dir):
                try:
                    os.remove(os.path.join(self.fleet_dir, name))
                except OSError:
                    pass
            try:
                os.rmdir(self.fleet_dir)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# OS-process replica entry
# ---------------------------------------------------------------------------


def run_replica(*, fleet_dir: str, replica_id: str,
                model_path: Optional[str] = None, model=None,
                input_shape=None, port: int = 0,
                heartbeat_s: float = 1.0,
                engine_kwargs: Optional[Dict[str, Any]] = None,
                ready_event=None, device=None) -> None:
    """One OS-process serving replica, blocking until preempted: build
    the engine with the SIGTERM drain installed, join the membership
    board, heartbeat until the signal lands, let the engine answer every
    admitted request (its own drain), then say GOODBYE (deregister +
    addr removal — the announced-departure path; a SIGKILL skips all of
    this and the board expiry speaks instead)."""
    from deeplearning4j_tpu_torch.parallel.fleet import FileMembershipBoard

    engine = ServingEngine(model=model, model_path=model_path, port=port,
                           input_shape=input_shape,
                           handle_signals=True, device=device,
                           **dict(engine_kwargs or {}))
    engine.start()
    board = FileMembershipBoard(fleet_dir, heartbeat_timeout=heartbeat_s)
    board.register_worker(replica_id)
    publish_replica_addr(fleet_dir, replica_id, engine.url,
                         role=engine.role)
    if ready_event is not None:
        ready_event.set()
    interval = max(0.01, min(0.25, heartbeat_s / 4.0))
    try:
        while not engine.draining:
            board.heartbeat(replica_id)
            time.sleep(interval)
        # SIGTERM landed: the engine's serve-drain thread is answering
        # admitted work; keep beating until the drain finishes so the
        # router never misreads a graceful drain as death
        deadline = time.monotonic() + engine.drain_s + 5.0
        while not engine.drained and time.monotonic() < deadline:
            board.heartbeat(replica_id)
            time.sleep(interval)
    finally:
        goodbye_replica(board, fleet_dir, replica_id)


def main(argv=None) -> int:
    """``python -m deeplearning4j_tpu_torch.serving.fleet --fleet-dir D
    --replica-id r0 --model-path m.zip [--cpu]`` — the production
    replica process, on the card unless ``--cpu``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.fleet",
        description="one serving-fleet replica process")
    ap.add_argument("--fleet-dir", required=True)
    ap.add_argument("--replica-id", required=True)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument("--role", default="",
                    choices=("", "prefill", "decode"),
                    help="disaggregation role published with the addr "
                         "(default: DL4J_TPU_SERVE_ROLE)")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (default: the card, which "
                         "must be there)")
    args = ap.parse_args(argv)
    run_replica(fleet_dir=args.fleet_dir, replica_id=args.replica_id,
                model_path=args.model_path, port=args.port,
                heartbeat_s=args.heartbeat_s,
                engine_kwargs=({"role": args.role} if args.role else None),
                device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
