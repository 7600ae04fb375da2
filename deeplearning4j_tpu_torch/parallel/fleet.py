"""Elastic fleet runtime: preemption-tolerant N-worker parameter
averaging (counterpart: ``deeplearning4j_tpu/parallel/fleet.py`` —
``shard_for`` :96 and ``FileMembershipBoard`` :111-200, in the same file
format; the npz spool plumbing :203-235 over the port's own tree
flattening; ``_Heartbeater``, ``_InProcessWorker`` and ``run_worker``
:243-512; ``ElasticParameterAveragingTrainer`` :535-1047).

  coordinator       :class:`ElasticParameterAveragingTrainer` — one
                    averaging round per ``fit`` call: poll the membership
                    authority (the StateTracker — in-process, over its
                    TCP transport, or a :class:`FileMembershipBoard`
                    shared directory), partition the round's global batch
                    into one split per LIVE worker (sorted, balanced,
                    loud ValueError when not divisible), enqueue the
                    splits as fenced jobs, wait, average the results in
                    SPLIT ORDER.
  workers           in-process threads (:class:`_InProcessWorker`) or
                    other OS processes (:func:`run_worker` over
                    RemoteStateTracker + the file data plane): each pulls
                    a split, runs ``averaging_frequency`` independent
                    train steps from the broadcast params
                    (``data_parallel.local_round``), and completes the job
                    with the attempt-fenced protocol. The threads of one
                    process share the coordinator's net and run their
                    splits one at a time on it (one device).
  failure handling  a worker that dies holding a split is detected by
                    heartbeat expiry; the split is RECLAIMED and
                    re-executed by a survivor (no batch dropped); a
                    zombie whose heartbeat merely stalled gets its late
                    completion FENCED OUT (no batch double-counted) and
                    re-registers. A SIGTERM'd worker process announces
                    departure (deregister + immediate job re-queue)
                    before dying. The NEXT round re-forms over the
                    survivor set (membership epoch bump), which also
                    re-partitions any attached ETL pipelines
                    (``etl/pipeline.InputPipeline.reshard``).

Determinism is structural: a split's result is a pure function of
(broadcast params, split data, the round's steps) — executor identity
never enters (every split of a round draws the same dropout streams,
``data_parallel.round_step_rngs``) — and the average runs in split-index
order. A run that loses worker k at round s and re-admits a replacement
at round s+m is therefore bit-exact against a replay of the same
membership schedule, and at ``averaging_frequency=1`` with SGD it
matches the serial big-batch run.

The coordinator owns the training state: wrap the trainer in
``resilience.ResilientTrainer`` with a CheckpointManager (workers are
stateless between splits). ``device`` is where the net lives (``cuda``
unless ``"cpu"``); OS-process workers take their own.

Env knobs: ``DL4J_TPU_FLEET_HEARTBEAT_S`` (failure-detection timeout,
default 5.0), ``DL4J_TPU_FLEET_MIN_WORKERS`` (a round blocks until this
many members are live, default 1), ``DL4J_TPU_FLEET_DIR`` (when set, the
default shared directory for the file membership/data planes).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map

logger = logging.getLogger("deeplearning4j_tpu_torch")

HEARTBEAT_ENV = "DL4J_TPU_FLEET_HEARTBEAT_S"
MIN_WORKERS_ENV = "DL4J_TPU_FLEET_MIN_WORKERS"
FLEET_DIR_ENV = "DL4J_TPU_FLEET_DIR"

_MANIFEST = "fleet"  # FileServiceRegistry entry for cross-process workers


def _env_float(name: str, default: float) -> float:
    return envknob.get_float(name, default)


def _env_int(name: str, default: int) -> int:
    return envknob.get_int(name, default)


def shard_for(worker_id: str, live: List[str]) -> Optional[Tuple[int, int]]:
    """(rank, count) of ``worker_id`` in the SORTED live set — the ETL
    plane's shard selection under elastic membership (every member
    computes the same answer from the same membership snapshot). None
    when the worker is not (any longer) a member."""
    ordered = sorted(live)
    if worker_id not in ordered:
        return None
    return ordered.index(worker_id), len(ordered)


# ---------------------------------------------------------------------------
# File membership board (shared-directory transport)
# ---------------------------------------------------------------------------


class FileMembershipBoard:
    """Membership authority over a shared directory (the file half of the
    fleet's "file/socket transport": NFS/GCS-fuse deployments where the
    TCP tracker port cannot be reached; same znode-as-json-file idiom as
    statetracker.FileServiceRegistry). Join writes a heartbeat file,
    every beat rewrites it with a fresh sequence payload, leave removes
    it — so announced departure and heartbeat expiry look identical to
    the coordinator's poll, exactly like the tracker authority.

    Liveness is CLOCK-SKEW-FREE: the reader never compares a writer
    timestamp (or server mtime) against its own wall clock — unsynced
    hosts and coarse GCS-fuse mtimes would falsely expel live members.
    Instead each poll records, on the reader's MONOTONIC clock, when a
    member's payload was last observed to CHANGE; a member whose file
    stops changing for `heartbeat_timeout` of reader-time is dead."""

    def __init__(self, root: str, heartbeat_timeout: float = 5.0):
        self.root = os.path.abspath(root)
        self.heartbeat_timeout = heartbeat_timeout
        # worker -> (last payload seen, reader-monotonic time it changed)
        self._seen: Dict[str, Tuple[str, float]] = {}
        self._beats = 0
        os.makedirs(self.root, exist_ok=True)

    def _path(self, worker_id: str) -> str:
        return os.path.join(self.root, f"member-{worker_id}.hb")

    def register_worker(self, worker_id: str) -> int:
        self.heartbeat(worker_id)
        return 0  # epoch accounting is coordinator-side (set-change scan)

    def heartbeat(self, worker_id: str) -> None:
        self._beats += 1
        tmp = self._path(worker_id) + f".tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            # payload only needs to CHANGE every beat (a per-writer
            # sequence); the wall time rides along for human debugging
            f.write(f"{os.getpid()}:{self._beats}:{time.time()}\n")
        os.replace(tmp, self._path(worker_id))  # atomic publish

    def deregister_worker(self, worker_id: str) -> int:
        try:
            os.remove(self._path(worker_id))
        except FileNotFoundError:
            pass
        self._seen.pop(worker_id, None)
        return 0

    def live_workers(self) -> List[str]:
        now = time.monotonic()
        out = []
        try:
            names = os.listdir(self.root)
        except OSError as e:
            # a shared-mount blip must read as a PARTITION (the
            # coordinator's retry/fallback path), not as "fleet empty" —
            # an empty answer would run the round-timeout clock out
            raise ConnectionError(
                f"membership board unreadable at {self.root!r}: {e}"
            ) from e
        present = set()
        for name in names:
            if not (name.startswith("member-") and name.endswith(".hb")):
                continue
            wid = name[len("member-"):-len(".hb")]
            try:
                with open(os.path.join(self.root, name),
                          encoding="utf-8") as f:
                    payload = f.read()
            except OSError:
                continue  # removed between listdir and read
            present.add(wid)
            last = self._seen.get(wid)
            if last is None or last[0] != payload:
                self._seen[wid] = (payload, now)  # observed a fresh beat
                out.append(wid)
            elif now - last[1] <= self.heartbeat_timeout:
                out.append(wid)
        # forget removed files so a re-join starts a fresh observation
        for wid in list(self._seen):
            if wid not in present:
                del self._seen[wid]
        return sorted(out)


# ---------------------------------------------------------------------------
# npz tree plumbing (the file data plane: tensors never ride the JSON RPC)
# ---------------------------------------------------------------------------


def _atomic_savez(path: str, **arrays) -> None:
    """Crash-safe npz publish: tmp + rename (a member reading a
    half-written file would poison a round)."""
    tmp = f"{path}.tmp-{os.getpid()}.npz"  # .npz suffix: savez appends none
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _leaves(tree) -> list:
    """The non-None leaves of a nest of dicts, lists and tuples, in
    insertion order (the port's ``jax.tree_util.tree_leaves``: a net
    built from the same conf lays its trees out in the same order)."""
    return [x for x in tree_leaves(tree) if x is not None]


def _unflatten(template, leaves):
    """``leaves`` back into ``template``'s structure (None stays None);
    a tensor leaf takes the template leaf's dtype and device."""
    it = iter(leaves)

    def one(t):
        if t is None:
            return None
        v = next(it)
        if torch.is_tensor(t):
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            return v.to(device=t.device, dtype=t.dtype)
        return type(t)(np.asarray(v).item()) if np.ndim(v) == 0 else v

    return tree_map(one, template)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu").numpy()
    return np.asarray(leaf)


def _save_trees(path: str, losses=None, extra: Optional[dict] = None,
                **trees) -> None:
    """Atomic npz of several trees' leaves ({prefix}{i} keys, leaf
    order = :func:`_leaves` order, reproducible from the same conf), plus
    optional flat `extra` arrays — the ONE writer both the coordinator's
    round-state/result files and the workers' readers agree on."""
    arrays: Dict[str, np.ndarray] = {}
    for prefix, tree in trees.items():
        for i, leaf in enumerate(_leaves(tree)):
            arrays[f"{prefix}{i}"] = _host(leaf)
    if losses is not None:
        arrays["losses"] = _host(losses)
    for key, val in (extra or {}).items():
        arrays[key] = _host(val)
    _atomic_savez(path, **arrays)


def _load_tree(npz, prefix: str, template):
    """Leaves {prefix}{i} back into `template`'s structure."""
    n = len(_leaves(template))
    return _unflatten(template, [npz[f"{prefix}{i}"] for i in range(n)])


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------


class _Heartbeater:
    """Heartbeat from a side thread while a member computes: a split's
    first execution may build kernels (seconds of ``nvcc`` on the card),
    far past any sane failure-detection timeout — liveness and compute are
    separate planes, as with the reference's Hazelcast heartbeat thread
    next to the worker's training thread."""

    def __init__(self, worker_id: str, tracker, board, heartbeat_s: float,
                 enabled: bool = True):
        self.worker_id = worker_id
        self.tracker = tracker
        self.board = board
        self.interval = max(0.01, min(0.25, heartbeat_s / 4.0))
        self.enabled = enabled
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        if self.enabled:
            self._thread = threading.Thread(
                target=self._beat, daemon=True,
                name=f"hb-{self.worker_id}")
            self._thread.start()
        return self

    def _beat(self):
        while not self._stop.wait(self.interval):
            try:
                self.tracker.heartbeat(self.worker_id)
                if self.board is not None:
                    self.board.heartbeat(self.worker_id)
            except Exception:  # noqa: BLE001 — a dying transport ends beats
                return

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return False


class _InProcessWorker(threading.Thread):
    """One fleet member as a daemon thread: poll the tracker for split
    jobs, execute them through the coordinator's local round
    (:meth:`ElasticParameterAveragingTrainer._execute_split`), and
    complete with the fenced protocol. The thread analogue of the
    reference's worker JVM (ExecuteWorkerFlatMap) — the cross-process
    twin is :func:`run_worker`."""

    def __init__(self, fleet: "ElasticParameterAveragingTrainer",
                 worker_id: str, chaos=None, poll_s: float = 0.005):
        super().__init__(name=f"fleet-{worker_id}", daemon=True)
        self.fleet = fleet
        self.worker_id = worker_id
        self.chaos = chaos
        self.poll_s = poll_s
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:  # noqa: C901 — one worker loop, kept whole
        fleet, wid = self.fleet, self.worker_id
        tracker = fleet.tracker
        board = fleet.membership_board
        tracker.register_worker(wid)
        if board is not None:
            board.register_worker(wid)
        try:
            while not self._stop.is_set():
                rnd = fleet.round_index
                if self.chaos is not None and self.chaos.kill_on_poll(
                        wid, rnd):
                    return  # dies silently: no goodbye, no deregister
                job = tracker.request_job(wid)
                if board is not None:
                    board.heartbeat(wid)
                if job is None:
                    self._stop.wait(self.poll_s)
                    continue
                split = int(job.payload["split"])
                jrnd = int(job.payload["round"])
                if self.chaos is not None and self.chaos.kill_on_job(
                        wid, jrnd, split):
                    return  # dies HOLDING the job -> reclaim path
                stall = (self.chaos.stall_on_job(wid, jrnd, split)
                         if self.chaos is not None else None)
                try:
                    # side-thread heartbeats while computing: the first
                    # execution of a split may build kernels (seconds of
                    # nvcc), and a silent member mid-build must not read as
                    # dead
                    # — except the chaos zombie, whose silence is the fault
                    with _Heartbeater(
                            wid, tracker, board, self.fleet.heartbeat_s,
                            enabled=stall is None):
                        result = fleet._execute_split(job.payload)
                except Exception as e:  # noqa: BLE001 — JobFailed protocol
                    logger.warning("fleet worker %s failed split %d of "
                                   "round %d: %s", wid, split, jrnd, e)
                    tracker.fail_job(job.job_id, attempt=job.attempts)
                    continue
                if stall is not None:
                    # zombie: computed, then went silent past the
                    # heartbeat timeout — the split is reclaimed and
                    # re-executed underneath; the completion below MUST
                    # be fenced out or the round double-counts it
                    time.sleep(stall)
                accepted = tracker.complete_job(
                    job.job_id, result, attempt=job.attempts)
                if not accepted and not self._stop.is_set():
                    # fenced out: the split was reclaimed and re-assigned
                    # underneath this zombie — rejoin at a fresh epoch.
                    # NOT when evicted: a stopped worker re-registering
                    # would resurrect a ghost member for heartbeat_s and
                    # skew the next round's split count
                    logger.warning(
                        "fleet worker %s: completion of split %d round %d "
                        "fenced out (job reclaimed while stalled); "
                        "re-registering", wid, split, jrnd)
                    tracker.register_worker(wid)
                    if board is not None:
                        board.register_worker(wid)
        finally:
            if self._stop.is_set():
                # EVICTED (scripted/announced departure): re-remove any
                # membership trace a still-beating heartbeater recreated
                # after evict_worker's deregister — a ghost member file
                # would skew the next round's split count. A chaos-killed
                # worker must NOT clean up: its death is meant to be
                # detected by heartbeat expiry.
                tracker.deregister_worker(wid)
                if board is not None:
                    board.deregister_worker(wid)


def run_worker(address: str, worker_id: str, spool_dir: str, *,
               poll_s: float = 0.02, handle_signals: bool = True,
               stop_after_idle_s: Optional[float] = None,
               device=None) -> None:
    """Cross-process fleet member: the reference's worker JVM over our
    transports — control plane on the tracker's TCP JSON RPC
    (RemoteStateTracker), data plane on the spool directory (split /
    round-state / result npz files; tensors never ride the RPC —
    statetracker.StateTrackerServer contract). Builds its own net from
    the fleet manifest the coordinator registered (FileServiceRegistry
    role), so every member runs the same local round on its own
    ``device`` (``cuda`` unless given ``"cpu"``).

    Preemption: SIGTERM -> fail the in-flight job back to the queue,
    deregister (announced departure — the survivors rebalance without
    waiting out the heartbeat timeout), exit. The coordinator owns the
    authoritative checkpoint; a worker's goodbye is its announcement."""
    import signal
    import sys

    from deeplearning4j_tpu_torch.parallel.statetracker import (
        FileServiceRegistry,
        RemoteStateTracker,
    )

    # per-worker flight-recorder path (unless the operator pinned one):
    # N workers sharing the coordinator's cwd must not last-writer-wins
    # clobber the coordinator's checkpoint/membership/preempt timeline
    os.environ.setdefault(
        "DL4J_TPU_OBS_JOURNAL",
        os.path.join(spool_dir, f".obs_journal.{worker_id}.jsonl"))

    manifest = FileServiceRegistry(spool_dir).retrieve(_MANIFEST)
    if manifest is None:
        raise RuntimeError(f"no fleet manifest under {spool_dir!r}")
    net = _net_from_manifest(manifest, device)
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        local_round,
    )

    tracker = RemoteStateTracker.from_address(address)
    tracker.register_worker(worker_id)
    state = {"job": None, "preempted": False}

    def on_sigterm(signum, frame):
        state["preempted"] = True

    if handle_signals:
        signal.signal(signal.SIGTERM, on_sigterm)

    round_cache: Dict[int, tuple] = {}
    last_work = time.monotonic()
    try:
        while True:
            if state["preempted"]:
                # announced departure: in-flight job back to the queue,
                # membership epoch bumps NOW, not at heartbeat expiry
                job = state["job"]
                if job is not None:
                    tracker.fail_job(job.job_id, attempt=job.attempts)
                tracker.deregister_worker(worker_id)
                print(f"FLEET_WORKER_PREEMPTED {worker_id}", flush=True)
                sys.exit(143)
            job = tracker.request_job(worker_id)
            if job is None:
                if (stop_after_idle_s is not None
                        and time.monotonic() - last_work > stop_after_idle_s):
                    tracker.deregister_worker(worker_id)
                    return
                time.sleep(poll_s)
                continue
            state["job"] = job
            p = job.payload
            rnd, split = int(p["round"]), int(p["split"])
            try:
                # the whole split execution is JobFailed-protected, like
                # _InProcessWorker: a stale round's deleted spool file, a
                # corrupt npz, or ENOSPC must fail the JOB back to the
                # queue (toward the dead-letter cap), not kill the member
                if rnd not in round_cache:
                    round_cache.clear()  # old rounds never come back
                    with np.load(p["state"]) as z:
                        round_cache[rnd] = (
                            _load_tree(z, "p", net.params),
                            _load_tree(z, "s", net.states),
                            _load_tree(z, "u", net.updater_state),
                            int(z["iteration"]),
                            z["rngs"].copy(),
                        )
                params, states, upd, _, rngs = round_cache[rnd]
                with np.load(p["data"]) as z:
                    xs, ys, ms, lms = (
                        None if k not in z.files else
                        torch.from_numpy(z[k].copy()).to(net.device)
                        for k in ("xs", "ys", "ms", "lms"))
                with _Heartbeater(worker_id, tracker, None,
                                  float(manifest.get(
                                      "heartbeat_s",
                                      _env_float(HEARTBEAT_ENV, 5.0)))):
                    o_params, o_states, o_upd, losses = local_round(
                        net, (params, states, upd), xs, ys, ms, lms, rngs)
                result_path = os.path.join(
                    spool_dir, f"result-{rnd}-{split}-{worker_id}.npz")
                _save_trees(result_path, losses=np.asarray(losses),
                            p=o_params, s=o_states, u=o_upd)
            except Exception as e:  # noqa: BLE001 — JobFailed protocol
                logger.warning("fleet worker %s failed split %d of round "
                               "%d: %s", worker_id, split, rnd, e)
                tracker.fail_job(job.job_id, attempt=job.attempts)
                state["job"] = None
                continue
            accepted = tracker.complete_job(
                job.job_id, {"split": split, "path": result_path},
                attempt=job.attempts)
            if not accepted:
                # fenced out: the split was reclaimed (this member read
                # as dead) and re-assigned — rejoin at a fresh epoch,
                # same as the in-process worker
                print(f"FLEET_WORKER_FENCED {worker_id} r{rnd}s{split}",
                      flush=True)
                tracker.register_worker(worker_id)
            state["job"] = None
            last_work = time.monotonic()
    finally:
        tracker.close()


def _net_from_manifest(manifest: dict, device=None):
    """The coordinator's net rebuilt from its conf JSON, in the
    coordinator's dtype (the round state's leaves carry it)."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if manifest.get("model_class", "MultiLayerNetwork") != "MultiLayerNetwork":
        raise NotImplementedError("the elastic fleet drives "
                                  "MultiLayerNetwork")
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(manifest["conf"]),
        device=device).init()
    dtype = getattr(torch, manifest.get("dtype", "float32"))
    if dtype != torch.float32:
        net.params = tree_map(lambda a: a.to(dtype), net.params)
        net.updater_state = net.updater.init(net.params)
    return net


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class ElasticParameterAveragingTrainer:
    """Elastic ParameterAveragingTrainer (see module docstring). One
    ``fit(features, labels)`` call = one averaging round over the live
    membership. Carries the container fit contract, so ResilientTrainer
    and ParameterAveragingTrainingMaster drive it unchanged."""

    def __init__(
        self,
        net,
        num_workers: int = 2,
        averaging_frequency: int = 1,
        save_updater: bool = True,
        *,
        tracker=None,
        membership_board=None,
        heartbeat_s: Optional[float] = None,
        min_workers: Optional[int] = None,
        chaos=None,
        spool_dir: Optional[str] = None,
        round_timeout_s: float = 120.0,
        job_max_attempts: int = 5,
        device=None,
    ):
        from deeplearning4j_tpu_torch.ops.device import resolve_device
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            _check_net_device,
        )
        from deeplearning4j_tpu_torch.parallel.statetracker import StateTracker

        self.device = resolve_device(device)
        _check_net_device(net, self.device)
        self.net = net
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.save_updater = save_updater
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else _env_float(HEARTBEAT_ENV, 5.0))
        self.min_workers = (min_workers if min_workers is not None
                            else _env_int(MIN_WORKERS_ENV, 1))
        self.tracker = tracker if tracker is not None else StateTracker(
            heartbeat_timeout=self.heartbeat_s,
            max_attempts=job_max_attempts)
        self.membership_board = membership_board
        self.chaos = chaos
        self.spool_dir = spool_dir or envknob.get_str(FLEET_DIR_ENV)
        self.round_timeout_s = float(round_timeout_s)
        self.round_index = 0  # 1-based during a round; 0 before the first
        self.resilience_stats: Dict[str, Any] = {
            "retries": 0, "reclaims": 0, "backoff_seconds": 0.0,
            "rounds": 0, "membership_retries": 0, "membership_fallbacks": 0,
            "epoch": 0, "stale_completions": 0,
        }
        net.resilience_stats = self.resilience_stats
        # join the central MetricsRegistry: the fleet's rounds/epoch/
        # reclaim counters become one more view beside dispatch/memory
        obs_registry.register_net(net)
        self._workers: Dict[str, _InProcessWorker] = {}
        self._pending_spawn = [f"w{i}" for i in range(int(num_workers))]
        self._worker_seq = int(num_workers)  # next generated member id
        self._server = None
        self._round_state: Optional[dict] = None
        # the splits of this process run one at a time on the
        # coordinator's net (one device; a split swaps the round's
        # broadcast state in and reads its result out)
        self._compute_lock = threading.Lock()
        self._epoch = 0
        self._last_live: Optional[List[str]] = None
        self._listeners: List[Callable[[int, List[str]], None]] = []
        self._pipelines: List[tuple] = []
        self._is_graph = hasattr(net, "_as_inputs")
        if self._is_graph:
            raise NotImplementedError(
                "ElasticParameterAveragingTrainer drives MultiLayerNetwork; "
                "ComputationGraph stays on ParameterAveragingTrainer "
                "(SparkComputationGraph mode)")

    # -- membership surface -------------------------------------------------
    @property
    def membership_authority(self):
        return (self.membership_board if self.membership_board is not None
                else self.tracker)

    @property
    def epoch(self) -> int:
        return self._epoch

    def add_membership_listener(self, fn: Callable[[int, List[str]], None]):
        """``fn(epoch, sorted_live)`` fired whenever the live set the
        coordinator plans rounds over changes."""
        self._listeners.append(fn)

    def attach_pipeline(self, pipeline, worker_id: str,
                        boundary_fn: Callable[[], int]) -> None:
        """Live ETL resharding: on every membership change, re-partition
        `pipeline`'s shard selection to ``shard_for(worker_id, live)`` at
        the absolute batch boundary ``boundary_fn()`` (the control plane
        must agree on one boundary fleet-wide — typically the first
        global batch index of the next epoch/round)."""
        self._pipelines.append((pipeline, worker_id, boundary_fn))

    def admit_worker(self, worker_id: Optional[str] = None) -> str:
        """Grow the fleet: spawn (or re-admit) an in-process member. The
        next round re-forms over the enlarged set. Generated ids come
        from a monotone counter — len()-based naming would collide with
        a live member after an eviction (silently orphaning its thread
        and making the admit a membership no-op)."""
        if worker_id is None:
            worker_id = f"w{self._worker_seq}"
            self._worker_seq += 1
        self._spawn(worker_id)
        return worker_id

    def evict_worker(self, worker_id: str) -> None:
        """Scripted/announced departure (the deterministic-replay twin of
        a chaos kill): stop the member and deregister it — its in-flight
        jobs re-queue immediately."""
        w = self._workers.pop(worker_id, None)
        if w is not None:
            w.stop()
        self.tracker.deregister_worker(worker_id)
        if self.membership_board is not None:
            self.membership_board.deregister_worker(worker_id)

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Expose this coordinator's tracker over TCP for OS-process
        members (:func:`run_worker`); registers the fleet manifest in the
        spool dir so workers can build the identical net. Returns the
        address to hand to workers."""
        from deeplearning4j_tpu_torch.parallel.statetracker import (
            FileServiceRegistry,
            StateTrackerServer,
        )

        if self.spool_dir is None:
            raise ValueError("cross-process fleet needs spool_dir (the "
                             "file data plane; DL4J_TPU_FLEET_DIR)")
        os.makedirs(self.spool_dir, exist_ok=True)
        if self.net.params is None:
            self.net.init()
        FileServiceRegistry(self.spool_dir).register(_MANIFEST, {
            "model_class": type(self.net).__name__,
            "conf": self.net.conf.to_json(),
            "averaging_frequency": self.averaging_frequency,
            "save_updater": bool(self.save_updater),
            "heartbeat_s": self.heartbeat_s,
            "dtype": str(tree_leaves(self.net.params)[0].dtype).split(".")[-1],
        })
        self._server = StateTrackerServer(self.tracker, host, port).start()
        return self._server.address

    def close(self) -> None:
        for wid in list(self._workers):
            self.evict_worker(wid)
        if self._server is not None:
            self._server.stop()
            self._server = None

    def _spawn(self, wid: str) -> None:
        old = self._workers.get(wid)
        if old is not None and old.is_alive():
            raise ValueError(
                f"worker id {wid!r} is already a live member — evict it "
                "first or admit under a fresh id")
        w = _InProcessWorker(self, wid, chaos=self.chaos)
        self._workers[wid] = w
        w.start()
        # registration barrier: the membership a round forms over must be
        # deterministic, so a spawn/admit returns only once the member is
        # visible to the authority (otherwise the first round would race
        # the workers' registrations and the split count would flap)
        deadline = time.monotonic() + 10.0
        while wid not in self.membership_authority.live_workers():
            if time.monotonic() > deadline:
                raise RuntimeError(f"worker {wid} never registered")
            time.sleep(0.001)

    def _ensure_workers(self) -> None:
        pending, self._pending_spawn = self._pending_spawn, []
        for wid in pending:
            self._spawn(wid)

    # -- membership poll ----------------------------------------------------
    def _poll_membership(self) -> List[str]:
        """Sorted live member set, >= min_workers, with partition
        tolerance: a failed poll retries with backoff and ultimately
        falls back to the last-known set (LOUDLY) rather than killing
        training — the coordinator analogue of Spark surviving a
        transient ZooKeeper session loss."""
        stats = self.resilience_stats
        deadline = time.monotonic() + self.round_timeout_s
        backoff = 0.01
        while True:
            try:
                if self.chaos is not None:
                    self.chaos.on_membership_poll(self.round_index)
                # expire silent members FIRST: their in-flight jobs
                # re-queue and the epoch bumps before the round forms
                reclaimed = self.tracker.reclaim_dead_jobs()
                if reclaimed:
                    stats["reclaims"] += reclaimed
                live = sorted(self.membership_authority.live_workers())
            except (ConnectionError, TimeoutError) as e:
                # TimeoutError too: the FIRST slow RPC on a
                # RemoteStateTracker raises the socket timeout (only the
                # poisoned connection's LATER calls raise ConnectionError)
                stats["membership_retries"] += 1
                if time.monotonic() > deadline:
                    if self._last_live:
                        stats["membership_fallbacks"] += 1
                        logger.warning(
                            "membership authority unreachable (%s); falling "
                            "back to last-known membership %s", e,
                            self._last_live)
                        return list(self._last_live)
                    raise
                time.sleep(backoff)
                backoff = min(0.2, backoff * 2)
                continue
            if len(live) >= self.min_workers:
                self._note_membership(live)
                return live
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet below min_workers={self.min_workers} for "
                    f"{self.round_timeout_s:.0f}s (live: {live})")
            time.sleep(0.01)

    def _note_membership(self, live: List[str]) -> None:
        if self._last_live == live:
            return
        self._epoch += 1
        self.resilience_stats["epoch"] = self._epoch
        obs_journal.event("membership", epoch=self._epoch,
                          live=list(live), was=self._last_live,
                          round=self.round_index)
        logger.info("fleet membership epoch %d: %s (was %s) — rounds "
                    "re-form over %d workers", self._epoch, live,
                    self._last_live, len(live))
        self._last_live = list(live)
        for fn in self._listeners:
            fn(self._epoch, list(live))
        from deeplearning4j_tpu_torch.etl.pipeline import DROP_SHARD

        for pipeline, wid, boundary_fn in self._pipelines:
            # a DEPARTED member owns nothing (reshard(None) would mean
            # "own everything" and double-feed the survivors' batches)
            shard = shard_for(wid, live)
            pipeline.reshard(DROP_SHARD if shard is None else shard,
                             at_seq=boundary_fn())

    # -- the round ----------------------------------------------------------
    def _to_rounds(self, a):
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            _as_tensor,
            stack_rounds,
        )

        return stack_rounds(_as_tensor(a, self.net.device),
                            self.averaging_frequency)

    def _execute_split(self, payload: dict):
        """Run one split's local round (in-process data plane). A
        reclaimed job re-executes here with the SAME round state — the
        result is identical no matter which worker runs it."""
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            local_round,
        )

        rs = self._round_state
        if rs is None or payload["round"] != rs["round"]:
            raise RuntimeError(
                f"split for round {payload['round']} but round "
                f"{None if rs is None else rs['round']} is current")
        with obs_trace.span("fleet.split", round=int(payload["round"]),
                            split=int(payload["split"]),
                            membership_epoch=self._epoch):
            xs, ys, ms, lms = rs["splits"][payload["split"]]
            with self._compute_lock:
                net = self.net
                it0 = net.iteration
                try:
                    params, states, upd, losses = local_round(
                        net, (rs["params"], rs["states"], rs["upd"]),
                        xs, ys, ms, lms, rs["rngs"])
                finally:
                    net.iteration = it0
        return {"split": int(payload["split"]),
                "arrays": (params, states, upd, losses)}

    def _step_rngs(self):
        from deeplearning4j_tpu_torch.parallel.data_parallel import round_step_rngs

        return round_step_rngs(self.net, self.averaging_frequency)

    def _publish_round(self, rnd: int, splits: List[tuple]) -> List[dict]:
        """Round state for the workers; returns per-split payloads. With
        a spool dir the state/split arrays also land as npz files for
        OS-process members (the file data plane)."""
        net = self.net
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            _snapshot_of,
        )

        params, states, upd = _snapshot_of(
            (net.params, net.states, net.updater_state))
        self._round_state = {
            "round": rnd,
            "params": params,
            "states": states,
            "upd": upd,
            "iteration": int(net.iteration),
            "rngs": self._step_rngs(),
            "splits": splits,
        }
        payloads = [{"round": rnd, "split": i} for i in range(len(splits))]
        if self.spool_dir:
            os.makedirs(self.spool_dir, exist_ok=True)
            state_path = os.path.join(self.spool_dir, f"state-{rnd}.npz")
            rs = self._round_state
            _save_trees(state_path,
                        extra={"iteration": rs["iteration"],
                               "rngs": rs["rngs"]},
                        p=rs["params"], s=rs["states"], u=rs["upd"])
            for i, (xs, ys, ms, lms) in enumerate(splits):
                sp = os.path.join(self.spool_dir, f"split-{rnd}-{i}.npz")
                arrs = {"xs": _host(xs), "ys": _host(ys)}
                if ms is not None:
                    arrs["ms"] = _host(ms)
                if lms is not None:
                    arrs["lms"] = _host(lms)
                _atomic_savez(sp, **arrs)
                payloads[i].update(state=state_path, data=sp)
            self._gc_spool(rnd)
        return payloads

    def _gc_spool(self, rnd: int) -> None:
        """Bound spool disk to the live round plus one (a reclaimed job
        of the previous round must still find its files)."""
        try:
            names = os.listdir(self.spool_dir)
        except OSError:
            return
        for name in names:
            for prefix in ("state-", "split-", "result-"):
                if name.startswith(prefix):
                    try:
                        r = int(name[len(prefix):].split("-")[0].split(".")[0])
                    except ValueError:
                        continue
                    if r < rnd - 1:
                        try:
                            os.remove(os.path.join(self.spool_dir, name))
                        except OSError:
                            pass

    def fit(self, features, labels, mask=None, label_mask=None) -> float:
        """One elastic averaging round: re-form over the live membership,
        split, dispatch, reclaim as needed, average in split order. The
        round span carries the membership epoch so a flight-recorder
        timeline correlates rounds with chaos-injected kills."""
        with obs_trace.span("fleet.round") as sp:
            loss = self._fit_round(features, labels, mask, label_mask)
            sp.set_attr("round", self.round_index)
            sp.set_attr("membership_epoch", self._epoch)
            sp.set_attr("workers", len(self._last_live or ()))
        return loss

    def _fit_round(self, features, labels, mask=None,
                   label_mask=None) -> float:
        net = self.net
        if net.params is None:
            net.init()
        self._ensure_workers()
        self.round_index += 1
        rnd = self.round_index
        live = self._poll_membership()
        n = len(live)
        x = self._to_rounds(features)
        y = self._to_rounds(labels)
        m = self._to_rounds(mask)
        lm = self._to_rounds(label_mask)
        gb = x.shape[1]
        if gb % n != 0:
            raise ValueError(
                f"global batch {gb} not divisible by {n} live workers — "
                "pad or trim so every member trains an equal split "
                "(silent tail truncation would drop examples; the "
                "multihost.local_batch_slice rule)")
        per = gb // n
        take = lambda a, sl: None if a is None else a[:, sl]
        splits = [
            (take(x, slice(i * per, (i + 1) * per)),
             take(y, slice(i * per, (i + 1) * per)),
             take(m, slice(i * per, (i + 1) * per)),
             take(lm, slice(i * per, (i + 1) * per)))
            for i in range(n)
        ]
        if hasattr(net, "_reset_rnn_states"):
            net._reset_rnn_states(per)
        payloads = self._publish_round(rnd, splits)
        from deeplearning4j_tpu_torch.parallel.statetracker import Job

        job_ids = [f"r{rnd}-s{i}" for i in range(n)]
        for jid, payload in zip(job_ids, payloads):
            self.tracker.add_job(Job(jid, payload))
        results = self._await_round(job_ids)
        loss = self._apply_average(results, n)
        self.resilience_stats["rounds"] += 1
        if hasattr(self.tracker, "stale_completion_count"):
            # RPC-safe accessor: works for in-process AND remote trackers
            self.resilience_stats["stale_completions"] = (
                self.tracker.stale_completion_count())
        net.iteration += self.averaging_frequency
        net._score = loss
        return loss

    def _await_round(self, job_ids: List[str]) -> Dict[int, tuple]:
        """Wait until every split of this round is DONE, reclaiming dead
        members' in-flight splits along the way. No early exit: a round
        completes over whatever membership survives it (no batch dropped),
        or fails loudly (poisoned split / timeout / fleet extinct)."""
        stats = self.resilience_stats
        deadline = time.monotonic() + self.round_timeout_s
        last_expire = time.monotonic()
        want = set(job_ids)
        while True:
            done = self.tracker.results()
            if want <= set(done):
                break
            now = time.monotonic()
            # failure detection AND dead-letter checks at heartbeat
            # granularity, not every completion poll — the coordinator
            # shares the core with the worker threads doing the compute
            # (and each check copies a tracker dict / costs an RPC)
            if now - last_expire >= max(0.05, self.heartbeat_s / 2):
                last_expire = now
                reclaimed = self.tracker.reclaim_dead_jobs()
                if reclaimed:
                    stats["reclaims"] += reclaimed
                    logger.warning(
                        "fleet round %d: reclaimed %d in-flight split(s) "
                        "from dead worker(s); re-executing on survivors",
                        self.round_index, reclaimed)
                    live = self.membership_authority.live_workers()
                    if not live and not any(
                            t.is_alive() for t in self._workers.values()):
                        raise RuntimeError(
                            "fleet extinct: every worker died holding "
                            "splits and none can re-execute them")
                poisoned = self.tracker.poisoned_jobs() if hasattr(
                    self.tracker, "poisoned_jobs") else {}
                bad = want & set(poisoned)
                if bad:
                    raise RuntimeError(
                        f"split job(s) {sorted(bad)} poisoned after "
                        f"{max(poisoned[b] for b in bad)} attempts — a "
                        "batch may not be silently dropped; fix the fault "
                        "and rerun")
            if now > deadline:
                raise RuntimeError(
                    f"fleet round {self.round_index} timed out waiting for "
                    f"{sorted(want - set(done))}")
            time.sleep(0.005)
        drained = self.tracker.drain_results()
        out: Dict[int, tuple] = {}
        for jid in job_ids:
            res = drained[jid]
            if isinstance(res, dict) and "arrays" in res:
                out[int(res["split"])] = res["arrays"]
            else:  # file data plane (cross-process member)
                with np.load(res["path"]) as z:
                    out[int(res["split"])] = (
                        _load_tree(z, "p", self.net.params),
                        _load_tree(z, "s", self.net.states),
                        _load_tree(z, "u", self.net.updater_state),
                        torch.from_numpy(z["losses"].copy()),
                    )
        return out

    def _apply_average(self, results: Dict[int, tuple], n: int) -> float:
        """Host-side averaging round, in SPLIT-INDEX order (deterministic
        regardless of executor identity or completion order): params (and
        updater state, reference saveUpdater :416-434) averaged; batch-
        statistics states averaged; recurrent stream states keep the
        coordinator's (workers rebuild from broadcast each split)."""
        from deeplearning4j_tpu_torch.parallel.data_parallel import (
            _state_is_stream,
            average_trees,
        )

        net = self.net
        ordered = [results[i] for i in range(n)]
        net.params = average_trees([r[0] for r in ordered])
        net.states = [
            (net.states[i]  # recurrent stream state: local, not averaged
             if _state_is_stream(net, i)
             else average_trees([r[1][i] for r in ordered]))
            for i in range(len(net.states))
        ]
        if self.save_updater:
            net.updater_state = average_trees([r[2] for r in ordered])
        else:
            net.updater_state = ordered[0][2]
        losses = np.stack([_host(r[3]).astype(np.float32) for r in ordered])
        return float(np.mean(np.mean(losses, axis=1)))
