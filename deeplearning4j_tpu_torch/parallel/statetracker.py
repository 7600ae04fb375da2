"""Job distribution and state tracking (counterpart:
``deeplearning4j_tpu/parallel/statetracker.py`` — ``Job`` :44,
``StateTracker`` :55 with heartbeat expiry, reclaim, the fenced
completion, the dead-letter cap and the membership epoch,
``HogwildWorkRouter`` and ``IterativeReduceWorkRouter``,
``StateTrackerServer`` and ``RemoteStateTracker`` (the JSON-over-TCP
wire, one JSON object a line each way) and ``FileServiceRegistry``).

Host code, the same in both packages: the tracker is in-process and
thread-safe; ``StateTrackerServer`` hosts one on a TCP port so that other
OS processes drive the job queue, heartbeats and reclaim through
``RemoteStateTracker``. The wire is the JAX package's, so a client of one
package talks to the server of the other. Membership events go to the
port's ``obs/journal``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Job:
    """Reference scaleout/api/Job.java: work id + payload (+ worker)."""

    job_id: str
    payload: Any
    worker_id: Optional[str] = None
    attempts: int = 0
    done: bool = False
    result: Any = None


class StateTracker:
    """In-process job queue + heartbeats + reclaim + fleet membership
    (BaseHazelCastStateTracker.java:49 capability surface, promoted to the
    elastic fleet's membership authority: `register_worker` /
    `deregister_worker` / `live_workers` and a `membership_epoch` that
    bumps on every join, announced departure, and heartbeat-expiry death,
    so averaging rounds can re-form over the survivor set).

    Delivery guarantees for the fleet's no-drop/no-double-count contract:
      * a reclaimed job is RE-QUEUED, never lost (no batch dropped);
      * `complete_job` is FENCED by the assignment's attempt number — a
        zombie executor (stalled heartbeat, job reclaimed and re-assigned
        underneath it) gets its late completion rejected, so a split is
        counted exactly once (`stale_completions` audits the rejections);
      * a job failing `max_attempts` times routes to a dead-letter list
        (`poisoned_jobs`) instead of cycling forever.
    """

    def __init__(self, heartbeat_timeout: float = 5.0,
                 max_attempts: Optional[int] = None):
        self.heartbeat_timeout = heartbeat_timeout
        self.max_attempts = max_attempts
        self._lock = threading.Lock()
        self._pending: List[Job] = []
        self._assigned: Dict[str, Job] = {}  # job_id -> job
        self._done: Dict[str, Job] = {}
        self._poisoned: Dict[str, Job] = {}  # dead-letter list
        self._heartbeats: Dict[str, float] = {}
        self._registered: List[str] = []  # fleet members, join order
        self._epoch = 0
        self._params: Dict[str, Any] = {}  # replicated-map role
        self.stale_completions = 0  # fenced-out zombie completions

    # -- job lifecycle ----------------------------------------------------
    def add_job(self, job: Job) -> None:
        with self._lock:
            self._pending.append(job)

    def request_job(self, worker_id: str) -> Optional[Job]:
        """Worker asks for work (GiveMeMyJob protocol message). Returns a
        SNAPSHOT of the job, not the tracked object: the delivered
        attempt number must stay frozen in the worker's hands (the fence
        token), exactly as it does over the wire transport — a shared
        mutable Job would let a later re-assignment retroactively update
        a zombie's attempt and slip past the completion fence."""
        import copy

        with self._lock:
            self._heartbeats[worker_id] = time.monotonic()
            if not self._pending:
                return None
            job = self._pending.pop(0)
            job.worker_id = worker_id
            job.attempts += 1
            self._assigned[job.job_id] = job
            return copy.copy(job)

    def complete_job(self, job_id: str, result: Any = None,
                     attempt: Optional[int] = None) -> bool:
        """Record a finished job. When `attempt` is given, the completion
        is FENCED: it is accepted only while the job is still assigned at
        that attempt number. A worker whose job was reclaimed (stalled
        heartbeat) and re-assigned holds a stale attempt — its late
        completion is rejected so the split cannot be double-counted.
        Returns whether the completion was accepted."""
        with self._lock:
            job = self._assigned.get(job_id)
            if job is None or (attempt is not None
                               and job.attempts != attempt):
                if attempt is not None:
                    # audit FENCED rejections only: an unfenced legacy
                    # duplicate-complete is not a zombie event and must
                    # not pollute the double-count telemetry
                    self.stale_completions += 1
                return False
            del self._assigned[job_id]
            job.done = True
            job.result = result
            self._done[job_id] = job
            return True

    def fail_job(self, job_id: str, attempt: Optional[int] = None) -> bool:
        """JobFailed message: back to the queue — unless the job has
        already burned `max_attempts` deliveries, in which case it routes
        to the dead-letter list (a poison job must not cycle forever).
        FENCED like complete_job when `attempt` is given: a zombie whose
        job was reclaimed and re-assigned must not yank the survivor's
        live assignment back to pending (a third execution that burns
        attempts toward the poison cap). Returns True when re-queued,
        False when fenced/poisoned/unknown."""
        with self._lock:
            job = self._assigned.get(job_id)
            if job is None or (attempt is not None
                               and job.attempts != attempt):
                return False
            del self._assigned[job_id]
            return self._requeue_or_poison_locked(job)

    def _requeue_or_poison_locked(self, job: Job) -> bool:
        """Shared by every re-queue path (JobFailed, heartbeat-expiry
        reclaim, announced departure): a job that already burned
        `max_attempts` deliveries routes to the dead-letter list — a
        split whose executor keeps DYING (not just raising) must hit the
        same cap as one that keeps failing, or it cycles until the round
        timeout instead of surfacing in poisoned_jobs()."""
        if (self.max_attempts is not None
                and job.attempts >= self.max_attempts):
            self._poisoned[job.job_id] = job
            return False
        job.worker_id = None
        self._pending.append(job)
        return True

    def poisoned_jobs(self) -> Dict[str, int]:
        """Dead-letter list: job_id -> attempts burned before giving up."""
        with self._lock:
            return {k: j.attempts for k, j in self._poisoned.items()}

    def stale_completion_count(self) -> int:
        """Fenced-out zombie completions (RPC-safe accessor: the fleet's
        telemetry must see the counter through the wire transport too)."""
        with self._lock:
            return self.stale_completions

    # -- fleet membership --------------------------------------------------
    def register_worker(self, worker_id: str) -> int:
        """Worker joins the fleet; returns the new membership epoch."""
        with self._lock:
            self._heartbeats[worker_id] = time.monotonic()
            if worker_id not in self._registered:
                self._registered.append(worker_id)
                self._epoch += 1
            epoch = self._epoch
        from deeplearning4j_tpu_torch.obs import journal as obs_journal

        obs_journal.event("fleet.worker", action="register",
                          worker=worker_id, epoch=epoch)
        return epoch

    def deregister_worker(self, worker_id: str) -> int:
        """Announced departure (the SIGTERM'd worker's goodbye): drop the
        member, RE-QUEUE its in-flight jobs immediately (no heartbeat
        expiry to wait out), bump the epoch."""
        with self._lock:
            self._heartbeats.pop(worker_id, None)
            if worker_id in self._registered:
                self._registered.remove(worker_id)
                self._epoch += 1
            for job_id in list(self._assigned):
                job = self._assigned[job_id]
                if job.worker_id == worker_id:
                    del self._assigned[job_id]
                    self._requeue_or_poison_locked(job)
            epoch = self._epoch
        from deeplearning4j_tpu_torch.obs import journal as obs_journal

        obs_journal.event("fleet.worker", action="deregister",
                          worker=worker_id, epoch=epoch)
        return epoch

    def live_workers(self) -> List[str]:
        """Registered members with a fresh heartbeat, in join order."""
        now = time.monotonic()
        with self._lock:
            return [
                w for w in self._registered
                if now - self._heartbeats.get(w, 0.0)
                <= self.heartbeat_timeout
            ]

    def membership(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self._epoch, "workers": list(self._registered)}

    @property
    def membership_epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- heartbeats / failure detection -----------------------------------
    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            self._heartbeats[worker_id] = time.monotonic()

    def dead_workers(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [
                w for w, t in self._heartbeats.items()
                if now - t > self.heartbeat_timeout
            ]

    def reclaim_dead_jobs(self) -> int:
        """Re-queue jobs assigned to workers that stopped heartbeating
        (the ClearWorker/job-reclaim protocol). Dead workers are also
        DEREGISTERED from the fleet membership (epoch bump), so the next
        averaging round re-forms over the survivor set."""
        dead = set(self.dead_workers())
        reclaimed = 0
        with self._lock:
            for job_id in list(self._assigned):
                job = self._assigned[job_id]
                if job.worker_id in dead:
                    del self._assigned[job_id]
                    self._requeue_or_poison_locked(job)
                    reclaimed += 1
            for w in dead:
                self._heartbeats.pop(w, None)
                if w in self._registered:
                    self._registered.remove(w)
                    self._epoch += 1
        return reclaimed

    # -- shared parameter storage (replicated-map role) --------------------
    def set_params(self, key: str, value: Any) -> None:
        with self._lock:
            self._params[key] = value

    def get_params(self, key: str) -> Any:
        with self._lock:
            return self._params.get(key)

    # -- introspection ----------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "assigned": len(self._assigned),
                "done": len(self._done),
            }

    def results(self) -> Dict[str, Any]:
        with self._lock:
            return {k: j.result for k, j in self._done.items()}

    def drain_results(self) -> Dict[str, Any]:
        """Snapshot AND clear completed jobs (per-round aggregation must not
        see previous rounds' results)."""
        with self._lock:
            out = {k: j.result for k, j in self._done.items()}
            self._done.clear()
            return out


# ---------------------------------------------------------------------------
# Work routers
# ---------------------------------------------------------------------------


class HogwildWorkRouter:
    """Async dispatch, no synchronization between workers
    (HogWildWorkRouter.java): every idle worker immediately gets the next
    job; results apply in completion order."""

    def __init__(self, tracker: StateTracker, num_workers: int):
        self.tracker = tracker
        self.num_workers = num_workers

    def run(self, work_fn: Callable[[Any], Any]) -> Dict[str, Any]:
        def worker(wid: str):
            while True:
                job = self.tracker.request_job(wid)
                if job is None:
                    return
                try:
                    result = work_fn(job.payload)
                    self.tracker.complete_job(job.job_id, result)
                except Exception:  # noqa: BLE001 — JobFailed protocol
                    if job.attempts >= 3:
                        # poison job: record as done-with-None while still
                        # assigned, so it can't cycle forever
                        self.tracker.complete_job(job.job_id, None)
                    else:
                        self.tracker.fail_job(job.job_id)

        threads = [
            threading.Thread(target=worker, args=(f"worker-{i}",), daemon=True)
            for i in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return self.tracker.results()


class IterativeReduceWorkRouter:
    """Barrier rounds with aggregation (IterativeReduceWorkRouter.java):
    all workers finish the round, then `reduce_fn` merges results before
    the next round starts."""

    def __init__(self, tracker: StateTracker, num_workers: int):
        self.tracker = tracker
        self.num_workers = num_workers

    def run_round(self, work_fn: Callable[[Any], Any],
                  reduce_fn: Callable[[List[Any]], Any]) -> Any:
        HogwildWorkRouter(self.tracker, self.num_workers).run(work_fn)
        round_results = self.tracker.drain_results()  # this round only
        results = [r for r in round_results.values() if r is not None]
        merged = reduce_fn(results)
        self.tracker.set_params("merged", merged)
        return merged


# ---------------------------------------------------------------------------
# Cross-process transport (the Hazelcast TCP member plane)
# ---------------------------------------------------------------------------


_RPC_METHODS = frozenset({
    "request_job", "complete_job", "fail_job", "heartbeat", "add_job",
    "dead_workers", "reclaim_dead_jobs", "set_params", "get_params",
    "counts", "results", "drain_results",
    # fleet membership + dead-letter surface
    "register_worker", "deregister_worker", "live_workers", "membership",
    "poisoned_jobs", "stale_completion_count",
})


class StateTrackerServer:
    """TCP host for a StateTracker — the part of
    BaseHazelCastStateTracker.java:49 that is genuinely cross-process: the
    master binds a port (the reference's Hazelcast member on :5701/:2181)
    and workers in OTHER OS processes drive the job-queue/heartbeat/reclaim
    protocol over it. Newline-delimited JSON RPC
    ({"method": m, "args": [...]} -> {"ok": result} | {"err": msg});
    payloads/results must be JSON values — tensors never ride this plane
    (they move through the parallel/*_parallel.py collectives).

    Publish the address for workers with FileServiceRegistry (the
    zookeeper role), as the reference registers the Hazelcast host
    (ZooKeeperConfigurationRegister)."""

    def __init__(self, tracker: StateTracker, host: str = "127.0.0.1",
                 port: int = 0):
        import socketserver

        self.tracker = tracker
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        req = json.loads(line)
                        method = req["method"]
                        if method not in _RPC_METHODS:
                            raise ValueError(f"unknown method {method!r}")
                        args = req.get("args", [])
                        if method == "add_job":
                            outer.tracker.add_job(Job(args[0], args[1]))
                            resp = {"ok": None}
                        elif method == "request_job":
                            job = outer.tracker.request_job(args[0])
                            resp = {"ok": None if job is None else
                                    {"job_id": job.job_id,
                                     "payload": job.payload,
                                     "attempts": job.attempts}}
                        else:
                            resp = {"ok": getattr(outer.tracker, method)(
                                *args)}
                    except Exception as e:  # noqa: BLE001 — protocol error reply
                        resp = {"err": f"{type(e).__name__}: {e}"}
                    try:
                        wire = json.dumps(resp)
                    except TypeError as e:
                        # non-JSON result (e.g. an ndarray set_params by an
                        # in-process router): an error REPLY, not a dead
                        # connection — tensors don't ride this plane
                        wire = json.dumps(
                            {"err": f"result not JSON-serializable: {e}"})
                    self.wfile.write((wire + "\n").encode("utf-8"))
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "StateTrackerServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


class RemoteStateTracker:
    """Worker-side proxy: same surface as StateTracker, each call one JSON
    RPC round trip to the master's StateTrackerServer (the reference
    worker's Hazelcast client role). One persistent connection per proxy;
    construct per process/thread."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        import socket

        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._broken = False

    @classmethod
    def from_address(cls, address: str, **kw) -> "RemoteStateTracker":
        host, port = address.rsplit(":", 1)
        return cls(host, int(port), **kw)

    def _call(self, method: str, *args):
        with self._lock:
            if self._broken:
                raise ConnectionError(
                    "state tracker connection is broken (an earlier call "
                    "timed out mid-reply; request/reply pairing is lost — "
                    "reconnect with a new RemoteStateTracker)")
            try:
                self._sock.sendall(
                    (json.dumps({"method": method, "args": list(args)})
                     + "\n").encode("utf-8"))
                line = self._rfile.readline()
            except Exception:
                # a timeout/partial read leaves the late reply queued on the
                # socket: a retry would read the PREVIOUS call's reply and
                # silently desync every later call — poison the connection
                self._broken = True
                self._sock.close()
                raise
        if not line:
            raise ConnectionError("state tracker server closed connection")
        resp = json.loads(line)
        if "err" in resp:
            raise RuntimeError(f"remote state tracker: {resp['err']}")
        return resp["ok"]

    def close(self) -> None:
        self._sock.close()

    # -- StateTracker surface over the wire --------------------------------
    def add_job(self, job: Job) -> None:
        self._call("add_job", job.job_id, job.payload)

    def request_job(self, worker_id: str) -> Optional[Job]:
        d = self._call("request_job", worker_id)
        if d is None:
            return None
        return Job(d["job_id"], d["payload"], worker_id=worker_id,
                   attempts=d["attempts"])

    def complete_job(self, job_id: str, result: Any = None,
                     attempt: Optional[int] = None) -> bool:
        return self._call("complete_job", job_id, result, attempt)

    def fail_job(self, job_id: str, attempt: Optional[int] = None) -> bool:
        return self._call("fail_job", job_id, attempt)

    def heartbeat(self, worker_id: str) -> None:
        self._call("heartbeat", worker_id)

    def register_worker(self, worker_id: str) -> int:
        return self._call("register_worker", worker_id)

    def deregister_worker(self, worker_id: str) -> int:
        return self._call("deregister_worker", worker_id)

    def live_workers(self) -> List[str]:
        return self._call("live_workers")

    def membership(self) -> Dict[str, Any]:
        return self._call("membership")

    def poisoned_jobs(self) -> Dict[str, int]:
        return self._call("poisoned_jobs")

    def stale_completion_count(self) -> int:
        return self._call("stale_completion_count")

    def dead_workers(self) -> List[str]:
        return self._call("dead_workers")

    def reclaim_dead_jobs(self) -> int:
        return self._call("reclaim_dead_jobs")

    def set_params(self, key: str, value: Any) -> None:
        self._call("set_params", key, value)

    def get_params(self, key: str) -> Any:
        return self._call("get_params", key)

    def counts(self) -> Dict[str, int]:
        return self._call("counts")

    def results(self) -> Dict[str, Any]:
        return self._call("results")

    def drain_results(self) -> Dict[str, Any]:
        return self._call("drain_results")


# ---------------------------------------------------------------------------
# Service registry (zookeeper role)
# ---------------------------------------------------------------------------


class FileServiceRegistry:
    """Register/retrieve service addresses + configs through a shared
    directory (ZooKeeperConfigurationRegister/Retriever role: the znode is
    a json file; multi-host deployments point this at NFS/GCS-fuse)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.json")

    def register(self, name: str, value: Dict[str, Any]) -> None:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(value, f)
        os.replace(tmp, self._path(name))  # atomic publish

    def retrieve(self, name: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(name), "r", encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def unregister(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def list_services(self) -> List[str]:
        return sorted(
            os.path.splitext(n)[0]
            for n in os.listdir(self.root)
            if n.endswith(".json")
        )
