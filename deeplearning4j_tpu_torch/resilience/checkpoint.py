"""Async atomic checkpoint manager with retention, digests and fallback
(counterpart: ``deeplearning4j_tpu/resilience/checkpoint.py`` —
``CheckpointManager`` with the zip backend, ``is_primary`` :190, the
``ckpt.snapshot``, ``ckpt.write`` and ``ckpt.commit`` spans and the
``checkpoint`` journal event :240-378).

  * Async: ``save()`` copies the training state to the host
    synchronously (every leaf cloned: the updaters write the parameters
    in place) and hands serialization and IO to a worker thread, so the
    train loop stalls for the snapshot only. A non-blocking save while
    the last write is in flight is skipped, not queued.
  * Atomic: the payload is written into ``ckpt-<step>.tmp/``, fsync'd,
    manifested, then committed with one directory rename.
  * Verified: ``MANIFEST.json`` records a sha256 per payload file;
    ``latest_intact()`` re-hashes, warns about and skips a corrupt
    checkpoint, and falls back to the newest intact one.
  * Retention: keep-last-k (``DL4J_TPU_CKPT_KEEP``) plus keep-every-n
    anchors, pruned after each commit.

The directory layout, the manifest and the zip are the JAX package's, so
each package's manager reads the other's zip checkpoints.
``backend="sharded"`` writes the trees through
``utils/sharded_checkpoint`` (the port's own shard files, where the JAX
package writes orbax; neither reads the other's). ``should_save(step)`` is the step cadence
(``every_steps`` / ``DL4J_TPU_CKPT_EVERY``) or a wall-clock one
(``every_seconds``); ``DL4J_TPU_CKPT_ASYNC=0`` makes saves synchronous.
Only the primary process writes (:func:`is_primary`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob

logger = logging.getLogger("deeplearning4j_tpu_torch")

ENV_EVERY = "DL4J_TPU_CKPT_EVERY"
ENV_KEEP = "DL4J_TPU_CKPT_KEEP"
ENV_ASYNC = "DL4J_TPU_CKPT_ASYNC"

MANIFEST = "MANIFEST.json"
MANIFEST_FORMAT = 1
_CKPT_PREFIX = "ckpt-"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed digest/structure verification (raised only by
    the explicit single-checkpoint restore path; the scanning restore
    logs and falls back instead)."""


# --------------------------------------------------------------------- utils
def fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def atomic_replace(path: str, data: bytes) -> None:
    """Crash-safe single-file write: tmp + fsync + rename (the
    early-stopping savers route their bestModel/latestModel zips through
    this so a preemption mid-save can no longer tear them)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _host_tree(tree):
    """A host copy of every leaf: the synchronous part of an async save.
    The updaters write the parameters in place, and on the CPU ``.cpu()``
    of a tensor is that tensor, so every leaf is cloned; a later step
    cannot reach the snapshot the worker writes. On the card each leaf's
    copy is a synchronous device-to-host copy."""
    from deeplearning4j_tpu_torch.ops.lowprec import tree_map

    return tree_map(lambda a: a.detach().to("cpu", copy=True)
                    if isinstance(a, torch.Tensor) else a, tree)


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes: process 0
    by the multihost env contract (``DL4J_TPU_PROCESS_ID``), else rank 0
    of an initialized ``torch.distributed`` group, else (one process)
    True."""
    pid = envknob.get_opt_int("DL4J_TPU_PROCESS_ID")
    if pid is not None:
        return pid == 0
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


@dataclass
class _SaveJob:
    step: int
    model_class: str
    conf_json: str
    params: Any
    states: Any
    updater_state: Any
    meta: Dict[str, Any]
    training_state: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    path: Optional[str] = None


class CheckpointManager:
    """See module docstring. One manager owns one checkpoint directory."""

    def __init__(
        self,
        directory: str,
        *,
        every_steps: Optional[int] = None,
        every_seconds: Optional[float] = None,
        keep_last: Optional[int] = None,
        keep_every: Optional[int] = None,
        async_save: Optional[bool] = None,
        backend: str = "zip",
        compression: int = zipfile.ZIP_STORED,
        primary: Optional[bool] = None,
        chaos=None,
    ):
        if backend not in ("zip", "sharded"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.directory = os.path.abspath(directory)
        self.every_steps = (envknob.get_int(ENV_EVERY) if every_steps is None
                            else int(every_steps))
        self.every_seconds = every_seconds
        self.keep_last = (envknob.get_int(ENV_KEEP) if keep_last is None
                          else int(keep_last))
        self.keep_every = keep_every
        self.async_save = (envknob.raw(ENV_ASYNC) != "0"
                           if async_save is None else bool(async_save))
        self.backend = backend
        self.compression = compression
        self._primary = primary
        self.chaos = chaos
        self._last_save_t: Optional[float] = None
        self._queue: "queue.Queue[_SaveJob]" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # serializes the actual fs writes: a BLOCKING save (preemption)
        # may run on the caller thread while the async worker is mid-job
        self._write_lock = threading.Lock()
        # telemetry: saves, skips, bytes, the worker's write seconds and
        # the caller's snapshot stall (snapshot_s, last_snapshot_s)
        self.stats = {"saves": 0, "skipped_busy": 0, "bytes": 0,
                      "write_s": 0.0, "pruned": 0, "errors": 0,
                      "snapshot_s": 0.0, "last_snapshot_s": 0.0}
        self.errors: List[BaseException] = []
        os.makedirs(self.directory, exist_ok=True)

    # ---------------------------------------------------------------- policy
    def is_primary(self) -> bool:
        if self._primary is None:
            self._primary = is_primary()
        return self._primary

    def should_save(self, step: int) -> bool:
        """Step/time cadence (both opt-in; the trainer additionally saves
        on preemption and at fit() exit regardless of cadence)."""
        if self.every_steps and step % self.every_steps == 0:
            return True
        if self.every_seconds is not None:
            now = time.monotonic()
            if (self._last_save_t is None
                    or now - self._last_save_t >= self.every_seconds):
                return True
        return False

    # ----------------------------------------------------------------- save
    def save(self, net, *, step: int, epoch: int = 0,
             iterator_state: Optional[dict] = None,
             block: Optional[bool] = None) -> Optional[str]:
        """Checkpoint `net` (MultiLayerNetwork or ComputationGraph) as
        step `step`. Synchronous part: host snapshot of
        params/states/updater + training state. Async part (unless
        ``block`` or sync mode): zip/fsync/manifest/commit/retention in
        the worker thread. Returns the committed path when blocking, else
        None (the commit is observable via flush()/checkpoints()).

        A non-blocking save while the previous write is still in flight
        is SKIPPED (counted in stats["skipped_busy"]) rather than queued
        without bound — checkpoint cadence must never grow an unbounded
        snapshot backlog in host RAM. Blocking saves (preemption,
        fit-exit) always wait for a slot instead."""
        if not self.is_primary():
            return None
        block = (not self.async_save) if block is None else block
        training_state = dict(net.training_state()) if hasattr(
            net, "training_state") else {"iteration": int(net.iteration)}
        training_state.update({
            "step": int(step),
            "epoch": int(epoch),
            "iterator_state": iterator_state,
        })
        from deeplearning4j_tpu_torch.utils.serialization import (
            container_meta,
        )

        # the synchronous half of an async save, the only stall the train
        # loop pays
        t_snap = time.perf_counter()
        with obs_trace.span("ckpt.snapshot", step=int(step)):
            job = _SaveJob(
                step=int(step),
                model_class=type(net).__name__,
                conf_json=net.conf.to_json(),
                params=_host_tree(net.params),
                states=_host_tree(net.states),
                updater_state=_host_tree(net.updater_state),
                meta=container_meta(net),
                training_state=training_state,
            )
        snap_s = time.perf_counter() - t_snap
        self.stats["snapshot_s"] += snap_s
        self.stats["last_snapshot_s"] = snap_s
        self._last_save_t = time.monotonic()
        if block:
            self._write(job)
            if job.error is not None:
                # raised HERE means handled here: drop it from the list
                # flush() reports, or the next flush would re-raise an
                # error the caller already dealt with
                try:
                    self.errors.remove(job.error)
                except ValueError:
                    pass
                raise job.error
            return job.path
        self._ensure_worker()
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            self.stats["skipped_busy"] += 1
            logger.warning(
                "checkpoint step %d skipped: previous write still in "
                "flight (next cadence point will retry)", step)
            return None
        return None

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name="ckpt-writer")
                self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:  # close() sentinel
                # the sentinel must be task_done'd too: a manager reused
                # after close() (ensure_worker restarts the thread) would
                # otherwise deadlock every later flush()'s queue.join()
                self._queue.task_done()
                return
            self._write(job)
            self._queue.task_done()

    def flush(self) -> None:
        """Wait until every enqueued save has committed; re-raise the
        first writer error (a failed checkpoint must not stay silent)."""
        if self._worker is not None:
            self._queue.join()
        if self.errors:
            err, self.errors = self.errors[0], []
            raise err

    def close(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._worker.join(timeout=10.0)
        self._worker = None

    # ---------------------------------------------------------------- write
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_CKPT_PREFIX}{step:08d}")

    def _write(self, job: _SaveJob) -> None:
        with self._write_lock:
            self._write_locked(job)

    def _write_locked(self, job: _SaveJob) -> None:
        t0 = time.perf_counter()
        final = self._ckpt_path(job.step)
        tmp = final + ".tmp"
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with obs_trace.span("ckpt.write", step=job.step,
                                backend=self.backend):
                files = (self._write_zip_payload(tmp, job)
                         if self.backend == "zip"
                         else self._write_sharded_payload(tmp, job))
            manifest = {
                "format": MANIFEST_FORMAT,
                "backend": self.backend,
                "step": job.step,
                "epoch": job.training_state.get("epoch", 0),
                "iteration": job.training_state.get("iteration"),
                "model_class": job.model_class,
                "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "files": files,
                "iterator_state": job.training_state.get("iterator_state"),
            }
            mpath = os.path.join(tmp, MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            # the commit: one directory rename; a crash before this line
            # leaves only a .tmp dir that the next write sweeps away.
            # A re-save of an existing step (save_on_exit, restart of a
            # finished run) renames the old dir ASIDE first — an rmtree
            # here would open a whole-tree-wide window with NO checkpoint
            # for the step; .old dirs don't parse as checkpoints, so the
            # scan never sees the intermediate state
            with obs_trace.span("ckpt.commit", step=job.step):
                old = None
                if os.path.isdir(final):
                    old = final + ".old"
                    if os.path.isdir(old):
                        shutil.rmtree(old)
                    os.replace(final, old)
                os.replace(tmp, final)
                if old is not None:
                    shutil.rmtree(old, ignore_errors=True)
                fsync_dir(self.directory)
            job.path = final
            total_bytes = sum(f["bytes"] for f in files.values())
            self.stats["saves"] += 1
            self.stats["bytes"] += total_bytes
            self.stats["write_s"] += time.perf_counter() - t0
            # flight-recorder marker: a post-mortem timeline can line the
            # last committed checkpoint up against spans/preemption events
            obs_journal.event(
                "checkpoint", step=job.step, path=final,
                epoch=job.training_state.get("epoch", 0),
                bytes=total_bytes)
            if self.chaos is not None:
                self.chaos.on_checkpoint_written(final, job.step)
            self._retain()
        except BaseException as e:  # noqa: BLE001 — surfaced via flush()
            job.error = e
            self.stats["errors"] += 1
            self.errors.append(e)
            logger.error("checkpoint step %d failed: %s", job.step, e)
            shutil.rmtree(tmp, ignore_errors=True)
        finally:
            job.done.set()

    def _write_sharded_payload(self, tmp: str,
                               job: _SaveJob) -> Dict[str, dict]:
        """The sharded layout (``utils/sharded_checkpoint``): the trees as
        one committed version under ``state``, the configuration, the
        training state and the metadata as JSON; the manifest digests
        every file."""
        from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc
        from deeplearning4j_tpu_torch.utils.serialization import (
            _jsonable_training_state,
        )

        sc.save_pytree(os.path.join(tmp, "state"), {
            "params": job.params, "states": job.states,
            "updater": job.updater_state})
        with open(os.path.join(tmp, "configuration.json"), "w") as f:
            f.write(job.conf_json)
        with open(os.path.join(tmp, "training_state.json"), "w") as f:
            json.dump(_jsonable_training_state(job.training_state), f)
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump({"model_class": job.model_class,
                       "format": "torch-shards", **job.meta}, f)
        files = {}
        for root, _, names in os.walk(tmp):
            for name in names:
                p = os.path.join(root, name)
                fsync_file(p)
                files[os.path.relpath(p, tmp)] = {
                    "sha256": file_sha256(p), "bytes": os.path.getsize(p)}
        return files

    def _write_zip_payload(self, tmp: str, job: _SaveJob) -> Dict[str, dict]:
        from deeplearning4j_tpu_torch.utils.serialization import (
            write_model_parts,
        )

        zpath = os.path.join(tmp, "model.zip")
        write_model_parts(
            zpath,
            model_class=job.model_class,
            conf_json=job.conf_json,
            params=job.params,
            states=job.states,
            updater_state=job.updater_state,
            meta=job.meta,
            training_state=job.training_state,
            compression=self.compression,
        )
        fsync_file(zpath)
        return {"model.zip": {"sha256": file_sha256(zpath),
                              "bytes": os.path.getsize(zpath)}}

    # ------------------------------------------------------------- retention
    def _retain(self) -> None:
        """keep-last-k + keep-every-n anchors; prune the rest. Runs after
        every successful commit (never deletes the checkpoint it just
        wrote: it is always within the last k >= 1)."""
        entries = self.checkpoints()
        if not entries:
            return
        keep = {s for s, _ in entries[-max(1, self.keep_last):]}
        if self.keep_every:
            keep |= {s for s, _ in entries if s % self.keep_every == 0}
        for step, path in entries:
            if step not in keep:
                shutil.rmtree(path, ignore_errors=True)
                self.stats["pruned"] += 1

    # ----------------------------------------------------------------- scan
    def checkpoints(self) -> List[Tuple[int, str]]:
        """Committed checkpoints, sorted ascending by step."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if not name.startswith(_CKPT_PREFIX) or name.endswith(".tmp"):
                continue
            try:
                step = int(name[len(_CKPT_PREFIX):])
            except ValueError:
                continue
            out.append((step, os.path.join(self.directory, name)))
        return sorted(out)

    def verify(self, path: str) -> Tuple[bool, str]:
        """Re-hash every manifested file. (ok, reason)."""
        mpath = os.path.join(path, MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return False, f"manifest unreadable: {e}"
        for rel, info in manifest.get("files", {}).items():
            p = os.path.join(path, rel)
            if not os.path.isfile(p):
                return False, f"missing payload file {rel}"
            if os.path.getsize(p) != info["bytes"]:
                return False, (f"{rel}: size {os.path.getsize(p)} != "
                               f"manifested {info['bytes']}")
            if file_sha256(p) != info["sha256"]:
                return False, f"{rel}: sha256 mismatch"
        return True, "ok"

    def read_manifest(self, path: str) -> Dict[str, Any]:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)

    def latest_intact(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Newest checkpoint that passes verification, scanning backwards
        with a LOUD warning per corrupt candidate — fallback may cost
        history, silence may cost correctness."""
        for step, path in reversed(self.checkpoints()):
            ok, reason = self.verify(path)
            if ok:
                return path, self.read_manifest(path)
            logger.warning(
                "checkpoint %s is corrupt (%s); falling back to the "
                "previous retained checkpoint", path, reason)
        return None

    # -------------------------------------------------------------- restore
    def restore(self, path: str, net) -> Dict[str, Any]:
        """Restore checkpoint dir `path` into the existing `net` (must be
        built from the same configuration). Verifies first — an explicit
        restore of a corrupt checkpoint raises :class:`CheckpointCorrupt`
        rather than loading garbage."""
        ok, reason = self.verify(path)
        if not ok:
            raise CheckpointCorrupt(f"{path}: {reason}")
        manifest = self.read_manifest(path)
        if manifest.get("backend", "zip") == "zip":
            from deeplearning4j_tpu_torch.utils.serialization import (
                ModelSerializer,
            )

            ts = ModelSerializer.load_into(net,
                                           os.path.join(path, "model.zip"))
        else:
            ts = self._restore_sharded(path, net)
        return {
            "step": int(manifest.get("step", ts.get("step", 0) or 0)),
            "epoch": int(ts.get("epoch", manifest.get("epoch", 0)) or 0),
            "iterator_state": ts.get("iterator_state",
                                     manifest.get("iterator_state")),
            "path": path,
        }

    def _restore_sharded(self, path: str, net) -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc

        if net.params is None:
            net.init()
        state = sc.restore_pytree(os.path.join(path, "state"), {
            "params": net.params, "states": net.states,
            "updater": net.updater_state}, device=net.device)
        net.params = state["params"]
        net.states = state["states"]
        net.updater_state = state["updater"]
        with open(os.path.join(path, "training_state.json")) as f:
            ts = json.load(f)
        net.restore_training_state(ts)
        return ts

    def restore_latest(self, net) -> Optional[Dict[str, Any]]:
        """Restore the newest intact checkpoint into `net`; None when the
        directory holds nothing restorable (fresh run)."""
        found = self.latest_intact()
        if found is None:
            return None
        path, _ = found
        return self.restore(path, net)
