"""VectorStore: an online-mutable vector index with atomic generation
swaps (counterpart: ``deeplearning4j_tpu/retrieval/store.py``, all of
it).

Writers mutate a STAGING arena — a slot-addressed ``[capacity + 1, dim]``
device tensor (row ``capacity`` a zero trash row, the pack's filler)
written in place under the store's mutation lock only — and a host
master copy (the authoritative rows, the duplicate-id rule's witness);
readers search an IMMUTABLE published
:class:`~deeplearning4j_tpu_torch.retrieval.index.IndexSnapshot`.
``publish()`` packs the live slots into a FRESH device tensor
(``index_select``, never a view of staging), optionally trains the IVF
quantizer on it, and swaps the published reference atomically: an
in-flight search keeps the old generation's tensors, so a swap fails no
admitted search. Everything runs on the current stream of the store's
device, so a later in-place staging write is ordered after every pack
that read staging before it, and the caching allocator never hands out
a tensor a queued search still reads.

An upsert with the same id twice keeps the last row, in the host master
(numpy assignment) and in staging alike: staging is written once per
distinct slot, with that slot's last row.

Publishes are gated like promotions: a latched
``online/drift.DriftMonitor`` alarm VETOES the publish
(:class:`PublishVetoed` — journaled, counted, the published generation
unmoved). Feeds ride ``online/stream.StreamSource``: one
:meth:`feed_once` is one poll window of upsert/delete batches, then a
gated publish.

Capacity is ``DL4J_TPU_ANN_ROWS``, or when that is 0 the closed form
``ops/memory.ann_arena_rows`` on the device's memory. The store lives on
``device`` (the card unless the caller passes ``device="cpu"``): host
arrays are uploaded once, tensors on that device stay there (one copy
down to the master), and a tensor on another device raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import memory
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size
from deeplearning4j_tpu_torch.retrieval.index import (
    ExactIndex,
    IndexSnapshot,
    IVFIndex,
    measure_recall,
)
from deeplearning4j_tpu_torch.retrieval.stats import RetrievalStats


class IndexFullError(RuntimeError):
    """No free slot for a new id — the arena is at capacity."""


class PublishVetoed(RuntimeError):
    """A latched drift alarm blocked the publish; the previously
    published generation keeps serving (a veto is not an outage)."""


def _resolve_capacity(dim: int, capacity: Optional[int],
                      device: torch.device) -> int:
    if capacity is not None and int(capacity) > 0:
        return int(capacity)
    rows = envknob.get_int("DL4J_TPU_ANN_ROWS")
    if rows and rows > 0:
        return int(rows)
    return memory.ann_arena_rows(dim, device=device)


class VectorStore:
    """One named, online-mutable ANN index (``kind`` = ``exact``/``ivf``)."""

    def __init__(self, dim: int, *, capacity: Optional[int] = None,
                 kind: str = "ivf", metric: str = "cosine",
                 clusters: Optional[int] = None,
                 nprobe: Optional[int] = None, ivf_iters: int = 25,
                 min_ivf_rows: int = 32, name: str = "index",
                 stats: Optional[RetrievalStats] = None,
                 device=None) -> None:
        if kind not in ("exact", "ivf"):
            raise ValueError(f"kind must be exact|ivf, got {kind!r}")
        if metric not in ("cosine", "ip"):
            raise ValueError(f"metric must be cosine|ip, got {metric!r}")
        self.device = resolve_device(device)
        self.name = name
        self.dim = int(dim)
        self.kind = kind
        self.metric = metric
        self.capacity = _resolve_capacity(self.dim, capacity, self.device)
        self.min_ivf_rows = int(min_ivf_rows)
        self.retrieval_stats = stats or RetrievalStats()
        obs_registry.default_registry().register_ledger(
            self, "retrieval_stats", self.retrieval_stats)
        self._exact = ExactIndex()
        self._ivf = IVFIndex(clusters=clusters, nprobe=nprobe,
                             iters=ivf_iters)
        # host master (the authoritative copy)
        self._host_vecs = np.zeros((self.capacity, self.dim), np.float32)
        self._ids = np.full(self.capacity, -1, np.int64)
        self._id2slot: Dict[int, int] = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        # staging arena: slot-addressed, trash row at index `capacity`,
        # written in place under _mut only
        self._staging = torch.zeros((self.capacity + 1, self.dim),
                                    dtype=torch.float32, device=self.device)
        self._mut = threading.Lock()
        self._pub = threading.Lock()  # serializes whole publishes
        self._snapshot = self._empty_snapshot()
        # the last publish's host seconds by stage (pack, then the IVF
        # build's: k-means++ seeding, Lloyd steps, assignment, members)
        self.last_publish: Dict[str, Any] = {}

    # -- snapshot plumbing -------------------------------------------------

    def _empty_snapshot(self) -> IndexSnapshot:
        n_pad = bucket_size(1)
        return IndexSnapshot(
            vecs=torch.zeros((n_pad, self.dim), dtype=torch.float32,
                             device=self.device),
            ids=np.full(n_pad, -1, np.int64), n=0, generation=0,
            metric=self.metric)

    @property
    def snapshot(self) -> IndexSnapshot:
        """The current published generation (immutable; safe to search
        without any lock — a concurrent publish swaps the reference,
        never the tensors)."""
        return self._snapshot

    @property
    def rows(self) -> int:
        return len(self._id2slot)

    @property
    def generation(self) -> int:
        return self._snapshot.generation

    # -- mutation plane (staging arena + host master) ----------------------

    def _norm_rows(self, vecs):
        """(host rows, device rows or None): a host array is normalized
        on the host (the JAX package's arithmetic) and uploaded once into
        staging from the master; a tensor on the store's device is
        normalized there and copied once to the master. A tensor on
        another device raises."""
        if not torch.is_tensor(vecs):
            rows = np.array(vecs, np.float32, copy=True).reshape(-1, self.dim)
            if self.metric == "cosine":
                norms = np.linalg.norm(rows, axis=1, keepdims=True)
                rows = rows / np.maximum(norms, 1e-12)
            return rows, None
        if vecs.device != self.device:
            raise ValueError(f"rows on {vecs.device}, the store "
                             f"{self.name!r} on {self.device}")
        rows_d = vecs.to(torch.float32).reshape(-1, self.dim)
        if self.metric == "cosine":
            rows_d = rows_d / torch.clamp(torch.linalg.vector_norm(
                rows_d, dim=1, keepdim=True), min=1e-12)
        return rows_d.cpu().numpy(), rows_d

    def _write_staging(self, slots, rows_d=None) -> None:
        """Write the rows at ``slots`` into staging, each slot once with
        its LAST row (the master's numpy assignment keeps the last row of
        a slot listed twice): from the master, or from the device rows."""
        s = np.asarray(slots, np.int64)
        uniq, first_rev = np.unique(s[::-1], return_index=True)
        if rows_d is None:
            rows = torch.from_numpy(self._host_vecs[uniq]).to(self.device)
        else:
            last = torch.from_numpy(len(s) - 1 - first_rev).to(self.device)
            rows = rows_d.index_select(0, last)
        self._staging.index_copy_(
            0, torch.from_numpy(uniq).to(self.device), rows)

    def upsert(self, ids, vecs) -> int:
        """Insert-or-replace rows by external id. Returns rows written."""
        id_arr = np.asarray(ids, np.int64).reshape(-1)
        rows, rows_d = self._norm_rows(vecs)
        if rows.shape[0] != id_arr.shape[0]:
            raise ValueError(
                f"{id_arr.shape[0]} ids vs {rows.shape[0]} vectors")
        with self._mut:
            slots = []
            for ext in id_arr:
                ext = int(ext)
                slot = self._id2slot.get(ext)
                if slot is None:
                    if not self._free:
                        raise IndexFullError(
                            f"index {self.name!r} full at "
                            f"{self.capacity} rows")
                    slot = self._free.pop()
                    self._id2slot[ext] = slot
                    self._ids[slot] = ext
                slots.append(slot)
            self._host_vecs[slots] = rows
            self._write_staging(slots, rows_d)
        self.retrieval_stats.bump("upserts", len(slots))
        return len(slots)

    def delete(self, ids) -> int:
        """Drop rows by external id (unknown ids ignored). Returns rows
        dropped."""
        id_arr = np.asarray(ids, np.int64).reshape(-1)
        with self._mut:
            slots = []
            for ext in id_arr:
                slot = self._id2slot.pop(int(ext), None)
                if slot is None:
                    continue
                slots.append(slot)
                self._ids[slot] = -1
                self._free.append(slot)
            if slots:
                self._host_vecs[slots] = 0.0
                self._staging.index_fill_(
                    0, torch.tensor(slots, device=self.device), 0.0)
        if slots:
            self.retrieval_stats.bump("deletes", len(slots))
        return len(slots)

    # -- publish plane (generation swap) -----------------------------------

    def publish(self, drift=None, force: bool = False) -> IndexSnapshot:
        """Pack live slots into a fresh immutable generation and swap it
        in atomically. ``drift`` (an ``online/drift.DriftMonitor``) with
        a latched/firing alarm VETOES the publish unless ``force``."""
        if drift is not None and not force:
            verdict = drift.check()
            if verdict.get("alarmed"):
                self.retrieval_stats.bump("publish_vetoes")
                obs_journal.event(
                    "retrieval.publish_veto", index=self.name,
                    generation=self._snapshot.generation,
                    max_z=verdict.get("max_z"))
                raise PublishVetoed(
                    f"index {self.name!r}: drift alarm "
                    f"(max_z={verdict.get('max_z')}) vetoed the publish; "
                    f"generation {self._snapshot.generation} keeps serving")
        with self._pub:
            t0 = time.perf_counter()
            with self._mut:
                live = sorted(self._id2slot.values())
                n = len(live)
                # n_pad >= n + 1 guarantees at least one zero pad row —
                # the IVF member-table sentinel
                n_pad = bucket_size(n + 1)
                slots = np.full(n_pad, self.capacity, np.int64)
                slots[:n] = live
                ids = np.full(n_pad, -1, np.int64)
                ids[:n] = self._ids[slots[:n]]
                # a new tensor: later in-place staging writes, queued
                # after this read on the same stream, never reach it
                packed = self._staging.index_select(
                    0, torch.from_numpy(slots).to(self.device))
                gen = self._snapshot.generation + 1
            snap = IndexSnapshot(vecs=packed, ids=ids, n=n, generation=gen,
                                 metric=self.metric)
            timings: Dict[str, Any] = {"pack_s": time.perf_counter() - t0}
            if self.kind == "ivf" and n >= self.min_ivf_rows:
                snap = self._ivf.build(snap)
                timings.update(self._ivf.last_build)
            with self._mut:
                self._snapshot = snap
            self.last_publish = timings
        self.retrieval_stats.bump("publishes")
        self.retrieval_stats.set("generation", gen)
        self.retrieval_stats.set("rows", n)
        obs_journal.event("retrieval.publish", index=self.name,
                          generation=gen, rows=n,
                          ivf=snap.centroids is not None)
        return snap

    # -- search plane (lock-free over the published generation) -----------

    def search(self, queries, k: int = 10,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the CURRENT published generation. Returns
        ``(ids [B, k] int64, scores [B, k] float32)``; id -1 marks
        fewer-than-k live rows."""
        snap = self._snapshot
        if self.kind == "ivf" and snap.centroids is not None:
            ids, scores = self._ivf.search(snap, queries, k, nprobe=nprobe)
        else:
            ids, scores = self._exact.search(snap, queries, k)
        self.retrieval_stats.bump("search_requests")
        self.retrieval_stats.bump("search_rows", int(ids.shape[0]))
        return ids, scores

    def search_exact(self, queries, k: int = 10):
        """The oracle path, always exhaustive — recall probes and tests
        compare against this on the SAME generation."""
        return self._exact.search(self._snapshot, queries, k)

    def probe_recall(self, queries, k: int = 10) -> float:
        """Measured recall@k of this store's probe path vs the exact
        oracle on the current generation (never assumed)."""
        snap = self._snapshot
        if snap.centroids is None:
            recall = 1.0  # exact path IS the oracle
        else:
            recall = measure_recall(snap, self._ivf, queries, k)
        self.retrieval_stats.bump("recall_probes")
        self.retrieval_stats.set("last_recall", recall)
        return recall

    # -- online feed (StreamSource loop) -----------------------------------

    def apply_batch(self, batch) -> Tuple[int, int]:
        """One feed batch -> (upserted, deleted). Accepts a DataSet
        (features = vectors, labels = ids; features None => labels are
        ids to DELETE) or an ('upsert'|'delete', ...) tuple."""
        if isinstance(batch, tuple) and batch and isinstance(batch[0], str):
            op = batch[0]
            if op == "delete":
                return 0, self.delete(batch[1])
            if op == "upsert":
                return self.upsert(batch[1], batch[2]), 0
            raise ValueError(f"unknown feed op {op!r}")
        feats = getattr(batch, "features", None)
        labels = getattr(batch, "labels", None)
        if labels is None:
            raise ValueError(
                "feed batch needs labels (external ids); got "
                f"{type(batch).__name__}")
        if feats is None:
            return 0, self.delete(labels)
        return self.upsert(labels, feats), 0

    def feed_once(self, stream, drift=None, publish: bool = True) -> dict:
        """Drain ONE StreamSource poll window (ends when the feed idles
        ``DL4J_TPU_ONLINE_IDLE_S``), observing vectors into ``drift``
        before they land, then publish gated on the drift verdict.
        Returns a window report; a veto rides it as ``vetoed=True``
        (the generation field then names the UNMOVED generation)."""
        upserted = deleted = batches = 0
        for batch in stream:
            feats = getattr(batch, "features", None)
            if drift is not None and feats is not None:
                drift.observe(np.asarray(feats, np.float32).reshape(
                    -1, self.dim))
            u, d = self.apply_batch(batch)
            upserted += u
            deleted += d
            batches += 1
            self.retrieval_stats.bump("feed_batches")
        self.retrieval_stats.bump("feed_windows")
        report = {"batches": batches, "upserted": upserted,
                  "deleted": deleted, "published": False, "vetoed": False,
                  "generation": self._snapshot.generation}
        if publish and batches:
            try:
                snap = self.publish(drift=drift)
                report.update(published=True, generation=snap.generation)
            except PublishVetoed:
                report.update(vetoed=True)
        return report

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Capacity/row-count report for ``/models`` — host-side ints
        only, beside the serving engine's ``kv_report``."""
        snap = self._snapshot
        return {
            "kind": self.kind,
            "metric": self.metric,
            "dim": self.dim,
            "capacity": self.capacity,
            "rows": self.rows,
            "generation": snap.generation,
            "ivf_built": snap.centroids is not None,
            "clusters": (int(snap.centroids.shape[0])
                         if snap.centroids is not None else 0),
            "nprobe": envknob.get_int("DL4J_TPU_ANN_NPROBE"),
            "arena_bytes": (self.capacity + 1) * memory.ann_row_bytes(
                self.dim),
        }
