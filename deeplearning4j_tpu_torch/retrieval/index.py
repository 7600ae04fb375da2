"""Vector indexes over a device arena: the exact top-k oracle and IVF
probing (counterpart: ``deeplearning4j_tpu/retrieval/index.py``, all of
it).

Two index families over ONE immutable published snapshot layout
(:class:`IndexSnapshot`, produced by ``retrieval/store.VectorStore``
publishes):

- :class:`ExactIndex` — ``scores = q @ vecs[:n].T`` and ``torch.topk``
  over the live rows. Exact by construction: the oracle every IVF recall
  number is measured against.
- :class:`IVFIndex` — a k-means coarse quantizer
  (``clustering/kmeans.KMeansClustering`` on the arena's device) built at
  publish time; a query scores its ``DL4J_TPU_ANN_NPROBE`` nearest
  clusters and ranks only their members: a coarse product, a gather of
  the candidate rows (``index_select``) and a batched product.

These are the plain products and selections the JAX package computes
outside any Pallas kernel (``_exact_topk`` and ``_ivf_topk`` are XLA), so
the port runs them as PyTorch ops; no hand-written kernel is involved.

Snapshot layout (the JAX package's): the packed arena is
``[n_pad, dim]`` with rows ``>= n`` zero, ``n_pad = bucket_size(n + 1)``;
IVF member tables pad each cluster's row list to ``cap_per =
bucket_size(largest cluster)`` with the sentinel ``n_pad - 1``, always a
zero pad row, and sentinel scores are masked to ``-inf`` before the
top-k. Results with fewer live rows than k carry ``-inf`` scores, which
surface as id -1. The JAX package pads query batches up the bucket
ladder to bound its retraces; eager PyTorch has none to bound, and a
zero query row changes no other row's answer, so the port does not pad
them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size

_EPS = 1e-12
# bytes of gathered candidate rows one IVF search block may hold
GATHER_BYTES = 1 << 30


@dataclass(frozen=True)
class IndexSnapshot:
    """One immutable published index generation. ``vecs`` is the packed
    device arena [n_pad, dim] (rows >= n zero); ``ids`` the aligned
    external ids (int64 on the host, -1 on pad rows); the IVF fields
    (``centroids`` [K, dim], ``members`` [K, cap_per] int64, on the
    arena's device) are None on exact-only publishes."""

    vecs: Any
    ids: np.ndarray
    n: int
    generation: int
    metric: str = "cosine"
    centroids: Any = None
    members: Any = None

    @property
    def dim(self) -> int:
        return int(self.vecs.shape[1])

    @property
    def n_pad(self) -> int:
        return int(self.vecs.shape[0])

    @property
    def cap_per(self) -> int:
        return 0 if self.members is None else int(self.members.shape[1])


def _normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def _exact_topk(q, vecs, n: int, k: int, cosine: bool):
    """Scores over the n live rows -> top-k (scores, packed row indices);
    past n live rows the top-k is filled with -inf (pad rows, which can
    never win)."""
    if cosine:
        q = _normalize(q)
    scores = q @ vecs[:n].T
    if k > n:
        scores = torch.cat([scores, scores.new_full(
            (scores.shape[0], k - n), float("-inf"))], dim=1)
    top = torch.topk(scores, k, dim=1)
    return top.values, top.indices


def _ivf_topk(q, vecs, centroids, members, k: int, nprobe: int,
              cosine: bool):
    """Coarse-probe then rank: top-nprobe centroids -> gather member rows
    -> exact scores on the candidate set only. Sentinel member slots
    (n_pad - 1, a zero pad row) masked to -inf."""
    if cosine:
        q = _normalize(q)
    probe = torch.topk(q @ centroids.T, nprobe, dim=1).indices  # [B, np]
    cand = members[probe].reshape(q.shape[0], -1)               # [B, M]
    cvecs = vecs.index_select(0, cand.reshape(-1)).view(
        q.shape[0], cand.shape[1], vecs.shape[1])              # [B, M, d]
    scores = torch.bmm(cvecs, q[:, :, None])[:, :, 0]
    scores = scores.masked_fill(cand == vecs.shape[0] - 1, float("-inf"))
    top = torch.topk(scores, k, dim=1)
    return top.values, torch.gather(cand, 1, top.indices)


def _as_queries(queries, dim: int, device: torch.device) -> torch.Tensor:
    """[B, dim] f32 queries on the arena's device: host arrays are
    uploaded; a tensor on another device raises."""
    if torch.is_tensor(queries):
        if queries.device != device:
            raise ValueError(f"queries on {queries.device}, the index on "
                             f"{device}")
        q = queries.to(torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(
            np.asarray(queries, np.float32)))
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or q.shape[1] != dim:
        raise ValueError(f"queries must be [B, {dim}], got "
                         f"{tuple(q.shape)}")
    return q.to(device)


def _finalize(snap: IndexSnapshot, scores, rows):
    """Host readback + slot->external-id mapping; -inf entries (fewer
    than k live rows) surface as id -1."""
    scores = scores.cpu().numpy()
    rows = rows.cpu().numpy()
    ids = snap.ids[rows]
    ids = np.where(np.isfinite(scores), ids, -1)
    return ids, scores


class ExactIndex:
    """Exhaustive batched top-k — the correctness oracle (the
    reference's wordsNearest full scan, on the device)."""

    kind = "exact"

    def search(self, snap: IndexSnapshot, queries, k: int = 10):
        q = _as_queries(queries, snap.dim, snap.vecs.device)
        k_eff = min(int(k), snap.n_pad)
        scores, rows = _exact_topk(q, snap.vecs, snap.n, k_eff,
                                   snap.metric == "cosine")
        return _finalize(snap, scores, rows)


class IVFIndex:
    """Inverted-file probing over a k-means coarse quantizer. Recall is
    a property of (clusters, nprobe, data) — ``measure_recall`` reports
    it against the exact oracle on the SAME snapshot, never assumed."""

    kind = "ivf"

    def __init__(self, clusters: Optional[int] = None,
                 nprobe: Optional[int] = None, seed: int = 0,
                 iters: int = 25) -> None:
        self.clusters = clusters
        self.nprobe = nprobe
        self.seed = seed
        self.iters = int(iters)
        self._exact = ExactIndex()
        # the last build's host seconds by stage, iterations and layout
        self.last_build: Dict[str, Any] = {}

    def _n_clusters(self, n: int) -> int:
        k = self.clusters
        if k is None:
            k = envknob.get_int("DL4J_TPU_ANN_CLUSTERS")
        if not k or k <= 0:
            k = int(np.sqrt(max(1, n)))
        return max(1, min(int(k), max(1, n)))

    def _n_probe(self, n_clusters: int, override=None) -> int:
        p = override if override is not None else self.nprobe
        if p is None:
            p = envknob.get_int("DL4J_TPU_ANN_NPROBE")
        return max(1, min(int(p), n_clusters))

    def build(self, snap: IndexSnapshot) -> IndexSnapshot:
        """Train the coarse quantizer on the snapshot's live rows, on
        their device, and attach centroids and padded member tables. A
        cluster's members are its rows in ascending order (a stable sort
        by cluster), the JAX package's table bit for bit."""
        from deeplearning4j_tpu_torch.clustering.kmeans import (
            KMeansClustering,
        )

        n, n_pad = snap.n, snap.n_pad
        if n < 1:
            raise ValueError("cannot build an IVF quantizer over 0 rows")
        kc = self._n_clusters(n)
        km = KMeansClustering(kc, max_iterations=self.iters, seed=self.seed,
                              device=snap.vecs.device)
        km.fit(snap.vecs[:n])
        t0 = time.perf_counter()
        assign = km.device_assignments
        counts = torch.bincount(assign, minlength=kc)
        cap_per = bucket_size(max(1, int(counts.max())))
        order = torch.sort(assign, stable=True).indices
        cluster = assign[order]
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(n, device=assign.device) - starts[cluster]
        members = torch.full((kc, cap_per), n_pad - 1, dtype=torch.int64,
                             device=assign.device)
        members[cluster, slot] = order
        centroids = km.device_centers
        if snap.metric == "cosine":
            centroids = _normalize(centroids)
        members_s = time.perf_counter() - t0
        self.last_build = dict(km.timings, members_s=members_s,
                               iterations=km.iterations_run, clusters=kc,
                               cap_per=cap_per)
        return IndexSnapshot(
            vecs=snap.vecs, ids=snap.ids, n=n, generation=snap.generation,
            metric=snap.metric, centroids=centroids.to(torch.float32),
            members=members)

    def search(self, snap: IndexSnapshot, queries, k: int = 10,
               nprobe: Optional[int] = None):
        if snap.centroids is None:
            return self._exact.search(snap, queries, k)
        q = _as_queries(queries, snap.dim, snap.vecs.device)
        k_eff = min(int(k), snap.n_pad)
        probes = self._n_probe(int(snap.centroids.shape[0]), nprobe)
        # a block of queries gathers at most GATHER_BYTES of rows
        per_query = probes * snap.cap_per * snap.dim * 4
        block = max(1, GATHER_BYTES // per_query)
        parts = [_ivf_topk(q[i:i + block], snap.vecs, snap.centroids,
                           snap.members, k_eff, probes,
                           snap.metric == "cosine")
                 for i in range(0, q.shape[0], block)]
        scores = torch.cat([p[0] for p in parts])
        rows = torch.cat([p[1] for p in parts])
        return _finalize(snap, scores, rows)


def measure_recall(snap: IndexSnapshot, ivf: IVFIndex, queries,
                   k: int = 10) -> float:
    """recall@k of the IVF probe vs the exact oracle on the SAME
    snapshot — measured, never assumed."""
    exact_ids, _ = ExactIndex().search(snap, queries, k)
    ivf_ids, _ = ivf.search(snap, queries, k)
    hits, total = 0, 0
    for row_e, row_i in zip(exact_ids, ivf_ids):
        truth = set(int(i) for i in row_e if i >= 0)
        if not truth:
            continue
        got = set(int(i) for i in row_i if i >= 0)
        hits += len(truth & got)
        total += len(truth)
    return hits / total if total else 1.0
