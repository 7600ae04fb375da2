"""K-means clustering on the caller's device (counterpart:
``deeplearning4j_tpu/clustering/kmeans.py``, all of it).

Capability mirror of the reference
(deeplearning4j-core/.../clustering/kmeans/KMeansClustering.java:31 over
algorithm/BaseClusteringAlgorithm.java): ``setup(k, maxIterations,
distanceFunction)``, then Lloyd iterations — assign every point to its
nearest center, recompute the centers — until max iterations or the
cost stops improving. Euclidean, manhattan and cosine distances, as the
reference's string ``distanceFunction``.

The same arithmetic as the JAX package, laid out for a million rows:

* k-means++ seeding keeps a running minimum of each row's squared
  distance to the centers drawn so far (the JAX package re-stacks the
  distances to every earlier center for each new one: O(k^2 n d) on the
  host). A minimum does not depend on the order it is taken in, so the
  D^2 weights are the same; each new center's distances are computed on
  the device, and the draws come from ``np.random.default_rng(seed)``
  on the host with the JAX package's calls in its order (``integers``,
  then ``choice(n, p=d2 / total)``, or ``integers`` when the total is
  0), so both packages draw the same rows.
* The Lloyd step sums the rows by cluster (``index_add_``) instead of
  the JAX package's [N, K] one-hot product (4 GB at 1M x 1000); an
  empty cluster keeps its old center, the cost is the sum of each row's
  distance to its nearest center, and the convergence test is the JAX
  package's. Distances are taken in blocks of ``ROW_CHUNK`` rows.
* The last assignment is taken against the final centers.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
)
from deeplearning4j_tpu_torch.ops.device import resolve_device

# rows per distance block: [ROW_CHUNK, K] f32 is 1 GiB at K = 1,000
ROW_CHUNK = 1 << 18


def _distances(x: torch.Tensor, centers: torch.Tensor,
               distance: str) -> torch.Tensor:
    """[n, K] distances of a block of rows to the centers, in the JAX
    package's formulas."""
    if distance == "euclidean":
        return torch.sqrt(torch.clamp(
            (x * x).sum(1)[:, None] - 2.0 * (x @ centers.T)
            + (centers * centers).sum(1)[None, :], min=0.0))
    if distance == "manhattan":
        return torch.cdist(x, centers, p=1.0)
    if distance == "cosine":
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                             min=1e-12)
        cn = centers / torch.clamp(
            torch.linalg.vector_norm(centers, dim=1, keepdim=True), min=1e-12)
        return 1.0 - xn @ cn.T
    raise ValueError(f"unknown distance {distance}")


def _assign(x: torch.Tensor, centers: torch.Tensor,
            distance: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest center (the first on a tie) and its distance."""
    assign = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    mins = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(0, x.shape[0], ROW_CHUNK):
        m, a = _distances(x[i:i + ROW_CHUNK], centers, distance).min(1)
        mins[i:i + ROW_CHUNK] = m
        assign[i:i + ROW_CHUNK] = a
    return assign, mins


def _sq_dist_to(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n] squared euclidean distances of the rows to one point, as the
    JAX seeding takes them (``sum((x - c) ** 2)``)."""
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(0, x.shape[0], ROW_CHUNK):
        out[i:i + ROW_CHUNK] = torch.square(x[i:i + ROW_CHUNK] - c).sum(1)
    return out


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor, k: int,
                distance: str):
    """Assign, then update: new centers, the assignment and the cost."""
    assign, mins = _assign(x, centers, distance)
    counts = torch.bincount(assign, minlength=k).to(x.dtype)
    sums = torch.zeros_like(centers).index_add_(0, assign, x)
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return new_centers, assign, mins.sum()


class KMeansClustering:
    """`KMeansClustering.setup(k, maxIter, distance)` surface, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        distance: str = "euclidean",
        convergence_threshold: float = 1e-4,
        seed: int = 0,
        device=None,
    ):
        self.k = k
        self.max_iterations = max_iterations
        self.distance = distance
        self.convergence_threshold = convergence_threshold
        self.seed = seed
        self.device = resolve_device(device)
        self.centers_: Optional[np.ndarray] = None
        self.assignments_: Optional[np.ndarray] = None
        # the same two on the device, for callers that stay there
        self.device_centers: Optional[torch.Tensor] = None
        self.device_assignments: Optional[torch.Tensor] = None
        # the row indices k-means++ drew, in draw order
        self.seed_rows: Optional[list] = None
        self.iterations_run = 0
        # host seconds of the last fit's stages: seeding, the Lloyd
        # steps, the final assignment (each ends in a host read)
        self.timings: Dict[str, float] = {}

    @classmethod
    def setup(cls, k: int, max_iterations: int, distance: str = "euclidean",
              **kw) -> "KMeansClustering":
        return cls(k, max_iterations, distance, **kw)

    def _rows(self, points) -> torch.Tensor:
        """f32 rows on this clustering's device; a tensor elsewhere
        raises (no silent copy between devices)."""
        if torch.is_tensor(points):
            if points.device != self.device:
                raise ValueError(f"rows on {points.device}, k-means on "
                                 f"{self.device}")
            return points.to(torch.float32)
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(points, np.float32))).to(self.device)

    def fit(self, points) -> "KMeansClustering":
        """The clustering itself: seeding, Lloyd steps and the final
        assignment, leaving ``centers_``, ``assignments_`` (numpy and
        device copies) and ``iterations_run``."""
        x = self._rows(points)
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        centers = self._kmeanspp_init(x, rng)
        t1 = time.perf_counter()
        prev_cost = None
        for it in range(self.max_iterations):
            centers, _, cost = _lloyd_step(x, centers, self.k,
                                           self.distance)
            cost = float(cost)
            self.iterations_run = it + 1
            # distribution-variation convergence (reference's
            # ConvergenceCondition on iteration-over-iteration improvement)
            if prev_cost is not None and prev_cost - cost <= (
                self.convergence_threshold * max(1.0, prev_cost)
            ):
                break
            prev_cost = cost
        t2 = time.perf_counter()
        # final assignment against the FINAL centers (the loop's
        # assignment was computed from the pre-update centers)
        assign, _ = _assign(x, centers, self.distance)
        self.device_centers, self.device_assignments = centers, assign
        self.centers_ = centers.cpu().numpy()
        self.assignments_ = assign.cpu().numpy()
        self.timings = {"seed_s": t1 - t0, "lloyd_s": t2 - t1,
                        "assign_s": time.perf_counter() - t2}
        return self

    def apply_to(self, points) -> ClusterSet:
        """Run clustering (BaseClusteringAlgorithm.applyTo)."""
        if len(points) > 0 and isinstance(points[0], Point):
            pts = points
            x = np.stack([p.array for p in points]).astype(np.float32)
        else:
            x = points
            host = (points.cpu().numpy() if torch.is_tensor(points)
                    else np.asarray(points, np.float32))
            pts = [Point(host[i], point_id=str(i)) for i in range(len(host))]
        self.fit(x)
        clusters = [Cluster(self.centers_[j], cluster_id=j)
                    for j in range(self.k)]
        for i, a in enumerate(self.assignments_):
            clusters[int(a)].points.append(pts[i])
        return ClusterSet(clusters)

    def _kmeanspp_init(self, x: torch.Tensor,
                       rng: np.random.Generator) -> torch.Tensor:
        """k-means++ seeding (D^2-weighted) over a running minimum of D^2
        (module docstring); the draws on the host, the distances on the
        device."""
        n = x.shape[0]
        rows = [int(rng.integers(0, n))]
        d2 = None
        for _ in range(1, self.k):
            nearest = _sq_dist_to(x, x[rows[-1]])
            d2 = nearest if d2 is None else torch.minimum(d2, nearest)
            d2_host = d2.cpu().numpy()
            total = d2_host.sum()
            if total <= 0:  # fewer distinct points than k
                rows.append(int(rng.integers(0, n)))
                continue
            rows.append(int(rng.choice(n, p=d2_host / total)))
        self.seed_rows = rows
        return x[torch.tensor(rows, device=x.device)].clone()

    def predict(self, points) -> np.ndarray:
        x = self._rows(points)
        assign, _ = _assign(x, self.device_centers, self.distance)
        return assign.cpu().numpy()
