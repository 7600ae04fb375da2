"""The vantage-point tree of the port (counterpart:
``deeplearning4j_tpu/clustering/vptree.py`` — ``VPTree``).

Host numpy, as in the JAX package: a vantage point drawn from the tree's
own ``default_rng(seed)``, a median-radius split, and a k-nearest search
with tau pruning; euclidean, or cosine searched as euclidean on the
normalised rows. The same draws give the same tree, so ties resolve as in
the JAX package.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx):
        self.idx = idx
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, items: np.ndarray, distance: str = "euclidean", seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self.distance = distance
        if distance == "cosine":
            # Tau pruning requires the triangle inequality, which cosine
            # distance violates. On L2-NORMALIZED vectors, euclidean distance
            # is monotone in cosine distance (||a-b||^2 = 2*(1 - a.b)), so we
            # search in normalized-L2 space (metric) and report
            # cos_dist = l2^2 / 2 — exact same ranking, valid pruning.
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._search_items = self.items / np.maximum(norms, 1e-12)
        else:
            self._search_items = self.items
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.items))))

    def _prep_query(self, q: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            return q / max(float(np.linalg.norm(q)), 1e-12)
        return q

    def _report(self, l2: float) -> float:
        """Convert internal metric distance to the user-facing one."""
        return l2 * l2 / 2.0 if self.distance == "cosine" else l2

    def _dist(self, i: int, q: np.ndarray) -> float:
        """Metric (triangle-inequality-valid) distance used for the search."""
        return float(np.linalg.norm(self._search_items[i] - q))

    def _dist_ii(self, i: int, j: int) -> float:
        return self._dist(i, self._search_items[j])

    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[int(self._rng.integers(0, len(idxs)))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = np.array([self._dist_ii(i, vp) for i in rest])
        median = float(np.median(dists))
        node.threshold = median
        inside = [i for i, d in zip(rest, dists) if d < median]
        outside = [i for i, d in zip(rest, dists) if d >= median]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        """k nearest (distance, index) pairs, ascending (VPTree.search)."""
        query = self._prep_query(np.asarray(query, np.float64))
        heap: List[Tuple[float, int]] = []  # max-heap of (-d, idx)
        tau = [np.inf]

        def rec(node):
            if node is None:
                return
            d = self._dist(node.idx, query)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.idx))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d < node.threshold:
                rec(node.inside)
                if d + tau[0] >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau[0] <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        return sorted([(self._report(-d), i) for d, i in heap])

    def words_nearest(self, query, k: int, exclude_self: bool = True) -> List[int]:
        res = self.knn(query, k + (1 if exclude_self else 0))
        out = [i for d, i in res if not (exclude_self and d < 1e-12)]
        return out[:k]
