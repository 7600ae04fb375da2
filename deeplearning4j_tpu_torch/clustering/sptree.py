"""The space-partitioning tree for Barnes-Hut of the port (counterpart:
``deeplearning4j_tpu/clustering/sptree.py`` — ``SPTree``).

Host numpy, as in the JAX package: cells of 2^d children with a centre of
mass and a point count; ``compute_non_edge_forces`` treats a cell as one
point when its extent over the distance is below theta.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SPTree:
    __slots__ = (
        "center", "width", "dim", "cum_size", "center_of_mass", "point",
        "point_index", "children", "is_leaf",
    )

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.dim = len(self.center)
        self.cum_size = 0
        self.center_of_mass = np.zeros(self.dim)
        self.point: Optional[np.ndarray] = None
        self.point_index = -1
        self.children: Optional[List[Optional["SPTree"]]] = None
        self.is_leaf = True

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, data: np.ndarray) -> "SPTree":
        data = np.asarray(data, np.float64)
        mins, maxs = data.min(0), data.max(0)
        center = (mins + maxs) / 2.0
        width = np.maximum((maxs - mins) / 2.0, 1e-10) * (1.0 + 1e-5)
        tree = cls(center, width)
        for i, p in enumerate(data):
            tree.insert(p, i)
        return tree

    def _child_index(self, point: np.ndarray) -> int:
        idx = 0
        for d in range(self.dim):
            if point[d] > self.center[d]:
                idx |= 1 << d
        return idx

    def _subdivide(self) -> None:
        self.children = [None] * (1 << self.dim)
        self.is_leaf = False

    def _make_child(self, ci: int) -> "SPTree":
        offset = np.array(
            [(1 if (ci >> d) & 1 else -1) for d in range(self.dim)], np.float64
        )
        return type(self)(self.center + offset * self.width / 2.0, self.width / 2.0)

    def insert(self, point: np.ndarray, index: int) -> None:
        point = np.asarray(point, np.float64)
        # update center of mass (SpTree.insert)
        self.center_of_mass = (
            self.center_of_mass * self.cum_size + point
        ) / (self.cum_size + 1)
        self.cum_size += 1
        if self.is_leaf and self.point is None:
            self.point = point
            self.point_index = index
            return
        if self.is_leaf:
            # duplicate point guard: if identical, keep merged in this cell
            if np.allclose(self.point, point, atol=1e-12):
                return
            old_point, old_index = self.point, self.point_index
            self.point, self.point_index = None, -1
            self._subdivide()
            self._insert_into_child(old_point, old_index)
        self._insert_into_child(point, index)

    def _insert_into_child(self, point, index):
        ci = self._child_index(point)
        if self.children[ci] is None:
            self.children[ci] = self._make_child(ci)
        self.children[ci].insert(point, index)

    # -- Barnes-Hut force (SpTree.computeNonEdgeForces) --------------------
    def compute_non_edge_forces(
        self, point: np.ndarray, theta: float, neg_f: np.ndarray
    ) -> float:
        """Accumulate repulsive force for `point` into neg_f; returns the
        contribution to the normalization constant sum_Q."""
        if self.cum_size == 0:
            return 0.0
        diff = point - self.center_of_mass
        dist2 = float(diff @ diff)
        max_width = float(self.width.max()) * 2.0  # full cell extent
        if self.is_leaf or max_width * max_width < theta * theta * dist2:
            if self.is_leaf and self.point is not None and dist2 < 1e-24:
                return 0.0  # the point itself
            q = 1.0 / (1.0 + dist2)
            mult = self.cum_size * q
            sum_q = mult
            neg_f += mult * q * diff
            return sum_q
        sum_q = 0.0
        for child in self.children:
            if child is not None:
                sum_q += child.compute_non_edge_forces(point, theta, neg_f)
        return sum_q
