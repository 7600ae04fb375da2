"""The k-d tree of the port (counterpart:
``deeplearning4j_tpu/clustering/kdtree.py`` — ``KDTree``).

Host numpy, as in the JAX package: a balanced build by median splits,
inserts, nearest and k-nearest queries, and axis-aligned range queries.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "idx", "left", "right", "axis")

    def __init__(self, point, idx, axis):
        self.point = point
        self.idx = idx
        self.axis = axis
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    @classmethod
    def build(cls, points: np.ndarray) -> "KDTree":
        """Balanced build by recursive median split."""
        points = np.asarray(points, np.float64)
        tree = cls(points.shape[1])

        def rec(idxs, depth):
            if len(idxs) == 0:
                return None
            axis = depth % tree.dims
            order = idxs[np.argsort(points[idxs, axis])]
            mid = len(order) // 2
            node = _Node(points[order[mid]], int(order[mid]), axis)
            node.left = rec(order[:mid], depth + 1)
            node.right = rec(order[mid + 1 :], depth + 1)
            return node

        tree.root = rec(np.arange(len(points)), 0)
        tree.size = len(points)
        return tree

    def insert(self, point, idx: Optional[int] = None) -> None:
        point = np.asarray(point, np.float64)
        if idx is None:
            idx = self.size
        if self.root is None:
            self.root = _Node(point, idx, 0)
            self.size += 1
            return
        node = self.root
        depth = 0
        while True:
            axis = node.axis
            branch = "left" if point[axis] < node.point[axis] else "right"
            nxt = getattr(node, branch)
            if nxt is None:
                setattr(node, branch, _Node(point, idx, (depth + 1) % self.dims))
                self.size += 1
                return
            node = nxt
            depth += 1

    def nn(self, query) -> Tuple[float, int]:
        """Nearest neighbor: (distance, index)."""
        res = self.knn(query, 1)
        return res[0]

    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist

        def rec(node):
            if node is None:
                return
            d = float(np.linalg.norm(query - node.point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            axis = node.axis
            diff = query[axis] - node.point[axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            rec(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far)

        rec(self.root)
        return sorted([(-d, i) for d, i in heap])

    def range(self, lower, upper) -> List[int]:
        """All point indices inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[int] = []

        def rec(node):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.idx)
            axis = node.axis
            if node.point[axis] >= lower[axis]:
                rec(node.left)
            if node.point[axis] <= upper[axis]:
                rec(node.right)

        rec(self.root)
        return out
