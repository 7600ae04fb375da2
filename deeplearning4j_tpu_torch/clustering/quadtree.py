"""The 2-D space-partitioning tree of the port (counterpart:
``deeplearning4j_tpu/clustering/quadtree.py`` — ``QuadTree``): an
:class:`SPTree` held to two dimensions."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SPTree


class QuadTree(SPTree):
    """An SPTree in two dimensions (a unit cell at the origin by default)."""

    def __init__(self, center=None, width=None):
        if center is None:
            center = np.zeros(2)
        if width is None:
            width = np.ones(2)
        assert len(center) == 2, "QuadTree is strictly 2-D"
        super().__init__(center, width)

    @classmethod
    def build(cls, data: np.ndarray) -> "QuadTree":
        data = np.asarray(data, np.float64)
        assert data.shape[1] == 2, "QuadTree requires 2-D data"
        return super().build(data)
