"""Cluster model objects (counterpart:
``deeplearning4j_tpu/clustering/cluster.py``, all of it).

Capability mirror of the reference clustering/cluster package
(deeplearning4j-core/.../clustering/cluster/{Point,Cluster,ClusterSet}.java):
points with ids, clusters with centers + members, a ClusterSet grouping them
with nearest-cluster assignment. Host-side numpy objects, as in the JAX
package: the k-means math runs in ``clustering/kmeans.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Point:
    """Reference cluster/Point.java: id + label + array."""

    array: np.ndarray
    point_id: Optional[str] = None
    label: Optional[str] = None


@dataclass
class Cluster:
    """Reference cluster/Cluster.java: center + member points."""

    center: np.ndarray
    points: List[Point] = field(default_factory=list)
    cluster_id: int = 0

    def distance_to_center(self, p: Point) -> float:
        return float(np.linalg.norm(p.array - self.center))


class ClusterSet:
    """Reference cluster/ClusterSet.java."""

    def __init__(self, clusters: List[Cluster]):
        self.clusters = clusters

    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def nearest_cluster(self, p: Point) -> Cluster:
        dists = np.linalg.norm(self.centers() - p.array, axis=1)
        return self.clusters[int(np.argmin(dists))]

    def __len__(self) -> int:
        return len(self.clusters)
