"""Clustering (counterpart: ``deeplearning4j_tpu/clustering/``): the
cluster objects and ``KMeansClustering``, whose k-means builds the IVF
index's coarse quantizer (``retrieval/index.py``), and the host-side
spatial trees: ``KDTree``, ``QuadTree``, ``SPTree`` (Barnes-Hut t-SNE's
repulsion) and ``VPTree`` (its input neighbours)."""

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
)
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.sptree import SPTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = [
    "Cluster",
    "ClusterSet",
    "Point",
    "KMeansClustering",
    "KDTree",
    "QuadTree",
    "SPTree",
    "VPTree",
]
