"""Clustering (counterpart: ``deeplearning4j_tpu/clustering/``): the
cluster objects and ``KMeansClustering``, whose k-means builds the IVF
index's coarse quantizer (``retrieval/index.py``). The spatial trees
(``kdtree``, ``vptree``, ``sptree``, ``quadtree``) wait for the t-SNE
slice."""

from deeplearning4j_tpu_torch.clustering.cluster import (
    Cluster,
    ClusterSet,
    Point,
)
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering

__all__ = [
    "Cluster",
    "ClusterSet",
    "Point",
    "KMeansClustering",
]
