"""Graph embeddings of the port (counterpart: ``deeplearning4j_tpu/graph/``):
the adjacency-list graph, edge-list loaders, random-walk iterators and
DeepWalk (walks, then hierarchical-softmax skip-gram over vertices on
the device), with the degree-Huffman coding and the ``.npz`` file."""

from deeplearning4j_tpu_torch.graph.api import Edge, Graph, Vertex
from deeplearning4j_tpu_torch.graph.deepwalk import (
    DeepWalk,
    build_graph_huffman,
)
from deeplearning4j_tpu_torch.graph.loaders import (
    load_delimited_edges,
    load_weighted_edges,
)
from deeplearning4j_tpu_torch.graph.walks import (
    NoEdgeHandling,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)

__all__ = [
    "Edge",
    "Graph",
    "Vertex",
    "load_delimited_edges",
    "load_weighted_edges",
    "NoEdgeHandling",
    "RandomWalkIterator",
    "WeightedRandomWalkIterator",
    "DeepWalk",
    "build_graph_huffman",
]
