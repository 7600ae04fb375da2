"""Random-walk iterators of the port (counterpart:
``deeplearning4j_tpu/graph/walks.py`` — ``NoEdgeHandling``,
``RandomWalkIterator``, ``WeightedRandomWalkIterator``).

Host-only numpy, as in the JAX package: one walk of ``walk_length`` steps
from each vertex in order, each step one draw of ``default_rng(seed)``
(uniform, or weighted by the edges' weights), so both packages walk the
same vertices.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgesException


class NoEdgeHandling(Enum):
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform walks of ``walk_length`` steps (``walk_length + 1``
    vertices), one from each vertex of [first_vertex, last_vertex)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 no_edge_handling: NoEdgeHandling =
                 NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 first_vertex: int = 0, last_vertex: Optional[int] = None):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.first_vertex = first_vertex
        self.last_vertex = (graph.num_vertices() if last_vertex is None
                            else last_vertex)

    def _dangling(self, cur: int) -> int:
        if self.no_edge_handling is NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED:
            return cur
        raise NoEdgesException(f"vertex {cur} has no edges mid-walk")

    def _next_vertex(self, cur: int, rng: np.random.Generator) -> int:
        if self.graph.get_vertex_degree(cur) == 0:
            return self._dangling(cur)
        return self.graph.get_random_connected_vertex(cur, rng)

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        for start in range(self.first_vertex, self.last_vertex):
            walk = np.empty((self.walk_length + 1,), np.int32)
            walk[0] = cur = start
            for t in range(1, self.walk_length + 1):
                cur = self._next_vertex(cur, rng)
                walk[t] = cur
            yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Walks whose steps choose an edge with probability proportional to
    its weight."""

    def _next_vertex(self, cur: int, rng: np.random.Generator) -> int:
        edges = self.graph.get_edges_out(cur)
        if not edges:
            return self._dangling(cur)
        weights = np.array([e.weight for e in edges], np.float64)
        return edges[int(rng.choice(len(edges),
                                    p=weights / weights.sum()))].dst
