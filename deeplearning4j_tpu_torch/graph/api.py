"""Graph structures of the port (counterpart:
``deeplearning4j_tpu/graph/api.py`` — ``Vertex``, ``Edge``, ``Graph``,
``NoEdgesException``).

Host-only, as in the JAX package: vertices with optional values,
directed or undirected weighted edges in adjacency lists (an undirected
edge is stored at both ends), degrees, and a uniform neighbour draw from
the caller's numpy generator (the walks' stream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, List, Optional, Sequence, TypeVar

import numpy as np

V = TypeVar("V")


@dataclass
class Vertex(Generic[V]):
    """A vertex: its index and an optional value."""

    idx: int
    value: Any = None


@dataclass
class Edge:
    """An edge: its ends, weight and whether it is directed."""

    src: int
    dst: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """An adjacency-list graph."""

    def __init__(self, num_vertices: int, directed: bool = False,
                 vertex_values: Optional[Sequence[Any]] = None):
        self.directed = directed
        self._vertices = [
            Vertex(i, vertex_values[i] if vertex_values is not None else None)
            for i in range(num_vertices)
        ]
        self._adj: List[List[Edge]] = [[] for _ in range(num_vertices)]

    def add_edge(self, src: int, dst: int, weight: float = 1.0,
                 directed: Optional[bool] = None) -> None:
        directed = self.directed if directed is None else directed
        self._adj[src].append(Edge(src, dst, weight, directed))
        if not directed and src != dst:
            self._adj[dst].append(Edge(dst, src, weight, directed))

    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._adj[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [e.dst for e in self._adj[idx]]

    def get_random_connected_vertex(self, idx: int,
                                    rng: np.random.Generator) -> int:
        """A uniformly drawn neighbour (one ``rng.integers`` draw)."""
        nbrs = self._adj[idx]
        if not nbrs:
            raise NoEdgesException(f"vertex {idx} has no outgoing edges")
        return nbrs[int(rng.integers(0, len(nbrs)))].dst

    def degrees(self) -> np.ndarray:
        return np.array([len(a) for a in self._adj], np.int64)


class NoEdgesException(Exception):
    """A walk reached a vertex with no edge out."""
