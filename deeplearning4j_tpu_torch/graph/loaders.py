"""Edge-list loaders of the port (counterpart:
``deeplearning4j_tpu/graph/loaders.py`` — ``load_delimited_edges``,
``load_weighted_edges``).

Host-only: "src<delim>dst[<delim>weight]" lines into a :class:`Graph`,
blank lines and lines starting with the comment prefix skipped.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.api import Graph


def _edge_lines(path: str, delimiter: str, comment_prefix: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith(comment_prefix):
                yield line.split(delimiter)


def load_delimited_edges(path: str, num_vertices: int, delimiter: str = ",",
                         directed: bool = False,
                         comment_prefix: str = "//") -> Graph:
    """An unweighted edge list (any third column ignored)."""
    g = Graph(num_vertices, directed=directed)
    for parts in _edge_lines(path, delimiter, comment_prefix):
        g.add_edge(int(parts[0]), int(parts[1]))
    return g


def load_weighted_edges(path: str, num_vertices: int, delimiter: str = ",",
                        directed: bool = False,
                        comment_prefix: str = "//") -> Graph:
    """An edge list with the weight in the third column (1.0 if absent)."""
    g = Graph(num_vertices, directed=directed)
    for parts in _edge_lines(path, delimiter, comment_prefix):
        w = float(parts[2]) if len(parts) > 2 else 1.0
        g.add_edge(int(parts[0]), int(parts[1]), weight=w)
    return g
