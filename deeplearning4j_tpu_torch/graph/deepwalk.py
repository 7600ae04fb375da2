"""DeepWalk of the port (counterpart: ``deeplearning4j_tpu/graph/deepwalk.py``
— ``build_graph_huffman`` and ``DeepWalk``).

A Huffman tree over the vertex degrees (a degree plays a word count's
part, clamped at 1, ties by vertex index), random walks as sentences,
and every (centre, context) pair of a walk's window through one
hierarchical-softmax skip-gram step: Word2Vec's :func:`hs_body` (an XLA
program in the JAX package, no Pallas kernel; PyTorch ops in place on
the tables here), at a constant learning rate. Walks and pairs are made
on the host (the pairs vectorised, in the JAX package's order); each
``fit_walks`` permutes them with ``default_rng(seed)``, copies them to
the device once and runs the batches as slices. The tables are numpy
between calls; ``save`` and ``load`` write and read the JAX package's
``.npz``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.walks import (
    NoEdgeHandling,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.nlp.huffman import build_huffman
from deeplearning4j_tpu_torch.nlp.vocab import VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import _pad_batch, hs_body
from deeplearning4j_tpu_torch.ops.device import resolve_device


def build_graph_huffman(degrees: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman codes over the vertex degrees: (points int32, codes f32,
    mask f32) [n, L], rows in vertex order."""
    n = len(degrees)
    words = [VocabWord(word=str(i), count=max(1.0, float(degrees[i])), index=i)
             for i in range(n)]
    build_huffman([words[i] for i in
                   sorted(range(n), key=lambda i: (-words[i].count, i))])
    L = max(len(w.codes) for w in words)
    points = np.zeros((n, L), np.int32)
    codes = np.zeros((n, L), np.float32)
    mask = np.zeros((n, L), np.float32)
    for w in words:
        l = len(w.codes)
        points[w.index, :l] = w.points[:l]
        codes[w.index, :l] = w.codes[:l]
        mask[w.index, :l] = 1.0
    return points, codes, mask


def walk_pairs(walks: Sequence[np.ndarray], window: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(centres, contexts) int32: every pair within ``window`` steps of one
    walk, walk by walk, centre by centre, contexts left to right."""
    walks = [np.asarray(w) for w in walks if len(w)]
    if not walks:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    flat = np.concatenate(walks)
    lens = np.array([len(w) for w in walks])
    ends = np.repeat(np.cumsum(lens), lens)
    starts = ends - np.repeat(lens, lens)
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    pos = np.arange(len(flat))[:, None] + offs[None, :]
    r, c = np.nonzero((pos >= starts[:, None]) & (pos < ends[:, None]))
    return flat[r].astype(np.int32), flat[pos[r, c]].astype(np.int32)


class DeepWalk:
    """DeepWalk with DL4J's options: vector_size, window_size,
    learning_rate, seed, batch_size. Trains on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.01, seed: int = 12345,
                 batch_size: int = 2048, device=None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.batch_size = batch_size
        self.num_vertices = 0
        self.vertex_vectors: Optional[np.ndarray] = None  # syn0
        self._syn1: Optional[np.ndarray] = None
        self._huffman: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._init_called = False
        # the last fit_walks: pairs, batches, host seconds of the pairs and
        # of the device loop (up to the tables' copy back)
        self.fit_stats: dict = {}

    def initialize(self, graph_or_degrees) -> "DeepWalk":
        """The degree Huffman tree and fresh tables: syn0 = (U[0,1) - 0.5)
        / D from ``default_rng(seed)``, syn1 zeros."""
        degrees = (graph_or_degrees.degrees()
                   if isinstance(graph_or_degrees, Graph)
                   else np.asarray(graph_or_degrees, np.int64))
        n = len(degrees)
        self.num_vertices = n
        self._huffman = build_graph_huffman(degrees)
        rng = np.random.default_rng(self.seed)
        self.vertex_vectors = ((rng.random((n, self.vector_size)) - 0.5)
                               / self.vector_size).astype(np.float32)
        self._syn1 = np.zeros((n, self.vector_size), np.float32)
        self._init_called = True
        return self

    def fit(self, graph: Graph, walk_length: int = 40, epochs: int = 1,
            weighted: bool = False) -> "DeepWalk":
        """One walk from every vertex per epoch (seed + epoch), then
        :meth:`fit_walks` on them."""
        if not self._init_called:
            self.initialize(graph)
        it_cls = WeightedRandomWalkIterator if weighted else RandomWalkIterator
        for epoch in range(epochs):
            self.fit_walks(list(it_cls(
                graph, walk_length, seed=self.seed + epoch,
                no_edge_handling=NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)))
        return self

    def fit_walks(self, walks: Sequence[np.ndarray]) -> "DeepWalk":
        """Train on walks as sentences: their window pairs, permuted by
        ``default_rng(seed)``, in batches of ``batch_size`` (the last one
        padded with its first pair, masked)."""
        if not self._init_called:
            raise RuntimeError("DeepWalk not initialized (call initialize first)")
        t0 = time.perf_counter()
        centers, contexts = walk_pairs(walks, self.window_size)
        n = len(centers)
        if not n:
            return self
        order = np.random.default_rng(self.seed).permutation(n)
        B = self.batch_size
        nb = -(-n // B)
        cols = [np.concatenate([c[:(nb - 1) * B],
                                _pad_batch(c[(nb - 1) * B:], B)])
                for c in (centers[order], contexts[order])]
        t1 = time.perf_counter()
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        P, C, M = self._huffman
        P, C, M = up(P.astype(np.int64)), up(C), up(M)
        syn0, syn1 = up(self.vertex_vectors), up(self._syn1)
        cen, cx = (up(c.astype(np.int64)) for c in cols)
        plive = up((np.arange(nb * B) < n).astype(np.float32))
        lr = float(torch.tensor(self.learning_rate, dtype=torch.float32))
        for bi in range(nb):
            sl = slice(bi * B, (bi + 1) * B)
            c = cen[sl]
            hs_body(syn0, syn1, cx[sl], P[c], C[c], M[c] * plive[sl, None],
                    lr)
        self.vertex_vectors = syn0.cpu().numpy()
        self._syn1 = syn1.cpu().numpy()
        self.fit_stats = {"pairs": n, "batches": nb, "pairs_s": t1 - t0,
                          "loop_s": time.perf_counter() - t1}
        return self

    # -- queries ----------------------------------------------------------
    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.vertex_vectors[idx]

    def similarity(self, v1: int, v2: int) -> float:
        """Cosine similarity of two vertices' vectors."""
        a, b = self.vertex_vectors[v1], self.vertex_vectors[v2]
        denom = float(np.linalg.norm(a) * np.linalg.norm(b)) or 1.0
        return float(np.dot(a, b) / denom)

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        v = self.vertex_vectors[idx]
        norms = np.linalg.norm(self.vertex_vectors, axis=1)
        norms = np.where(norms == 0, 1.0, norms)
        sims = self.vertex_vectors @ v / (norms * (np.linalg.norm(v) or 1.0))
        return [int(i) for i in np.argsort(-sims) if int(i) != idx][:top_n]

    # -- files ------------------------------------------------------------
    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` (``np.savez`` adds the suffix)."""
        np.savez(
            path,
            vertex_vectors=self.vertex_vectors,
            syn1=self._syn1,
            points=self._huffman[0],
            codes=self._huffman[1],
            mask=self._huffman[2],
            meta=np.array([self.vector_size, self.window_size,
                           self.num_vertices], np.int64),
            lr=np.array([self.learning_rate], np.float64),
        )

    @classmethod
    def load(cls, path: str, device=None) -> "DeepWalk":
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        vs, ws, n = (int(x) for x in data["meta"])
        dw = cls(vector_size=vs, window_size=ws,
                 learning_rate=float(data["lr"][0]), device=device)
        dw.num_vertices = n
        dw.vertex_vectors = data["vertex_vectors"]
        dw._syn1 = data["syn1"]
        dw._huffman = (data["points"], data["codes"], data["mask"])
        dw._init_called = True
        return dw
