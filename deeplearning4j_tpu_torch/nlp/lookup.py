"""Embedding tables of the port (counterpart:
``deeplearning4j_tpu/nlp/lookup.py`` — ``InMemoryLookupTable``).

syn0, syn1 and syn1neg are numpy arrays on the host between fits, made
exactly as the JAX package makes them (``default_rng(seed)``, syn0 =
(U[0,1) - 0.5) / D, the other two zeros), so a fresh table is the same in
both packages bit for bit. ``Word2Vec.fit`` moves them to its device once
and brings them back at the end. The unigram table and the padded Huffman
path tensors are built here too; the queries (``vector``, ``similarity``,
``words_nearest``, ``words_nearest_sum``) run in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InMemoryLookupTable:
    def __init__(
        self,
        vocab: VocabCache,
        vector_length: int = 100,
        seed: int = 123,
        negative: float = 0.0,
        table_size: int = 100_000,
    ):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.negative = negative
        rng = np.random.default_rng(seed)
        n = max(1, vocab.num_words())
        self.syn0 = ((rng.random((n, vector_length)) - 0.5) / vector_length).astype(
            np.float32
        )
        self.syn1 = np.zeros((n, vector_length), np.float32)
        self.syn1neg = (
            np.zeros((n, vector_length), np.float32) if negative > 0 else None
        )
        self.table: Optional[np.ndarray] = (
            self._make_table(table_size) if negative > 0 else None
        )

    def _make_table(self, table_size: int, power: float = 0.75) -> np.ndarray:
        """Unigram table: word i fills a share of the ``table_size`` slots
        proportional to count^0.75."""
        counts = np.array(
            [w.count for w in self.vocab.vocab_words()], dtype=np.float64
        )
        if counts.size == 0:
            return np.zeros((table_size,), np.int32)
        probs = counts**power
        probs /= probs.sum()
        bounds = np.cumsum(probs)
        positions = (np.arange(table_size) + 0.5) / table_size
        return np.searchsorted(bounds, positions).astype(np.int32)

    # -- queries ----------------------------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return self.syn0[idx]

    def vectors(self, indices) -> np.ndarray:
        """syn0 rows ``[N, vector_length]`` of the given indices."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        return self.syn0[idx]

    def similarity(self, w1: str, w2: str) -> float:
        """Cosine similarity; nan for a word outside the vocabulary."""
        v1, v2 = self.vector(w1), self.vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = float(np.linalg.norm(v1) * np.linalg.norm(v2))
        if denom == 0.0:
            return 0.0
        return float(np.dot(v1, v2) / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """The ``top_n`` words of highest cosine similarity to a word (not
        itself) or to a vector."""
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            exclude = {word_or_vec}
            if v is None:
                return []
        else:
            v = np.asarray(word_or_vec, np.float32)
            exclude = set()
        norms = np.linalg.norm(self.syn0, axis=1)
        norms = np.where(norms == 0, 1.0, norms)
        sims = self.syn0 @ v / (norms * (np.linalg.norm(v) or 1.0))
        order = np.argsort(-sims)
        out: List[str] = []
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w in exclude:
                continue
            out.append(w)
            if len(out) >= top_n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str], negative: Sequence[str], top_n: int = 10) -> List[str]:
        """Analogy: the words nearest to sum(positive) - sum(negative),
        the query words left out."""
        v = np.zeros((self.vector_length,), np.float32)
        exclude = set(positive) | set(negative)
        for w in positive:
            vec = self.vector(w)
            if vec is not None:
                v += vec
        for w in negative:
            vec = self.vector(w)
            if vec is not None:
                v -= vec
        out = [w for w in self.words_nearest(v, top_n + len(exclude)) if w not in exclude]
        return out[:top_n]

    def huffman_tensors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(points [V, L] int32, codes [V, L] f32, mask [V, L] f32), every
        word's Huffman path padded to the longest, L."""
        words = self.vocab.vocab_words()
        L = max((len(w.codes) for w in words), default=1)
        V = len(words)
        points = np.zeros((V, L), np.int32)
        codes = np.zeros((V, L), np.float32)
        mask = np.zeros((V, L), np.float32)
        for i, w in enumerate(words):
            l = len(w.codes)
            points[i, :l] = w.points[:l]
            codes[i, :l] = w.codes[:l]
            mask[i, :l] = 1.0
        return points, codes, mask
