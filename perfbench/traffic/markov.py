"""Token data for every mix: a fixed random Markov chain (each token is
followed by one of ``successors`` fixed successors, uniformly), seeded by
the run's seed. A copy of ``chip_smoke.markov_tokens``; the successor
table is fixed (seed 1234), so every seed draws from the same chain.

Sizes never depend on the seed beyond their order: a mix with lengths
takes one fixed, evenly spread set of them per batch and lets the seed
permute it, so every seed asks for the same work.
"""

from __future__ import annotations

import numpy as np


def tokens(seed: int, shape, vocab: int, successors: int = 4) -> np.ndarray:
    """Token ids [..., T + 1] in [0, vocab): row starts drawn uniformly,
    each next token one of its ``successors`` fixed successors."""
    succ = np.random.default_rng(1234).integers(0, vocab, (vocab, successors))
    rng = np.random.default_rng(seed)
    *lead, t1 = shape
    rows = int(np.prod(lead))
    ids = np.empty((rows, t1), np.int64)
    ids[:, 0] = rng.integers(0, vocab, rows)
    pick = rng.integers(0, successors, (rows, t1))
    for j in range(1, t1):
        ids[:, j] = succ[ids[:, j - 1], pick[:, j]]
    return ids.reshape(shape)


def spread_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi], both ends included."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def padded_rows(seed: int, batches: int, rows: int, width: int, lo: int,
                vocab: int, pad_id: int = 0, successors: int = 4
                ) -> np.ndarray:
    """[batches, rows, width] ids in [1, vocab) with each batch's rows cut
    to the lengths of :func:`spread_lengths` (permuted by the seed) and
    ``pad_id`` after them."""
    ids = 1 + tokens(seed, (batches, rows, width), vocab - 1, successors)
    rng = np.random.default_rng([seed, 7])
    base = spread_lengths(rows, lo, width)
    lengths = np.stack([rng.permutation(base) for _ in range(batches)])
    ids[np.arange(width)[None, None] >= lengths[..., None]] = pad_id
    return ids
