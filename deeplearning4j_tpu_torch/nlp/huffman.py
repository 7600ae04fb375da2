"""Huffman codes for hierarchical softmax (counterpart:
``deeplearning4j_tpu/nlp/huffman.py`` — ``build_huffman``).

The word2vec.c two-pointer construction: the leaves, sorted by descending
count, are walked backwards while the new inner nodes are appended
forwards, and the two smallest counts are merged each time. Every leaf then
gets its code (branch bits, root first) and its points (inner-node rows of
syn1, root first), cut at ``MAX_CODE_LENGTH``. The same ties break the same
way as in the JAX package, so both give the same codes and points.
"""

from __future__ import annotations

from typing import List, Sequence

MAX_CODE_LENGTH = 40


def build_huffman(words: Sequence, max_code_length: int = MAX_CODE_LENGTH) -> None:
    """Set ``codes`` and ``points`` on each VocabWord of ``words``, which
    must be sorted by descending count with word i at index i."""
    n = len(words)
    if n == 0:
        return
    if n == 1:
        words[0].codes = [0]
        words[0].points = [0]
        return

    count = [0] * (2 * n + 1)
    binary = [0] * (2 * n + 1)
    parent = [0] * (2 * n + 1)
    for i, w in enumerate(words):
        count[i] = int(w.count)
    for i in range(n, 2 * n):
        count[i] = 2**31 - 1

    pos1, pos2 = n - 1, n
    for a in range(n - 1):
        if pos1 >= 0 and count[pos1] < count[pos2]:
            min1, pos1 = pos1, pos1 - 1
        else:
            min1, pos2 = pos2, pos2 + 1
        if pos1 >= 0 and count[pos1] < count[pos2]:
            min2, pos1 = pos1, pos1 - 1
        else:
            min2, pos2 = pos2, pos2 + 1
        count[n + a] = count[min1] + count[min2]
        parent[min1] = n + a
        parent[min2] = n + a
        binary[min2] = 1

    root = 2 * n - 2
    for i, w in enumerate(words):
        code: List[int] = []
        point: List[int] = []
        b = i
        while b != root:
            code.append(binary[b])
            point.append(b)
            b = parent[b]
        # collected leaf to root; emitted root first, points as syn1 rows
        # (node - n), the root's row first
        depth = min(len(code), max_code_length)
        w.codes = list(reversed(code))[:depth]
        w.points = ([root - n] + [p - n for p in reversed(point[1:])])[:depth]
