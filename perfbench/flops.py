"""The work an input needs, counted from its shapes: the yardstick of
every utilization and roofline metric. It counts what the model's
mathematics needs for these inputs (non-pad tokens, visible attention
pairs), never what an implementation happens to do, so a metric reads the
same work whatever computes it.

Conventions (PERF.md §6 of the port's kernel table): a product of
[m, k] by [k, n] is 2·m·k·n operations; a training step is the forward
and a backward of twice its products (3x); attention is 4·D operations
per visible (query, key) pair and head forward, 8·D backward (dV, dP, dQ,
dK), and the flash backward's bound is 10·D per pair (it recomputes S).
"""

from __future__ import annotations

from typing import Dict, Iterable


def causal_pairs(t: int) -> int:
    """Visible (query, key) pairs of one causal row of length t."""
    return t * (t + 1) // 2


def bidirectional_pairs(lengths: Iterable[int]) -> int:
    """Visible pairs of rows whose keys are masked after each length,
    counted for the non-pad queries only."""
    return sum(int(n) * int(n) for n in lengths)


def dense_per_token(d: int, d_ff: int) -> int:
    """Forward operations of one token through one block's products:
    q, k, v, o (4·d·d) and the two FFN products (2·d·d_ff)."""
    return 2 * (4 * d * d + 2 * d * d_ff)


def head_per_token(d: int, vocab: int) -> int:
    """Forward operations of one token through the tied output head."""
    return 2 * d * vocab


def train_step(model: Dict, tokens: int, head_tokens: int,
               pairs: int) -> int:
    """Operations of one training step: ``tokens`` non-pad tokens
    through every block, ``head_tokens`` through the head, ``pairs``
    visible pairs per head and layer summed over the rows; forward and
    backward."""
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    hd = d // model["n_heads"]
    return (3 * tokens * L * dense_per_token(d, f)
            + 3 * head_tokens * head_per_token(d, model["vocab_size"])
            + 12 * hd * model["n_heads"] * L * pairs)


def attn_bwd_bound(heads: int, head_dim: int, pairs: int) -> int:
    """The flash backward's operations for one call: 10·D per visible
    pair and head (S recomputed, dP, dV, dK, dQ)."""
    return 10 * head_dim * heads * pairs

