"""The work of a ``mellum_lm`` training step, counted from its shapes (the
conventions of ``flops.py``: a product of [m, k] by [k, n] is 2·m·k·n
operations, a training step the forward and a backward of twice its
products, attention 4·D a visible (query, key) pair and query head
forward, 12·D with the backward). It counts what the model's mathematics
needs: the rows the held experts compute (the port's ``moe.routed_rows``),
the pairs each layer's window leaves visible; never the activation
checkpoint's recompute or the repeated K/V heads."""

from __future__ import annotations

from typing import Dict

from perfbench.flops import causal_pairs

SLIDING = "sliding_attention"


def windowed_pairs(t: int, window: int) -> int:
    """Visible pairs of one causal row of length t where each query sees
    its last ``window`` keys: sum over i of min(i + 1, window)."""
    if window <= 0 or window >= t:
        return causal_pairs(t)
    return window * (window + 1) // 2 + (t - window) * window


def layer_pairs(model: Dict, rows: int, t: int):
    """Visible pairs per layer of ``rows`` rows of length t, in layer
    order."""
    w = model["sliding_window"]
    return [rows * (windowed_pairs(t, w) if kind == SLIDING
                    else causal_pairs(t))
            for kind in model["layer_types"]]


def per_token(model: Dict) -> int:
    """Forward operations of one token through one block's dense
    products: q, k, v and o (GQA widths) and the router."""
    d = model["d_model"]
    qd = model["n_heads"] * model["head_dim"]
    kvd = model["n_kv_heads"] * model["head_dim"]
    return 2 * d * (2 * qd + 2 * kvd + model["experts"])


def per_routed_row(model: Dict) -> int:
    """Forward operations of one routed row through its expert: gate, up
    and down (3 products of d by d_ff)."""
    return 3 * 2 * model["d_model"] * model["d_ff"]


def train_step(model: Dict, tokens: int, routed_rows: float,
               pairs: int) -> float:
    """Operations of one training step: ``tokens`` through every block's
    dense products and the untied head, ``routed_rows`` (summed over the
    layers) through the experts, ``pairs`` visible pairs summed over the
    layers and rows, for every query head; forward and backward."""
    heads, hd = model["n_heads"], model["head_dim"]
    fwd = (tokens * model["n_layers"] * per_token(model)
           + routed_rows * per_routed_row(model)
           + tokens * 2 * model["d_model"] * model["vocab_size"]
           + 4 * hd * heads * pairs)
    return 3 * fwd


def attn_fwd_bound(heads: int, head_dim: int, pairs: float) -> float:
    """The flash forward's operations for one call: 4·D a visible pair and
    head (S = Q K^T, O = P V)."""
    return 4 * head_dim * heads * pairs
