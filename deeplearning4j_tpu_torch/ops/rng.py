"""Deterministic random streams (counterpart:
``deeplearning4j_tpu/ops/rng.py`` — ``step_key`` and ``layer_key``).

The JAX package folds the iteration and the layer index into its base key
(``step_key``, then ``layer_key(..., "dropout")``). The port derives a
``torch.Generator`` the same way: its seed is a splitmix64 mix of
``(conf.seed, kind, iteration, layer)``, so the dropout stream of one
layer at one step is fixed by those numbers and no generator state has
to be saved for an exact resume; the pretraining samplers (an
AutoEncoder's corruption, an RBM's Gibbs chain) draw from the ``sample``
kind. jax's threefry and torch's Philox give other bits, so draws are
compared port against port only.
"""

from __future__ import annotations

import torch

# the JAX package's fold-in tags of the stream kinds
KIND_TAGS = {"dropout": 0x2, "sample": 0x3}
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int, layer: int,
                kind: str = "dropout") -> int:
    """The 63-bit seed of one layer's stream of ``kind`` at one step."""
    x = _splitmix64(int(seed) & _MASK64)
    for part in (KIND_TAGS[kind], int(step), int(layer)):
        x = _splitmix64(x ^ (part & _MASK64))
    return x >> 1


def layer_generator(seed: int, step: int, layer: int, device,
                    kind: str = "dropout") -> torch.Generator:
    """A generator on ``device`` for layer ``layer``'s draws of ``kind``
    at ``step``."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, step, layer, kind))
