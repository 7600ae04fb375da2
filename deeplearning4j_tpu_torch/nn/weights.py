"""Weight initialization schemes (counterpart:
``deeplearning4j_tpu/nn/weights.py``).

The same schemes and distributions as the JAX package (the reference's
``WeightInit``): distribution, normalized, relu, size, uniform, vi, xavier,
zero. Draws come from an explicit ``torch.Generator``; jax threefry and
torch Philox give different numbers from the same seed, so fresh inits
are never compared across packages.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

WEIGHT_INITS = (
    "distribution",
    "normalized",
    "relu",
    "size",
    "uniform",
    "vi",
    "xavier",
    "zero",
)


def _uniform(gen, shape, dtype, device, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return lo + (hi - lo) * u


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _sample_distribution(gen, shape, dist: dict, dtype, device):
    kind = dist.get("type", "normal").lower()
    if kind in ("normal", "gaussian"):
        return (dist.get("mean", 0.0)
                + dist.get("std", 1.0) * _normal(gen, shape, dtype, device))
    if kind == "uniform":
        return _uniform(gen, shape, dtype, device, dist.get("lower", 0.0),
                        dist.get("upper", 1.0))
    if kind == "binomial":
        n = dist.get("n", 1)
        probs = torch.full((n,) + tuple(shape), float(dist.get("p", 0.5)),
                           dtype=dtype, device=device)
        return torch.bernoulli(probs, generator=gen).sum(dim=0)
    raise ValueError(f"Unknown distribution type '{kind}'")


def init_weights(gen: torch.Generator, shape: Sequence[int], scheme: str,
                 fan_in: int, fan_out: int, dist: Optional[dict] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """A weight tensor of ``shape``, on ``gen``'s device, drawn with the
    named scheme from ``gen``. ``fan_in``/``fan_out`` are explicit because
    recurrent layers compute them, not shape[0]/[1]."""
    shape = tuple(shape)
    dev = gen.device
    s = scheme.lower()
    if s == "distribution":
        if dist is None:
            raise ValueError("WeightInit DISTRIBUTION requires a `dist` config")
        return _sample_distribution(gen, shape, dist, dtype, dev)
    if s == "normalized":
        return (_uniform(gen, shape, dtype, dev) - 0.5) / float(fan_in)
    if s == "relu":
        return _normal(gen, shape, dtype, dev) * math.sqrt(2.0 / fan_in)
    if s == "size":
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, dev, -r, r)
    if s == "uniform":
        a = 1.0 / float(fan_in)
        return _uniform(gen, shape, dtype, dev, -a, a)
    if s == "vi":
        r = math.sqrt(6.0) / math.sqrt(sum(shape) + 1.0)
        return _uniform(gen, shape, dtype, dev, -r, r)
    if s == "xavier":
        return _normal(gen, shape, dtype, dev) / math.sqrt(fan_in + fan_out)
    if s == "zero":
        return torch.zeros(shape, dtype=dtype, device=dev)
    raise ValueError(f"Unknown weight init '{scheme}'. Known: {WEIGHT_INITS}")
