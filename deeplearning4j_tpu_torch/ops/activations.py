"""String-named activation registry (counterpart:
``deeplearning4j_tpu/ops/activations.py``).

The config DSL names activations by string; each name maps to a torch
function with the JAX package's definition: sigmoid, tanh, relu,
leakyrelu (slope 0.01), softmax (last axis), identity/linear, softsign,
softplus, hardtanh, hardsigmoid (clip(0.2x + 0.5, 0, 1)), cube, elu,
rectifiedtanh, step, gelu (tanh approximation, jax.nn.gelu's default) and
swish/silu.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}


def _register(*names):
    def deco(fn):
        for n in names:
            ACTIVATIONS[n] = fn
        return fn

    return deco


@_register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@_register("tanh")
def tanh(x):
    return torch.tanh(x)


@_register("relu")
def relu(x):
    return torch.relu(x)


@_register("leakyrelu")
def leakyrelu(x):
    return F.leaky_relu(x, negative_slope=0.01)


@_register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@_register("identity", "linear")
def identity(x):
    return x


@_register("softsign")
def softsign(x):
    return F.softsign(x)


@_register("softplus")
def softplus(x):
    return F.softplus(x)


@_register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@_register("hardsigmoid")
def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@_register("cube")
def cube(x):
    return x * x * x


@_register("elu")
def elu(x):
    return F.elu(x)


@_register("rectifiedtanh")
def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


@_register("step")
def step(x):
    return (x > 0.0).to(x.dtype)


@_register("gelu")
def gelu(x):
    return F.gelu(x, approximate="tanh")


@_register("swish", "silu")
def swish(x):
    return F.silu(x)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}"
        ) from None
