"""Layer protocol, inverted dropout and the dense parameter init
(counterpart: ``deeplearning4j_tpu/nn/layers/base.py``).

A layer is an object built from its resolved conf, with
``initialize(gen, input_shape) -> (params, state, output_shape)`` and
``apply(params, state, x, *, train=False, gen=None, mask=None) ->
(y, new_state)`` over plain dicts of tensors. ``gen`` is the layer's
dropout generator for this step (``ops/rng.layer_generator``); dropout
acts on the layer's input, in training only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import activation

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def inverted_dropout(x: torch.Tensor, rate: float, train: bool,
                     gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout on a layer's input: keep each entry with
    probability 1 - rate and scale it by 1 / (1 - rate), at train time."""
    if not train or rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout requires a generator at train time")
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


class BaseLayerImpl:
    """Base for the runtime layers. Subclasses set params in
    ``initialize`` and define ``apply``; stateless layers return their
    ``state`` ({}) unchanged."""

    def __init__(self, conf):
        self.conf = conf
        self.act = activation(conf.activation) if conf.activation else None

    def initialize(self, gen: torch.Generator, input_shape
                   ) -> Tuple[Params, State, Tuple[int, ...]]:
        raise NotImplementedError

    def apply(self, params: Params, state: State, x: torch.Tensor, *,
              train: bool = False, gen: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    def _dropout_in(self, x, train, gen):
        return inverted_dropout(x, self.conf.dropout or 0.0, train, gen)

    def _init_dense_params(self, gen: torch.Generator, n_in: int,
                           n_out: int) -> Params:
        W = init_weights(gen, (n_in, n_out), self.conf.weight_init,
                         fan_in=n_in, fan_out=n_out, dist=self.conf.dist)
        b = torch.full((n_out,), float(self.conf.bias_init or 0.0),
                       dtype=torch.float32, device=W.device)
        return {"W": W, "b": b}
