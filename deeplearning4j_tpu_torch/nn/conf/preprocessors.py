"""Input preprocessors — shape adapters between layer families
(counterpart: ``deeplearning4j_tpu/nn/conf/preprocessors.py``).

The same classes and JSON form as the JAX package; the forward transforms
act on torch tensors. CNN activations are NHWC, RNN activations
[batch, time, features].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

PREPROCESSOR_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    PREPROCESSOR_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_to_dict(p) -> Dict[str, Any]:
    import dataclasses

    d = dataclasses.asdict(p)
    d["type"] = type(p).__name__
    return d


def preprocessor_from_dict(d: Dict[str, Any]):
    d = dict(d)
    cls = PREPROCESSOR_REGISTRY[d.pop("type")]
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return cls(**kwargs)


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor:
    """[N,H,W,C] -> [N, H*W*C] (reference: CnnToFeedForwardPreProcessor.java)."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def out_shape(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        h, w, c = in_shape
        return (h * w * c,)


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor:
    """[N, H*W*C] -> [N,H,W,C] (reference: FeedForwardToCnnPreProcessor.java)."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 1

    def __call__(self, x):
        return x.reshape(
            x.shape[0], self.input_height, self.input_width, self.num_channels
        )

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        return (self.input_height, self.input_width, self.num_channels)


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor:
    """[N,T,F] -> [N*T, F] (reference: RnnToFeedForwardPreProcessor.java)."""

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        t, f = in_shape
        return (f,)


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor:
    """[N*T, F] -> [N,T,F]; time length supplied by the container at apply time
    (reference: FeedForwardToRnnPreProcessor.java)."""

    def __call__(self, x, time_steps: int = -1):
        return x.reshape(-1, time_steps, x.shape[-1]) if time_steps > 0 else x

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        # shape bookkeeping handled by container (needs T)
        return in_shape


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor:
    """[N*T,H,W,C] -> [N,T,H*W*C] (reference: CnnToRnnPreProcessor.java)."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x, time_steps: int = -1):
        flat = x.reshape(x.shape[0], -1)
        if time_steps > 0:
            flat = flat.reshape(-1, time_steps, flat.shape[-1])
        return flat

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        h, w, c = in_shape
        return (h * w * c,)


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor:
    """[N,T,H*W*C] -> [N*T,H,W,C] (reference: RnnToCnnPreProcessor.java)."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x):
        n, t, f = x.shape
        return x.reshape(
            n * t, self.input_height, self.input_width, self.num_channels
        )

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        return (self.input_height, self.input_width, self.num_channels)


@register_preprocessor
@dataclass
class ReshapePreProcessor:
    """Arbitrary reshape keeping the batch axis (reference: ReshapePreProcessor.java)."""

    target_shape: Tuple[int, ...] = ()

    def __call__(self, x):
        return x.reshape((x.shape[0],) + tuple(self.target_shape))

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        return tuple(self.target_shape)


@register_preprocessor
@dataclass
class UnitVarianceProcessor:
    """Normalize each example to unit variance (reference:
    UnitVarianceProcessor.java)."""

    def __call__(self, x):
        flat = x.reshape(x.shape[0], -1)
        std = torch.std(flat, dim=1, correction=0).reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return x / torch.clamp(std, min=1e-8)

    def out_shape(self, in_shape) -> Tuple[int, ...]:
        return in_shape
