"""BatchNormalization and LocalResponseNormalization (counterpart:
``deeplearning4j_tpu/nn/layers/normalization.py`` —
``BatchNormalizationImpl`` :23 and ``LocalResponseNormalizationImpl``
:59).

Both are written in tensor ops, as the JAX package writes them, not
through ``F.batch_norm`` or ``F.local_response_norm``: ``F.batch_norm``
keeps the *unbiased* batch variance in its running estimate and
``F.local_response_norm`` divides alpha by the window, where the JAX
layers use the biased variance in both the normalisation and the running
update and ``x / (k + alpha * sum_window(x^2))^beta``. BN's running mean
and variance live in the layer *state*; gamma and beta are its params
unless ``lock_gamma_beta``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl


class BatchNormalizationImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        n = input_shape[-1]  # features (dense) or channels (NHWC)
        conf = self.conf
        dev = gen.device
        f32 = dict(dtype=torch.float32, device=dev)
        params = {}
        if not conf.lock_gamma_beta:
            params["gamma"] = torch.full((n,), float(conf.gamma), **f32)
            params["beta"] = torch.full((n,), float(conf.beta), **f32)
        state = {"mean": torch.zeros((n,), **f32),
                 "var": torch.ones((n,), **f32)}
        return params, state, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        axes = tuple(range(x.dim() - 1))  # all but the channel axis
        if train:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            # running estimates: decay * old + (1 - decay) * batch
            new_state = {
                "mean": conf.decay * state["mean"] + (1 - conf.decay) * mean,
                "var": conf.decay * state["var"] + (1 - conf.decay) * var,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean) / torch.sqrt(var + conf.eps)
        if conf.lock_gamma_beta:
            return conf.gamma * xhat + conf.beta, new_state
        return params["gamma"] * xhat + params["beta"], new_state


class LocalResponseNormalizationImpl(BaseLayerImpl):
    """Cross-channel LRN on NHWC: y = x / (k + alpha * sum_window(x^2))^beta
    over a window of ``n`` channels padded (n // 2, n - 1 - n // 2)."""

    def initialize(self, gen, input_shape):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        n = int(conf.n)
        half = n // 2
        sq = F.pad(x * x, (half, n - 1 - half))
        window = sq.unfold(-1, n, 1).sum(-1)
        return x / (conf.k + conf.alpha * window) ** conf.beta, state
