"""Feedforward layers, inference side (counterpart:
``deeplearning4j_tpu/nn/layers/feedforward.py`` — ``DenseLayerImpl``,
``OutputLayerImpl`` and ``RnnOutputLayerImpl``, :27-67).

``OutputLayerImpl.loss`` is training and waits for the training slice;
the embedding, activation, autoencoder and RBM layers wait for the slices
that serve them.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl


class DenseLayerImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        n_in = self.conf.n_in or input_shape[-1]
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        return params, {}, (self.conf.n_out,)

    def preout(self, params, x):
        return x @ params["W"] + params["b"]

    def apply(self, params, state, x, *, mask=None):
        return self.act(self.preout(params, x)), state


class OutputLayerImpl(DenseLayerImpl):
    """Dense + loss function; ``apply`` gives the activated output."""


class RnnOutputLayerImpl(OutputLayerImpl):
    """The dense output applied per timestep on [N, T, F] input (the
    matmul broadcasts over T)."""

    def initialize(self, gen, input_shape):
        t, f = input_shape
        n_in = self.conf.n_in or f
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        return params, {}, (t, self.conf.n_out)
