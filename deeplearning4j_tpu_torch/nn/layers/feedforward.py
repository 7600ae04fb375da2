"""Feedforward layers (counterpart:
``deeplearning4j_tpu/nn/layers/feedforward.py`` — ``DenseLayerImpl``,
``OutputLayerImpl`` with its ``loss`` and ``RnnOutputLayerImpl``, :27-67).

The embedding, activation, autoencoder and RBM layers wait for the slices
that use them.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl


class DenseLayerImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        n_in = self.conf.n_in or input_shape[-1]
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        return params, {}, (self.conf.n_out,)

    def preout(self, params, x):
        return x @ params["W"] + params["b"]

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        return self.act(self.preout(params, x)), state


class OutputLayerImpl(DenseLayerImpl):
    """Dense + loss function; ``apply`` gives the activated output, and the
    container computes the loss from ``preout`` (softmax with mcxent or
    NLL fused through log-softmax)."""

    def loss(self, params, x, labels, mask=None):
        z = self.preout(params, x)
        name = self.conf.loss_function
        if losses.fused_with_softmax(name) and self.conf.activation == "softmax":
            return losses.mcxent_from_logits(labels, z, mask)
        return losses.loss_fn(name)(labels, self.act(z), mask)


class RnnOutputLayerImpl(OutputLayerImpl):
    """The dense output applied per timestep on [N, T, F] input (the
    matmul broadcasts over T)."""

    def initialize(self, gen, input_shape):
        t, f = input_shape
        n_in = self.conf.n_in or f
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        return params, {}, (t, self.conf.n_out)
