"""Feedforward layers (counterpart:
``deeplearning4j_tpu/nn/layers/feedforward.py`` — ``DenseLayerImpl``,
``OutputLayerImpl`` with its ``loss`` and ``RnnOutputLayerImpl``, :27-67;
``EmbeddingLayerImpl`` :70, ``ActivationLayerImpl`` :84,
``AutoEncoderImpl`` :93 and ``RBMImpl`` :125).

The AutoEncoder and the RBM are pretrained layerwise
(``MultiLayerNetwork.pretrain``): the AutoEncoder by the gradient of its
reconstruction loss after input corruption, the RBM by the closed-form
CD-k estimate of ``cd_grads`` (not a loss gradient). Their draws come
from a ``torch.Generator`` (``ops/rng``'s ``sample`` streams), not from
JAX's bits. A draw source may also be a callable ``draw(kind, shape)``
giving uniforms (``kind == "uniform"``) or standard normals, so a test
can inject the draws of a Gibbs chain. A binary unit is sampled as
``u < p`` from a uniform ``u``.
"""

from __future__ import annotations

import torch

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


class EmbeddingLayerImpl(BaseLayerImpl):
    """Row lookup: an [N, 1] index column (read as [N]) or [N, T] indices,
    float or integer, gives [N, n_out] or [N, T, n_out]."""

    def initialize(self, gen, input_shape):
        n_in = self.conf.n_in  # the vocabulary: not inferable from data
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        return params, {}, (self.conf.n_out,)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        idx = x.long()
        if idx.dim() >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = torch.nn.functional.embedding(idx, params["W"]) + params["b"]
        return self.act(y), state


class ActivationLayerImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        return {}, {}, tuple(input_shape)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        return self.act(x), state


def _draw(gen, kind: str, like: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) or standard normals shaped like ``like``, from a
    generator or an injected ``draw(kind, shape)``."""
    if callable(gen):
        return torch.as_tensor(gen(kind, tuple(like.shape)),
                               dtype=like.dtype, device=like.device)
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(like.shape, generator=gen, dtype=like.dtype,
              device=like.device)


class AutoEncoderImpl(BaseLayerImpl):
    """Denoising autoencoder: the forward is the encoder; pretraining
    minimizes the reconstruction loss of the corrupted input, decoded
    through W^T and the visible bias."""

    def initialize(self, gen, input_shape):
        n_in = self.conf.n_in or input_shape[-1]
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        params["vb"] = torch.zeros((n_in,), dtype=torch.float32,
                                   device=params["W"].device)
        return params, {}, (self.conf.n_out,)

    def encode(self, params, x):
        return self.act(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self.act(h @ params["W"].T + params["vb"])

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, gen):
        corrupted = x
        level = self.conf.corruption_level
        if level and level > 0:
            keep = _draw(gen, "uniform", x) < 1.0 - level
            corrupted = torch.where(keep, x, torch.zeros_like(x))
        recon = self.decode(params, self.encode(params, corrupted))
        return losses.loss_fn(self.conf.loss_function)(x, recon, None)


class RBMImpl(BaseLayerImpl):
    """RBM with CD-k pretraining. Units: binary | gaussian | rectified |
    softmax (hidden), binary | gaussian | linear | softmax (visible)."""

    def initialize(self, gen, input_shape):
        n_in = self.conf.n_in or input_shape[-1]
        params = self._init_dense_params(gen, n_in, self.conf.n_out)
        params["vb"] = torch.zeros((n_in,), dtype=torch.float32,
                                   device=params["W"].device)
        return params, {}, (self.conf.n_out,)

    def _hidden_mean(self, params, v):
        z = v @ params["W"] + params["b"]
        h = self.conf.hidden_unit
        if h == "binary":
            return torch.sigmoid(z)
        if h == "rectified":
            return torch.relu(z)
        if h == "gaussian":
            return z
        if h == "softmax":
            return torch.softmax(z, dim=-1)
        raise ValueError(f"unknown hidden unit {h}")

    def _visible_mean(self, params, h):
        z = h @ params["W"].T + params["vb"]
        v = self.conf.visible_unit
        if v == "binary":
            return torch.sigmoid(z)
        if v in ("gaussian", "linear"):
            return z
        if v == "softmax":
            return torch.softmax(z, dim=-1)
        raise ValueError(f"unknown visible unit {v}")

    @staticmethod
    def _sample(unit: str, mean: torch.Tensor, gen) -> torch.Tensor:
        if unit == "binary":
            return (_draw(gen, "uniform", mean) < mean).to(mean.dtype)
        if unit == "gaussian":
            return mean + _draw(gen, "normal", mean)
        return mean

    def _sample_hidden(self, params, v, gen):
        mean = self._hidden_mean(params, v)
        return self._sample(self.conf.hidden_unit, mean, gen), mean

    def _sample_visible(self, params, h, gen):
        mean = self._visible_mean(params, h)
        return self._sample(self.conf.visible_unit, mean, gen), mean

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        return self._hidden_mean(params, x), state

    @torch.no_grad()
    def cd_grads(self, params, v0, gen):
        """The CD-k estimate: the positive phase <v0 h0> minus the
        negative phase <vk hk>, per example, with the params' keys (the
        sign of a gradient to subtract). Draws in chain order: h0, then
        (v, h) k times."""
        k = max(1, int(self.conf.k))
        h0_mean = self._hidden_mean(params, v0)
        h_sample, _ = self._sample_hidden(params, v0, gen)
        vk, hk_mean = v0, h0_mean
        for _ in range(k):
            vk, _ = self._sample_visible(params, h_sample, gen)
            h_sample, hk_mean = self._sample_hidden(params, vk, gen)
        n = v0.shape[0]
        return {"W": -(v0.T @ h0_mean - vk.T @ hk_mean) / n,
                "b": -torch.mean(h0_mean - hk_mean, dim=0),
                "vb": -torch.mean(v0 - vk, dim=0)}

    def pretrain_loss(self, params, x, gen=None):
        """A monitoring proxy: the reconstruction cross-entropy after one
        mean-field Gibbs step."""
        recon = self._visible_mean(params, self._hidden_mean(params, x))
        return losses.loss_fn("reconstruction_crossentropy")(x, recon, None)
