"""Convolution and pooling (counterpart:
``deeplearning4j_tpu/nn/layers/convolution.py`` — ``ConvolutionLayerImpl``
:23 and ``SubsamplingLayerImpl`` :72).

The JAX layout is kept: NHWC activations and HWIO weights, so a JAX
network's params carry over unchanged. The JAX package lowers both layers
to XLA ops (``lax.conv_general_dilated``, ``lax.reduce_window``), not to
Pallas kernels; the port runs PyTorch's (cuDNN on the card, TF32 off:
``ops/device.resolve_device``). ``x.permute(0, 3, 1, 2)`` of an NHWC
tensor already has channels-last strides, so cuDNN takes its NHWC
kernels without a copy of the activations, and the output goes back to
NHWC by the inverse permute.

Semantics follow ``lax``: symmetric explicit padding, floor output sizes,
max pooling padded with -inf at any padding (``F.max_pool2d`` refuses a
padding past half the window: such a padding is applied by ``F.pad``
first), average pooling dividing every window by ``kh * kw`` (padding
included) and sum pooling as that sum. A bf16 (or f16) window sum is
``lax.reduce_window``'s: the window's elements added in row-major order
in the input's dtype, rounding at every add (``_window_sum``); wider
dtypes take ``F.avg_pool2d``. The JAX package's strict-mode
three-pass conv (``ops/precision.py``) is TPU arithmetic and does not
carry over: on the card an f32 conv is f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerImpl
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _out_size(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


class ConvolutionLayerImpl(BaseLayerImpl):
    def initialize(self, gen, input_shape):
        h, w, c_in = input_shape
        conf = self.conf
        if conf.n_in and conf.n_in != c_in:
            raise ValueError(f"conv n_in={conf.n_in} != input channels {c_in}")
        kh, kw = conf.kernel_size
        W = init_weights(gen, (kh, kw, c_in, conf.n_out), conf.weight_init,
                         fan_in=c_in * kh * kw, fan_out=conf.n_out * kh * kw,
                         dist=conf.dist)
        b = torch.full((conf.n_out,), float(conf.bias_init or 0.0),
                       dtype=torch.float32, device=W.device)
        oh = _out_size(h, kh, conf.stride[0], conf.padding[0])
        ow = _out_size(w, kw, conf.stride[1], conf.padding[1])
        return {"W": W, "b": b}, {}, (oh, ow, conf.n_out)

    def preout(self, params, x):
        conf = self.conf
        y = F.conv2d(_nchw(x), params["W"].permute(3, 2, 0, 1),
                     params["b"], stride=tuple(conf.stride),
                     padding=tuple(conf.padding))
        return _nhwc(y)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        x = self._dropout_in(x, train, gen)
        return self.act(self.preout(params, x)), state


class SubsamplingLayerImpl(BaseLayerImpl):
    """MAX / AVG / SUM pooling."""

    def initialize(self, gen, input_shape):
        h, w, c = input_shape
        (kh, kw), (sh, sw), (ph, pw) = (self.conf.kernel_size,
                                        self.conf.stride, self.conf.padding)
        return {}, {}, (_out_size(h, kh, sh, ph), _out_size(w, kw, sw, pw), c)

    def apply(self, params, state, x, *, train=False, gen=None, mask=None):
        conf = self.conf
        kernel, stride = tuple(conf.kernel_size), tuple(conf.stride)
        (kh, kw), (ph, pw) = kernel, conf.padding
        pt = conf.pooling_type.lower()
        if pt not in ("max", "avg", "average", "sum"):
            raise ValueError(f"unknown pooling type {pt}")
        z = _nchw(x)
        padding = (ph, pw)
        if ph > kh // 2 or pw > kw // 2:  # past what the pool ops take
            z = F.pad(z, (pw, pw, ph, ph),
                      value=float("-inf") if pt == "max" else 0.0)
            padding = (0, 0)
        if pt == "max":
            y = F.max_pool2d(z, kernel, stride, padding)
        elif z.element_size() < 4:
            y = _window_sum(z, kernel, stride, padding)
            if pt != "sum":
                y = y / float(kh * kw)
        else:
            # every window divided by kh * kw, padding included (avg), or
            # by nothing (sum)
            y = F.avg_pool2d(z, kernel, stride, padding,
                             divisor_override=kh * kw if pt != "sum" else 1)
        return _nhwc(y), state


def _window_sum(z, kernel, stride, padding):
    """NCHW window sums in ``z``'s dtype, one strided slice per window
    offset added in row-major order (the order and the per-add rounding
    of XLA's ``reduce_window`` on a narrow float)."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if ph or pw:
        z = F.pad(z, (pw, pw, ph, ph))
    oh = (z.shape[2] - kh) // sh + 1
    ow = (z.shape[3] - kw) // sw + 1
    y = None
    for di in range(kh):
        for dj in range(kw):
            part = z[:, :, di:di + sh * (oh - 1) + 1:sh,
                     dj:dj + sw * (ow - 1) + 1:sw]
            y = part if y is None else y + part
    return y
