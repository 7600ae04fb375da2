"""Config -> runtime layer mapping (counterpart:
``deeplearning4j_tpu/nn/layers/factory.py``).

Every layer of the JAX package's MultiLayerNetwork zoo is mapped; a conf
with no runtime raises, naming the layer. The conf-family tuples are the
JAX package's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import layers as conf_layers
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttentionImpl
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayerImpl,
    SubsamplingLayerImpl,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayerImpl,
    AutoEncoderImpl,
    DenseLayerImpl,
    EmbeddingLayerImpl,
    OutputLayerImpl,
    RBMImpl,
    RnnOutputLayerImpl,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalizationImpl,
    LocalResponseNormalizationImpl,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRUImpl,
    GravesBidirectionalLSTMImpl,
    GravesLSTMImpl,
)

FACTORY = {
    conf_layers.DenseLayer: DenseLayerImpl,
    conf_layers.OutputLayer: OutputLayerImpl,
    conf_layers.RnnOutputLayer: RnnOutputLayerImpl,
    conf_layers.EmbeddingLayer: EmbeddingLayerImpl,
    conf_layers.ActivationLayer: ActivationLayerImpl,
    conf_layers.AutoEncoder: AutoEncoderImpl,
    conf_layers.RBM: RBMImpl,
    conf_layers.ConvolutionLayer: ConvolutionLayerImpl,
    conf_layers.SubsamplingLayer: SubsamplingLayerImpl,
    conf_layers.BatchNormalization: BatchNormalizationImpl,
    conf_layers.LocalResponseNormalization: LocalResponseNormalizationImpl,
    conf_layers.GravesLSTM: GravesLSTMImpl,
    conf_layers.GravesBidirectionalLSTM: GravesBidirectionalLSTMImpl,
    conf_layers.GRU: GRUImpl,
    conf_layers.MultiHeadAttention: MultiHeadAttentionImpl,
}

# recurrent layers with carryable state (TBPTT chaining, rnnTimeStep)
STATEFUL_RNN_CONFS = (
    conf_layers.GravesLSTM,
    conf_layers.GravesBidirectionalLSTM,
    conf_layers.GRU,
)

# layer families that take [N, T, F] (and the feature mask)
RNN_CONFS = (
    conf_layers.GravesLSTM,
    conf_layers.GravesBidirectionalLSTM,
    conf_layers.GRU,
    conf_layers.RnnOutputLayer,
    conf_layers.MultiHeadAttention,
)
CNN_CONFS = (
    conf_layers.ConvolutionLayer,
    conf_layers.SubsamplingLayer,
    conf_layers.LocalResponseNormalization,
)


def create_layer(conf):
    try:
        impl_cls = FACTORY[type(conf)]
    except KeyError:
        raise ValueError(
            f"no runtime for layer conf {type(conf).__name__} (the "
            "MultiLayerNetwork zoo maps "
            f"{sorted(c.__name__ for c in FACTORY)})") from None
    return impl_cls(conf)
