"""Config -> runtime layer mapping (counterpart:
``deeplearning4j_tpu/nn/layers/factory.py``).

Only the layers the port has runtimes for are mapped; any other conf
raises, naming the layer. The conf-family tuples are the JAX package's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import layers as conf_layers
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttentionImpl
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayerImpl,
    OutputLayerImpl,
    RnnOutputLayerImpl,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTMImpl

FACTORY = {
    conf_layers.DenseLayer: DenseLayerImpl,
    conf_layers.OutputLayer: OutputLayerImpl,
    conf_layers.RnnOutputLayer: RnnOutputLayerImpl,
    conf_layers.GravesLSTM: GravesLSTMImpl,
    conf_layers.MultiHeadAttention: MultiHeadAttentionImpl,
}

# recurrent layers with carryable state (rnnTimeStep)
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


def create_layer(conf):
    try:
        impl_cls = FACTORY[type(conf)]
    except KeyError:
        raise ValueError(
            f"layer {type(conf).__name__} is not ported yet (the port runs "
            f"{sorted(c.__name__ for c in FACTORY)})") from None
    return impl_cls(conf)
