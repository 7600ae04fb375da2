"""Configuration DSL (counterpart: ``deeplearning4j_tpu/nn/conf``).

The serializable model spec: ``NeuralNetConfiguration.builder()`` ->
``MultiLayerConfiguration`` with a JSON round trip identical to the JAX
package's, so a configuration written by either package reads in the
other.
"""

from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    AutoEncoder,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    EmbeddingLayer,
    GRU,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LocalResponseNormalization,
    MultiHeadAttention,
    OutputLayer,
    RBM,
    RnnOutputLayer,
    SubsamplingLayer,
    layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration
