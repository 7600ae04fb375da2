"""VGG-16 (counterpart: ``deeplearning4j_tpu/models/vgg.py`` —
``vgg16_conf`` :28 and ``build_vgg16`` :79): thirteen 3x3 convolutions in
five blocks, each block closed by a 2x2 max pool, then dense 4096, 4096
(dropout 0.5) and a softmax head, at 224x224. The configuration JSON is
the JAX package's string.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

INPUT_SHAPE = (224, 224, 3)

# (out_channels, convs_in_block) per VGG-16 block
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16_conf(num_classes: int = 1000, in_channels: int = 3,
               input_size: int = 224, seed: int = 42,
               learning_rate: float = 0.01, updater: str = "nesterovs",
               momentum: float = 0.9, l2: float = 5e-4, dropout: float = 0.5,
               dtype_policy: str = "strict",
               gradient_checkpointing: bool = False):
    lb = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .momentum(momentum)
        .l2(l2)
        .weight_init("relu")
        .list()
        .dtype_policy(dtype_policy)
        .gradient_checkpointing(gradient_checkpointing)
    )
    idx, c_in, size = 0, in_channels, input_size
    for c_out, reps in _BLOCKS:
        for _ in range(reps):
            lb.layer(idx, ConvolutionLayer(n_in=c_in, n_out=c_out,
                                           kernel_size=(3, 3),
                                           padding=(1, 1),
                                           activation="relu"))
            c_in = c_out
            idx += 1
        lb.layer(idx, SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        size //= 2
        idx += 1
    lb.layer(idx, DenseLayer(n_in=size * size * 512, n_out=4096,
                             activation="relu", dropout=dropout))
    lb.input_preprocessor(idx, CnnToFeedForwardPreProcessor(size, size, 512))
    idx += 1
    lb.layer(idx, DenseLayer(n_in=4096, n_out=4096, activation="relu",
                             dropout=dropout))
    idx += 1
    lb.layer(idx, OutputLayer(n_in=4096, n_out=num_classes,
                              activation="softmax", loss_function="mcxent"))
    return lb.build()


def build_vgg16(input_size: int = 224, num_classes: int = 1000,
                device=None, **kw) -> MultiLayerNetwork:
    """An initialized VGG-16 on ``device`` (the card unless "cpu")."""
    conf = vgg16_conf(num_classes=num_classes, input_size=input_size, **kw)
    return MultiLayerNetwork(conf, device=device).init(
        input_shape=(input_size, input_size, conf.layers[0].n_in))
