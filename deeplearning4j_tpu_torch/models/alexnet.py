"""AlexNet (counterpart: ``deeplearning4j_tpu/models/alexnet.py`` —
``alexnet_conf`` and ``build_alexnet``): the single-tower AlexNet at
227x227 as one MultiLayerNetwork configuration — five convolutions, LRN
after the first two, three max pools, two dense layers of 4096 with
dropout 0.5 and a softmax head. The configuration JSON is the JAX
package's string.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    LocalResponseNormalization,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

INPUT_SHAPE = (227, 227, 3)


def alexnet_conf(num_classes: int = 1000, in_channels: int = 3,
                 input_size: int = 227, seed: int = 42,
                 learning_rate: float = 0.01, updater: str = "nesterovs",
                 momentum: float = 0.9, l2: float = 5e-4,
                 dropout: float = 0.5, dtype_policy: str = "strict",
                 gradient_checkpointing: bool = False):
    # spatial sizes down the stack (input 227: 55 -> 27 -> 13 -> 13 -> 13 -> 6)
    s1 = (input_size - 11) // 4 + 1      # conv1 stride 4, valid
    p1 = (s1 - 3) // 2 + 1               # pool 3x3 /2
    s2 = p1                               # conv2 pad 2 keeps size
    p2 = (s2 - 3) // 2 + 1
    final = (p2 - 3) // 2 + 1            # pool5
    if final < 1:
        raise ValueError(
            f"input_size {input_size} too small for the AlexNet stack "
            f"(pool5 output would be {final}x{final}; minimum input is 67)")
    return (
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
        .layer(0, ConvolutionLayer(n_in=in_channels, n_out=96,
                                   kernel_size=(11, 11), stride=(4, 4),
                                   activation="relu"))
        .layer(1, LocalResponseNormalization())
        .layer(2, SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        .layer(3, ConvolutionLayer(n_in=96, n_out=256, kernel_size=(5, 5),
                                   padding=(2, 2), activation="relu"))
        .layer(4, LocalResponseNormalization())
        .layer(5, SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        .layer(6, ConvolutionLayer(n_in=256, n_out=384, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu"))
        .layer(7, ConvolutionLayer(n_in=384, n_out=384, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu"))
        .layer(8, ConvolutionLayer(n_in=384, n_out=256, kernel_size=(3, 3),
                                   padding=(1, 1), activation="relu"))
        .layer(9, SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        .layer(10, DenseLayer(n_in=final * final * 256, n_out=4096,
                              activation="relu", dropout=dropout))
        .layer(11, DenseLayer(n_in=4096, n_out=4096, activation="relu",
                              dropout=dropout))
        .layer(12, OutputLayer(n_in=4096, n_out=num_classes,
                               activation="softmax", loss_function="mcxent"))
        .input_preprocessor(10, CnnToFeedForwardPreProcessor(final, final,
                                                             256))
        .build()
    )


def build_alexnet(input_size: int = 227, num_classes: int = 1000,
                  device=None, **kw) -> MultiLayerNetwork:
    """An initialized AlexNet on ``device`` (the card unless "cpu")."""
    conf = alexnet_conf(num_classes=num_classes, input_size=input_size, **kw)
    return MultiLayerNetwork(conf, device=device).init(
        input_shape=(input_size, input_size, conf.layers[0].n_in))
