"""LeNet-5 for MNIST (counterpart: ``deeplearning4j_tpu/models/lenet.py`` —
``lenet5_conf`` :24 and ``build_lenet5`` :68), the configuration
``bench.py`` names as the framework's headline (configs[0]).

conv 5x5 x20 -> max pool 2x2 -> conv 5x5 x50 -> max pool 2x2 -> dense
500 relu -> softmax 10, Nesterovs at 0.01 with momentum 0.9 and l2 5e-4,
on NHWC [N, 28, 28, 1] input. The configuration JSON is the JAX
package's string.
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

INPUT_SHAPE = (28, 28, 1)


def lenet5_conf(seed: int = 12345, learning_rate: float = 0.01,
                updater: str = "nesterovs", momentum: float = 0.9,
                l2: float = 5e-4):
    return (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .momentum(momentum)
        .l2(l2)
        .weight_init("xavier")
        .list()
        .layer(0, ConvolutionLayer(n_in=1, n_out=20, kernel_size=(5, 5),
                                   stride=(1, 1), activation="identity"))
        .layer(1, SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                   stride=(2, 2)))
        .layer(2, ConvolutionLayer(n_in=20, n_out=50, kernel_size=(5, 5),
                                   stride=(1, 1), activation="identity"))
        .layer(3, SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                   stride=(2, 2)))
        .layer(4, DenseLayer(n_in=4 * 4 * 50, n_out=500, activation="relu"))
        .layer(5, OutputLayer(n_in=500, n_out=10, activation="softmax",
                              loss_function="mcxent"))
        .input_preprocessor(4, CnnToFeedForwardPreProcessor(4, 4, 50))
        .build()
    )


def build_lenet5(device=None, **kw) -> MultiLayerNetwork:
    """An initialized LeNet-5 on ``device`` (the card unless "cpu")."""
    return MultiLayerNetwork(lenet5_conf(**kw), device=device).init(
        input_shape=INPUT_SHAPE)
