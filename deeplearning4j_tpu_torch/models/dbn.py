"""The pretraining-era stacks (counterpart:
``deeplearning4j_tpu/models/dbn.py`` — ``dbn_conf``,
``stacked_autoencoder_conf`` and their builders, :27-108): a deep belief
network of RBMs (784-500-250-200-10, binary units, CD-1) and a stack of
denoising autoencoders (784-500-250-10, corruption 0.3), each with a
softmax head and ``pretrain=True``, so ``fit_iterator`` pretrains the
stack layer by layer before the supervised fine-tune. The configuration
JSON is the JAX package's string.
"""

from __future__ import annotations

from typing import Callable, Sequence

from deeplearning4j_tpu_torch.nn.conf import (
    RBM,
    AutoEncoder,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _pretrain_stack_conf(layer_factory: Callable[[int, int], object],
                         n_in: int, hidden: Sequence[int], num_classes: int,
                         seed: int, learning_rate: float, updater: str):
    """N pretrainable layers from ``layer_factory(n_in, n_out)`` and a
    softmax head, with pretrain and backprop on."""
    b = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .weight_init("xavier")
        .list()
        .pretrain(True)
        .backprop(True)
    )
    sizes = [n_in, *hidden]
    for i in range(len(hidden)):
        b = b.layer(i, layer_factory(sizes[i], sizes[i + 1]))
    b = b.layer(len(hidden), OutputLayer(
        n_in=sizes[-1], n_out=num_classes, activation="softmax",
        loss_function="negativeloglikelihood"))
    return b.build()


def dbn_conf(n_in: int = 784, hidden: Sequence[int] = (500, 250, 200),
             num_classes: int = 10, hidden_unit: str = "binary",
             visible_unit: str = "binary", k: int = 1, seed: int = 123,
             learning_rate: float = 0.1, updater: str = "sgd",
             activation: str = "sigmoid"):
    """A stack of RBMs: CD-k pretraining, then the backprop fine-tune."""
    return _pretrain_stack_conf(
        lambda i, o: RBM(n_in=i, n_out=o, hidden_unit=hidden_unit,
                         visible_unit=visible_unit, k=k,
                         activation=activation),
        n_in, hidden, num_classes, seed, learning_rate, updater)


def stacked_autoencoder_conf(n_in: int = 784,
                             hidden: Sequence[int] = (500, 250),
                             num_classes: int = 10,
                             corruption_level: float = 0.3, seed: int = 123,
                             learning_rate: float = 0.1,
                             updater: str = "sgd"):
    """Stacked denoising autoencoders (corruption, sigmoid
    reconstruction) and a softmax head."""
    return _pretrain_stack_conf(
        lambda i, o: AutoEncoder(n_in=i, n_out=o,
                                 corruption_level=corruption_level,
                                 activation="sigmoid"),
        n_in, hidden, num_classes, seed, learning_rate, updater)


def _build(conf, device) -> MultiLayerNetwork:
    return MultiLayerNetwork(conf, device=device).init(
        input_shape=(1, conf.layers[0].n_in))


def build_dbn(device=None, **kwargs) -> MultiLayerNetwork:
    """An initialized DBN on ``device`` (the card unless "cpu")."""
    return _build(dbn_conf(**kwargs), device)


def build_stacked_autoencoder(device=None, **kwargs) -> MultiLayerNetwork:
    """An initialized stacked autoencoder on ``device``."""
    return _build(stacked_autoencoder_conf(**kwargs), device)
