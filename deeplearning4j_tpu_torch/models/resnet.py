"""ResNet-50 on the ComputationGraph (counterpart:
``deeplearning4j_tpu/models/resnet.py`` — ``resnet50_conf`` :65 and
``build_resnet50`` :131): a 7x7/2 stem with BN and a 3x3/2 max pool, then
16 bottleneck blocks (1x1 -> 3x3 -> 1x1, each conv followed by
BatchNormalization) in four stages of 3, 4, 6 and 3 blocks with
``ElementWiseVertex(op="add")`` shortcuts (a 1x1 projection where the
shape changes), a global average pool and a softmax head: 25.6 M
parameters at 224 x 224 x 3 and 1000 classes. The configuration JSON is
the JAX package's string. Convolutions run through cuDNN with TF32 off,
BN in tensor ops, as the CNNs of ``nn/layers`` do.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

# (num_blocks, mid_channels, out_channels) per stage
_STAGES = [(3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048)]


def _conv_bn(gb, name, n_in, n_out, kernel, stride, padding, input_name,
             activation=None):
    gb.add_layer(
        f"{name}_conv",
        ConvolutionLayer(
            n_in=n_in, n_out=n_out, kernel_size=kernel, stride=stride,
            padding=padding, activation="identity", bias_init=0.0,
        ),
        input_name,
    )
    gb.add_layer(f"{name}_bn", BatchNormalization(n_in=n_out, n_out=n_out),
                 f"{name}_conv")
    last = f"{name}_bn"
    if activation:
        gb.add_layer(f"{name}_act", ActivationLayer(activation=activation), last)
        last = f"{name}_act"
    return last


def _bottleneck(gb, name, n_in, mid, n_out, stride, input_name):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity/projection shortcut."""
    a = _conv_bn(gb, f"{name}_a", n_in, mid, (1, 1), (stride, stride), (0, 0),
                 input_name, activation="relu")
    b = _conv_bn(gb, f"{name}_b", mid, mid, (3, 3), (1, 1), (1, 1), a,
                 activation="relu")
    c = _conv_bn(gb, f"{name}_c", mid, n_out, (1, 1), (1, 1), (0, 0), b)
    if stride != 1 or n_in != n_out:
        shortcut = _conv_bn(gb, f"{name}_proj", n_in, n_out, (1, 1),
                            (stride, stride), (0, 0), input_name)
    else:
        shortcut = input_name
    gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, shortcut)
    gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def resnet50_conf(
    num_classes: int = 1000,
    input_size: int = 224,
    in_channels: int = 3,
    seed: int = 12345,
    learning_rate: float = 0.1,
    updater: str = "nesterovs",
    momentum: float = 0.9,
    l2: float = 1e-4,
    dtype_policy: str = "strict",
    gradient_checkpointing: bool = False,
):
    gb = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .momentum(momentum)
        .l2(l2)
        .weight_init("relu")  # He init, reference WeightInit.RELU
        .graph_builder()
        .add_inputs("in")
        .dtype_policy(dtype_policy)
        .gradient_checkpointing(gradient_checkpointing)
    )
    stem = _conv_bn(gb, "stem", in_channels, 64, (7, 7), (2, 2), (3, 3), "in",
                    activation="relu")
    gb.add_layer(
        "stem_pool",
        SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                         padding=(1, 1)),
        stem,
    )
    cur = "stem_pool"
    n_in = 64
    for si, (blocks, mid, n_out) in enumerate(_STAGES):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            cur = _bottleneck(gb, f"s{si}b{bi}", n_in, mid, n_out, stride, cur)
            n_in = n_out
    # 5 ceil-halving downsamples: stem conv (k7 s2 p3), stem maxpool
    # (k3 s2 p1), and the first block of stages 1-3 — each maps h -> ceil(h/2)
    final_hw = input_size
    for _ in range(5):
        final_hw = (final_hw + 1) // 2
    final_hw = max(1, final_hw)
    gb.add_layer(
        "avgpool",
        SubsamplingLayer(pooling_type="avg", kernel_size=(final_hw, final_hw),
                         stride=(final_hw, final_hw)),
        cur,
    )
    gb.add_layer(
        "out",
        OutputLayer(n_in=n_in, n_out=num_classes, activation="softmax",
                    loss_function="mcxent"),
        "avgpool",
        preprocessor=CnnToFeedForwardPreProcessor(1, 1, n_in),
    )
    return gb.set_outputs("out").build()


def build_resnet50(input_size: int = 224, num_classes: int = 1000,
                   in_channels: int = 3, device=None, **kw) -> ComputationGraph:
    """An initialized graph on ``device`` (the card unless "cpu")."""
    conf = resnet50_conf(num_classes=num_classes, input_size=input_size,
                         in_channels=in_channels, **kw)
    net = ComputationGraph(conf, device=device)
    net.init(input_shapes={"in": (input_size, input_size, in_channels)})
    return net
