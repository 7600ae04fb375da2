"""GoogLeNet / Inception-v1 on the ComputationGraph (counterpart:
``deeplearning4j_tpu/models/googlenet.py`` — ``googlenet_conf`` :133 with
``aux_heads`` and ``build_googlenet`` :173): the LRN stem, nine Inception
modules (four towers merged on the channel axis by ``MergeVertex``), and
with ``aux_heads=True`` the paper's two auxiliary softmax heads as extra
OUTPUTS of the graph, the main head first: ``output()`` returns three
arrays and ``fit`` takes three label arrays, their losses summed. The
configuration JSON is the JAX package's string.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    DenseLayer,
    LocalResponseNormalization,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

# (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj) per module — the paper's
# Table 1 ("Going Deeper with Convolutions", Szegedy et al. 2014)
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _conv(gb, name, n_in, n_out, kernel, stride, padding, input_name):
    gb.add_layer(
        name,
        ConvolutionLayer(n_in=n_in, n_out=n_out, kernel_size=kernel,
                         stride=stride, padding=padding, activation="relu"),
        input_name,
    )
    return name


def _inception(gb, name, n_in, spec, input_name):
    c1, r3, c3, r5, c5, pp = spec
    t1 = _conv(gb, f"{name}_1x1", n_in, c1, (1, 1), (1, 1), (0, 0),
               input_name)
    r3n = _conv(gb, f"{name}_3x3r", n_in, r3, (1, 1), (1, 1), (0, 0),
                input_name)
    t3 = _conv(gb, f"{name}_3x3", r3, c3, (3, 3), (1, 1), (1, 1), r3n)
    r5n = _conv(gb, f"{name}_5x5r", n_in, r5, (1, 1), (1, 1), (0, 0),
                input_name)
    t5 = _conv(gb, f"{name}_5x5", r5, c5, (5, 5), (1, 1), (2, 2), r5n)
    gb.add_layer(
        f"{name}_pool",
        SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                         stride=(1, 1), padding=(1, 1)),
        input_name,
    )
    tp = _conv(gb, f"{name}_poolproj", n_in, pp, (1, 1), (1, 1), (0, 0),
               f"{name}_pool")
    gb.add_vertex(f"{name}_out", MergeVertex(), t1, t3, t5, tp)
    return f"{name}_out", c1 + c3 + c5 + pp


def _aux_head(gb, name, n_in, hw, num_classes, input_name):
    """Auxiliary classifier (paper section 5: avgpool5/3 -> 1x1 conv 128 ->
    fc 1024 -> dropout 0.7 -> softmax) — an extra OUTPUT of the graph."""
    # paper: 5x5/3 avg pool (14 -> 4 at 224px); clamped for small inputs
    k = min(5, hw)
    gb.add_layer(
        f"{name}_pool",
        SubsamplingLayer(pooling_type="avg", kernel_size=(k, k),
                         stride=(3, 3)),
        input_name,
    )
    _conv(gb, f"{name}_conv", n_in, 128, (1, 1), (1, 1), (0, 0),
          f"{name}_pool")
    out_hw = max(1, (hw - k) // 3 + 1)
    gb.add_layer(
        f"{name}_fc",
        DenseLayer(n_in=128 * out_hw * out_hw, n_out=1024,
                   activation="relu"),
        f"{name}_conv",
        preprocessor=CnnToFeedForwardPreProcessor(out_hw, out_hw, 128),
    )
    gb.add_layer(
        name,
        OutputLayer(n_in=1024, n_out=num_classes, activation="softmax",
                    loss_function="mcxent", dropout=0.7),
        f"{name}_fc",
    )
    return name


def googlenet_conf(input_size: int = 224, num_classes: int = 1000,
                   in_channels: int = 3, aux_heads: bool = False,
                   learning_rate: float = 0.01, updater: str = "nesterovs",
                   momentum: float = 0.9, l2: float = 2e-4, seed: int = 123):
    gb = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .momentum(momentum)
        .l2(l2)
        .weight_init("relu")
        .graph_builder()
        .add_inputs("in")
    )
    # stem: conv7/2 -> pool3/2 -> LRN -> 1x1 -> 3x3 -> LRN -> pool3/2
    _conv(gb, "stem1", in_channels, 64, (7, 7), (2, 2), (3, 3), "in")
    gb.add_layer("pool1", SubsamplingLayer(pooling_type="max",
                                           kernel_size=(3, 3), stride=(2, 2),
                                           padding=(1, 1)), "stem1")
    gb.add_layer("lrn1", LocalResponseNormalization(), "pool1")
    _conv(gb, "stem2a", 64, 64, (1, 1), (1, 1), (0, 0), "lrn1")
    _conv(gb, "stem2b", 64, 192, (3, 3), (1, 1), (1, 1), "stem2a")
    gb.add_layer("lrn2", LocalResponseNormalization(), "stem2b")
    gb.add_layer("pool2", SubsamplingLayer(pooling_type="max",
                                           kernel_size=(3, 3), stride=(2, 2),
                                           padding=(1, 1)), "lrn2")

    cur, n_in = "pool2", 192
    hw = input_size
    for _ in range(3):  # stem conv + 2 maxpools, each ceil-halving
        hw = (hw + 1) // 2
    outputs = []
    for mod, spec in _INCEPTION.items():
        cur, n_in = _inception(gb, f"inc{mod}", n_in, spec, cur)
        if mod in ("3b", "4e"):  # pool between stacks 3->4 and 4->5
            gb.add_layer(f"pool_{mod}",
                         SubsamplingLayer(pooling_type="max",
                                          kernel_size=(3, 3), stride=(2, 2),
                                          padding=(1, 1)), cur)
            cur = f"pool_{mod}"
            hw = (hw + 1) // 2
        if aux_heads and mod == "4a":
            outputs.append(_aux_head(gb, "aux1", n_in, hw, num_classes, cur))
        if aux_heads and mod == "4d":
            outputs.append(_aux_head(gb, "aux2", n_in, hw, num_classes, cur))

    hw = max(1, hw)
    gb.add_layer("avgpool",
                 SubsamplingLayer(pooling_type="avg", kernel_size=(hw, hw),
                                  stride=(hw, hw)), cur)
    gb.add_layer(
        "out",
        OutputLayer(n_in=n_in, n_out=num_classes, activation="softmax",
                    loss_function="mcxent", dropout=0.4),
        "avgpool",
        preprocessor=CnnToFeedForwardPreProcessor(1, 1, n_in),
    )
    # main output FIRST (ComputationGraph.output()[0] is the main head)
    return gb.set_outputs("out", *outputs).build()


def build_googlenet(input_size: int = 224, num_classes: int = 1000,
                    in_channels: int = 3, device=None, **kw) -> ComputationGraph:
    """An initialized graph on ``device`` (the card unless "cpu")."""
    conf = googlenet_conf(input_size=input_size, num_classes=num_classes,
                          in_channels=in_channels, **kw)
    net = ComputationGraph(conf, device=device)
    net.init(input_shapes={"in": (input_size, input_size, in_channels)})
    return net
