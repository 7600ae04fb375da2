"""Per-layer configuration dataclasses (counterpart:
``deeplearning4j_tpu/nn/conf/layers.py``).

The same classes, fields and defaults as the JAX package, so any layer
JSON it writes parses here and writes back to the identical string.
Hyperparameter fields default to ``None`` = "inherit from the global
builder"; :func:`resolve` fills them. RNN tensors are [batch, time,
features] and CNN tensors NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# registry for JSON serde (role of Jackson subtype registration,
# NeuralNetConfiguration.java:285-345)
# ---------------------------------------------------------------------------

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_to_dict(layer: "Layer") -> Dict[str, Any]:
    d = dataclasses.asdict(layer)
    d["type"] = type(layer).__name__
    return d


def layer_from_dict(d: Dict[str, Any]) -> "Layer":
    d = dict(d)
    cls = LAYER_REGISTRY[d.pop("type")]
    # tolerate tuples serialized as lists
    obj = cls(**d)
    return obj


def _tupled(v):
    return tuple(v) if isinstance(v, list) else v


# ---------------------------------------------------------------------------
# base classes
# ---------------------------------------------------------------------------

# Fields a layer may leave as None to inherit the global builder value
# (reference: layerwise override resolution NeuralNetConfiguration.java:703-860).
INHERITABLE = (
    "activation",
    "weight_init",
    "dist",
    "bias_init",
    "learning_rate",
    "bias_learning_rate",
    "l1",
    "l2",
    "dropout",
    "updater",
    "momentum",
    "rho",
    "rms_decay",
    "adam_mean_decay",
    "adam_var_decay",
    "epsilon",
    "gradient_normalization",
    "gradient_normalization_threshold",
)

# True defaults, applied when neither layer nor builder sets a value.
# Values follow the reference's Builder defaults
# (NeuralNetConfiguration.java:377-460): activation sigmoid, weightInit xavier,
# lr 0.1, momentum 0.5, rmsDecay 0.95, adam 0.9/0.999, updater sgd.
GLOBAL_DEFAULTS: Dict[str, Any] = {
    "activation": "sigmoid",
    "weight_init": "xavier",
    "dist": None,
    "bias_init": 0.0,
    "learning_rate": 0.1,
    "bias_learning_rate": None,  # None -> use learning_rate
    "l1": 0.0,
    "l2": 0.0,
    "dropout": 0.0,
    "updater": "sgd",
    "momentum": 0.5,
    "rho": 0.95,
    "rms_decay": 0.95,
    "adam_mean_decay": 0.9,
    "adam_var_decay": 0.999,
    "epsilon": 1e-8,
    "gradient_normalization": None,
    "gradient_normalization_threshold": 1.0,
}


@dataclass
class Layer:
    """Base layer conf. All hyperparams optional -> inherit from builder."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[dict] = None
    bias_init: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    rho: Optional[float] = None
    rms_decay: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    epsilon: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return layer_to_dict(self)


def resolve(layer: Layer, global_conf: Optional[Dict[str, Any]] = None) -> Layer:
    """Return a copy with all inheritable Nones filled from global/builder defaults."""
    global_conf = global_conf or {}
    updates = {}
    for f in INHERITABLE:
        if getattr(layer, f) is None:
            v = global_conf.get(f)
            if v is None:
                v = GLOBAL_DEFAULTS[f]
            updates[f] = v
    resolved = dataclasses.replace(layer, **updates)
    if resolved.bias_learning_rate is None:
        resolved.bias_learning_rate = resolved.learning_rate
    return resolved


@dataclass
class FeedForwardLayer(Layer):
    n_in: int = 0
    n_out: int = 0


# ---------------------------------------------------------------------------
# concrete layers
# ---------------------------------------------------------------------------


@register_layer
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer (reference: nn/conf/layers/DenseLayer.java)."""


@register_layer
@dataclass
class OutputLayer(FeedForwardLayer):
    """Output layer with a loss function (reference: nn/conf/layers/OutputLayer.java)."""

    loss_function: str = "mcxent"


@register_layer
@dataclass
class RnnOutputLayer(FeedForwardLayer):
    """Per-timestep output layer (reference: nn/conf/layers/RnnOutputLayer.java)."""

    loss_function: str = "mcxent"


@register_layer
@dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2D convolution; n_in = input channels, n_out = filters.

    Reference: nn/conf/layers/ConvolutionLayer.java (kernel/stride/padding);
    runtime nn/layers/convolution.py (cuDNN on the card; NHWC, HWIO).
    """

    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.kernel_size = _tupled(self.kernel_size)
        self.stride = _tupled(self.stride)
        self.padding = _tupled(self.padding)


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """Spatial pooling: MAX / AVG / SUM (reference: nn/conf/layers/SubsamplingLayer.java)."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.kernel_size = _tupled(self.kernel_size)
        self.stride = _tupled(self.stride)
        self.padding = _tupled(self.padding)


@register_layer
@dataclass
class BatchNormalization(FeedForwardLayer):
    """Batch normalization (reference: nn/conf/layers/BatchNormalization.java;
    runtime nn/layers/normalization/BatchNormalization.java, 348 LoC).

    gamma/beta are trainable params; running mean/var live in layer *state*
    (reference stores them in the param vector via
    BatchNormalizationParamInitializer — pytree state is the functional
    equivalent)."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False


@register_layer
@dataclass
class LocalResponseNormalization(Layer):
    """LRN across channels (reference: nn/conf/layers/LocalResponseNormalization.java)."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> vector lookup (reference: nn/conf/layers/EmbeddingLayer.java;
    runtime feedforward/embedding/EmbeddingLayer.java). Input is int indices;
    forward is a gather (runtime nn/layers/feedforward.py)."""


@register_layer
@dataclass
class ActivationLayer(Layer):
    """Standalone activation (reference: nn/conf/layers/ActivationLayer.java)."""


@register_layer
@dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder (reference: nn/conf/layers/AutoEncoder.java;
    runtime feedforward/autoencoder/AutoEncoder.java)."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss_function: str = "reconstruction_crossentropy"


@register_layer
@dataclass
class RBM(FeedForwardLayer):
    """Restricted Boltzmann machine trained by CD-k
    (reference: nn/conf/layers/RBM.java; runtime feedforward/rbm/RBM.java:101-137
    contrastiveDivergence). hidden/visible unit types: binary | gaussian |
    rectified | softmax."""

    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    k: int = 1
    sparsity: float = 0.0
    loss_function: str = "reconstruction_crossentropy"


@register_layer
@dataclass
class GravesLSTM(FeedForwardLayer):
    """LSTM with peepholes, Graves (2013) variant
    (reference: nn/conf/layers/GravesLSTM.java; runtime
    nn/layers/recurrent/LSTMHelpers.java — fwd loop :132, bwd :273,
    weight layout [wI,wF,wO,wG,wFF,wOO,wGG] :58,97-99).
    Runtime: nn/layers/recurrent.py (the K1 kernel on the card)."""

    forget_gate_bias_init: float = 1.0


@register_layer
@dataclass
class GravesBidirectionalLSTM(FeedForwardLayer):
    """Bidirectional Graves LSTM (reference:
    nn/conf/layers/GravesBidirectionalLSTM.java; runtime
    nn/layers/recurrent/GravesBidirectionalLSTM.java, 313 LoC).
    Output is the sum of forward and backward passes (reference semantics)."""

    forget_gate_bias_init: float = 1.0


@register_layer
@dataclass
class GRU(FeedForwardLayer):
    """Gated recurrent unit (reference: nn/conf/layers/GRU.java; runtime
    nn/layers/recurrent/GRU.java, 399 LoC)."""


@register_layer
@dataclass
class MultiHeadAttention(FeedForwardLayer):
    """Multi-head self-attention over [N, T, F] sequences.

    Beyond-reference capability of the JAX package. Runtime:
    nn/layers/attention.py (K5 for a masked batch, K4 without, on the
    card). n_out is the model width; head_dim = n_out // num_heads."""

    num_heads: int = 4
    causal: bool = False

    def __post_init__(self):
        if self.n_out and self.num_heads and self.n_out % self.num_heads:
            raise ValueError(
                f"n_out={self.n_out} not divisible by num_heads={self.num_heads}"
            )
