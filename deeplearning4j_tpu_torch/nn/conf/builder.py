"""Fluent configuration builder (counterpart:
``deeplearning4j_tpu/nn/conf/builder.py``).

``NeuralNetConfiguration.builder()`` -> global setters -> ``.list()`` ->
``.layer(i, conf)`` ... ``.build()`` gives a MultiLayerConfiguration with
every layer resolved against the global defaults, exactly as the JAX
package builds it; ``.graph_builder()`` (``builder.py:201-206``) gives the
ComputationGraph's ``GraphBuilder`` (``nn/conf/graph.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.layers import GLOBAL_DEFAULTS, Layer, resolve

OPTIMIZATION_ALGOS = (
    "stochastic_gradient_descent",
    "line_gradient_descent",
    "conjugate_gradient",
    "lbfgs",
    "hessian_free",
)

LR_POLICIES = (
    "none",
    "exponential",
    "inverse",
    "poly",
    "sigmoid",
    "step",
    "schedule",
    "score",
)


class NeuralNetConfiguration:
    """Global (per-network) hyperparameters + the builder entry point."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._global: Dict[str, Any] = {}  # inheritable layer defaults
        self._seed: int = 123
        self._iterations: int = 1
        self._optimization_algo: str = "stochastic_gradient_descent"
        self._max_num_line_search_iterations: int = 5
        self._minimize: bool = True
        self._use_drop_connect: bool = False
        self._lr_policy: str = "none"
        self._lr_policy_decay_rate: Optional[float] = None
        self._lr_policy_steps: Optional[float] = None
        self._lr_policy_power: Optional[float] = None
        self._lr_schedule: Optional[Dict[int, float]] = None
        self._momentum_schedule: Optional[Dict[int, float]] = None
        self._regularization: bool = False

    # -- fluent global setters (subset mirrors Builder fields :377-703) -----
    def seed(self, s: int):
        self._seed = int(s)
        return self

    def iterations(self, n: int):
        self._iterations = int(n)
        return self

    def optimization_algo(self, algo: str):
        algo = algo.lower()
        if algo not in OPTIMIZATION_ALGOS:
            raise ValueError(f"unknown optimization algo {algo}")
        self._optimization_algo = algo
        return self

    def max_num_line_search_iterations(self, n: int):
        self._max_num_line_search_iterations = int(n)
        return self

    def minimize(self, b: bool = True):
        self._minimize = bool(b)
        return self

    def regularization(self, b: bool = True):
        self._regularization = bool(b)
        return self

    def learning_rate_policy(self, policy: str):
        policy = policy.lower()
        if policy not in LR_POLICIES:
            raise ValueError(f"unknown lr policy {policy}")
        self._lr_policy = policy
        return self

    def lr_policy_decay_rate(self, v: float):
        self._lr_policy_decay_rate = float(v)
        return self

    def lr_policy_steps(self, v: float):
        self._lr_policy_steps = float(v)
        return self

    def lr_policy_power(self, v: float):
        self._lr_policy_power = float(v)
        return self

    def learning_rate_schedule(self, schedule: Dict[int, float]):
        self._lr_schedule = {int(k): float(v) for k, v in schedule.items()}
        self._lr_policy = "schedule"
        return self

    def momentum_after(self, schedule: Dict[int, float]):
        self._momentum_schedule = {int(k): float(v) for k, v in schedule.items()}
        return self

    def _set(self, k, v):
        self._global[k] = v
        return self

    def activation(self, v: str):
        return self._set("activation", v)

    def weight_init(self, v: str):
        return self._set("weight_init", v)

    def dist(self, v: dict):
        return self._set("dist", v)

    def bias_init(self, v: float):
        return self._set("bias_init", float(v))

    def learning_rate(self, v: float):
        return self._set("learning_rate", float(v))

    def bias_learning_rate(self, v: float):
        return self._set("bias_learning_rate", float(v))

    def l1(self, v: float):
        self._regularization = True
        return self._set("l1", float(v))

    def l2(self, v: float):
        self._regularization = True
        return self._set("l2", float(v))

    def drop_out(self, v: float):
        return self._set("dropout", float(v))

    def updater(self, v: str):
        return self._set("updater", v.lower())

    def momentum(self, v: float):
        return self._set("momentum", float(v))

    def rho(self, v: float):
        return self._set("rho", float(v))

    def rms_decay(self, v: float):
        return self._set("rms_decay", float(v))

    def adam_mean_decay(self, v: float):
        return self._set("adam_mean_decay", float(v))

    def adam_var_decay(self, v: float):
        return self._set("adam_var_decay", float(v))

    def epsilon(self, v: float):
        return self._set("epsilon", float(v))

    def gradient_normalization(self, v: str):
        return self._set("gradient_normalization", v.lower())

    def gradient_normalization_threshold(self, v: float):
        return self._set("gradient_normalization_threshold", float(v))

    # -- transition to the layer-stack builder ------------------------------
    def list(self) -> "ListBuilder":
        return ListBuilder(self)

    def graph_builder(self):
        """Transition to the DAG builder (reference
        ComputationGraphConfiguration.GraphBuilder :569-605)."""
        from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

        return GraphBuilder(self)

    def global_conf(self) -> Dict[str, Any]:
        g = dict(GLOBAL_DEFAULTS)
        g.update(self._global)
        return g

    def training_conf(self) -> Dict[str, Any]:
        """The non-layer training hyperparams carried into the network conf."""
        return {
            "seed": self._seed,
            "iterations": self._iterations,
            "optimization_algo": self._optimization_algo,
            "max_num_line_search_iterations": self._max_num_line_search_iterations,
            "minimize": self._minimize,
            "lr_policy": self._lr_policy,
            "lr_policy_decay_rate": self._lr_policy_decay_rate,
            "lr_policy_steps": self._lr_policy_steps,
            "lr_policy_power": self._lr_policy_power,
            "lr_schedule": self._lr_schedule,
            "momentum_schedule": self._momentum_schedule,
            "regularization": self._regularization,
        }


class ListBuilder:
    """Layer-stack builder (reference ListBuilder :151-180)."""

    def __init__(self, parent: Builder):
        self._parent = parent
        self._layers: Dict[int, Layer] = {}
        self._preprocessors: Dict[int, Any] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._gradient_checkpointing = False
        self._dtype_policy = "strict"
        self._tbptt_fwd_length = 20
        self._tbptt_back_length = 20

    def layer(self, index: int, layer: Layer) -> "ListBuilder":
        self._layers[int(index)] = layer
        return self

    def add(self, layer: Layer) -> "ListBuilder":
        self._layers[len(self._layers)] = layer
        return self

    def input_preprocessor(self, index: int, preprocessor) -> "ListBuilder":
        self._preprocessors[int(index)] = preprocessor
        return self

    def backprop(self, b: bool) -> "ListBuilder":
        self._backprop = bool(b)
        return self

    def pretrain(self, b: bool) -> "ListBuilder":
        self._pretrain = bool(b)
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        t = t.lower()
        if t not in ("standard", "truncated_bptt"):
            raise ValueError(f"unknown backprop type {t}")
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd_length = int(n)
        return self

    def gradient_checkpointing(self, enabled: bool = True) -> "ListBuilder":
        """Rematerialize layer activations in the backward pass (a
        training option; the port's inference path does not read it)."""
        self._gradient_checkpointing = bool(enabled)
        return self

    def dtype_policy(self, policy: str) -> "ListBuilder":
        """'strict' (f32, reference semantics) or 'performance' (bf16
        compute with f32 master params)."""
        if policy not in ("strict", "performance"):
            raise ValueError(f"unknown dtype_policy {policy!r}")
        self._dtype_policy = policy
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back_length = int(n)
        return self

    def build(self):
        from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration

        if not self._layers:
            raise ValueError("no layers configured")
        n = max(self._layers) + 1
        missing = [i for i in range(n) if i not in self._layers]
        if missing:
            raise ValueError(f"missing layer indices: {missing}")
        g = self._parent.global_conf()
        layers: List[Layer] = [
            resolve(copy.deepcopy(self._layers[i]), g) for i in range(n)
        ]
        return MultiLayerConfiguration(
            layers=layers,
            input_preprocessors=dict(self._preprocessors),
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            gradient_checkpointing=self._gradient_checkpointing,
            dtype_policy=self._dtype_policy,
            tbptt_fwd_length=self._tbptt_fwd_length,
            tbptt_back_length=self._tbptt_back_length,
            **self._parent.training_conf(),
        )
