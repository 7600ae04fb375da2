"""MultiLayerConfiguration — the serializable stack spec (counterpart:
``deeplearning4j_tpu/nn/conf/multi_layer.py``).

JSON is the model identity: ``to_json`` writes the JAX package's exact
layout, and ``from_json`` reads what it writes. ``to_yaml`` and
``from_yaml`` (JAX :143-152) write and read the same dict as YAML; they
import PyYAML when called, as the graph configuration's do.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict


@dataclass
class MultiLayerConfiguration:
    layers: List[Layer] = field(default_factory=list)
    input_preprocessors: Dict[int, Any] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"  # standard | truncated_bptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    # remat of per-layer activations in training (not read by inference)
    gradient_checkpointing: bool = False
    # 'strict' = f32 everywhere (reference ND4J semantics, the north-star
    # mode); 'performance' = bf16 compute / f32 masters (MXU-native)
    dtype_policy: str = "strict"
    # training hyperparams (from the Builder)
    seed: int = 123
    iterations: int = 1
    optimization_algo: str = "stochastic_gradient_descent"
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    lr_policy: str = "none"
    lr_policy_decay_rate: Optional[float] = None
    lr_policy_steps: Optional[float] = None
    lr_policy_power: Optional[float] = None
    lr_schedule: Optional[Dict[int, float]] = None
    momentum_schedule: Optional[Dict[int, float]] = None
    regularization: bool = False

    # -- serde --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_to_dict

        return {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration",
            "version": 1,
            "layers": [l.to_dict() for l in self.layers],
            "input_preprocessors": {
                str(k): preprocessor_to_dict(v)
                for k, v in self.input_preprocessors.items()
            },
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "gradient_checkpointing": self.gradient_checkpointing,
            "dtype_policy": self.dtype_policy,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "seed": self.seed,
            "iterations": self.iterations,
            "optimization_algo": self.optimization_algo,
            "max_num_line_search_iterations": self.max_num_line_search_iterations,
            "minimize": self.minimize,
            "lr_policy": self.lr_policy,
            "lr_policy_decay_rate": self.lr_policy_decay_rate,
            "lr_policy_steps": self.lr_policy_steps,
            "lr_policy_power": self.lr_policy_power,
            "lr_schedule": (
                {str(k): v for k, v in self.lr_schedule.items()}
                if self.lr_schedule
                else None
            ),
            "momentum_schedule": (
                {str(k): v for k, v in self.momentum_schedule.items()}
                if self.momentum_schedule
                else None
            ),
            "regularization": self.regularization,
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_from_dict

        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_preprocessors={
                int(k): preprocessor_from_dict(v)
                for k, v in (d.get("input_preprocessors") or {}).items()
            },
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "standard"),
            gradient_checkpointing=d.get("gradient_checkpointing", False),
            dtype_policy=d.get("dtype_policy", "strict"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            seed=d.get("seed", 123),
            iterations=d.get("iterations", 1),
            optimization_algo=d.get(
                "optimization_algo", "stochastic_gradient_descent"
            ),
            max_num_line_search_iterations=d.get(
                "max_num_line_search_iterations", 5
            ),
            minimize=d.get("minimize", True),
            lr_policy=d.get("lr_policy", "none"),
            lr_policy_decay_rate=d.get("lr_policy_decay_rate"),
            lr_policy_steps=d.get("lr_policy_steps"),
            lr_policy_power=d.get("lr_policy_power"),
            lr_schedule=(
                {int(k): v for k, v in d["lr_schedule"].items()}
                if d.get("lr_schedule")
                else None
            ),
            momentum_schedule=(
                {int(k): v for k, v in d["momentum_schedule"].items()}
                if d.get("momentum_schedule")
                else None
            ),
            regularization=d.get("regularization", False),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    # the YAML round trip: the same dict schema as the JSON; PyYAML is
    # imported only here, as in the graph configuration
    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml

        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))
