"""ComputationGraph configuration: the DAG spec, ``GraphBuilder`` and the
vertex confs (counterpart: ``deeplearning4j_tpu/nn/conf/graph.py`` — all
of it: ``GraphVertex`` and ``register_vertex``; the Merge, ElementWise,
Subset, Scale, Preprocessor, LastTimeStep and DuplicateToTimeSeries
vertices; ``ComputationGraphConfiguration`` with ``validate``,
``topological_order`` and its dict/JSON/YAML round trip; ``GraphBuilder``).

The reference's ``ComputationGraphConfiguration`` and
``GraphBuilder.addInputs/addLayer/addVertex/setOutputs``. Vertex forward
functions live in ``nn/graph.py``. The feature axis is the last axis
everywhere (NHWC for CNN activations, [B, T, F] for sequences), so Merge
and Subset act on axis -1. The JSON is the JAX package's string, byte for
byte, so a graph zip written by either package reads in the other; YAML
imports ``yaml`` lazily, as the JAX package does.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.layers import (
    Layer,
    layer_from_dict,
    resolve,
)

# ---------------------------------------------------------------------------
# vertex conf registry (role of Jackson subtype registration for vertices)
# ---------------------------------------------------------------------------

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class GraphVertex:
    """Base class for non-layer vertex configs."""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GraphVertex":
        d = dict(d)
        cls = VERTEX_REGISTRY[d.pop("type")]
        return cls(**d)


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate inputs along the feature (last) axis
    (reference nn/conf/graph/MergeVertex.java)."""


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise combine: add | subtract | product | average | max
    (reference nn/conf/graph/ElementWiseVertex.java — Add/Subtract/Product)."""

    op: str = "add"

    def __post_init__(self):
        if self.op not in ("add", "subtract", "product", "average", "max"):
            raise ValueError(f"unknown elementwise op {self.op}")


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """Feature-range slice [from_index, to_index] inclusive, reference
    nn/conf/graph/SubsetVertex.java semantics."""

    from_index: int = 0
    to_index: int = 0


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """Multiply input by a fixed scalar."""

    scale: float = 1.0


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """Wraps an InputPreProcessor as a standalone vertex
    (reference nn/conf/graph/PreprocessorVertex.java)."""

    preprocessor: Any = None

    def to_dict(self) -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_to_dict

        return {
            "type": "PreprocessorVertex",
            "preprocessor": preprocessor_to_dict(self.preprocessor),
        }


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B,T,F] -> [B,F]: final time step, or the last unmasked step when the
    named input carries a mask (reference nn/conf/graph/rnn/LastTimeStepVertex.java)."""

    mask_input: Optional[str] = None


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B,F] -> [B,T,F] with T taken from the named reference input
    (reference nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java)."""

    reference_input: str = ""


def _vertex_from_dict(d: Dict[str, Any]) -> GraphVertex:
    d = dict(d)
    t = d["type"]
    if t == "PreprocessorVertex":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_from_dict

        return PreprocessorVertex(preprocessor=preprocessor_from_dict(d["preprocessor"]))
    return GraphVertex.from_dict(d)


# ---------------------------------------------------------------------------
# the graph configuration
# ---------------------------------------------------------------------------


@dataclass
class ComputationGraphConfiguration:
    """Serializable DAG spec. `vertices[name]` is either a resolved layer
    conf (layer vertex) or a GraphVertex; `vertex_inputs[name]` lists input
    names (graph inputs or other vertices) in order."""

    inputs: List[str] = field(default_factory=list)
    vertices: Dict[str, Any] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: List[str] = field(default_factory=list)
    input_preprocessors: Dict[str, Any] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    gradient_checkpointing: bool = False  # remat layer activations
    dtype_policy: str = "strict"  # 'performance' = bf16 compute / f32 masters
    tbptt_back_length: int = 20
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

    # ---------------------------------------------------------------- checks
    def validate(self) -> None:
        """Structural validation (reference ComputationGraphConfiguration
        .validate(): unknown inputs, missing outputs, cycles)."""
        if not self.inputs:
            raise ValueError("graph has no inputs (addInputs)")
        if not self.outputs:
            raise ValueError("graph has no outputs (setOutputs)")
        known = set(self.inputs) | set(self.vertices)
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                if i not in known:
                    raise ValueError(f"vertex '{name}' references unknown input '{i}'")
        for o in self.outputs:
            if o not in self.vertices:
                raise ValueError(f"output '{o}' is not a vertex")
        self.topological_order()  # raises on cycle

    def topological_order(self) -> List[str]:
        """Kahn topological sort of vertex names (reference
        ComputationGraph.topologicalSortOrder() :279,511-540)."""
        indeg = {name: 0 for name in self.vertices}
        consumers: Dict[str, List[str]] = {}
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                if i in self.vertices:
                    indeg[name] += 1
                    consumers.setdefault(i, []).append(name)
        # deterministic order: insertion order of `vertices` for ties
        ready = [n for n in self.vertices if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in consumers.get(n, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"graph has a cycle involving {sorted(cyc)}")
        return order

    # ----------------------------------------------------------------- serde
    def to_dict(self) -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_to_dict

        def vert(v):
            if isinstance(v, Layer):
                d = v.to_dict()
                d["vertex_kind"] = "layer"
                return d
            d = v.to_dict()
            d["vertex_kind"] = "graph"
            return d

        return {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration",
            "version": 1,
            "inputs": list(self.inputs),
            "vertices": {k: vert(v) for k, v in self.vertices.items()},
            "vertex_inputs": {k: list(v) for k, v in self.vertex_inputs.items()},
            "outputs": list(self.outputs),
            "input_preprocessors": {
                k: preprocessor_to_dict(v)
                for k, v in self.input_preprocessors.items()
            },
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "gradient_checkpointing": self.gradient_checkpointing,
            "dtype_policy": self.dtype_policy,
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
    def from_dict(d: Dict[str, Any]) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import preprocessor_from_dict

        def vert(vd):
            vd = dict(vd)
            kind = vd.pop("vertex_kind")
            if kind == "layer":
                return layer_from_dict(vd)
            return _vertex_from_dict(vd)

        return ComputationGraphConfiguration(
            inputs=list(d["inputs"]),
            vertices={k: vert(v) for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            outputs=list(d["outputs"]),
            input_preprocessors={
                k: preprocessor_from_dict(v)
                for k, v in (d.get("input_preprocessors") or {}).items()
            },
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            gradient_checkpointing=d.get("gradient_checkpointing", False),
            dtype_policy=d.get("dtype_policy", "strict"),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            seed=d.get("seed", 123),
            iterations=d.get("iterations", 1),
            optimization_algo=d.get("optimization_algo", "stochastic_gradient_descent"),
            max_num_line_search_iterations=d.get("max_num_line_search_iterations", 5),
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
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    # YAML round-trip (reference NeuralNetConfiguration.java:285-345)
    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml

        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))


# ---------------------------------------------------------------------------
# GraphBuilder
# ---------------------------------------------------------------------------


class GraphBuilder:
    """Fluent DAG builder (reference GraphBuilder :569-605).

    Usage:
        conf = (NeuralNetConfiguration.builder().learning_rate(0.1)
                .graph_builder()
                .add_inputs("in")
                .add_layer("d1", DenseLayer(n_in=4, n_out=8), "in")
                .add_vertex("merge", MergeVertex(), "d1", "in")
                .add_layer("out", OutputLayer(n_in=12, n_out=3,
                           activation="softmax", loss_function="mcxent"),
                           "merge")
                .set_outputs("out")
                .build())
    """

    def __init__(self, parent):
        self._parent = parent  # nn.conf.builder.Builder
        self._inputs: List[str] = []
        self._vertices: Dict[str, Any] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._outputs: List[str] = []
        self._input_preprocessors: Dict[str, Any] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._tbptt_fwd_length = 20
        self._gradient_checkpointing = False
        self._dtype_policy = "strict"
        self._tbptt_back_length = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(
        self, name: str, layer: Layer, *inputs: str, preprocessor=None
    ) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name '{name}'")
        self._vertices[name] = layer
        self._vertex_inputs[name] = list(inputs)
        if preprocessor is not None:
            self._input_preprocessors[name] = preprocessor
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name '{name}'")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop(self, b: bool) -> "GraphBuilder":
        self._backprop = bool(b)
        return self

    def pretrain(self, b: bool) -> "GraphBuilder":
        self._pretrain = bool(b)
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        t = t.lower()
        if t not in ("standard", "truncated_bptt"):
            raise ValueError(f"unknown backprop type {t}")
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd_length = int(n)
        return self

    def gradient_checkpointing(self, enabled: bool = True) -> "GraphBuilder":
        """Recompute layer activations in the backward (the remat
        ladder's ``block``)."""
        self._gradient_checkpointing = bool(enabled)
        return self

    def dtype_policy(self, policy: str) -> "GraphBuilder":
        """'strict' or 'performance' (bf16 compute / f32 masters)."""
        if policy not in ("strict", "performance"):
            raise ValueError(f"unknown dtype_policy {policy!r}")
        self._dtype_policy = policy
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back_length = int(n)
        return self

    def build(self) -> ComputationGraphConfiguration:
        g = self._parent.global_conf()
        vertices = {
            k: (resolve(copy.deepcopy(v), g) if isinstance(v, Layer) else v)
            for k, v in self._vertices.items()
        }
        conf = ComputationGraphConfiguration(
            inputs=list(self._inputs),
            vertices=vertices,
            vertex_inputs={k: list(v) for k, v in self._vertex_inputs.items()},
            outputs=list(self._outputs),
            input_preprocessors=dict(self._input_preprocessors),
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd_length,
            gradient_checkpointing=self._gradient_checkpointing,
            dtype_policy=self._dtype_policy,
            tbptt_back_length=self._tbptt_back_length,
            **self._parent.training_conf(),
        )
        conf.validate()
        return conf
