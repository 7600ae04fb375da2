"""ComputationGraph, the DAG network container (counterpart:
``deeplearning4j_tpu/nn/graph.py`` — ``init`` with input-shape inference
:114-180, ``_vertex_out_shape``, ``_apply_vertex`` :210-251, ``_forward``
with mask propagation :253-313, ``_regularization_penalty`` and the
summed multi-output ``_loss`` :315-402, the train step and the bf16
loss-scaled step :417-540, ``fit_batches`` :689, ``fit`` :742 (the Solver
for non-SGD algorithms), ``_bucket_batch`` :790, the TBPTT window loop
:837-921, ``fit_iterator`` :922 over DataSets and MultiDataSets,
``output`` :1026, ``feed_forward``, ``score``, ``evaluate``,
``rnn_clear_previous_state`` / ``rnn_time_step`` :1125-1172,
``apply_lr_score_decay``, ``training_state`` :1187-1205 and ``clone``;
plus ``load``, the counterpart of
``ModelSerializer.restore_computation_graph``).

Params, layer states and updater state are dicts keyed by layer-vertex
name (the JAX layout, so a graph zip maps leaf for leaf), each a dict of
tensors on ``device`` — the card unless the caller passes
``device="cpu"``. ``init`` draws fresh weights from a ``torch.Generator``
seeded with ``conf.seed``, layer by layer in topological order (not the
JAX package's bits); :func:`params_from_numpy` carries a JAX graph's dicts
over bit for bit.

Every vertex runs in topological order over a dict of activations; each
layer vertex goes through ``nn/common.apply_layer`` as in the
MultiLayerNetwork, so a GravesLSTM vertex runs K1 (and K2 in the
backward) on the card. A vertex inherits the mask of its first masked
input; LastTimeStep drops it. The loss is the sum of every output layer's
loss plus the l1/l2 penalty; a step is ``nn/common.train_iteration``
(bf16 and loss-scaled under ``DL4J_TPU_BF16``). ``fit_batches`` and a
fused ``fit_iterator`` are K serial fits, which is the JAX package's
contract for its fused scan. Not ported: ``MemoryStats`` /
``measure_memory`` (the XLA AOT ledger), ``register_net`` and the input
pipeline wrap of ``fit_iterator``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.common import (
    LossScaled,
    apply_layer,
    cast_loss_input,
    decay_lr_scale_entry,
    promote_to,
    tbptt_backprop_window,
    train_iteration,
)
from deeplearning4j_tpu_torch.nn.conf import layers as conf_layers
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    GraphVertex,
    LastTimeStepVertex,
    MergeVertex,
    PreprocessorVertex,
    ScaleVertex,
    SubsetVertex,
)
from deeplearning4j_tpu_torch.nn.layers.factory import (
    RNN_CONFS,
    STATEFUL_RNN_CONFS,
    create_layer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayerImpl
from deeplearning4j_tpu_torch.nn.multilayer import _fill, _host, params_from_numpy
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.ops import rng as rng_mod
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optimize.updaters import (
    LayerUpdater,
    flatten_paths,
)

_REG_PARAM_NAMES = ("W", "U")


def _as_list(x) -> List:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class GraphUpdater:
    """One ``LayerUpdater`` per layer vertex over the name-keyed dicts
    (``_update_all`` :403); a parameterless layer passes through."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 layer_names: Sequence[str]):
        self.updaters = {n: LayerUpdater(conf.vertices[n], conf)
                         for n in layer_names}

    def init(self, params):
        return {n: u.init(params[n]) for n, u in self.updaters.items()}

    def update(self, grads, state, params, iteration):
        updates, new_state = {}, {}
        for n, u in self.updaters.items():
            if not grads[n]:
                updates[n], new_state[n] = grads[n], state[n]
                continue
            updates[n], new_state[n] = u.update(grads[n], state[n],
                                                params[n], iteration)
        return updates, new_state


class ComputationGraph(LossScaled):
    """DAG of layer vertices and combining vertices over named inputs."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device=None) -> None:
        conf.validate()
        self.device = resolve_device(device)
        self.conf = conf
        self.topo = conf.topological_order()
        self.layer_names = [n for n in self.topo
                            if isinstance(conf.vertices[n], conf_layers.Layer)]
        self.layers = {n: create_layer(conf.vertices[n])
                       for n in self.layer_names}
        self.updater = GraphUpdater(conf, self.layer_names)
        self.params: Optional[Dict[str, Any]] = None
        self.states: Optional[Dict[str, Any]] = None
        self.updater_state: Optional[Dict[str, Any]] = None
        self.iteration = 0
        self.listeners: list = []
        self._score: Optional[torch.Tensor] = None
        self._input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
        # the bf16 dynamic loss scale (DL4J_TPU_BF16), made at first use
        self._loss_scale: Optional[Dict[str, torch.Tensor]] = None
        self.dispatch_stats = dispatch.DispatchStats()
        # BN batch statistics would absorb pad rows in training
        self._bucketing_blocked = any(
            isinstance(v, conf_layers.BatchNormalization)
            for v in conf.vertices.values())
        self._bucket_scope = False  # True while fit_iterator drives fit()
        # the ledgers join the metrics registry (JAX nn/graph.py :109-111)
        from deeplearning4j_tpu_torch.obs.registry import register_net

        register_net(self)

    # ------------------------------------------------------------------ init
    def _infer_input_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Per-input feature shapes from each input's first consuming
        layer (dense and recurrent only; a CNN-fed input needs explicit
        shapes)."""
        shapes: Dict[str, Tuple[int, ...]] = {}
        for inp in self.conf.inputs:
            for name, ins in self.conf.vertex_inputs.items():
                if inp in ins:
                    v = self.conf.vertices[name]
                    if isinstance(v, RNN_CONFS):
                        shapes[inp] = (-1, v.n_in)
                        break
                    if isinstance(v, conf_layers.ConvolutionLayer):
                        raise ValueError(
                            f"input '{inp}' feeds a CNN; pass explicit "
                            "input_shapes to init()")
                    if isinstance(v, conf_layers.FeedForwardLayer):
                        shapes[inp] = (v.n_in,)
                        break
            if inp not in shapes:
                raise ValueError(
                    f"cannot infer shape for input '{inp}'; pass input_shapes")
        return shapes

    def init(self, input_shapes: Union[Dict[str, Sequence[int]],
                                       Sequence[Sequence[int]], None] = None
             ) -> "ComputationGraph":
        """Fresh params, states and updater state, shapes propagated in
        topological order."""
        if input_shapes is None:
            shapes = self._infer_input_shapes()
        elif isinstance(input_shapes, dict):
            shapes = {k: tuple(v) for k, v in input_shapes.items()}
        else:
            shapes = {n: tuple(s)
                      for n, s in zip(self.conf.inputs, input_shapes)}
        self._input_shapes = dict(shapes)
        vshape: Dict[str, Tuple[int, ...]] = dict(shapes)
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        params: Dict[str, Any] = {}
        states: Dict[str, Any] = {}
        for name in self.topo:
            v = self.conf.vertices[name]
            in_shapes = [vshape[i] for i in self.conf.vertex_inputs[name]]
            if isinstance(v, conf_layers.Layer):
                shape = in_shapes[0]
                pp = self.conf.input_preprocessors.get(name)
                if pp is not None:
                    shape = pp.out_shape(shape)
                p, s, out_shape = self.layers[name].initialize(gen, shape)
                params[name], states[name] = p, s
                vshape[name] = tuple(out_shape)
            else:
                vshape[name] = self._vertex_out_shape(v, name, in_shapes)
        self.params, self.states = params, states
        self.updater_state = self.updater.init(params)
        return self

    def _vertex_out_shape(self, v: GraphVertex, name: str, in_shapes
                          ) -> Tuple[int, ...]:
        if isinstance(v, MergeVertex):
            base = list(in_shapes[0])
            base[-1] = sum(s[-1] for s in in_shapes)
            return tuple(base)
        if isinstance(v, (ElementWiseVertex, ScaleVertex)):
            return tuple(in_shapes[0])
        if isinstance(v, SubsetVertex):
            base = list(in_shapes[0])
            base[-1] = v.to_index - v.from_index + 1
            return tuple(base)
        if isinstance(v, PreprocessorVertex):
            return tuple(v.preprocessor.out_shape(tuple(in_shapes[0])))
        if isinstance(v, LastTimeStepVertex):
            return tuple(in_shapes[0][1:])  # drop the time axis
        if isinstance(v, DuplicateToTimeSeriesVertex):
            ref = (self._input_shapes or {}).get(v.reference_input)
            t = ref[0] if ref and len(ref) >= 2 else -1
            return (t,) + tuple(in_shapes[0])
        raise ValueError(f"unknown vertex type {type(v).__name__} for '{name}'")

    def num_params(self) -> int:
        return sum(int(v.numel()) for v in tree_leaves(self.params))

    @classmethod
    def load(cls, path: str, device=None,
             load_updater: bool = True) -> "ComputationGraph":
        """Read a graph zip written by the JAX package's
        ``ModelSerializer.write_model`` or by the port's ``write_model``:
        the configuration, the input shapes from the metadata, the
        coefficients, layer states, updater state (unless
        ``load_updater`` is False), the iteration and the training state.
        Every leaf the configuration implies must be there with its shape
        (a layout mismatch raises); a leafless vertex (a pooling layer's
        ``{}``) writes nothing and comes from the template."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_model_zip,
        )

        z = read_model_zip(path, "ComputationGraph")
        net = cls(ComputationGraphConfiguration.from_json(z["conf"]),
                  device=device)
        ishape = z["meta"].get("input_shape")
        net.init({k: tuple(v) for k, v in ishape.items()} if ishape
                 else None)

        def tree(data):
            return params_from_numpy(npz_bytes_to_tree(data),
                                     device=net.device)

        net.params = _fill(net.params, tree(z["coefficients"]),
                           "coefficients")
        if z["state"] is not None:
            net.states = _fill(net.states, tree(z["state"]), "state")
        if load_updater and z["updater"] is not None:
            net.updater_state = _fill(net.updater_state, tree(z["updater"]),
                                      "updater")
        net.iteration = int(z["meta"].get("iteration", 0))
        net.restore_training_state(z["training_state"])
        return net

    # --------------------------------------------------------------- forward
    def _apply_vertex(self, v: GraphVertex, xs: List[torch.Tensor],
                      inputs: Dict[str, torch.Tensor],
                      masks: Dict[str, torch.Tensor]) -> torch.Tensor:
        if isinstance(v, MergeVertex):
            return torch.cat(xs, dim=-1)
        if isinstance(v, ElementWiseVertex):
            y = xs[0]
            if v.op == "add":
                for x in xs[1:]:
                    y = y + x
            elif v.op == "subtract":
                for x in xs[1:]:
                    y = y - x
            elif v.op == "product":
                for x in xs[1:]:
                    y = y * x
            elif v.op == "average":
                y = sum(xs) / float(len(xs))
            elif v.op == "max":
                for x in xs[1:]:
                    y = torch.maximum(y, x)
            return y
        if isinstance(v, SubsetVertex):
            return xs[0][..., v.from_index:v.to_index + 1]
        if isinstance(v, ScaleVertex):
            return xs[0] * v.scale
        if isinstance(v, PreprocessorVertex):
            return v.preprocessor(xs[0])
        if isinstance(v, LastTimeStepVertex):
            x = xs[0]  # [B, T, F]
            mask = masks.get(v.mask_input) if v.mask_input else None
            if mask is None:
                return x[:, -1, :]
            # the last unmasked step of each example
            idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        if isinstance(v, DuplicateToTimeSeriesVertex):
            t = inputs[v.reference_input].shape[1]
            x = xs[0]
            return x[:, None, :].expand(x.shape[0], t, x.shape[1])
        raise ValueError(f"unknown vertex type {type(v).__name__}")

    def _dropout_gen(self, name: str, train: bool, step: Optional[int]):
        """The dropout generator of layer vertex ``name`` at ``step`` (its
        stream is keyed by the vertex's topological index), or None when
        it draws nothing."""
        if not train or not (self.conf.vertices[name].dropout or 0.0) > 0:
            return None
        return rng_mod.layer_generator(self.conf.seed, step,
                                       self.topo.index(name), self.device)

    def _forward(self, params, states, inputs: Dict[str, torch.Tensor], *,
                 train: bool = False, step: Optional[int] = None,
                 masks: Optional[Dict[str, torch.Tensor]] = None,
                 carry_state: bool = False,
                 backprop_window: Optional[int] = None):
        """Every vertex in topological order: (activations by name, the
        inputs included; new states)."""
        masks = dict(masks or {})
        acts: Dict[str, torch.Tensor] = dict(inputs)
        new_states = dict(states)
        for name in self.topo:
            v = self.conf.vertices[name]
            ins = self.conf.vertex_inputs[name]
            xs = [acts[i] for i in ins]
            in_mask = next((masks[i] for i in ins if i in masks), None)
            if isinstance(v, conf_layers.Layer):
                x = xs[0]
                pp = self.conf.input_preprocessors.get(name)
                if pp is not None:
                    x = pp(x)
                kwargs = {}
                if isinstance(v, STATEFUL_RNN_CONFS):
                    if carry_state:
                        kwargs["carry_state"] = True
                    if backprop_window is not None:
                        kwargs["backprop_window"] = backprop_window
                y, new_states[name] = apply_layer(
                    self.layers[name], self.conf, params[name], states[name],
                    x, self._dropout_gen(name, train, step),
                    in_mask if isinstance(v, RNN_CONFS) else None, kwargs,
                    train=train)
                if in_mask is not None:
                    masks[name] = in_mask
            else:
                y = self._apply_vertex(v, xs, inputs, masks)
                if in_mask is not None and not isinstance(
                        v, LastTimeStepVertex):
                    masks[name] = in_mask
            acts[name] = y
        return acts, new_states

    def _regularization_penalty(self, params):
        total = 0.0
        for name in self.layer_names:
            lc = self.conf.vertices[name]
            l1 = lc.l1 or 0.0
            l2 = lc.l2 or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for path, leaf in flatten_paths(params[name]).items():
                if path[-1] in _REG_PARAM_NAMES:
                    if l2:
                        total = total + 0.5 * l2 * torch.sum(leaf * leaf)
                    if l1:
                        total = total + l1 * torch.sum(torch.abs(leaf))
        return total

    def _loss(self, params, states, inputs, labels: List[torch.Tensor], *,
              train: bool, step: Optional[int] = None, masks=None,
              label_masks: Optional[List] = None, carry_state: bool = False,
              backprop_window: Optional[int] = None):
        """(sum of the output layers' losses + the penalty, new states).
        Each output's loss runs from its input activation (softmax with
        mcxent fused); its label mask defaults to the mask propagated to
        that input."""
        acts, new_states = self._forward(
            params, states, inputs, train=train, step=step, masks=masks,
            carry_state=carry_state, backprop_window=backprop_window)
        prop = dict(masks or {})
        for name in self.topo:
            ins = self.conf.vertex_inputs[name]
            m = next((prop[i] for i in ins if i in prop), None)
            if m is not None and not isinstance(self.conf.vertices[name],
                                                LastTimeStepVertex):
                prop[name] = m
        total = 0.0
        for oi, oname in enumerate(self.conf.outputs):
            impl = self.layers[oname]
            if not isinstance(impl, OutputLayerImpl):
                raise ValueError(f"output vertex '{oname}' is not an "
                                 "OutputLayer/RnnOutputLayer")
            in_name = self.conf.vertex_inputs[oname][0]
            x = acts[in_name]
            pp = self.conf.input_preprocessors.get(oname)
            if pp is not None:
                x = pp(x)
            x = impl._dropout_in(x, train,
                                 self._dropout_gen(oname, train, step))
            lm = label_masks[oi] if label_masks else None
            if lm is None:
                lm = prop.get(in_name)
            x = cast_loss_input(x)
            total = total + impl.loss(promote_to(params[oname], x), x,
                                      labels[oi], lm)
        return total + self._regularization_penalty(params), new_states

    def _train_step(self, inputs, labels, masks, label_masks, *,
                    carry_state: bool = False,
                    backprop_window: Optional[int] = None) -> torch.Tensor:
        """One optimizer iteration on this batch (loss-scaled in bf16
        under ``DL4J_TPU_BF16``). Returns the loss."""
        def loss_fn(params, xs):
            return self._loss(params, self.states, xs, labels, train=True,
                              step=self.iteration, masks=masks,
                              label_masks=label_masks,
                              carry_state=carry_state,
                              backprop_window=backprop_window)

        loss, self.states = train_iteration(self, loss_fn, inputs)
        return loss

    # ------------------------------------------------------------------- fit
    @property
    def score_value(self) -> float:
        return float("nan") if self._score is None else float(self._score)

    def _record_iteration(self, loss) -> None:
        self._score = loss
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, loss)
        self.iteration += 1

    def _as_input(self, x) -> torch.Tensor:
        """A tensor on the graph's device; floating data in the params'
        dtype (f32, or f64 when the params are f64)."""
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        x = torch.as_tensor(x, device=self.device)
        dtype = next(iter(tree_leaves(self.params or {})), None)
        dtype = None if dtype is None else dtype.dtype
        return x.to(dtype) if x.is_floating_point() and dtype else x

    def _as_inputs(self, features) -> Dict[str, torch.Tensor]:
        feats = _as_list(features)
        if len(feats) != len(self.conf.inputs):
            raise ValueError(
                f"expected {len(self.conf.inputs)} inputs, got {len(feats)}")
        return {n: self._as_input(f) for n, f in zip(self.conf.inputs, feats)}

    def _as_labels(self, labels) -> List[torch.Tensor]:
        labels_l = [self._as_input(l) for l in _as_list(labels)]
        if len(labels_l) != len(self.conf.outputs):
            raise ValueError(f"expected {len(self.conf.outputs)} label "
                             f"arrays, got {len(labels_l)}")
        return labels_l

    def _as_masks(self, masks) -> Dict[str, torch.Tensor]:
        """A masks argument (a dict by input name, or a list in the conf's
        input order) as the name-keyed dict ``_forward`` takes."""
        if masks is None:
            return {}
        if isinstance(masks, dict):
            return {k: self._as_input(m) for k, m in masks.items()
                    if m is not None}
        return {n: self._as_input(m)
                for n, m in zip(self.conf.inputs, _as_list(masks))
                if m is not None}

    def _as_label_masks(self, label_masks):
        if label_masks is None:
            return None
        return [None if m is None else self._as_input(m)
                for m in _as_list(label_masks)]

    def fit(self, features, labels, masks=None, label_masks=None):
        """One MultiDataSet fit (``features``/``labels``: an array or a
        list in the conf's input/output order): ``conf.iterations``
        optimizer iterations, or for a ``truncated_bptt`` conf one per
        window; under a non-SGD ``optimization_algo`` one Solver run.
        Returns the last loss (a 0-d tensor on the device)."""
        if self.params is None:
            self.init()
        inputs = self._as_inputs(features)
        labels_l = self._as_labels(labels)
        masks_d = self._as_masks(masks)
        lmasks = self._as_label_masks(label_masks)
        if self.conf.backprop_type == "truncated_bptt":
            return self._fit_tbptt(inputs, labels_l, masks_d, lmasks)
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            from deeplearning4j_tpu_torch.optimize.solvers import Solver

            Solver(self).optimize_graph(inputs, labels_l, masks_d, lmasks)
            return self._score
        inputs, labels_l, masks_d, lmasks = self._bucket_batch(
            inputs, labels_l, masks_d, lmasks)
        loss = None
        for _ in range(max(1, self.conf.iterations)):
            loss = self._train_step(inputs, labels_l, masks_d, lmasks)
            self._record_iteration(loss)
        return loss

    def _bucket_batch(self, inputs, labels_l, masks_d, lmasks):
        """Pad every input, label and mask along the example axis to its
        bucket, with a label mask per output that keeps the pad rows out
        of its loss (``dispatch.bucketing_mode``: by default inside
        ``fit_iterator`` only; never with BatchNormalization; skipped when
        feature masks come without a full set of label masks, whose
        propagation this hook cannot check)."""
        mode = dispatch.bucketing_mode()
        if (mode == "off" or (mode == "auto" and not self._bucket_scope)
                or self._bucketing_blocked):
            return inputs, labels_l, masks_d, lmasks
        explicit = lmasks is not None and all(m is not None for m in lmasks)
        if masks_d and not explicit:
            return inputs, labels_l, masks_d, lmasks
        n = next(iter(inputs.values())).shape[0]
        target = dispatch.bucket_size(n)
        if target != n:
            ik, mk = list(inputs), list(masks_d)
            padded = dispatch.pad_rows(
                target, [inputs[k] for k in ik] + labels_l
                + [masks_d[k] for k in mk])
            inputs = dict(zip(ik, padded[:len(ik)]))
            labels_l = padded[len(ik):len(ik) + len(labels_l)]
            masks_d = dict(zip(mk, padded[len(ik) + len(labels_l):]))
        new_lmasks = []
        for oi, lab in enumerate(labels_l):
            lm = lmasks[oi] if lmasks is not None else None
            if lm is not None:
                lm = dispatch.pad_axis0(lm, target)
            else:
                lm = dispatch.row_validity_mask(
                    n, target, lab.shape[1] if lab.dim() == 3 else None,
                    device=self.device)
            new_lmasks.append(lm)
        return inputs, labels_l, masks_d, new_lmasks

    def fit_batches(self, features, labels) -> np.ndarray:
        """``fit`` of each leading-axis slice of [K, N, ...] stacks (an
        array, or a list per input and per output), in order; returns the
        K * iterations losses. SGD-family, non-TBPTT, mask-free."""
        if self.params is None:
            self.init()
        if self.conf.backprop_type == "truncated_bptt":
            raise ValueError("fit_batches: use fit() for TBPTT training")
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            raise ValueError("fit_batches supports SGD-family training only")
        feats, labs = _as_list(features), _as_list(labels)
        if len(feats) != len(self.conf.inputs):
            raise ValueError(
                f"expected {len(self.conf.inputs)} inputs, got {len(feats)}")
        if len(labs) != len(self.conf.outputs):
            raise ValueError(f"expected {len(self.conf.outputs)} label "
                             f"arrays, got {len(labs)}")
        col = CollectScoresIterationListener(frequency=1)
        self.listeners.append(col)
        try:
            for k in range(len(feats[0])):
                self.fit([f[k] for f in feats], [l[k] for l in labs])
        finally:
            self.listeners.remove(col)
        return np.asarray([s for _, s in col.scores], np.float32)

    def _reset_rnn_states(self, batch_n: int) -> None:
        """Zero recurrent state sized for this batch (sequence start)."""
        for n in self.layer_names:
            lc = self.conf.vertices[n]
            if isinstance(lc, STATEFUL_RNN_CONFS):
                self.states[n] = {
                    k: torch.zeros((batch_n, lc.n_out), dtype=torch.float32,
                                   device=self.device)
                    for k in self.states[n]}

    def _fit_tbptt(self, inputs, labels_l, masks_d, lmasks):
        """Truncated BPTT over the DAG: one step per window of
        ``tbptt_fwd_length`` steps of the time-series inputs, recurrent
        state carried across windows as data; a shorter
        ``tbptt_back_length`` truncates the backward inside each
        window."""
        seq = [v for v in inputs.values() if v.dim() == 3]
        if not seq:
            raise ValueError("backprop_type='truncated_bptt' requires at "
                             "least one time-series ([B,T,F]) input")
        t_total, batch_n = seq[0].shape[1], seq[0].shape[0]
        w = self.conf.tbptt_fwd_length
        self._reset_rnn_states(batch_n)
        bw = tbptt_backprop_window(self.conf)
        loss = None
        for start in range(0, t_total, w):
            sl = slice(start, min(start + w, t_total))
            in_w = {k: v[:, sl] if v.dim() == 3 else v
                    for k, v in inputs.items()}
            lb_w = [l[:, sl] if l.dim() == 3 else l for l in labels_l]
            mk_w = {k: (m[:, sl] if m.dim() >= 2 and m.shape[1] == t_total
                        else m) for k, m in masks_d.items()}
            lm_w = ([m[:, sl] if m is not None and labels_l[i].dim() == 3
                     else m for i, m in enumerate(lmasks)]
                    if lmasks else lmasks)
            loss = self._train_step(in_w, lb_w, mk_w, lm_w, carry_state=True,
                                    backprop_window=bw)
            self._record_iteration(loss)
        return loss

    def fit_iterator(self, iterator, num_epochs: int = 1,
                     fused_batches: int = 1) -> "ComputationGraph":
        """fit over an iterator of MultiDataSets (or DataSets for a
        single-input, single-output graph), inside bucketing's "auto"
        scope. ``fused_batches=K`` fuses K steps into one program in the
        JAX package, whose contract is that this equals K serial fits; the
        port runs eagerly, so it runs the K serial fits."""
        if self.params is None:
            self.init()
        # DL4J_TPU_PIPELINE_WORKERS > 0 wraps a plain iterator in an input
        # pipeline staging to this net's device; a staged iterator's
        # telemetry is adopted as pipeline_stats and registered
        from deeplearning4j_tpu_torch.etl.pipeline import maybe_wrap
        from deeplearning4j_tpu_torch.obs.registry import register_net

        iterator = maybe_wrap(iterator, device=self.device)
        if getattr(iterator, "pipeline_stats", None) is not None:
            self.pipeline_stats = iterator.pipeline_stats
            register_net(self)
        self._bucket_scope = True
        try:
            for _ in range(num_epochs):
                for ds in iterator:
                    self._fit_ds(ds)
                if hasattr(iterator, "reset"):
                    iterator.reset()
        finally:
            self._bucket_scope = False
        return self

    def _fit_ds(self, ds) -> None:
        if hasattr(ds, "features_list"):  # MultiDataSet
            self.fit(ds.features_list, ds.labels_list, ds.features_masks,
                     ds.labels_masks)
        else:
            self.fit(ds.features, ds.labels, ds.features_mask,
                     ds.labels_mask)

    # ------------------------------------------------------------- inference
    def output(self, *features) -> List[torch.Tensor]:
        """Inference outputs in ``conf.outputs`` order. A ragged batch is
        zero-padded to its bucket and the answers sliced back (inference
        is row-independent: BN's running stats, no dropout)."""
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        with torch.inference_mode():
            inputs = self._as_inputs(list(features))
            n = next(iter(inputs.values())).shape[0]
            target = dispatch.inference_bucket(n)
            if target is not None:
                inputs = {k: dispatch.pad_axis0(v, target)
                          for k, v in inputs.items()}
            acts, _ = self._forward(self.params, self.states, inputs)
            return [acts[o][:n] for o in self.conf.outputs]

    def feed_forward(self, *features) -> Dict[str, torch.Tensor]:
        """Every vertex's activation by name, the inputs included."""
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        with torch.inference_mode():
            acts, _ = self._forward(self.params, self.states,
                                    self._as_inputs(list(features)))
        return acts

    def score(self, features, labels, masks=None, label_masks=None) -> float:
        """The summed loss (with the l1/l2 penalty), inference mode."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(
                self.params, self.states, self._as_inputs(features),
                self._as_labels(labels), train=False,
                masks=self._as_masks(masks),
                label_masks=self._as_label_masks(label_masks))
        return float(loss)

    def evaluate(self, iterator):
        """Classification stats (``eval.Evaluation``) of the FIRST
        output over every DataSet or MultiDataSet of the iterator."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation()
        for ds in iterator:
            feats = getattr(ds, "features_list", None) or ds.features
            labels = getattr(ds, "labels_list", None) or ds.labels
            out = self.output(*_as_list(feats))[0]
            ev.eval(_host(_as_list(labels)[0]), _host(out))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    # ------------------------------------------------- stateful rnn streaming
    def rnn_clear_previous_state(self) -> None:
        """Back to the empty (0, n) stream state; the next
        ``rnn_time_step`` sizes it for its batch."""
        for n in self.layer_names:
            if isinstance(self.conf.vertices[n], STATEFUL_RNN_CONFS):
                self.states[n] = {
                    k: torch.zeros((0,) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=v.device)
                    for k, v in self.states[n].items()}

    def rnn_time_step(self, *features) -> List[torch.Tensor]:
        """Stateful inference (reference rnnTimeStep :1601): [B, F] inputs
        are one step, [B, T, F] are T steps in order; the recurrent state
        carries across calls (a stream of another batch starts from
        zeros). Returns each output's last step."""
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        with torch.inference_mode():
            feats = []
            for f in features:
                f = self._as_input(f)
                feats.append(f[:, None, :] if f.dim() == 2 else f)
            acts, new_states = self._forward(
                self.params, self.states, self._as_inputs(feats),
                carry_state=True)
            self.states = new_states
            outs = [acts[o] for o in self.conf.outputs]
            return [o[:, -1, :] if o.dim() == 3 else o for o in outs]

    def apply_lr_score_decay(self) -> None:
        """Multiply the effective learning rate by
        ``conf.lr_policy_decay_rate`` (the ``score`` policy)."""
        rate = self.conf.lr_policy_decay_rate
        if rate is None:
            return
        self.updater_state = {n: decay_lr_scale_entry(s, rate)
                              for n, s in self.updater_state.items()}

    def set_listeners(self, *listeners) -> "ComputationGraph":
        self.listeners = list(listeners)
        return self

    def clone(self) -> "ComputationGraph":
        """A graph of a copy of the configuration on the same device, with
        copies of the params, states and updater state, at the same
        iteration."""
        other = ComputationGraph(copy.deepcopy(self.conf), device=self.device)
        if self.params is not None:
            other.params = tree_map(torch.clone, self.params)
            other.states = tree_map(torch.clone, self.states)
            other.updater_state = tree_map(torch.clone, self.updater_state)
            other._input_shapes = dict(self._input_shapes or {})
        other.iteration = self.iteration
        return other
