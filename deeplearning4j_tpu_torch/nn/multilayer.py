"""MultiLayerNetwork (counterpart: ``deeplearning4j_tpu/nn/multilayer.py``
— ``init``, ``_forward``, ``_regularization_penalty`` :210, ``_loss``
:233, the train step :278-327, the bf16 loss-scaled step :344-411,
``fit`` :483 with ``_bucket_batch`` :517,
``fit_batches``, the TBPTT window loop :769-839, ``fit_iterator`` :841,
``pretrain`` :926, ``output`` :1002, ``feed_forward``, ``score`` :1025,
``evaluate`` :1031, the streaming ``rnn_clear_previous_state`` /
``rnn_time_step`` :1044-1127, ``apply_lr_score_decay`` :1129,
``training_state`` :1144-1171 and ``clone`` :1177; plus ``load``, the
counterpart of ``ModelSerializer.restore_multi_layer_network``).

Parameters, layer states and updater state are lists (one entry per
layer) of dicts of tensors in the JAX layout, on ``device`` — the card
unless the caller passes ``device="cpu"``. ``init`` draws fresh weights
from a ``torch.Generator`` seeded with ``conf.seed`` (not the JAX
package's bits); :func:`params_from_numpy` and
:func:`updater_state_from_numpy` carry a JAX network's lists over bit for
bit.

A train step is eager: the forward (dropout from ``ops/rng`` streams of
``(conf.seed, iteration, layer)``), the loss with the l1/l2 penalty,
``torch.autograd.grad`` (the LSTM layers' scan goes through
``LstmScanFn``: K1 forward and K2 backward on the card), then the
updaters and the parameter step in place (``nn/common.train_iteration``;
under ``DL4J_TPU_BF16`` the bf16 loss-scaled step, its scale in
``loss_scale`` and ``training_state``). A ``truncated_bptt``
configuration fed [N, T, F] runs one step per window of
``tbptt_fwd_length`` steps, carrying the recurrent state across windows as
data. ``output`` pads a ragged batch to its bucket and slices the answer
back; ``fit`` pads one only inside ``fit_iterator`` (or with
``DL4J_TPU_BUCKET_BATCHES=1``), masking the pad rows out of the loss.
A network with a BatchNormalization layer is never padded in training
(the pad rows would enter the batch statistics). Layers train under the
remat ladder (``nn/common.apply_layer``). A non-SGD ``optimization_algo``
(line gradient descent, conjugate gradient, LBFGS) runs ``fit`` through
``optimize/solvers.Solver``; a ``pretrain`` configuration's
``fit_iterator`` first pretrains its AutoEncoder and RBM layers greedily,
layer by layer (``pretrain``). A CNN-first network needs its
``input_shape=(h, w, c)`` at ``init``, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.common import (
    apply_layer,
    cast_loss_input,
    LossScaled,
    decay_lr_scale_entry,
    promote_to,
    tbptt_backprop_window,
    train_iteration,
)
from deeplearning4j_tpu_torch.nn.conf import layers as conf_layers
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToRnnPreProcessor,
    FeedForwardToRnnPreProcessor,
)
from deeplearning4j_tpu_torch.nn.layers.factory import (
    RNN_CONFS,
    STATEFUL_RNN_CONFS,
    create_layer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    AutoEncoderImpl,
    OutputLayerImpl,
    RBMImpl,
)
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.ops import rng as rng_mod
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.optimize.updaters import (
    LayerUpdater,
    MultiLayerUpdater,
    apply_updates,
    flatten_paths,
)

Layers = List[Dict[str, torch.Tensor]]

# param leaves regularized by l1/l2: weights and recurrent weights, never
# biases or peepholes
_REG_PARAM_NAMES = ("W", "U")


def params_from_numpy(layers, *, device=None):
    """The port's params (or states) from a JAX MultiLayerNetwork's list of
    per-layer dicts (nested for the bidirectional LSTM), or a JAX
    ComputationGraph's dict of them keyed by vertex name, handed over as
    numpy arrays. Float values are carried as f32, bit for bit."""
    dev = resolve_device(device)

    def node(v):
        if isinstance(v, dict):
            return {k: node(x) for k, x in v.items()}
        a = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
        return torch.from_numpy(a.copy()).to(dev)

    if isinstance(layers, dict):
        return node(layers)
    return [node(layer) for layer in layers]


def updater_state_from_numpy(layers: Sequence[Dict[str, Any]], *,
                             device=None) -> List[Dict[str, Any]]:
    """The port's updater state from a JAX network's ``updater_state``
    handed over as nested dicts of numpy arrays (one dict per layer, e.g.
    ``{"cache": {"W": ...}}`` or ``{"lr_scale": ...}``), as f32 tensors."""
    dev = resolve_device(device)

    def node(v):
        if isinstance(v, dict):
            return {k: node(x) for k, x in v.items()}
        a = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
        return torch.from_numpy(a.copy()).to(dev)

    return [node(layer) for layer in layers]


class MultiLayerNetwork(LossScaled):
    def __init__(self, conf: MultiLayerConfiguration, device=None) -> None:
        self.device = resolve_device(device)
        self.conf = conf
        self.layers = [create_layer(lc) for lc in conf.layers]
        self.updater = MultiLayerUpdater(conf.layers, conf)
        self.params: Optional[Layers] = None
        self.states: Optional[Layers] = None
        self.updater_state: Optional[List[Dict[str, Any]]] = None
        self.iteration = 0
        self.listeners: list = []
        self._score: Optional[torch.Tensor] = None  # last loss, on device
        self._input_shape: Optional[Tuple[int, ...]] = None
        # each activation's shape past the batch axis (the input first),
        # as init propagated it
        self._act_shapes: List[Tuple[int, ...]] = []
        # True while fit_iterator drives fit(): bucketing's "auto" scope
        self._bucket_scope = False
        # padded rows would enter BN's batch statistics in training
        self._bucketing_blocked = any(
            isinstance(lc, conf_layers.BatchNormalization)
            for lc in conf.layers)
        # the bf16 dynamic loss scale (DL4J_TPU_BF16), made at first use
        self._loss_scale: Optional[Dict[str, torch.Tensor]] = None
        self.dispatch_stats = dispatch.DispatchStats()
        # every *_stats ledger above joins the metrics registry (JAX
        # nn/multilayer.py :102-104): one Prometheus scrape covers them
        from deeplearning4j_tpu_torch.obs.registry import register_net

        register_net(self)

    # ------------------------------------------------------------------ init
    def _infer_input_shape(self) -> Tuple[int, ...]:
        l0 = self.conf.layers[0]
        if isinstance(l0, RNN_CONFS):
            return (-1, l0.n_in)
        if isinstance(l0, conf_layers.ConvolutionLayer):
            raise ValueError(
                "CNN-first networks need an explicit input_shape=(h, w, c)")
        if isinstance(l0, conf_layers.FeedForwardLayer):
            return (l0.n_in,)
        raise ValueError(
            f"cannot infer input shape from first layer {type(l0).__name__}; "
            "pass input_shape to init()")

    def init(self, input_shape: Optional[Sequence[int]] = None
             ) -> "MultiLayerNetwork":
        """Fresh params, states and updater state, with per-layer shapes
        inferred through the stack."""
        shape = (tuple(input_shape) if input_shape
                 else self._infer_input_shape())
        self._input_shape = shape
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        params, states = [], []
        self._act_shapes = [shape]
        for i, layer in enumerate(self.layers):
            pp = self.conf.input_preprocessors.get(i)
            if pp is not None:
                shape = pp.out_shape(shape)
            p, s, shape = layer.initialize(gen, shape)
            params.append(p)
            states.append(s)
            self._act_shapes.append(tuple(shape))
        self.params = params
        self.states = states
        self.updater_state = self.updater.init(params)
        return self

    def num_params(self) -> int:
        return sum(int(v.numel()) for v in tree_leaves(self.params))

    @classmethod
    def load(cls, path: str, device=None,
             load_updater: bool = True) -> "MultiLayerNetwork":
        """Read a zip written by the JAX package's
        ``ModelSerializer.write_model`` or by the port's ``write_model``:
        the configuration, the input shape from the metadata, the
        coefficients, the layer states, the updater state (unless
        ``load_updater`` is False) and the iteration. Every leaf the
        configuration implies must be there with its shape (a layout
        mismatch raises), so a checkpoint taken in the middle of training
        resumes where it stopped."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_model_zip,
        )

        z = read_model_zip(path, "MultiLayerNetwork")
        net = cls(MultiLayerConfiguration.from_json(z["conf"]),
                  device=device)
        ishape = z["meta"].get("input_shape")
        net.init(tuple(ishape) if ishape else None)
        n = len(net.layers)

        def layers_of(data):
            tree = npz_bytes_to_tree(data)
            return [tree.get(i, {}) for i in range(n)]

        net.params = _fill(net.params, params_from_numpy(
            layers_of(z["coefficients"]), device=net.device), "coefficients")
        if z["state"] is not None:
            net.states = _fill(net.states, params_from_numpy(
                layers_of(z["state"]), device=net.device), "state")
        if load_updater and z["updater"] is not None:
            net.updater_state = _fill(net.updater_state,
                                      updater_state_from_numpy(
                                          layers_of(z["updater"]),
                                          device=net.device), "updater")
        net.iteration = int(z["meta"].get("iteration", 0))
        net.restore_training_state(z["training_state"])
        return net

    # --------------------------------------------------------------- forward
    def _apply_preprocessor(self, i, x, batch_n):
        pp = self.conf.input_preprocessors.get(i)
        if pp is None:
            return x
        if isinstance(pp, (FeedForwardToRnnPreProcessor,
                           CnnToRnnPreProcessor)):
            return pp(x, time_steps=x.shape[0] // batch_n)
        return pp(x)

    def _dropout_gen(self, i: int, train: bool, step: Optional[int]):
        """Layer i's dropout generator for ``step``, or None when the
        layer draws nothing."""
        if not train or not (self.conf.layers[i].dropout or 0.0) > 0:
            return None
        return rng_mod.layer_generator(self._stream_seed(), step, i,
                                       self.device)

    def _stream_seed(self) -> int:
        """The dropout streams' base: ``conf.seed``, or a parameter-
        averaging worker's own (``_worker``, set by the trainer)."""
        w = getattr(self, "_worker", None)
        return (self.conf.seed if w is None
                else rng_mod.worker_seed(self.conf.seed, w))

    def _forward(self, params, states, x, *, train: bool = False,
                 step: Optional[int] = None, mask=None,
                 upto: Optional[int] = None, carry_state: bool = False,
                 backprop_window: Optional[int] = None):
        """Forward through layers [0, upto): (activations incl. the input,
        new states). The mask goes to the recurrent-family layers only;
        carry_state and backprop_window to the stateful recurrent ones."""
        n_layers = len(self.layers) if upto is None else upto
        batch_n = x.shape[0]
        acts = [x]
        new_states = list(states)
        for i in range(n_layers):
            lc = self.conf.layers[i]
            x = self._apply_preprocessor(i, x, batch_n)
            kwargs = {}
            if isinstance(lc, STATEFUL_RNN_CONFS):
                if carry_state:
                    kwargs["carry_state"] = True
                if backprop_window is not None:
                    kwargs["backprop_window"] = backprop_window
            y, new_states[i] = apply_layer(
                self.layers[i], self.conf, params[i], states[i], x,
                self._dropout_gen(i, train, step),
                mask if isinstance(lc, RNN_CONFS) else None, kwargs,
                train=train)
            acts.append(y)
            x = y
        return acts, new_states

    def _regularization_penalty(self, params):
        """0.5 * l2 * |W|^2 + l1 * |W|_1 over the weight leaves."""
        total = 0.0
        for lc, p in zip(self.conf.layers, params):
            l1 = lc.l1 or 0.0
            l2 = lc.l2 or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for path, leaf in flatten_paths(p).items():
                if path[-1] in _REG_PARAM_NAMES:
                    if l2:
                        total = total + 0.5 * l2 * torch.sum(leaf * leaf)
                    if l1:
                        total = total + l1 * torch.sum(torch.abs(leaf))
        return total

    def _loss(self, params, states, x, labels, *, train: bool,
              step: Optional[int] = None, mask=None, label_mask=None,
              carry_state: bool = False,
              backprop_window: Optional[int] = None):
        """(loss + penalty, new states)."""
        out_impl = self.layers[-1]
        if not isinstance(out_impl, OutputLayerImpl):
            raise ValueError("last layer must be an OutputLayer/RnnOutputLayer")
        last = len(self.layers) - 1
        acts, new_states = self._forward(
            params, states, x, train=train, step=step, mask=mask, upto=last,
            carry_state=carry_state, backprop_window=backprop_window)
        last_in = cast_loss_input(
            self._apply_preprocessor(last, acts[-1], x.shape[0]))
        last_in = out_impl._dropout_in(last_in, train,
                                       self._dropout_gen(last, train, step))
        lmask = label_mask if label_mask is not None else mask
        loss = out_impl.loss(promote_to(params[-1], last_in), last_in,
                             labels, lmask)
        return loss + self._regularization_penalty(params), new_states

    def _train_step(self, x, labels, mask, label_mask, *,
                    carry_state: bool = False,
                    backprop_window: Optional[int] = None) -> torch.Tensor:
        """One optimizer iteration on this batch: loss and gradients, the
        updaters, the parameter step in place (loss-scaled in bf16 under
        ``DL4J_TPU_BF16``). Returns the loss."""
        def loss_fn(params, xx):
            return self._loss(
                params, self.states, xx, labels, train=True,
                step=self.iteration, mask=mask, label_mask=label_mask,
                carry_state=carry_state, backprop_window=backprop_window)

        loss, self.states = train_iteration(self, loss_fn, x)
        return loss

    # ------------------------------------------------------------------- fit
    @property
    def score_value(self) -> float:
        """The last training loss (reading it waits for the card)."""
        return float("nan") if self._score is None else float(self._score)

    def _record_iteration(self, loss) -> None:
        self._score = loss
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, loss)
        self.iteration += 1

    def _as_optional(self, a):
        return None if a is None else self._as_input(a)

    def fit(self, features, labels, mask=None, label_mask=None):
        """One DataSet fit: ``conf.iterations`` optimizer iterations on this
        batch, or for a ``truncated_bptt`` conf fed [N, T, F] one per
        window; under a non-SGD ``optimization_algo``, one Solver run of
        ``conf.iterations`` iterations. Returns the last loss (a 0-d
        tensor on the device)."""
        if self.params is None:
            self.init()
        features, labels = self._as_input(features), self._as_input(labels)
        mask, label_mask = self._as_optional(mask), self._as_optional(
            label_mask)
        if (self.conf.backprop_type == "truncated_bptt"
                and features.dim() == 3):
            return self._fit_tbptt(features, labels, mask, label_mask)
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            from deeplearning4j_tpu_torch.optimize.solvers import Solver

            Solver(self).optimize(features, labels, mask, label_mask)
            return self._score
        features, labels, mask, label_mask = self._bucket_batch(
            features, labels, mask, label_mask)
        loss = None
        for _ in range(max(1, self.conf.iterations)):
            loss = self._train_step(features, labels, mask, label_mask)
            self._record_iteration(loss)
        return loss

    def _bucket_batch(self, features, labels, mask, label_mask):
        """Pad a ragged batch up to its bucket and mask the pad rows out of
        the loss (the row-validity mask rides the label mask, attached
        even when no padding happened). Applies per
        ``dispatch.bucketing_mode``: by default only inside
        ``fit_iterator``; never to a network with BatchNormalization."""
        mode = dispatch.bucketing_mode()
        if (mode == "off" or (mode == "auto" and not self._bucket_scope)
                or self._bucketing_blocked):
            return features, labels, mask, label_mask
        n = features.shape[0]
        target = dispatch.bucket_size(n)
        if target != n:
            features, labels, mask, label_mask = dispatch.pad_rows(
                target, [features, labels, mask, label_mask])
        if label_mask is None:
            label_mask = mask if mask is not None else (
                dispatch.row_validity_mask(
                    n, target, labels.shape[1] if labels.dim() == 3 else None,
                    device=self.device))
        return features, labels, mask, label_mask

    def fit_batches(self, features, labels, masks=None, label_masks=None
                    ) -> np.ndarray:
        """``for k in range(K): fit(features[k], labels[k], ...)`` over the
        leading axis of [K, N, ...] stacks; returns the K * iterations
        losses. SGD-family, non-TBPTT configurations only."""
        if self.params is None:
            self.init()
        if self.conf.backprop_type == "truncated_bptt":
            raise ValueError("fit_batches: use fit() for TBPTT training")
        if self.conf.optimization_algo != "stochastic_gradient_descent":
            raise ValueError("fit_batches supports SGD-family training only")
        col = CollectScoresIterationListener(frequency=1)
        self.listeners.append(col)
        try:
            for k in range(len(features)):
                self.fit(features[k], labels[k],
                         None if masks is None else masks[k],
                         None if label_masks is None else label_masks[k])
        finally:
            self.listeners.remove(col)
        return np.asarray([s for _, s in col.scores], np.float32)

    def _reset_rnn_states(self, batch_n: int) -> None:
        """Zero recurrent state sized for this batch (sequence start)."""
        for i, lc in enumerate(self.conf.layers):
            if isinstance(lc, STATEFUL_RNN_CONFS):
                self.states[i] = {
                    k: torch.zeros((batch_n, lc.n_out), dtype=torch.float32,
                                   device=self.device)
                    for k in self.states[i]}

    def _tbptt_windows(self, features, labels, mask=None, label_mask=None):
        """(features, labels, mask, label_mask) slices of
        ``tbptt_fwd_length`` steps along time."""
        t_total = features.shape[1]
        w = self.conf.tbptt_fwd_length
        for start in range(0, t_total, w):
            sl = slice(start, min(start + w, t_total))
            yield (features[:, sl],
                   labels[:, sl] if labels.dim() == 3 else labels,
                   mask[:, sl] if (mask is not None and mask.dim() >= 2
                                   and mask.shape[1] == t_total) else mask,
                   label_mask[:, sl] if (label_mask is not None
                                         and labels.dim() == 3)
                   else label_mask)

    def _fit_tbptt(self, features, labels, mask=None, label_mask=None):
        """Truncated BPTT: one train step per window, the recurrent state
        carried from window to window as data (no gradient across the
        boundary); a shorter ``tbptt_back_length`` truncates the backward
        pass inside each window."""
        if features.dim() != 3:
            raise ValueError(
                "backprop_type='truncated_bptt' requires [B,T,F] features")
        loss = None
        self._reset_rnn_states(features.shape[0])
        bw = tbptt_backprop_window(self.conf)
        for f_w, l_w, m_w, lm_w in self._tbptt_windows(
                features, labels, mask, label_mask):
            loss = self._train_step(f_w, l_w, m_w, lm_w, carry_state=True,
                                    backprop_window=bw)
            self._record_iteration(loss)
        return loss

    def fit_iterator(self, iterator, num_epochs: int = 1,
                     fused_batches: int = 1) -> "MultiLayerNetwork":
        """fit(DataSetIterator): a ``pretrain`` configuration first
        pretrains layerwise over the iterator (``pretrain``); then every
        DataSet of every epoch through ``fit``, inside bucketing's "auto"
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
        if self.conf.pretrain:
            self.pretrain(iterator)
            if hasattr(iterator, "reset"):
                iterator.reset()
        self._bucket_scope = True
        try:
            for _ in range(num_epochs):
                for ds in iterator:
                    self.fit(ds.features, ds.labels, ds.features_mask,
                             ds.labels_mask)
                if hasattr(iterator, "reset"):
                    iterator.reset()
        finally:
            self._bucket_scope = False
        return self

    # -------------------------------------------------------------- pretrain
    def pretrain(self, data, num_epochs: int = 1) -> None:
        """Greedy layerwise pretraining of the AutoEncoder and RBM layers,
        in order: each sees the batches (an iterator of DataSets, or one
        array) through the layers before it in inference mode and its own
        input preprocessor, and takes one step per batch with its own
        ``LayerUpdater`` (a fresh state, its own iteration count): the
        gradient of its reconstruction loss (AutoEncoder) or the CD-k
        estimate (RBM). The draws of step j of layer i come from the
        ``sample`` stream of ``(conf.seed, j, i)``."""
        if self.params is None:
            self.init()

        def batches():
            if hasattr(data, "__iter__") and not hasattr(data, "shape"):
                for ds in data:
                    yield self._as_input(ds.features)
                if hasattr(data, "reset"):
                    data.reset()
            else:
                yield self._as_input(data)

        for i, layer in enumerate(self.layers):
            if not isinstance(layer, (AutoEncoderImpl, RBMImpl)):
                continue
            lu = LayerUpdater(self.conf.layers[i], self.conf)
            lu_state = lu.init(self.params[i])
            it_count = 0
            for _ in range(num_epochs):
                for xb in batches():
                    with torch.no_grad():
                        batch_n = xb.shape[0]
                        if i > 0:
                            xb = self._forward(self.params, self.states, xb,
                                               upto=i)[0][-1]
                        xb = self._apply_preprocessor(i, xb, batch_n)
                    gen = rng_mod.layer_generator(
                        self.conf.seed, it_count, i, self.device,
                        kind="sample")
                    p = self.params[i]
                    grads = self._pretrain_grads(layer, p, xb, gen)
                    upd, lu_state = lu.update(grads, lu_state, p, it_count)
                    apply_updates([p], [upd], True)
                    it_count += 1

    @staticmethod
    def _pretrain_grads(layer, params, x, gen):
        """One pretraining step's gradient for ``layer``'s params."""
        if isinstance(layer, RBMImpl):
            return layer.cd_grads(params, x, gen)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = layer.pretrain_loss(leaves, x, gen)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        materialize_grads=True)
        return dict(zip(leaves, grads))

    # ------------------------------------------------------------- inference
    def _as_input(self, x) -> torch.Tensor:
        """A tensor on the net's device; floating data in the params' dtype
        (f32, or f64 when the params are f64), as the JAX package's type
        promotion computes it."""
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch takes no read-only numpy views
        x = torch.as_tensor(x, device=self.device)
        dtype = next((v.dtype for p in self.params or () for v in p.values()),
                     None)
        return x.to(dtype) if x.is_floating_point() and dtype else x

    def output(self, x) -> torch.Tensor:
        """Batch inference. A ragged batch is zero-padded to its bucket and
        the answer sliced back: every ported layer is row-independent, so
        the pad rows change no real row."""
        with torch.inference_mode():
            x = self._as_input(x)
            n = x.shape[0]
            target = dispatch.inference_bucket(n)
            if target is not None:
                x = dispatch.pad_axis0(x, target)
            return self._forward(self.params, self.states, x)[0][-1][:n]

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first. ``train=True`` applies
        dropout from this iteration's streams."""
        with torch.no_grad():
            return self._forward(self.params, self.states,
                                 self._as_input(x), train=train,
                                 step=self.iteration)[0]

    def score(self, features, labels, mask=None, label_mask=None) -> float:
        """The loss (with the l1/l2 penalty) on this batch, inference mode."""
        with torch.no_grad():
            loss, _ = self._loss(
                self.params, self.states, self._as_input(features),
                self._as_input(labels), train=False,
                mask=self._as_optional(mask),
                label_mask=self._as_optional(label_mask))
        return float(loss)

    def evaluate(self, iterator):
        """Classification stats (``eval.Evaluation``) of ``output`` over
        every DataSet of the iterator, label masks honoured."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation()
        for ds in iterator:
            out = self.output(ds.features)
            ev.eval(_host(ds.labels), _host(out),
                    mask=None if ds.labels_mask is None
                    else _host(ds.labels_mask))
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    # ------------------------------------------------- stateful rnn streaming
    def rnn_clear_previous_state(self) -> None:
        """Back to the empty (0, ...) stream state; params untouched. The
        next rnn_time_step sizes it for its batch."""
        for i, layer in enumerate(self.layers):
            if getattr(layer, "grows_state", False):
                # a KV cache starts empty; a zeroed one of the old length
                # would be attended to (the JAX package's fault: ROADMAP
                # queue 3)
                self.states[i] = {}
            elif hasattr(layer, "step"):
                self.states[i] = {
                    k: torch.zeros((0,) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=v.device)
                    for k, v in self.states[i].items()}

    def _sized_rnn_states(self, states, n: int):
        """States with stream leaves sized for batch n. Only the cleared
        (0, ...) form is re-sized; any other batch mismatch raises."""
        out = list(states)
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "step"):
                sized = {}
                for k, v in states[i].items():
                    if v.shape[0] == n:
                        sized[k] = v
                    elif v.shape[0] == 0:
                        sized[k] = torch.zeros((n,) + tuple(v.shape[1:]),
                                               dtype=v.dtype,
                                               device=v.device)
                    else:
                        raise ValueError(
                            f"rnn_time_step batch {n} != carried state batch "
                            f"{v.shape[0]} (layer {i}); call "
                            "rnn_clear_previous_state() to start a new stream")
                out[i] = sized
        return out

    def _rnn_step_body(self, states, x):
        new_states = list(states)
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "step"):
                x, new_states[i] = layer.step(self.params[i], states[i], x)
            else:
                x, _ = layer.apply(self.params[i], states[i], x)
        return x, new_states

    def rnn_time_step(self, x_t) -> torch.Tensor:
        """Stateful streaming inference: x_t [N, F] (one step) or
        [N, T, F] (T steps in order). State carries across calls."""
        with torch.inference_mode():
            x_t = self._as_input(x_t)
            states = self._sized_rnn_states(self.states, x_t.shape[0])
            if x_t.dim() == 3:
                ys = []
                for t in range(x_t.shape[1]):
                    y, states = self._rnn_step_body(states, x_t[:, t])
                    ys.append(y)
                self.states = states
                return torch.stack(ys, dim=1)
            y, self.states = self._rnn_step_body(states, x_t)
            return y


    def apply_lr_score_decay(self) -> None:
        """Multiply the effective learning rate by
        ``conf.lr_policy_decay_rate`` (the event-driven ``score`` policy);
        the cumulative factor lives in the updater state."""
        rate = self.conf.lr_policy_decay_rate
        if rate is None:
            return
        self.updater_state = [decay_lr_scale_entry(s, rate)
                              for s in self.updater_state]

    # ------------------------------------------------------------- listeners
    def set_listeners(self, *listeners) -> "MultiLayerNetwork":
        self.listeners = list(listeners)
        return self

    def clone(self) -> "MultiLayerNetwork":
        """A network of a copy of the configuration on the same device,
        with copies (not shared tensors) of the params, states and updater
        state, at the same iteration."""
        import copy

        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        if self.params is not None:
            net._input_shape = self._input_shape
            net.params = tree_map(torch.clone, self.params)
            net.states = tree_map(torch.clone, self.states)
            net.updater_state = tree_map(torch.clone, self.updater_state)
            net.iteration = self.iteration
        return net


def _host(a) -> np.ndarray:
    """A numpy copy of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _fill(template, loaded, what: str):
    """``loaded`` checked against the layout ``template`` implies (a list
    per layer, or a graph's dict per layer vertex): per layer the same
    keys (nested, for the updater state) and the same shape
    per leaf (for states, past the batch axis: a stream state carries the
    batch it was last sized for). A node with no leaves (a parameterless
    layer's ``{"v": {}}``) writes nothing to the npz, so it is taken from
    the template."""
    skip = 1 if what == "state" else 0

    def check(want, got, where):
        if isinstance(want, dict):
            keys = {k for k, v in want.items() if tree_leaves(v)}
            if not isinstance(got, dict) or keys != set(got):
                have = sorted(got) if isinstance(got, dict) else got
                raise ValueError(
                    f"checkpoint {what} of {where} has keys {have}, the "
                    f"configuration implies {sorted(keys)}")
            return {k: check(v, got[k], f"{where}[{k!r}]") if k in keys
                    else v for k, v in want.items()}
        if tuple(got.shape)[skip:] != tuple(want.shape)[skip:]:
            raise ValueError(
                f"checkpoint {what} of {where} has shape "
                f"{tuple(got.shape)}, expected {tuple(want.shape)}")
        return got

    if isinstance(template, dict):
        return {k: check(want, loaded.get(k, {}), f"vertex {k!r}")
                for k, want in template.items()}
    return [check(want, got, f"layer {i}")
            for i, (want, got) in enumerate(zip(template, loaded))]
