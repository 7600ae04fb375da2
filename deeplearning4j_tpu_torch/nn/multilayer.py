"""MultiLayerNetwork, inference half (counterpart:
``deeplearning4j_tpu/nn/multilayer.py`` — ``init``, ``num_params``,
``_forward``, ``output`` :1002, ``feed_forward``, and the streaming
``rnn_clear_previous_state`` / ``_sized_rnn_states`` / ``rnn_time_step``
:1044-1127; plus ``load``, the counterpart of
``ModelSerializer.restore_multi_layer_network``).

Parameters and states are lists (one entry per layer) of dicts of
tensors in the JAX layout, on ``device`` — the card unless the caller
passes ``device="cpu"``. ``init`` draws fresh weights from a
``torch.Generator`` seeded with ``conf.seed`` (not the JAX package's
bits); :func:`params_from_numpy` carries a JAX parameter list over bit
for bit. ``output`` pads a ragged batch to its bucket
(``ops/dispatch.inference_bucket``, ``DL4J_TPU_BUCKET_BATCHES``) and
slices the answer back. ``rnn_time_step`` goes through each layer's
``step`` (plain ops, as in the JAX package). Training (fit, TBPTT, the
updaters, pretraining, scoring) waits for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.common import apply_layer
from deeplearning4j_tpu_torch.nn.conf import layers as conf_layers
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToRnnPreProcessor,
    FeedForwardToRnnPreProcessor,
)
from deeplearning4j_tpu_torch.nn.layers.factory import RNN_CONFS, create_layer
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.ops.device import resolve_device

Layers = List[Dict[str, torch.Tensor]]


def params_from_numpy(layers: Sequence[Dict[str, Any]], *,
                      device=None) -> Layers:
    """The port's params (or states) from a JAX MultiLayerNetwork's list of
    per-layer dicts handed over as numpy arrays. Float values are carried
    as f32, bit for bit."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
        return torch.from_numpy(a.copy()).to(dev)

    return [{k: leaf(v) for k, v in layer.items()} for layer in layers]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None) -> None:
        self.device = resolve_device(device)
        self.conf = conf
        self.layers = [create_layer(lc) for lc in conf.layers]
        self.params: Optional[Layers] = None
        self.states: Optional[Layers] = None
        self._input_shape: Optional[Tuple[int, ...]] = None

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
        """Fresh params and states, with per-layer shapes inferred through
        the stack."""
        shape = (tuple(input_shape) if input_shape
                 else self._infer_input_shape())
        self._input_shape = shape
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.conf.seed))
        params, states = [], []
        for i, layer in enumerate(self.layers):
            pp = self.conf.input_preprocessors.get(i)
            if pp is not None:
                shape = pp.out_shape(shape)
            p, s, shape = layer.initialize(gen, shape)
            params.append(p)
            states.append(s)
        self.params = params
        self.states = states
        return self

    def num_params(self) -> int:
        return sum(int(v.numel()) for p in self.params for v in p.values())

    @classmethod
    def load(cls, path: str, device=None) -> "MultiLayerNetwork":
        """Read a zip written by the JAX package's
        ``ModelSerializer.write_model``: the configuration, the input
        shape from the metadata, the coefficients and the layer states.
        Every leaf the configuration implies must be there with its shape
        (a layout mismatch raises). The updater section is not read."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_multi_layer_zip,
        )

        conf_json, coeff, state, meta = read_multi_layer_zip(path)
        net = cls(MultiLayerConfiguration.from_json(conf_json),
                  device=device)
        ishape = meta.get("input_shape")
        net.init(tuple(ishape) if ishape else None)
        n = len(net.layers)
        tree = npz_bytes_to_tree(coeff)
        net.params = _fill(net.params, params_from_numpy(
            [tree.get(i, {}) for i in range(n)], device=net.device),
            "coefficients")
        if state is not None:
            tree = npz_bytes_to_tree(state)
            net.states = _fill(net.states, params_from_numpy(
                [tree.get(i, {}) for i in range(n)], device=net.device),
                "state")
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

    def _forward(self, x):
        """Inference forward through every layer: (activations incl. the
        input, new states)."""
        batch_n = x.shape[0]
        acts = [x]
        new_states = list(self.states)
        for i, layer in enumerate(self.layers):
            x = self._apply_preprocessor(i, x, batch_n)
            y, new_states[i] = apply_layer(layer, self.conf, self.params[i],
                                           self.states[i], x, None)
            acts.append(y)
            x = y
        return acts, new_states

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # torch takes no read-only numpy views
        return torch.as_tensor(x, device=self.device)

    def output(self, x) -> torch.Tensor:
        """Batch inference. A ragged batch is zero-padded to its bucket and
        the answer sliced back: every ported layer is row-independent, so
        the pad rows change no real row."""
        with torch.inference_mode():
            x = self._as_input(x)
            n = x.shape[0]
            target = dispatch.inference_bucket(n)
            if target is not None:
                return self._forward(dispatch.pad_axis0(x, target))[0][-1][:n]
            return self._forward(x)[0][-1]

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first. ``train=True``
        (dropout, batch statistics) waits for the training slice."""
        if train:
            raise ValueError("feed_forward(train=True) is not ported yet")
        with torch.inference_mode():
            return self._forward(self._as_input(x))[0]

    # ------------------------------------------------- stateful rnn streaming
    def rnn_clear_previous_state(self) -> None:
        """Back to the empty (0, ...) stream state; params untouched. The
        next rnn_time_step sizes it for its batch."""
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "step"):
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


def _fill(template: Layers, loaded: Layers, what: str) -> Layers:
    """``loaded`` checked against the layout ``template`` implies: the same
    keys per layer and the same shape per leaf (for states, past the batch
    axis: a stream state carries the batch it was last sized for)."""
    skip = 1 if what == "state" else 0
    for i, (want, got) in enumerate(zip(template, loaded)):
        if set(want) != set(got):
            raise ValueError(
                f"checkpoint {what} of layer {i} has keys {sorted(got)}, the "
                f"configuration implies {sorted(want)}")
        for k, v in want.items():
            if tuple(got[k].shape)[skip:] != tuple(v.shape)[skip:]:
                raise ValueError(
                    f"checkpoint {what} [{i}][{k!r}] has shape "
                    f"{tuple(got[k].shape)}, expected {tuple(v.shape)}")
    return loaded
