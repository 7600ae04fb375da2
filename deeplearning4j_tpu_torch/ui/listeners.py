"""The training listeners that post to the UI (counterpart:
``deeplearning4j_tpu/ui/listeners.py`` — ``HistogramIterationListener``
:70, ``FlowIterationListener`` :103 and
``ConvolutionalIterationListener`` :142).

Each listener posts to a ``UiServer`` (``server_url``: HTTP POST to
``/train/update``) or keeps its payloads in a ``HistoryStorage``. The
histogram listener copies the network's parameters off the card once a
posting: every tensor flattened into one buffer on the card, one copy to
the host, split there. The convolutional listener copies its 4-d
activations the same way; the flow listener reads shapes only. Nothing
else waits for the card, so a fit with these listeners synchronizes
once every ``frequency`` iterations. The binning, means and grids are the
JAX package's numpy code on the copied arrays, so the payloads equal
JAX's for the same parameters.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.server import HistoryStorage

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays, through one device-to-host copy."""
    if not tensors:
        return []
    host = torch.cat([t.detach().reshape(-1) for t in tensors]).to(
        "cpu").numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


def _param_tensors(model) -> Dict[str, torch.Tensor]:
    """Each parameter by ``<layer>_<name>``, in the JAX listener's order."""
    out = {}
    params = model.params
    if isinstance(params, dict):  # ComputationGraph: name -> {pname: t}
        for lname, ps in params.items():
            for pname, t in (ps or {}).items():
                out[f"{lname}_{pname}"] = t
    else:  # MultiLayerNetwork: a list of {pname: t}
        for i, ps in enumerate(params or []):
            for pname, t in (ps or {}).items():
                out[f"{i}_{pname}"] = t
    return out


def _flatten_params(model) -> Dict[str, np.ndarray]:
    tensors = _param_tensors(model)
    return dict(zip(tensors, _to_host(list(tensors.values()))))


def _numel(ps) -> int:
    return int(sum(t.numel() for t in (ps or {}).values()))


class _PostingListener(IterationListener):
    def __init__(self, server_url: Optional[str] = None,
                 storage: Optional[HistoryStorage] = None):
        self.server_url = server_url
        self.storage = storage or (None if server_url else HistoryStorage())

    def _publish(self, payload: Dict[str, Any]) -> None:
        if self.server_url:
            try:
                req = urllib.request.Request(
                    self.server_url.rstrip("/") + "/train/update",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=5):
                    pass
            except (urllib.error.URLError, OSError) as e:
                # monitoring never aborts training: log and go on
                logger.warning("UI post failed (%s); continuing", e)
        if self.storage is not None:
            self.storage.put(payload["type"], payload)


class HistogramIterationListener(_PostingListener):
    """Every parameter tensor binned, and the score, each N iterations."""

    def __init__(self, frequency: int = 10, num_bins: int = 20, **kw):
        super().__init__(**kw)
        self.frequency = max(1, frequency)
        self.num_bins = num_bins

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency != 0:
            return
        params = {}
        for name, arr in _flatten_params(model).items():
            flat = arr.reshape(-1)
            counts, edges = np.histogram(flat, bins=self.num_bins)
            params[name] = {
                "lower": edges[:-1].tolist(),
                "upper": edges[1:].tolist(),
                "counts": counts.tolist(),
                "mean": float(flat.mean()),
                "std": float(flat.std()),
            }
        score = float(score)
        self._publish({
            "type": "histogram",
            "iteration": iteration,
            "score": score,
            "params": params,
        })
        self._publish({
            "type": "score", "iteration": iteration, "score": score,
        })


class FlowIterationListener(_PostingListener):
    """The topology and each layer's type and parameter count."""

    def __init__(self, frequency: int = 10, **kw):
        super().__init__(**kw)
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency != 0:
            return
        layers: List[Dict[str, Any]] = []
        conf = model.conf
        if hasattr(conf, "vertices"):  # graph
            for name in conf.topological_order():
                v = conf.vertices[name]
                ps = model.params.get(name, {}) if model.params else {}
                layers.append({
                    "name": name,
                    "layer_type": type(v).__name__,
                    "n_params": _numel(ps),
                    "inputs": list(conf.vertex_inputs.get(name, [])),
                })
        else:
            for i, lc in enumerate(conf.layers):
                ps = model.params[i] if model.params else {}
                layers.append({
                    "name": str(i),
                    "layer_type": type(lc).__name__,
                    "n_params": _numel(ps),
                    "inputs": [str(i - 1)] if i else [],
                })
        self._publish({
            "type": "flow",
            "iteration": iteration,
            "score": float(score),
            "layers": layers,
        })


class ConvolutionalIterationListener(_PostingListener):
    """Per-channel [H, W] activation maps of the first example, each
    normalized to [0, 1] and rounded to 4 places. Activations are NHWC,
    the port's layout, so a channel is the last axis."""

    def __init__(self, frequency: int = 10, max_channels: int = 16, **kw):
        super().__init__(**kw)
        self.frequency = max(1, frequency)
        self.max_channels = max_channels
        self._last_input = None

    def set_input(self, x) -> None:
        """The minibatch to trace (NHWC); its first example is re-run
        forward at each posting."""
        self._last_input = (x.detach() if isinstance(x, torch.Tensor)
                            else np.asarray(x))

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency != 0 or self._last_input is None:
            return
        first = self._last_input[:1]
        if hasattr(model.conf, "vertices"):
            acts = model.feed_forward(first)
        else:
            acts = model.feed_forward(first, train=False)
        seq = (acts if isinstance(acts, list)
               else [acts[k] for k in sorted(acts)])
        maps = [(li, a) for li, a in enumerate(seq) if a.dim() == 4]
        grids: Dict[str, List[List[float]]] = {}
        for (li, _), a in zip(maps, _to_host([a for _, a in maps])):
            for c in range(min(a.shape[-1], self.max_channels)):
                g = a[0, :, :, c]
                lo, hi = float(g.min()), float(g.max())
                norm = (g - lo) / (hi - lo) if hi > lo else g * 0
                grids[f"layer{li}_ch{c}"] = np.round(norm, 4).tolist()
        self._publish({
            "type": "activations",
            "iteration": iteration,
            "grids": grids,
        })
