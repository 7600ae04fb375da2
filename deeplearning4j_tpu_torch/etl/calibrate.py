"""Post-training int8 calibration (counterpart:
``deeplearning4j_tpu/etl/calibrate.py`` :34-165 — ``QuantSpec``,
``quant_spec_from_json`` and ``QuantCalibrator``).

:class:`QuantCalibrator` drives the net's ``feed_forward`` over the
calibration batches and folds, per layer input, a streaming ``[n, sum,
sumsq, absmax]`` accumulator (no activation retained). ``absmax / 127``
is the per-tensor symmetric activation scale (Jacob et al., CVPR 2018);
the mean and std ride along for audit. The fitted :class:`QuantSpec`
serializes into the checkpoint zip as ``quant.json`` beside
``normalizer.json``, with a gate sample of the first 32 calibration rows
so ``ModelRegistry.load`` measures the int8-vs-f32 delta at load time.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["QuantSpec", "QuantCalibrator", "quant_spec_from_json"]

_SPEC_VERSION = 1
_GATE_SAMPLE_ROWS = 32


class QuantSpec:
    """Fitted calibration artifact: per-layer activation scales + audit
    moments + the gate sample. Serde mirrors DataNormalization.state_dict
    (class-tagged JSON, arrays as lists) so the zip entry stays
    human-readable beside normalizer.json."""

    def __init__(self, act_scales: List[Optional[float]],
                 sample: Optional[np.ndarray] = None,
                 audit: Optional[List[Optional[Dict[str, float]]]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.act_scales = list(act_scales)
        self.sample = None if sample is None else np.asarray(
            sample, np.float32)
        self.audit = list(audit) if audit is not None else [None] * len(
            self.act_scales)
        self.meta = dict(meta or {})
        self.meta.setdefault("version", _SPEC_VERSION)

    def state_dict(self) -> dict:
        return {
            "class": type(self).__name__,
            "act_scales": [None if s is None else float(s)
                           for s in self.act_scales],
            "sample": None if self.sample is None else self.sample.tolist(),
            "sample_shape": None if self.sample is None
            else list(self.sample.shape),
            "audit": self.audit,
            "meta": self.meta,
        }

    def to_json(self) -> str:
        return json.dumps(self.state_dict(), sort_keys=True)

    @classmethod
    def from_state_dict(cls, state: dict) -> "QuantSpec":
        sample = state.get("sample")
        if sample is not None:
            sample = np.asarray(sample, np.float32)
            shape = state.get("sample_shape")
            if shape:
                sample = sample.reshape(shape)
        return cls(state.get("act_scales") or [], sample,
                   state.get("audit"), state.get("meta"))


def quant_spec_from_json(payload: str) -> QuantSpec:
    state = json.loads(payload)
    if state.get("class") not in (None, "QuantSpec"):
        raise ValueError(f"not a QuantSpec payload: {state.get('class')!r}")
    return QuantSpec.from_state_dict(state)


class QuantCalibrator:
    """Streaming calibration pass: ``fit(net, batches)`` feeds every
    calibration batch through the net's inference forward and folds each
    layer INPUT activation into an exact single-pass accumulator
    (etl/normalize.NormalizerStandardize._acc_one shape: n/sum/sumsq,
    plus absmax). Activations are reduced per batch and discarded —
    calibration memory is O(layers), not O(rows).

    The net is the port's ``MultiLayerNetwork`` (``feed_forward``,
    ``nn/multilayer.py``), on the card or the CPU; each activation is
    copied to the host and folded in float64.
    """

    def __init__(self, sample_rows: int = _GATE_SAMPLE_ROWS):
        self.sample_rows = int(sample_rows)
        self._acc: Optional[List[List[float]]] = None  # [n,sum,sumsq,absmax]
        self._sample: Optional[np.ndarray] = None
        self._layers = 0

    # -- streaming accumulation -------------------------------------------
    def _fold(self, i: int, x: np.ndarray) -> None:
        x64 = np.asarray(x, np.float64)
        acc = self._acc[i]
        acc[0] += float(x64.size)
        acc[1] += float(x64.sum())
        acc[2] += float(np.square(x64).sum())
        acc[3] = max(acc[3], float(np.abs(x64).max()) if x64.size else 0.0)

    def fit_batch(self, net, features) -> "QuantCalibrator":
        """Fold one calibration batch. Layer i's scale is computed from
        its INPUT activation acts[i] (feed_forward returns [input, layer0
        out, ...]); absmax is reshape-invariant, so the pre-preprocessor
        view is exact for the flatten/reshape preprocessors between conv
        and dense stacks."""
        feats = np.asarray(features)
        acts = net.feed_forward(feats, train=False)
        n_layers = len(acts) - 1
        if self._acc is None:
            self._acc = [[0.0, 0.0, 0.0, 0.0] for _ in range(n_layers)]
            self._layers = n_layers
        for i in range(n_layers):
            self._fold(i, acts[i].detach().cpu().numpy())
        if self._sample is None or self._sample.shape[0] < self.sample_rows:
            have = 0 if self._sample is None else self._sample.shape[0]
            take = np.asarray(feats[: self.sample_rows - have], np.float32)
            self._sample = take if self._sample is None else np.concatenate(
                [self._sample, take], axis=0)
        return self

    def fit(self, net, data) -> "QuantCalibrator":
        """``data``: a DataSetIterator-style iterable (objects with
        ``.features``), plain arrays, or an iterable of arrays."""
        batches = [data] if hasattr(data, "ndim") else data
        for b in batches:
            feats = getattr(b, "features", b)
            self.fit_batch(net, feats)
        if hasattr(data, "reset"):
            data.reset()
        return self

    # -- finalize ----------------------------------------------------------
    def spec(self, net=None) -> QuantSpec:
        if self._acc is None:
            raise RuntimeError("QuantCalibrator.spec() before fit()")
        scales: List[Optional[float]] = []
        audit: List[Optional[Dict[str, float]]] = []
        for n, s, sq, absmax in self._acc:
            if n <= 0 or absmax <= 0.0:
                scales.append(None)
                audit.append(None)
                continue
            mean = s / n
            var = max(sq / n - mean * mean, 0.0)
            scales.append(absmax / 127.0)
            audit.append({"absmax": absmax, "mean": mean,
                          "std": float(np.sqrt(var)), "rows": n})
        meta: Dict[str, Any] = {"version": _SPEC_VERSION,
                                "layers": self._layers}
        if net is not None:
            meta["net_layers"] = len(getattr(net, "layers", []) or [])
        return QuantSpec(scales, self._sample, audit, meta)
