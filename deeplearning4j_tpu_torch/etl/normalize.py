"""Fitted dataset normalizers (counterpart:
``deeplearning4j_tpu/etl/normalize.py`` :37-360 — ``DataNormalization``,
``NormalizerStandardize``, ``NormalizerMinMaxScaler``,
``ImagePreProcessingScaler`` and ``normalizer_from_json``). The port's own
copy, numpy on the host.

Statistics are fitted once over the training stream (count, sum and sum
of squares, or running min and max, in float64, per final-axis column:
``_column_stats_axes``) and then applied identically at train, eval and
serving time. ``transform`` normalizes a DataSet in place;
``transform_array`` is the pure form serving uses (a coalesced batch
shares its buffer between requests). ``to_json`` and
``normalizer_from_json`` round-trip the class-tagged state, the
``normalizer.json`` section of a checkpoint zip, so a zip written by
either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def _float_dtype_of(a) -> np.dtype:
    dt = np.asarray(a).dtype
    return dt if np.issubdtype(dt, np.floating) else np.dtype(np.float32)


def _column_stats_axes(x: np.ndarray):
    """Statistics per FINAL-axis column, accumulated over every leading
    axis: [N,F] -> per-feature, [N,T,F] -> per-feature over all timesteps,
    [N,H,W,C] -> per-channel (the reference's columnwise contract extended
    to the layouts the containers actually feed)."""
    return tuple(range(x.ndim - 1))


class DataNormalization:
    """fit / transform / revert lifecycle. Also usable as a DataSet
    pre-processor (``pre_process`` alias — the reference attaches
    normalizers to iterators via setPreProcessor)."""

    _FIELDS = ()  # fitted statistics, in serde order (ndarray or None)

    def __init__(self, fit_labels: bool = False):
        self._fit_labels = bool(fit_labels)

    # -- configuration -----------------------------------------------------
    def fit_label(self, fit_labels: bool = True) -> "DataNormalization":
        """Also fit/transform the LABELS (regression targets — the
        reference's fitLabel(true))."""
        self._fit_labels = bool(fit_labels)
        return self

    @property
    def is_fit(self) -> bool:
        raise NotImplementedError

    # -- fitting -----------------------------------------------------------
    def fit(self, data) -> "DataNormalization":
        """Accumulate statistics over a DataSetIterator (one full pass,
        reset() after), a single DataSet, or a bare feature array."""
        if hasattr(data, "features"):  # DataSet
            self._accumulate(np.asarray(data.features),
                             np.asarray(data.labels)
                             if self._fit_labels else None)
        elif hasattr(data, "__iter__") and not hasattr(data, "shape"):
            for ds in data:
                self._accumulate(np.asarray(ds.features),
                                 np.asarray(ds.labels)
                                 if self._fit_labels else None)
            if hasattr(data, "reset"):
                data.reset()
        else:
            self._accumulate(np.asarray(data), None)
        self._finalize()
        return self

    def _accumulate(self, features: np.ndarray,
                    labels: Optional[np.ndarray]) -> None:
        raise NotImplementedError

    def _finalize(self) -> None:
        pass

    # -- application -------------------------------------------------------
    def transform(self, ds):
        """Normalize a DataSet IN PLACE (returns it), or return the
        normalized copy of a bare array."""
        if hasattr(ds, "features"):
            ds.features = self.transform_array(ds.features)
            if self._fit_labels and ds.labels is not None:
                ds.labels = self.transform_array(ds.labels, labels=True)
            return ds
        return self.transform_array(ds)

    # the DataSetPreProcessor role (reference preProcess(DataSet))
    def pre_process(self, ds):
        return self.transform(ds)

    def transform_array(self, x, labels: bool = False) -> np.ndarray:
        """PURE normalization of a bare array (serving/predict path)."""
        self._require_fit()
        x = np.asarray(x)
        out = self._apply(np.asarray(x, np.float64), labels=labels)
        return out.astype(_float_dtype_of(x))

    def revert(self, ds):
        """Inverse transform (reference revert/revertFeatures) — DataSet
        in place, or a bare array copy."""
        if hasattr(ds, "features"):
            ds.features = self.revert_array(ds.features)
            if self._fit_labels and ds.labels is not None:
                ds.labels = self.revert_array(ds.labels, labels=True)
            return ds
        return self.revert_array(ds)

    def revert_array(self, x, labels: bool = False) -> np.ndarray:
        self._require_fit()
        x = np.asarray(x)
        out = self._unapply(np.asarray(x, np.float64), labels=labels)
        return out.astype(_float_dtype_of(x))

    def _apply(self, x64: np.ndarray, labels: bool) -> np.ndarray:
        raise NotImplementedError

    def _unapply(self, x64: np.ndarray, labels: bool) -> np.ndarray:
        raise NotImplementedError

    def _require_fit(self) -> None:
        if not self.is_fit:
            raise RuntimeError(
                f"{type(self).__name__} used before fit() — fitted "
                "statistics are the whole point (per-batch statistics "
                "drift; see datasets.DataSet utilities for that)")

    # -- serde -------------------------------------------------------------
    def state_dict(self) -> dict:
        out = {"class": type(self).__name__,
               "fit_labels": self._fit_labels}
        for f in self._FIELDS:
            v = getattr(self, f)
            out[f] = None if v is None else np.asarray(v).tolist()
        return out

    def load_state_dict(self, state: dict) -> "DataNormalization":
        self._fit_labels = bool(state.get("fit_labels", False))
        for f in self._FIELDS:
            v = state.get(f)
            setattr(self, f,
                    None if v is None else np.asarray(v, np.float64))
        return self

    def to_json(self) -> str:
        return json.dumps(self.state_dict())


class NormalizerStandardize(DataNormalization):
    """Per-column zero-mean/unit-variance by the FITTED statistics
    (reference NormalizerStandardize). Streaming count/sum/sumsq;
    population std; zero-variance columns divide by 1."""

    _FIELDS = ("mean", "std", "label_mean", "label_std")

    def __init__(self, fit_labels: bool = False):
        super().__init__(fit_labels)
        self.mean = self.std = None
        self.label_mean = self.label_std = None
        self._acc = None  # (n, sum, sumsq) per stream
        self._lacc = None

    @property
    def is_fit(self) -> bool:
        return self.mean is not None

    @staticmethod
    def _acc_one(acc, x: np.ndarray):
        x64 = np.asarray(x, np.float64)
        axes = _column_stats_axes(x64)
        n = int(np.prod([x64.shape[a] for a in axes])) if axes else 1
        s = x64.sum(axis=axes)
        sq = np.square(x64).sum(axis=axes)
        if acc is None:
            return [n, s, sq]
        acc[0] += n
        acc[1] += s
        acc[2] += sq
        return acc

    def _accumulate(self, features, labels):
        self._acc = self._acc_one(self._acc, features)
        if labels is not None:
            self._lacc = self._acc_one(self._lacc, labels)

    @staticmethod
    def _fin_one(acc):
        n, s, sq = acc
        mean = s / n
        var = np.maximum(sq / n - np.square(mean), 0.0)
        std = np.sqrt(var)
        return mean, np.where(std == 0, 1.0, std)

    def _finalize(self):
        self.mean, self.std = self._fin_one(self._acc)
        if self._lacc is not None:
            self.label_mean, self.label_std = self._fin_one(self._lacc)

    def _stats(self, labels: bool):
        if labels:
            if self.label_mean is None:
                raise RuntimeError("labels were not fitted "
                                   "(fit_label(True) before fit)")
            return self.label_mean, self.label_std
        return self.mean, self.std

    def _apply(self, x64, labels):
        mean, std = self._stats(labels)
        return (x64 - mean) / std

    def _unapply(self, x64, labels):
        mean, std = self._stats(labels)
        return x64 * std + mean


class NormalizerMinMaxScaler(DataNormalization):
    """Per-column scale into [lo, hi] (default [0, 1]) by the FITTED
    min/max (reference NormalizerMinMaxScaler); constant columns map to
    lo."""

    _FIELDS = ("feature_min", "feature_max", "label_min", "label_max")

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 fit_labels: bool = False):
        super().__init__(fit_labels)
        self.lo, self.hi = float(lo), float(hi)
        self.feature_min = self.feature_max = None
        self.label_min = self.label_max = None

    @property
    def is_fit(self) -> bool:
        return self.feature_min is not None

    def _accumulate(self, features, labels):
        def upd(cur_min, cur_max, x):
            x64 = np.asarray(x, np.float64)
            axes = _column_stats_axes(x64)
            mn, mx = x64.min(axis=axes), x64.max(axis=axes)
            if cur_min is None:
                return mn, mx
            return np.minimum(cur_min, mn), np.maximum(cur_max, mx)

        self.feature_min, self.feature_max = upd(
            self.feature_min, self.feature_max, features)
        if labels is not None:
            self.label_min, self.label_max = upd(
                self.label_min, self.label_max, labels)

    def _stats(self, labels: bool):
        if labels:
            if self.label_min is None:
                raise RuntimeError("labels were not fitted "
                                   "(fit_label(True) before fit)")
            lo, hi = self.label_min, self.label_max
        else:
            lo, hi = self.feature_min, self.feature_max
        span = hi - lo
        return lo, np.where(span == 0, 1.0, span)

    def _apply(self, x64, labels):
        mn, span = self._stats(labels)
        return (x64 - mn) / span * (self.hi - self.lo) + self.lo

    def _unapply(self, x64, labels):
        mn, span = self._stats(labels)
        return (x64 - self.lo) / (self.hi - self.lo) * span + mn

    def state_dict(self) -> dict:
        out = super().state_dict()
        out["lo"], out["hi"] = self.lo, self.hi
        return out

    def load_state_dict(self, state: dict):
        super().load_state_dict(state)
        self.lo = float(state.get("lo", 0.0))
        self.hi = float(state.get("hi", 1.0))
        return self


class ImagePreProcessingScaler(DataNormalization):
    """Pixel scaler: [0, 2^bits - 1] -> [lo, hi] (reference
    ImagePreProcessingScaler, default 8-bit -> [0, 1]). The statistics
    are CLOSED-FORM — fit() is a no-op kept for lifecycle uniformity."""

    _FIELDS = ()

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_bits: int = 8):
        super().__init__(fit_labels=False)
        self.lo, self.hi = float(lo), float(hi)
        self.max_bits = int(max_bits)

    @property
    def is_fit(self) -> bool:
        return True

    def fit(self, data) -> "ImagePreProcessingScaler":
        return self  # closed-form; nothing to accumulate

    def _accumulate(self, features, labels):  # pragma: no cover
        pass

    @property
    def _max_val(self) -> float:
        return float(2 ** self.max_bits - 1)

    def _apply(self, x64, labels):
        return x64 / self._max_val * (self.hi - self.lo) + self.lo

    def _unapply(self, x64, labels):
        return (x64 - self.lo) / (self.hi - self.lo) * self._max_val

    def state_dict(self) -> dict:
        out = super().state_dict()
        out.update(lo=self.lo, hi=self.hi, max_bits=self.max_bits)
        return out

    def load_state_dict(self, state: dict):
        self.lo = float(state.get("lo", 0.0))
        self.hi = float(state.get("hi", 1.0))
        self.max_bits = int(state.get("max_bits", 8))
        return self


_NORMALIZER_CLASSES = {
    c.__name__: c for c in (NormalizerStandardize, NormalizerMinMaxScaler,
                            ImagePreProcessingScaler)
}


def normalizer_from_json(s: str) -> DataNormalization:
    """Restore any normalizer from its ``to_json`` form (dispatches on the
    recorded class — the ``normalizer.json`` zip-section reader)."""
    state = json.loads(s)
    cls = state.get("class")
    if cls not in _NORMALIZER_CLASSES:
        raise ValueError(f"unknown normalizer class {cls!r} "
                         f"(known: {sorted(_NORMALIZER_CLASSES)})")
    return _NORMALIZER_CLASSES[cls]().load_state_dict(state)
