"""Classification, regression and ROC evaluation (counterpart:
``deeplearning4j_tpu/eval/evaluation.py`` — ``ConfusionMatrix``,
``Evaluation``, ``RegressionEvaluation`` and ``ROC``, :22-289).

The port's own copy of that numpy module (it imports nothing of the JAX
package): accuracy, precision, recall and F1 from a confusion matrix,
top-N accuracy, time-series and masked variants and ``merge`` for
distributed evaluation; per-column MSE, MAE, RMSE and R^2; binary ROC
with the exact trapezoidal AUC. Host-side: a network's outputs are
copied to numpy before they are counted.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix"):
        self.matrix += other.matrix

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    """Multi-class classification metrics (reference eval/Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        # top-N accuracy (later-DL4J Evaluation(topN) surface, beyond the
        # 0.4 reference): counted from full prediction vectors at eval time
        self.top_n = max(1, int(top_n))
        self._topn_correct = 0
        self._topn_total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [N, C] one-hot/probabilities, or time series
        [N, T, C] with optional mask [N, T] (reference time-series variants)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, c)
            if mask is not None:
                flat = np.asarray(mask).reshape(n * t).astype(bool)
                labels = labels[flat]
                predictions = predictions[flat]
        self._ensure(labels.shape[-1])
        actual = labels.argmax(axis=-1)
        guess = predictions.argmax(axis=-1)
        for a, g in zip(actual, guess):
            self.confusion.add(int(a), int(g))
        if self.top_n > 1:
            k = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(-predictions, k - 1, axis=-1)[:, :k]
            self._topn_correct += int((topk == actual[:, None]).any(-1).sum())
        else:
            self._topn_correct += int((guess == actual).sum())
        self._topn_total += len(actual)

    # -- metrics ------------------------------------------------------------
    @property
    def _m(self):
        if self.confusion is None:
            raise ValueError("no evaluations recorded")
        return self.confusion.matrix

    def accuracy(self) -> float:
        m = self._m
        total = m.sum()
        return float(np.trace(m)) / total if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        m = self._m
        if cls is not None:
            denom = m[:, cls].sum()
            return float(m[cls, cls]) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(m.shape[0]) if m[:, c].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        m = self._m
        if cls is not None:
            denom = m[cls, :].sum()
            return float(m[cls, cls]) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(m.shape[0]) if m[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self) -> float:
        if self._topn_total == 0:
            raise ValueError("no evaluations recorded")
        return self._topn_correct / self._topn_total

    def merge(self, other: "Evaluation"):
        """Distributed-eval reduce (reference Evaluation.merge :795)."""
        if other._topn_total and other.top_n != self.top_n:
            raise ValueError(
                f"cannot merge Evaluation(top_n={other.top_n}) into "
                f"Evaluation(top_n={self.top_n}) — the summed counters "
                "would blend different metrics")
        self._topn_correct += other._topn_correct
        self._topn_total += other._topn_total
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.merge(other.confusion)
        return self

    def stats(self) -> str:
        m = self._m
        lines = [
            "==========================Scores========================================",
            f" Accuracy:  {self.accuracy():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines += [
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "========================================================================",
            "Confusion matrix:",
            str(self.confusion),
        ]
        return "\n".join(lines)


class RegressionEvaluation:
    """Per-column regression metrics (reference eval/RegressionEvaluation.java):
    MSE, MAE, RMSE, RSE-based R^2, correlation."""

    def __init__(self, num_columns: Optional[int] = None):
        self.num_columns = num_columns
        self._labels: List[np.ndarray] = []
        self._preds: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, c)
            if mask is not None:
                flat = np.asarray(mask).reshape(n * t).astype(bool)
                labels = labels[flat]
                predictions = predictions[flat]
        self.num_columns = self.num_columns or labels.shape[-1]
        self._labels.append(labels)
        self._preds.append(predictions)

    def _stacked(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def mean_squared_error(self, col: int) -> float:
        l, p = self._stacked()
        return float(np.mean((l[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col: int) -> float:
        l, p = self._stacked()
        return float(np.mean(np.abs(l[:, col] - p[:, col])))

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        l, p = self._stacked()
        ss_res = np.sum((l[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((l[:, col] - np.mean(l[:, col])) ** 2)
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def correlation_r2(self, col: int) -> float:
        l, p = self._stacked()
        if np.std(l[:, col]) == 0 or np.std(p[:, col]) == 0:
            return 0.0
        return float(np.corrcoef(l[:, col], p[:, col])[0, 1] ** 2)

    def stats(self) -> str:
        cols = self.num_columns or 0
        lines = ["column  MSE        MAE        RMSE       R^2"]
        for c in range(cols):
            lines.append(
                f"{c:<7d} {self.mean_squared_error(c):<10.5f} "
                f"{self.mean_absolute_error(c):<10.5f} "
                f"{self.root_mean_squared_error(c):<10.5f} "
                f"{self.r_squared(c):<10.5f}"
            )
        return "\n".join(lines)


class ROC:
    """Binary ROC / AUC (threshold sweep over predicted P(class 1)).

    Beyond the 0.4-era reference (whose eval/ stops at Evaluation +
    RegressionEvaluation; ROC arrived in later DL4J) but part of the eval
    surface users coming from any dl4j version expect. Exact
    trapezoidal AUC over the unique-score thresholds; merge() accumulates
    raw (score, label) pairs so distributed evaluation reduces the same
    way Evaluation.merge does."""

    def __init__(self):
        self._scores: List[float] = []
        self._labels: List[int] = []

    def eval(self, labels, probabilities) -> "ROC":
        """labels: [N] 0/1 ints or [N, 2] one-hot; probabilities: [N]
        P(positive) or [N, 2] class probabilities."""
        labels = np.asarray(labels)
        probs = np.asarray(probabilities, np.float64)
        if labels.ndim == 2:
            # (N, 1) column labels ARE the 0/1 values; only 2-column
            # one-hot gets argmax (argmax of a column is silently all-0)
            labels = (labels[:, 0] if labels.shape[1] == 1
                      else labels.argmax(axis=1))
        if probs.ndim == 2:
            # (N, 1) sigmoid output IS P(positive); (N, 2) takes column 1
            probs = probs[:, 0] if probs.shape[1] == 1 else probs[:, 1]
        self._labels.extend(int(v) for v in labels)
        self._scores.extend(float(v) for v in probs)
        return self

    def merge(self, other: "ROC") -> "ROC":
        self._labels.extend(other._labels)
        self._scores.extend(other._scores)
        return self

    def roc_curve(self):
        """(fpr, tpr) arrays over descending score thresholds."""
        if not self._labels:
            return np.zeros(0), np.zeros(0)
        y = np.asarray(self._labels)
        s = np.asarray(self._scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        s = s[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        # one operating point per unique threshold (last index of each run)
        last = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
        tp, fp = tps[last], fps[last]
        p = int(y.sum())
        n = len(y) - p
        if p == 0 or n == 0:
            # single-class data: ROC is undefined (NOT 0.0 — an
            # all-positive batch must not report worst-possible AUC)
            return np.full(1, np.nan), np.full(1, np.nan)
        return np.r_[0.0, fp / n], np.r_[0.0, tp / p]

    def auc(self) -> float:
        fpr, tpr = self.roc_curve()
        if len(fpr) < 2 or np.isnan(fpr).any():
            return float("nan")
        return float(np.trapezoid(tpr, fpr))

    def stats(self) -> str:
        return (f"ROC: {len(self._labels)} examples, "
                f"{int(np.sum(self._labels))} positive, AUC {self.auc():.4f}")
