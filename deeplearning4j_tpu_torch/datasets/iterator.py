"""DataSet and the in-memory iterator (counterpart:
``deeplearning4j_tpu/datasets/iterator.py`` — ``DataSet`` :36,
``MultiDataSet`` :143-155, ``DataSetIterator`` and
``ListDataSetIterator`` :193).

A ``DataSet`` holds one minibatch (features, labels and their optional
masks) as numpy arrays or tensors; ``ListDataSetIterator`` cuts an
in-memory pair into minibatches and can resume mid-pass
(``state``/``restore_state``). The DataSet utilities (normalize, shuffle,
sample, split) and the async, multi-epoch and sampling iterators wait for
a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

import numpy as np


@dataclass
class DataSet:
    """One minibatch: features and labels with optional masks."""

    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])


@dataclass
class MultiDataSet:
    """A multi-input, multi-output minibatch (reference org.nd4j
    MultiDataSet, consumed by ``ComputationGraph.fit``)."""

    features_list: List[Any]
    labels_list: List[Any]
    features_masks: Optional[List[Optional[Any]]] = None
    labels_masks: Optional[List[Optional[Any]]] = None

    def num_examples(self) -> int:
        return int(np.asarray(self.features_list[0]).shape[0])


class DataSetIterator:
    """Protocol: iterate DataSets; ``reset`` starts a new pass."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def state(self) -> Optional[dict]:
        """A JSON-able resume cursor, or None when this iterator cannot
        resume exactly."""
        return None

    def restore_state(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support exact resume")


class ListDataSetIterator(DataSetIterator):
    """Minibatches of an in-memory array pair, in order; the last short
    batch is kept unless ``drop_partial``."""

    def __init__(self, features, labels, batch: int, masks=None,
                 label_masks=None, drop_partial: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.masks = None if masks is None else np.asarray(masks)
        self.label_masks = (None if label_masks is None
                            else np.asarray(label_masks))
        self._batch = int(batch)
        self.drop_partial = drop_partial
        self._cursor = 0       # batches yielded in the current pass
        self._resume_skip = 0  # one-shot start offset (restore_state)

    def __iter__(self):
        start, self._resume_skip = self._resume_skip, 0
        self._cursor = start
        n = self.features.shape[0]
        for i in range(start * self._batch, n, self._batch):
            if self.drop_partial and i + self._batch > n:
                break
            sl = slice(i, min(i + self._batch, n))
            # the cursor moves before the yield: a checkpoint taken after
            # fitting batch j resumes at j + 1
            self._cursor += 1
            yield DataSet(
                self.features[sl], self.labels[sl],
                None if self.masks is None else self.masks[sl],
                None if self.label_masks is None else self.label_masks[sl])

    def reset(self):
        self._cursor = 0
        self._resume_skip = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return int(self.features.shape[0])

    def state(self):
        return {"cursor": self._cursor}

    def restore_state(self, state):
        self._resume_skip = int(state["cursor"])
        self._cursor = self._resume_skip
