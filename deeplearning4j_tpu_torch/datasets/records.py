"""Record readers and record-to-minibatch assembly (counterpart:
``deeplearning4j_tpu/datasets/records.py`` — the Collection, Line, CSV
and CSVSequence readers, ``RecordReaderDataSetIterator`` :166,
``SequenceRecordReaderDataSetIterator`` :245 and
``RecordReaderMultiDataSetIterator`` :326).

Readers yield flat records (lists of values) or sequences of them;
``RecordReaderDataSetIterator`` cuts records into float32 DataSets with
a one-hot or passthrough label column; the sequence iterator pads each
batch to its longest sequence with masks, the data at the start or the
end of the window (``ALIGN_START``/``ALIGN_END``); the multi iterator
routes column ranges of named readers into a MultiDataSet. Everything
here is numpy on the host, so its output is the JAX package's byte for
byte; the input pipeline moves it to the card.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import DataSet, DataSetIterator, MultiDataSet


# ---------------------------------------------------------------------------
# Record readers
# ---------------------------------------------------------------------------


class RecordReader:
    """next()/has_next()/reset() over flat records (lists of values)."""

    def __iter__(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (Canova CollectionRecordReader)."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = [list(r) for r in records]

    def __iter__(self):
        return iter(self.records)


class LineRecordReader(RecordReader):
    """One record per line, the raw string as single field."""

    def __init__(self, path: str, encoding: str = "utf-8"):
        self.path = path
        self.encoding = encoding

    def __iter__(self):
        with open(self.path, "r", encoding=self.encoding) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield [line]


class CSVRecordReader(RecordReader):
    """CSV records (Canova CSVRecordReader: skipNumLines + delimiter),
    RFC-4180 aware: quoted fields may contain the delimiter, doubled
    quotes, and embedded newlines (stdlib ``csv`` does the state
    machine). ``skip_lines`` skips the first N RECORDS (header rows;
    identical to physical lines except when a quoted field spans lines).

    Ragged rows fail LOUDLY: every record must have the width of the
    first record, else ``ValueError`` with file + line number — the old
    behavior (yield the short row, die later inside ``float()`` during
    batch assembly with no provenance) debugged as a shape error three
    layers away from the bad byte."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ",",
                 encoding: str = "utf-8"):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.encoding = encoding

    def __iter__(self):
        import csv

        # newline="" is the csv-module contract: IT handles newlines, so
        # quoted embedded "\r\n" survives intact
        with open(self.path, "r", encoding=self.encoding, newline="") as f:
            rdr = csv.reader(f, delimiter=self.delimiter, quotechar='"',
                             doublequote=True)
            width = None
            for i, rec in enumerate(rdr):
                if i < self.skip_lines:
                    continue
                if not rec or (len(rec) == 1 and not rec[0].strip()):
                    continue  # blank line
                if width is None:
                    width = len(rec)
                elif len(rec) != width:
                    raise ValueError(
                        f"{self.path}:{rdr.line_num}: ragged row — "
                        f"{len(rec)} fields, expected {width} "
                        f"(first data row's width)")
                yield rec


class SequenceRecordReader:
    """Yields SEQUENCES (list of timestep records)."""

    def __iter__(self) -> Iterator[List[List]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Sequence]]):
        self.sequences = [[list(r) for r in seq] for seq in sequences]

    def __iter__(self):
        return iter(self.sequences)


class CSVSequenceRecordReader(SequenceRecordReader):
    """One sequence per CSV file in a directory (Canova
    CSVSequenceRecordReader); files sorted by name."""

    def __init__(self, directory: str, skip_lines: int = 0, delimiter: str = ","):
        self.directory = directory
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if not os.path.isfile(path):
                continue
            seq = list(CSVRecordReader(path, self.skip_lines, self.delimiter))
            if seq:
                yield seq


# ---------------------------------------------------------------------------
# Record -> DataSet assembly
# ---------------------------------------------------------------------------


def _to_float(record: Sequence):
    """Record values as floats; ndarray records (e.g. ImageRecordReader
    pixel rows) pass through without a per-element Python loop."""
    if isinstance(record, np.ndarray):
        return record.astype(np.float32, copy=False)
    return [float(v) for v in record]


class RecordReaderDataSetIterator(DataSetIterator):
    """Reference datasets/canova/RecordReaderDataSetIterator.java:48.

    label_index: column holding the label; num_possible_labels > 0 =>
    classification (one-hot), -1/None with regression=True => the label
    column(s) pass through as regression targets.
    """

    def __init__(
        self,
        reader: RecordReader,
        batch_size: int,
        label_index: Optional[int] = None,
        num_possible_labels: int = -1,
        regression: bool = False,
        label_index_to: Optional[int] = None,
    ):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.label_index_to = label_index_to

    def _split(self, record: List) -> Tuple[List[float], Optional[np.ndarray]]:
        vals = _to_float(record)
        is_arr = isinstance(vals, np.ndarray)
        li = self.label_index
        if li is None:
            return vals, None
        if li < 0:
            li = len(vals) + li
        if self.label_index_to is not None:  # multi-column regression label
            hi = self.label_index_to + 1
            label = np.asarray(vals[li:hi], np.float32)
            feats = (
                np.concatenate([vals[:li], vals[hi:]])
                if is_arr
                else vals[:li] + vals[hi:]
            )
            return feats, label
        label_val = vals[li]
        feats = (
            np.concatenate([vals[:li], vals[li + 1 :]])
            if is_arr
            else vals[:li] + vals[li + 1 :]
        )
        if self.regression or self.num_possible_labels <= 0:
            return feats, np.asarray([label_val], np.float32)
        one_hot = np.zeros((self.num_possible_labels,), np.float32)
        one_hot[int(label_val)] = 1.0
        return feats, one_hot

    def __iter__(self):
        feats, labels = [], []
        for record in self.reader:
            f, l = self._split(record)
            feats.append(f)
            labels.append(l)
            if len(feats) == self.batch_size:
                yield self._make(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._make(feats, labels)
        self.reader.reset()

    def _make(self, feats, labels) -> DataSet:
        x = np.asarray(feats, np.float32)
        if labels[0] is None:
            y = x  # unsupervised: features double as targets (AE pretrain)
        else:
            y = np.stack(labels)
        return DataSet(features=x, labels=y)


ALIGN_START = "align_start"
ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Variable-length sequence batches with masks (reference
    SequenceRecordReaderDataSetIterator; masking semantics per
    TestVariableLengthTS / MultiLayerNetwork.setLayerMaskArrays:1053).

    One reader (features+label per timestep row) or two parallel readers
    (features / labels). Sequences shorter than the batch max are padded;
    align_mode places the data at the start (default) or end of the padded
    window.
    """

    def __init__(
        self,
        features_reader: SequenceRecordReader,
        batch_size: int,
        labels_reader: Optional[SequenceRecordReader] = None,
        label_index: Optional[int] = None,
        num_possible_labels: int = -1,
        regression: bool = False,
        align_mode: str = ALIGN_START,
    ):
        if labels_reader is None and label_index is None:
            raise ValueError("need labels_reader or label_index")
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.align_mode = align_mode

    def _sequences(self):
        if self.labels_reader is not None:
            for fseq, lseq in zip(self.features_reader, self.labels_reader):
                f = np.asarray([_to_float(r) for r in fseq], np.float32)
                l = np.asarray([_to_float(r) for r in lseq], np.float32)
                yield f, self._encode_labels(l)
        else:
            li = self.label_index
            for seq in self.features_reader:
                rows = np.asarray([_to_float(r) for r in seq], np.float32)
                f = np.delete(rows, li, axis=1)
                yield f, self._encode_labels(rows[:, li : li + 1])

    def _encode_labels(self, l: np.ndarray) -> np.ndarray:
        if self.regression or self.num_possible_labels <= 0:
            return l
        flat = l.reshape(-1).astype(np.int64)
        return np.eye(self.num_possible_labels, dtype=np.float32)[flat]

    def __iter__(self):
        batch: List[Tuple[np.ndarray, np.ndarray]] = []
        for pair in self._sequences():
            batch.append(pair)
            if len(batch) == self.batch_size:
                yield self._assemble(batch)
                batch = []
        if batch:
            yield self._assemble(batch)
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def _assemble(self, batch) -> DataSet:
        n = len(batch)
        max_t = max(f.shape[0] for f, _ in batch)
        f_dim = batch[0][0].shape[1]
        l_dim = batch[0][1].shape[1]
        x = np.zeros((n, max_t, f_dim), np.float32)
        y = np.zeros((n, max_t, l_dim), np.float32)
        mask = np.zeros((n, max_t), np.float32)
        for i, (f, l) in enumerate(batch):
            t = f.shape[0]
            sl = slice(0, t) if self.align_mode == ALIGN_START else slice(max_t - t, max_t)
            x[i, sl] = f
            y[i, sl] = l
            mask[i, sl] = 1.0
        return DataSet(features=x, labels=y, features_mask=mask,
                       labels_mask=mask.copy())


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Named readers + column-range routing -> MultiDataSet (reference
    RecordReaderMultiDataSetIterator builder: addReader, addInput,
    addOutputOneHot)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._readers: Dict[str, RecordReader] = {}
        self._inputs: List[Tuple[str, int, Optional[int]]] = []
        self._outputs: List[Tuple[str, int, Optional[int], int]] = []

    def add_reader(self, name: str, reader: RecordReader):
        self._readers[name] = reader
        return self

    def add_input(self, reader_name: str, col_from: int, col_to: Optional[int] = None):
        self._inputs.append((reader_name, col_from, col_to))
        return self

    def add_output_one_hot(self, reader_name: str, col: int, num_classes: int):
        self._outputs.append((reader_name, col, None, num_classes))
        return self

    def add_output(self, reader_name: str, col_from: int, col_to: Optional[int] = None):
        self._outputs.append((reader_name, col_from, col_to, -1))
        return self

    def __iter__(self):
        iters = {name: iter(r) for name, r in self._readers.items()}
        while True:
            rows: Dict[str, List[List[float]]] = {n: [] for n in iters}
            exhausted = False
            for _ in range(self.batch_size):
                try:
                    for name, it in iters.items():
                        rows[name].append(_to_float(next(it)))
                except StopIteration:
                    exhausted = True
                    break
            count = min(len(v) for v in rows.values()) if rows else 0
            if count:
                yield self._make({k: v[:count] for k, v in rows.items()})
            if exhausted:
                break
        for r in self._readers.values():
            r.reset()

    def _make(self, rows: Dict[str, List[List[float]]]) -> MultiDataSet:
        feats, labels = [], []
        for name, c0, c1 in self._inputs:
            arr = np.asarray(rows[name], np.float32)
            hi = (c1 + 1) if c1 is not None else arr.shape[1]
            feats.append(arr[:, c0:hi])
        for name, c0, c1, n_classes in self._outputs:
            arr = np.asarray(rows[name], np.float32)
            if n_classes > 0:
                labels.append(
                    np.eye(n_classes, dtype=np.float32)[arr[:, c0].astype(np.int64)]
                )
            else:
                hi = (c1 + 1) if c1 is not None else arr.shape[1]
                labels.append(arr[:, c0:hi])
        return MultiDataSet(features_list=feats, labels_list=labels)
