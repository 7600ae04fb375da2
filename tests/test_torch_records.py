"""The port's record readers, record iterators, DataSet utilities and
iterators (``deeplearning4j_tpu_torch/datasets/``) against the JAX
package's on the same files and arrays: every record, every batch and
every cursor byte-equal, and the cursors of the async, multi-epoch and
sampling iterators resumable across the two packages."""

import numpy as np
import pytest

pytest.importorskip("jax")

from deeplearning4j_tpu.datasets import iterator as jit  # noqa: E402
from deeplearning4j_tpu.datasets import records as jrec  # noqa: E402

from deeplearning4j_tpu_torch.datasets import iterator as pit  # noqa: E402
from deeplearning4j_tpu_torch.datasets import records as prec  # noqa: E402


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_ds(a, b):
    if hasattr(a, "features_list"):
        assert len(a.features_list) == len(b.features_list)
        for x, y in zip(a.features_list, b.features_list):
            _same(x, y)
        for x, y in zip(a.labels_list, b.labels_list):
            _same(x, y)
        return
    _same(a.features, b.features)
    _same(a.labels, b.labels)
    _same(a.features_mask, b.features_mask)
    _same(a.labels_mask, b.labels_mask)


def _same_stream(ja, pa):
    ja, pa = list(ja), list(pa)
    assert len(ja) == len(pa) > 0
    for a, b in zip(ja, pa):
        _same_ds(a, b)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(3)
    rows = np.round(rng.standard_normal((23, 5)), 6)
    labels = rng.integers(0, 3, 23)
    with open(d / "plain.csv", "w") as f:
        f.write("a,b,c,d,e,label\n")
        for r, y in zip(rows, labels):
            f.write(",".join(repr(float(v)) for v in r) + f",{y}\n")
        f.write("\n")
    with open(d / "quoted.csv", "w") as f:
        f.write('"1.5","x, y",3\n"2.5","say ""hi""",4\n')
    with open(d / "ragged.csv", "w") as f:
        f.write("1,2,3\n4,5\n")
    with open(d / "lines.txt", "w") as f:
        f.write("alpha\n\nbeta gamma\ndelta\n")
    seq = d / "seq"
    seq.mkdir()
    lab = d / "seqlab"
    lab.mkdir()
    for k, t in enumerate((3, 5, 2, 4, 6)):
        x = np.round(rng.standard_normal((t, 2)), 5)
        y = rng.integers(0, 4, t)
        with open(seq / f"s{k}.csv", "w") as f:
            for row, yy in zip(x, y):
                f.write(f"{row[0]},{yy},{row[1]}\n")
        with open(lab / f"s{k}.csv", "w") as f:
            for yy in y:
                f.write(f"{yy}\n")
    return d


@pytest.mark.parametrize("name,kw", [
    ("plain.csv", {"skip_lines": 1}),
    ("quoted.csv", {}),
])
def test_csv_reader_records_equal(files, name, kw):
    path = str(files / name)
    assert list(prec.CSVRecordReader(path, **kw)) == \
        list(jrec.CSVRecordReader(path, **kw))


def test_ragged_csv_raises_in_both(files):
    path = str(files / "ragged.csv")
    for mod in (jrec, prec):
        with pytest.raises(ValueError, match="ragged row"):
            list(mod.CSVRecordReader(path))


def test_line_collection_and_sequence_readers(files):
    path = str(files / "lines.txt")
    assert list(prec.LineRecordReader(path)) == \
        list(jrec.LineRecordReader(path))
    recs = [[1, "2", 3.5], [4, 5, 6]]
    assert list(prec.CollectionRecordReader(recs)) == \
        list(jrec.CollectionRecordReader(recs))
    seqs = [[[1, 2], [3, 4]], [[5, 6]]]
    assert list(prec.CollectionSequenceRecordReader(seqs)) == \
        list(jrec.CollectionSequenceRecordReader(seqs))
    d = str(files / "seq")
    assert list(prec.CSVSequenceRecordReader(d)) == \
        list(jrec.CSVSequenceRecordReader(d))


@pytest.mark.parametrize("kw", [
    {"label_index": 5, "num_possible_labels": 3},
    {"label_index": -1, "regression": True},
    {"label_index": 3, "label_index_to": 4},
    {"label_index": None},
], ids=["one_hot", "regression", "label_range", "unsupervised"])
def test_record_reader_dataset_iterator(files, kw):
    path = str(files / "plain.csv")

    def run(mod):
        it = mod.RecordReaderDataSetIterator(
            mod.CSVRecordReader(path, skip_lines=1), 7, **kw)
        return list(it) + list(it)  # a second pass after the reset

    _same_stream(run(jrec), run(prec))


@pytest.mark.parametrize("align", ["align_start", "align_end"])
@pytest.mark.parametrize("two_readers", [False, True])
def test_sequence_iterator_pads_and_masks(files, align, two_readers):
    def run(mod):
        feats = mod.CSVSequenceRecordReader(str(files / "seq"))
        if two_readers:
            it = mod.SequenceRecordReaderDataSetIterator(
                feats, 2, labels_reader=mod.CSVSequenceRecordReader(
                    str(files / "seqlab")),
                num_possible_labels=4, align_mode=align)
        else:
            it = mod.SequenceRecordReaderDataSetIterator(
                feats, 2, label_index=1, num_possible_labels=4,
                align_mode=align)
        return list(it)

    got = run(prec)
    _same_stream(run(jrec), got)
    assert got[0].features_mask is not None


def test_multi_dataset_iterator(files):
    path = str(files / "plain.csv")

    def run(mod):
        it = (mod.RecordReaderMultiDataSetIterator(6)
              .add_reader("r", mod.CSVRecordReader(path, skip_lines=1))
              .add_reader("s", mod.CSVRecordReader(path, skip_lines=1))
              .add_input("r", 0, 2).add_input("s", 3)
              .add_output_one_hot("r", 5, 3).add_output("s", 0, 1))
        return list(it)

    _same_stream(run(jrec), run(prec))


# ----------------------------------------------------------- DataSet utilities

def _ds(mod, seed=5, dtype=np.float32, masks=True):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((12, 4, 3)).astype(dtype)
    f[:, 1] = 2.0  # a zero-std column
    y = rng.standard_normal((12, 4, 2)).astype(dtype)
    m = (rng.random((12, 4)) > 0.3).astype(np.float32) if masks else None
    return mod.DataSet(f, y, m, None if m is None else m.copy())


@pytest.mark.parametrize("op", [
    lambda d: d.normalize_zero_mean_zero_unit_variance(),
    lambda d: d.normalize(),
    lambda d: d.scale(),
    lambda d: d.scale(3.0),
    lambda d: d.shuffle(seed=9),
    lambda d: d.sample(5, seed=2),
    lambda d: d.sample(20, seed=2, with_replacement=True),
], ids=["standardize", "normalize", "scale_max", "scale_by", "shuffle",
        "sample", "sample_replace"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dataset_utilities_bit_equal(op, dtype):
    _same_ds(op(_ds(jit, dtype=dtype)), op(_ds(pit, dtype=dtype)))


def test_split_test_and_train():
    a, b = _ds(jit).split_test_and_train(7), _ds(pit).split_test_and_train(7)
    _same_ds(a.train, b.train)
    _same_ds(a.test, b.test)
    assert isinstance(b, pit.SplitTestAndTrain)
    for mod in (jit, pit):
        with pytest.raises(ValueError):
            _ds(mod).split_test_and_train(12)
        with pytest.raises(ValueError):
            _ds(mod).sample(13)


# ------------------------------------------------------------------ cursors

X = np.random.default_rng(1).standard_normal((40, 3)).astype(np.float32)
Y = np.eye(2, dtype=np.float32)[np.random.default_rng(2).integers(0, 2, 40)]


def _pair(kind):
    if kind == "async":
        return (jit.AsyncDataSetIterator(jit.ListDataSetIterator(X, Y, 6),
                                         queue_size=3, device_put=False),
                pit.AsyncDataSetIterator(pit.ListDataSetIterator(X, Y, 6),
                                         queue_size=3, device="cpu"))
    if kind == "epochs":
        return (jit.MultipleEpochsIterator(3, jit.ListDataSetIterator(X, Y,
                                                                      7)),
                pit.MultipleEpochsIterator(3, pit.ListDataSetIterator(X, Y,
                                                                      7)))
    return (jit.SamplingDataSetIterator(X, Y, 5, 9, seed=4),
            pit.SamplingDataSetIterator(X, Y, 5, 9, seed=4))


def _take(it, k):
    out = []
    gen = iter(it)
    for _ in range(k):
        out.append(next(gen))
    st = it.state()
    gen.close()
    return out, st


@pytest.mark.parametrize("kind", ["async", "epochs", "sampling"])
@pytest.mark.parametrize("cut", [0, 3, 6])
def test_cursor_equals_jax_and_resumes_both_ways(kind, cut):
    ja, pa = _pair(kind)
    _same_stream(list(ja), list(pa))  # whole passes
    ja, pa = _pair(kind)
    jb, js = _take(ja, cut)
    pb, ps = _take(pa, cut)
    if cut:
        _same_stream(jb, pb)
    assert ps == js
    # each package resumes from the other's cursor
    ref, _ = _pair(kind)
    tail = list(ref)[cut:]
    for it, st in ((_pair(kind)[1], js), (_pair(kind)[0], ps)):
        it.restore_state(st)
        _same_stream(tail, list(it))


def test_async_cursor_is_delivered_not_prefetched():
    it = pit.AsyncDataSetIterator(pit.ListDataSetIterator(X, Y, 4),
                                  queue_size=8, device="cpu")
    gen = iter(it)
    next(gen)
    next(gen)
    import time

    time.sleep(0.05)  # the producer runs ahead and fills the queue
    assert it.state() == {"cursor": 2}
    assert it.base.state()["cursor"] > 2
    gen.close()
    snap = it.pipeline_stats.snapshot()
    assert snap["batches"] == 2 and snap["records"] == 8


def test_async_raises_a_producer_failure():
    class Boom(pit.DataSetIterator):
        def __iter__(self):
            yield pit.DataSet(X[:2], Y[:2])
            raise IOError("disk gone")

        def state(self):
            return None

    it = pit.AsyncDataSetIterator(Boom(), device="cpu")
    with pytest.raises(IOError, match="disk gone"):
        list(it)
