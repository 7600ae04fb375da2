"""The port's schema, transforms and InputPipeline
(``deeplearning4j_tpu_torch/etl/``) against the JAX package's on the
same records: transformed records and the JSON forms equal, the
pipeline's batches byte-equal to the port's own serial iterator and to
JAX's ``from_reader`` (``device_put=False``) at 1, 2 and 4 workers, the
``maybe_wrap`` knob, sharding and ``reshard``, and a cursor taken
mid-pass equal to JAX's and resumable by either package."""

import numpy as np
import pytest

pytest.importorskip("jax")

from deeplearning4j_tpu.datasets import iterator as jit  # noqa: E402
from deeplearning4j_tpu.datasets import records as jrec  # noqa: E402
from deeplearning4j_tpu.etl import normalize as jnorm  # noqa: E402
from deeplearning4j_tpu.etl import pipeline as jpipe  # noqa: E402
from deeplearning4j_tpu.etl import schema as jschema  # noqa: E402
from deeplearning4j_tpu.etl import transforms as jtf  # noqa: E402

from deeplearning4j_tpu_torch.datasets import iterator as pit  # noqa: E402
from deeplearning4j_tpu_torch.datasets import records as prec  # noqa: E402
from deeplearning4j_tpu_torch.etl import normalize as pnorm  # noqa: E402
from deeplearning4j_tpu_torch.etl import pipeline as ppipe  # noqa: E402
from deeplearning4j_tpu_torch.etl import schema as pschema  # noqa: E402
from deeplearning4j_tpu_torch.etl import transforms as ptf  # noqa: E402

_RNG = np.random.default_rng(0)
N, F, C = 150, 6, 3
RECORDS = [[f"{v:.5f}" for v in _RNG.standard_normal(F)]
           + [str(int(_RNG.integers(0, C)))] for _ in range(N)]
X = _RNG.standard_normal((96, F)).astype(np.float32)
Y = np.eye(C, dtype=np.float32)[_RNG.integers(0, C, 96)]

RICH = [["1.5", "2", "y", "2016-03-01 10:00:00", "0"],
        ["-1", "3", "x", "2016-03-01 10:00:05", "1"],
        ["2.25", "junk", "z", "2016-03-02 00:00:00", "2"],
        ["0.5", "4", "y", "2016-03-03 12:30:00", "1"],
        ["3", "5", "x", "2016-03-04 08:00:00", "0"]]


def schema(mod):
    return (mod.Schema.builder()
            .add_numeric_column(*[f"x{i}" for i in range(F)])
            .add_integer_column("label").build())


def transform(sm, tm):
    return (tm.TransformProcess(schema(sm)).math_op("x0", "mul", 2.0)
            .condition_filter("x1", "gt", 1.5)
            .rolling_window("x2", 4, "mean").math_op("x3", "abs"))


def rich(sm, tm):
    s = (sm.Schema.builder().add_numeric_column("a", "b")
         .add_categorical_column("cat", ["x", "y", "z"])
         .add_string_column("when").add_integer_column("label").build())
    return (tm.TransformProcess(s).filter_invalid(["b"])
            .condition_filter("a", "lt", 0.0)
            .string_to_time("when", "%Y-%m-%d %H:%M:%S")
            .one_hot("cat").math_op("a", "pow", 2.0)
            .derive("s", ["a", "b"], "mean").rolling_window("a", 2, "max"))


def _bytes(ds):
    parts = [np.asarray(ds.features).tobytes(),
             np.asarray(ds.labels).tobytes()]
    for m in (ds.features_mask, ds.labels_mask):
        if m is not None:
            parts.append(np.asarray(m).tobytes())
    return b"".join(parts)


class TestSchemaAndTransforms:
    def test_schema_json_and_queries(self):
        j, p = schema(jschema), schema(pschema)
        assert p.to_json() == j.to_json()
        assert pschema.Schema.from_json(j.to_json()) == p
        assert p.names() == j.names() and p.index_of("label") == F
        with pytest.raises(KeyError):
            p.index_of("nope")
        with pytest.raises(ValueError, match="duplicate"):
            pschema.Schema([pschema.ColumnSpec("a"), pschema.ColumnSpec("a")])

    @pytest.mark.parametrize("which", ["numeric", "rich"])
    def test_records_schema_and_json_equal(self, which):
        if which == "rich":
            j, p, recs = rich(jschema, jtf), rich(pschema, ptf), RICH
        else:
            j, p, recs = (transform(jschema, jtf), transform(pschema, ptf),
                          RECORDS)
        assert list(p.execute(recs)) == list(j.execute(recs))
        assert p.final_schema().to_json() == j.final_schema().to_json()
        assert p.to_json() == j.to_json()
        back = ptf.TransformProcess.from_json(j.to_json())
        assert list(back.execute(recs)) == list(j.execute(recs))
        jh, jt = j.split_for_pipeline()
        ph, pt = p.split_for_pipeline()
        assert (ph is None) == (jh is None) and (pt is None) == (jt is None)
        if ph is not None:
            assert ph.to_json() == jh.to_json()
        if pt is not None:
            assert pt.to_json() == jt.to_json()
            assert pt.is_record_parallel_safe

    def test_map_column_not_serializable_and_unknown_category(self):
        s = (pschema.Schema.builder().add_categorical_column("c", ["u", "v"])
             .build())
        tp = ptf.TransformProcess(s).map_column("c", str.upper, "string")
        assert list(tp.execute([["u"]])) == [["U"]]
        with pytest.raises(NotImplementedError):
            tp.to_json()
        tp2 = ptf.TransformProcess(s).one_hot("c")
        with pytest.raises(ValueError, match="not in categories"):
            list(tp2.execute([["w"]]))


def _serial(tp_mod, rec_mod, tp):
    li = tp.final_schema().index_of("label")
    return list(rec_mod.RecordReaderDataSetIterator(
        tp_mod.TransformProcessRecordReader(
            rec_mod.CollectionRecordReader(RECORDS), tp),
        batch_size=16, label_index=li, num_possible_labels=C))


def _port_reader_pipe(workers=2, **kw):
    tp = transform(pschema, ptf)
    return ppipe.InputPipeline.from_reader(
        prec.CollectionRecordReader(RECORDS), 16,
        label_index=tp.final_schema().index_of("label"),
        num_possible_labels=C, transform=tp, workers=workers, prefetch=3,
        device="cpu", **kw)


def _jax_reader_pipe(workers=2):
    tp = transform(jschema, jtf)
    return jpipe.InputPipeline.from_reader(
        jrec.CollectionRecordReader(RECORDS), 16,
        label_index=tp.final_schema().index_of("label"),
        num_possible_labels=C, transform=tp, workers=workers, prefetch=3,
        device_put=False, shard=None)


class TestReaderMode:
    @pytest.mark.parametrize("workers", [1, 2, 4])
    def test_byte_equal_to_serial_and_jax(self, workers):
        serial = _serial(ptf, prec, transform(pschema, ptf))
        got = list(_port_reader_pipe(workers, shard=None))
        ref = list(_jax_reader_pipe(workers))
        assert [_bytes(d) for d in got] == [_bytes(d) for d in serial] \
            == [_bytes(d) for d in ref]
        assert len(got) > 3

    def test_vectorized_assembly_matches_per_record(self):
        for kw in ({"label_index": F, "num_possible_labels": C,
                    "regression": False, "label_index_to": None},
                   {"label_index": -1, "num_possible_labels": -1,
                    "regression": True, "label_index_to": None},
                   {"label_index": None, "num_possible_labels": -1,
                    "regression": False, "label_index_to": None}):
            a = ppipe.assemble_batch(RECORDS[:20], **kw)
            b = ppipe._assemble_per_record(RECORDS[:20], **kw)
            c = jpipe.assemble_batch(RECORDS[:20], **kw)
            assert _bytes(a) == _bytes(b) == _bytes(c)

    def test_reader_error_reaches_the_consumer(self):
        bad = [["1", "2"], ["x", "y"]]
        pipe = ppipe.InputPipeline.from_reader(
            prec.CollectionRecordReader(bad), 1, label_index=1,
            num_possible_labels=3, workers=2, device="cpu", shard=None)
        with pytest.raises(ValueError):
            list(pipe)

    def test_normalizer_applied_to_a_copy(self):
        jn = jnorm.NormalizerStandardize()
        jn.fit(jit.ListDataSetIterator(X, Y, 32))
        pn = pnorm.NormalizerStandardize()
        pn.fit(pit.ListDataSetIterator(X, Y, 32))
        src = pit.ListDataSetIterator(X, Y, 32)
        got = list(ppipe.InputPipeline(src, normalizer=pn, workers=2,
                                       device="cpu", shard=None))
        ref = list(jpipe.InputPipeline(
            jit.ListDataSetIterator(X, Y, 32), normalizer=jn, workers=2,
            device_put=False, shard=None))
        assert [_bytes(d) for d in got] == [_bytes(d) for d in ref]
        assert np.array_equal(src.features, X)  # the source untouched

    def test_stats_count_deliveries(self):
        pipe = ppipe.InputPipeline(pit.ListDataSetIterator(X, Y, 16),
                                   workers=2, device="cpu", shard=None)
        list(pipe)
        snap = pipe.pipeline_stats.snapshot()
        assert snap["batches"] == 6 and snap["records"] == 96
        assert snap["bytes"] == X.nbytes + Y.nbytes and snap["epochs"] == 1


class TestKnobsAndSharding:
    def test_maybe_wrap_knob(self, monkeypatch):
        it = pit.ListDataSetIterator(X, Y, 16)
        monkeypatch.delenv("DL4J_TPU_PIPELINE_WORKERS", raising=False)
        assert ppipe.maybe_wrap(it, device="cpu") is it
        monkeypatch.setenv("DL4J_TPU_PIPELINE_WORKERS", "3")
        wrapped = ppipe.maybe_wrap(it, device="cpu")
        assert isinstance(wrapped, ppipe.InputPipeline)
        assert wrapped.workers == 3 and wrapped.shard is None
        assert ppipe.maybe_wrap(wrapped, device="cpu") is wrapped
        assert ppipe.maybe_wrap(5, device="cpu") == 5
        monkeypatch.setenv("DL4J_TPU_PREFETCH", "5")
        assert ppipe.default_prefetch() == jpipe.default_prefetch() == 5
        assert pit.AsyncDataSetIterator(it, device="cpu").queue_size == 5

    def test_fit_iterator_adopts_the_pipeline(self, monkeypatch):
        from deeplearning4j_tpu_torch.nn.conf import (
            DenseLayer,
            NeuralNetConfiguration,
            OutputLayer,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.obs.registry import default_registry

        def net():
            conf = (NeuralNetConfiguration.builder().seed(7)
                    .learning_rate(0.05).updater("adam").list()
                    .layer(0, DenseLayer(n_in=F, n_out=8,
                                         activation="tanh"))
                    .layer(1, OutputLayer(n_in=8, n_out=C,
                                          activation="softmax",
                                          loss_function="mcxent"))
                    .build())
            return MultiLayerNetwork(conf, device="cpu").init()

        plain = net().fit_iterator(pit.ListDataSetIterator(X, Y, 16), 2)
        monkeypatch.setenv("DL4J_TPU_PIPELINE_WORKERS", "2")
        piped = net().fit_iterator(pit.ListDataSetIterator(X, Y, 16), 2)
        assert piped.pipeline_stats.snapshot()["batches"] == 12
        assert "pipeline_stats" in default_registry().ledgers(piped)
        for a, b in zip(plain.params, piped.params):
            for k in a:
                assert a[k].equal(b[k]), k

    def test_shard_partition_and_auto_shard(self, monkeypatch):
        ref = [_bytes(d) for d in pit.ListDataSetIterator(X, Y, 8)]
        parts = [[_bytes(d) for d in ppipe.InputPipeline(
            pit.ListDataSetIterator(X, Y, 8), workers=2, device="cpu",
            shard=(k, 3))] for k in range(3)]
        for k in range(3):
            assert parts[k] == ref[k::3]
        monkeypatch.setenv("DL4J_TPU_PROCESS_ID", "1")
        monkeypatch.setenv("DL4J_TPU_NUM_PROCESSES", "2")
        assert ppipe._auto_shard() == jpipe._auto_shard() == (1, 2)
        assert ppipe.InputPipeline(pit.ListDataSetIterator(X, Y, 8),
                                   device="cpu").shard == (1, 2)
        monkeypatch.setenv("DL4J_TPU_NUM_PROCESSES", "1")
        assert ppipe._auto_shard() is None
        with pytest.raises(ValueError, match="outside"):
            ppipe.InputPipeline(pit.ListDataSetIterator(X, Y, 8),
                                device="cpu", shard=(2, 2))

    def test_reshard_covers_every_batch_once_and_rides_the_cursor(self):
        mk = lambda sh: ppipe.InputPipeline(  # noqa: E731
            pit.ListDataSetIterator(X, Y, 16), workers=1, device="cpu",
            shard=sh)
        ref = [_bytes(d) for d in pit.ListDataSetIterator(X, Y, 16)]
        pa, pb = mk((0, 2)), mk((1, 2))
        pa.reshard((0, 1), at_seq=3)
        pb.reshard(ppipe.DROP_SHARD, at_seq=3)
        got_a, got_b = ([_bytes(d) for d in pa], [_bytes(d) for d in pb])
        assert got_b == [ref[1]] and got_a == [ref[0], ref[2]] + ref[3:]
        # the schedule rides the cursor
        pipe = mk((0, 2))
        pipe.reshard((0, 1), at_seq=3)
        it = iter(pipe)
        first = [_bytes(next(it))]
        st = pipe.state()
        it.close()
        assert st["shard_schedule"] == [[0, [0, 2]], [3, [0, 1]]]
        fresh = mk((0, 2))
        fresh.restore_state(st)
        assert first + [_bytes(d) for d in fresh] == got_a
        # a boundary the dispatcher passed raises
        pipe = mk((0, 2))
        it = iter(pipe)
        next(it)
        next(it)
        with pytest.raises(ValueError, match="already passed"):
            pipe.reshard((0, 1), at_seq=0)
        it.close()
        # a deferred reshard lands on the next pass
        pipe = mk((0, 2))
        assert [_bytes(d) for d in pipe] == ref[0::2]
        pipe.reshard((1, 2))
        assert [_bytes(d) for d in pipe] == ref[1::2]


def _take(pipe, k):
    it = iter(pipe)
    got = [next(it) for _ in range(k)]
    st = pipe.state()
    it.close()
    return got, st


class TestCursor:
    @pytest.mark.parametrize("mode", ["replay", "source"])
    def test_mid_pass_cursor_equals_jax_and_resumes_both_ways(self, mode):
        if mode == "replay":
            mk_p, mk_j = (lambda: _port_reader_pipe(2, shard=None),
                          lambda: _jax_reader_pipe(2))
        else:
            mk_p = lambda: ppipe.InputPipeline(  # noqa: E731
                pit.ListDataSetIterator(X, Y, 16), workers=2, device="cpu",
                shard=None)
            mk_j = lambda: jpipe.InputPipeline(  # noqa: E731
                jit.ListDataSetIterator(X, Y, 16), workers=2,
                device_put=False, shard=None)
        full = [_bytes(d) for d in mk_j()]
        pg, ps = _take(mk_p(), 3)
        jg, js = _take(mk_j(), 3)
        assert ps == js and ps["mode"] == mode and ps["next_seq"] == 3
        assert [_bytes(d) for d in pg] == [_bytes(d) for d in jg]
        for fresh, st in ((mk_p(), js), (mk_j(), ps)):
            fresh.restore_state(st)
            assert [_bytes(d) for d in fresh] == full[3:]
        before = mk_p()
        assert before.state() == mk_j().state()

    def test_from_native_matches_the_feeder(self):
        from deeplearning4j_tpu_torch import native

        pipe = ppipe.InputPipeline.from_native(X, Y, 16, epochs=2, seed=5,
                                               workers=2, device="cpu",
                                               shard=None)
        got = [_bytes(d) for d in pipe]
        it = native.NativePrefetchIterator(X, Y, 16, epochs=2, seed=5)
        want = [np.asarray(f).tobytes() + np.asarray(l).tobytes()
                for f, l in native._iter_py(it)]
        assert got == want and pipe.total_examples() == 192
