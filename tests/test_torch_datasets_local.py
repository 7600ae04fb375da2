"""The port's local datasets (``datasets/fetchers.py``'s Iris, CIFAR-10,
LFW and curves paths) and image ingest (``datasets/image.py``) against
the JAX package's, on the CPU, with ``DL4J_TPU_DATA_DIR`` pointed at a
temp dir. The JAX loaders are always called with ``download=False``.

  * ``load_iris`` (stand-in and a local ``iris.data``), the CIFAR batch
    reader over a batch file written to the temp dir,
    ``load_cifar10_info`` (local batches and the stand-in),
    ``load_cifar_like``, ``load_lfw_info`` (a local tree of PNGs and the
    stand-in) and ``load_curves`` are bit-equal to JAX's, their iterators
    too.
  * ``ImageLoader`` and ``ImageRecordReader`` over a temp dir of PNGs
    written with PIL give JAX's arrays; the cases of
    ``tests/test_ingest.py`` for them run on the port.
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference side
pytest.importorskip("PIL")

from deeplearning4j_tpu.datasets import fetchers as jf  # noqa: E402
from deeplearning4j_tpu.datasets import image as jimage  # noqa: E402
from deeplearning4j_tpu_torch.datasets import fetchers as pf  # noqa: E402
from deeplearning4j_tpu_torch.datasets import image as pimage  # noqa: E402
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: E402
    RecordReaderDataSetIterator,
)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    return tmp_path


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _cifar_bytes(rng, n):
    labels = rng.integers(0, 10, n).astype(np.uint8)
    imgs = rng.integers(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    raw = b"".join(bytes([labels[i]]) + imgs[i].tobytes() for i in range(n))
    return raw, labels, imgs


class TestIris:
    @pytest.mark.parametrize("seed", [6, 0])
    def test_stand_in_equals_jax(self, data_dir, seed):
        jx, jy = jf.load_iris(seed)
        px, py = pf.load_iris(seed)
        assert same(px, jx) and same(py, jy) and px.shape == (150, 4)

    def test_local_file_equals_jax(self, data_dir):
        rows = [f"{5 + i * 0.1:.1f},3.{i % 10},1.{i % 7},0.{i % 3},"
                f"{['Iris-setosa', 'Iris-versicolor', 'Iris-virginica'][i % 3]}"
                for i in range(30)]
        (data_dir / "iris.data").write_text("\n".join(rows) + "\n\n")
        jx, jy = jf.load_iris()
        px, py = pf.load_iris()
        assert same(px, jx) and same(py, jy) and px.shape == (30, 4)

    def test_iterator(self, data_dir):
        p = list(pf.IrisDataSetIterator(batch=40, num_examples=100))
        j = list(jf.IrisDataSetIterator(batch=40, num_examples=100))
        assert [b.features.shape[0] for b in p] == [40, 40, 20]
        for a, b in zip(p, j):
            assert same(a.features, b.features) and same(a.labels, b.labels)


class TestCifar:
    def test_batch_reader_equals_jax(self, data_dir):
        raw, labels, imgs_chw = _cifar_bytes(np.random.default_rng(3), 10)
        path = data_dir / "data_batch_1.bin"
        path.write_bytes(raw)
        pi, pl = pf.read_cifar_batch(path)
        ji, jl = jf.read_cifar_batch(path)
        assert same(pi, ji) and same(pl, jl)
        assert pi.shape == (10, 32, 32, 3)
        np.testing.assert_array_equal(pi[0, :, :, 2], imgs_chw[0, 2])
        np.testing.assert_array_equal(pl, labels)

    def test_truncated_raises(self, data_dir):
        (data_dir / "t.bin").write_bytes(b"\x00" * 100)
        with pytest.raises(ValueError, match="multiple"):
            pf.read_cifar_batch(data_dir / "t.bin")

    def test_local_batches_equal_jax(self, data_dir):
        rng = np.random.default_rng(4)
        d = data_dir / "cifar-10-batches-bin"
        d.mkdir()
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            (d / name).write_bytes(_cifar_bytes(rng, 4)[0])
        for train in (True, False):
            p = pf.load_cifar10_info(train=train)
            j = jf.load_cifar10_info(train=train, download=False)
            assert p[2] == j[2] == "local"
            assert same(p[0], j[0]) and same(p[1], j[1])
        assert p[0].shape == (4, 32, 32, 3)
        px, _ = pf.load_cifar10(train=True, num_examples=7)
        assert px.shape == (7, 32, 32, 3)
        it = list(pf.CifarDataSetIterator(batch=8, num_examples=20))
        assert [b.features.shape[0] for b in it] == [8, 8, 4]

    def test_stand_in_equals_jax(self, data_dir):
        p = pf.load_cifar10_info(train=False, num_examples=50)
        j = jf.load_cifar10_info(train=False, num_examples=50,
                                 download=False)
        assert p[2] == j[2] == "synthetic"
        assert same(p[0], j[0]) and same(p[1], j[1])

    @pytest.mark.parametrize("n,seed", [(5, 7), (33, 2)])
    def test_cifar_like_equals_jax(self, n, seed):
        px, py = pf.load_cifar_like(n, seed)
        jx, jy = jf.load_cifar_like(n, seed)
        assert same(px, jx) and same(py, jy)


class TestLfwAndCurves:
    def test_local_tree_equals_jax(self, data_dir):
        rng = np.random.default_rng(8)
        for person in ["alice", "bob", "carol"]:
            d = data_dir / "lfw" / person
            d.mkdir(parents=True)
            for j in range(2):
                _write_png(d / f"{person}_{j}.png",
                           rng.integers(0, 256, (32, 32)).astype(np.uint8))
        _write_png(data_dir / "lfw" / "stray.png",
                   np.zeros((32, 32), np.uint8))
        for n in (None, 3):
            p = pf.load_lfw_info(num_examples=n, height=16, width=16)
            j = jf.load_lfw_info(num_examples=n, height=16, width=16)
            assert p[2] == j[2] == ["alice", "bob", "carol"]
            assert p[3] == j[3] == "local"
            assert same(p[0], j[0]) and same(p[1], j[1])
        assert pf.load_lfw_info(height=16, width=16)[0].shape == (6, 16, 16,
                                                                   1)

    def test_empty_tree_falls_back_as_jax(self, data_dir):
        (data_dir / "lfw").mkdir()
        p, j = pf.load_lfw_info(num_examples=8), jf.load_lfw_info(
            num_examples=8)
        assert p[3] == j[3] == "synthetic"
        assert same(p[0], j[0])

    @pytest.mark.parametrize("kw", [{"num_examples": 32},
                                    {"num_examples": 5, "height": 12,
                                     "width": 20, "seed": 3}])
    def test_stand_in_equals_jax(self, data_dir, kw):
        p, j = pf.load_lfw_info(**kw), jf.load_lfw_info(**kw)
        assert p[3] == j[3] == "synthetic" and p[2] == j[2]
        assert same(p[0], j[0]) and same(p[1], j[1])
        it = pf.LFWDataSetIterator(batch=4, num_examples=10)
        assert it.provenance == "synthetic" and len(it.label_names) == 10

    @pytest.mark.parametrize("kw", [{"n": 16}, {"n": 9, "size": 20,
                                                "seed": 4}])
    def test_curves_equal_jax(self, kw):
        px, py = pf.load_curves(**kw)
        jx, jy = jf.load_curves(**kw)
        assert same(px, jx) and same(py, jy)
        assert px.max() == 1.0 and px.min() == 0.0


class TestImages:
    def test_loader_equals_jax(self, tmp_path):
        rng = np.random.default_rng(5)
        arr = rng.integers(0, 256, (16, 12, 3)).astype(np.uint8)
        p = tmp_path / "img.png"
        _write_png(p, arr)
        for kw in ({}, {"height": 8, "width": 6, "channels": 3},
                   {"channels": 1}, {"height": 4, "width": 4, "channels": 1}):
            a = pimage.ImageLoader(**kw)
            b = jimage.ImageLoader(**kw)
            assert same(a.as_matrix(p), b.as_matrix(p))
            assert same(a.as_row_vector(p), b.as_row_vector(p))
            assert same(a.from_file(p), b.from_file(p))
        out = pimage.ImageLoader().as_matrix(p)
        np.testing.assert_array_equal(out.astype(np.uint8), arr)
        assert pimage.ImageLoader(channels=1).as_matrix(p).shape == (16, 12)

    @pytest.mark.parametrize("kind", ["uint8", "unit", "wide", "gray"])
    def test_to_image_equals_jax(self, kind):
        rng = np.random.default_rng(6)
        a = {"uint8": rng.integers(0, 256, (10, 10, 3)).astype(np.uint8),
             "unit": rng.random((6, 6)).astype(np.float32),
             "wide": rng.normal(0, 300, (5, 7)).astype(np.float32),
             "gray": rng.integers(0, 256, (4, 4, 1)).astype(np.float32)}[kind]
        assert same(np.asarray(pimage.ImageLoader.to_image(a)),
                    np.asarray(jimage.ImageLoader.to_image(a)))

    def test_record_reader_equals_jax(self, tmp_path):
        rng = np.random.default_rng(7)
        for cls in ["cat", "dog"]:
            d = tmp_path / cls
            d.mkdir()
            for j in range(3):
                _write_png(d / f"{j}.png",
                           rng.integers(0, 256, (8, 8)).astype(np.uint8))
        for kw in ({"height": 8, "width": 8, "channels": 1},
                   {"height": 4, "width": 4, "channels": 3,
                    "normalize": True},
                   {"channels": 1, "append_label": False}):
            pr = pimage.ImageRecordReader(str(tmp_path), **kw)
            jr = jimage.ImageRecordReader(str(tmp_path), **kw)
            assert pr.labels == jr.labels == ["cat", "dog"]
            assert pr.num_labels() == 2
            p, j = list(pr), list(jr)
            assert len(p) == len(j) == 6
            assert all(same(a, b) for a, b in zip(p, j))
        assert [str(x) for x in pimage.list_image_files(tmp_path)] == \
            [str(x) for x in jimage.list_image_files(tmp_path)]

    def test_record_reader_feeds_the_dataset_iterator(self, tmp_path):
        rng = np.random.default_rng(7)
        for cls in ["cat", "dog"]:
            (tmp_path / cls).mkdir()
            for j in range(3):
                _write_png(tmp_path / cls / f"{j}.png",
                           rng.integers(0, 256, (8, 8)).astype(np.uint8))
        rr = pimage.ImageRecordReader(str(tmp_path), height=8, width=8,
                                      channels=1)
        recs = list(rr)
        assert all(r.shape == (65,) for r in recs)
        assert sorted({int(r[-1]) for r in recs}) == [0, 1]
        batches = list(RecordReaderDataSetIterator(
            rr, batch_size=4, label_index=-1, num_possible_labels=2))
        assert batches[0].features.shape == (4, 64)
        assert batches[0].labels.shape == (4, 2)
        np.testing.assert_allclose(batches[0].labels.sum(axis=1), 1.0)

    def test_missing_root_has_no_labels(self, tmp_path):
        rr = pimage.ImageRecordReader(str(tmp_path / "none"))
        assert rr.labels == [] and list(rr) == []
