"""The port's binding of the host IO library
(``deeplearning4j_tpu_torch/native``): the port builds
``native/src/dl4j_tpu_native.cpp`` into ``build/native/`` itself, a failed
build raises, and every entry point (idx, CSV, the shuffle, the prefetch
ring, npz) equals both the JAX package's binding and the port's plain
numpy versions, byte for byte."""

import os
import zipfile

import numpy as np
import pytest

pytest.importorskip("jax")

from deeplearning4j_tpu import native as jnat  # noqa: E402

from deeplearning4j_tpu_torch import native as pnat  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _idx(path, arr, code):
    with open(path, "wb") as f:
        f.write(bytes([0, 0, code, arr.ndim]))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(arr.astype(">f4" if code == 0x0D else np.uint8).tobytes())


def _eq(*arrays):
    a = arrays[0]
    for b in arrays[1:]:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_the_port_builds_its_own_library_under_build():
    assert pnat.native_available()
    path = pnat.loaded_path()
    assert path is not None
    assert os.path.realpath(path).startswith(
        os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.realpath(path) != os.path.realpath(jnat._LIB_PATH)
    assert pnat.library_path().name.startswith("libdl4j_tpu_native-")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnat, "SOURCE", bad)
    monkeypatch.setattr(pnat, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="native library build failed"):
        pnat.build()
    assert not any((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("normalize", [True, False])
def test_read_idx(tmp_path, normalize):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 5, 4))
    lab = rng.integers(0, 10, 17)
    flt = rng.standard_normal((3, 6)).astype(np.float32)
    for name, arr, code in (("img", img, 0x08), ("lab", lab, 0x08),
                            ("flt", flt, 0x0D)):
        p = str(tmp_path / name)
        _idx(p, arr, code)
        _eq(pnat.read_idx(p, normalize), jnat.read_idx(p, normalize),
            pnat._read_idx_py(p, normalize))
    with pytest.raises(IOError):
        pnat.read_idx(str(tmp_path / "missing"))


def test_read_csv(tmp_path):
    rng = np.random.default_rng(1)
    arr = np.round(rng.standard_normal((9, 4)), 4)
    p = str(tmp_path / "a.csv")
    np.savetxt(p, arr, delimiter=",", fmt="%.4f")
    q = str(tmp_path / "b.tsv")
    np.savetxt(q, arr, delimiter=";", fmt="%.4f")
    _eq(pnat.read_csv(p), jnat.read_csv(p), pnat._read_csv_py(p))
    _eq(pnat.read_csv(q, ";"), jnat.read_csv(q, ";"),
        pnat._read_csv_py(q, ";"))


@pytest.mark.parametrize("n,seed", [(1, 0), (10, 3), (257, 2**63 + 5),
                                    (1000, -7)])
def test_shuffle_indices(n, seed):
    _eq(pnat.shuffle_indices(n, seed), jnat.shuffle_indices(n, seed),
        pnat._shuffle_py(n, seed))


@pytest.mark.parametrize("epochs,batch,capacity", [(1, 7, 4), (3, 5, 1)])
def test_prefetch_ring(epochs, batch, capacity):
    rng = np.random.default_rng(2)
    f = rng.standard_normal((38, 2, 3)).astype(np.float32)
    y = rng.standard_normal((38, 4)).astype(np.float32)
    p = pnat.NativePrefetchIterator(f, y, batch, epochs, seed=11,
                                    capacity=capacity)
    j = jnat.NativePrefetchIterator(f, y, batch, epochs, seed=11,
                                    capacity=capacity)
    got, want, plain = list(p), list(j), list(pnat._iter_py(p))
    assert len(got) == len(want) == len(plain) == epochs * (38 // batch)
    for (a, b), (c, d), (e, g) in zip(got, want, plain):
        _eq(a, c, e)
        _eq(b, d, g)


def test_prefetch_ring_stops_when_left_mid_pass():
    f = np.zeros((400, 3), np.float32)
    it = iter(pnat.NativePrefetchIterator(f, f, 4, epochs=50, capacity=2))
    next(it)
    it.close()  # stops and joins the library's producer thread


def test_npz_reader_and_prefetch(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for k in range(4):
        p = str(tmp_path / f"part{k}.npz")
        np.savez(p, features=rng.standard_normal((5, 3)).astype(np.float32),
                 labels=rng.integers(0, 9, 5).astype(np.int64),
                 w=rng.standard_normal(2), i32=np.arange(3, dtype=np.int32),
                 m=rng.random(4) > 0.5)
        paths.append(p)
    comp = str(tmp_path / "comp.npz")
    np.savez_compressed(comp, a=np.arange(6.0))
    with zipfile.ZipFile(comp) as z:
        assert z.infolist()[0].compress_type == zipfile.ZIP_DEFLATED
    paths.append(comp)
    for p in paths:
        got, want, plain = (pnat.read_npz(p), jnat.read_npz(p),
                            pnat._read_npz_py(p))
        assert set(got) == set(want) == set(plain)
        for k in got:
            _eq(got[k], want[k], plain[k])
    streamed = list(pnat.iter_npz(paths, capacity=2))
    ref = list(jnat.iter_npz(paths, capacity=2))
    assert len(streamed) == len(ref) == len(paths)
    for a, b in zip(streamed, ref):
        assert set(a) == set(b)
        for k in a:
            _eq(a[k], b[k])
    assert list(pnat.iter_npz([])) == []
