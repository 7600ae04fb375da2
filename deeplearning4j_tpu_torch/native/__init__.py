"""ctypes binding of the repo's host IO library (counterpart:
``deeplearning4j_tpu/native/__init__.py`` — ``native_available`` :134,
``read_idx`` :143, ``read_csv`` :180, ``shuffle_indices`` :203,
``NativePrefetchIterator`` :236, ``read_npz`` :332, ``iter_npz`` :353).

The library is ``native/src/dl4j_tpu_native.cpp``, unchanged: idx and CSV
parsing, a splitmix64 Fisher-Yates shuffle, a threaded minibatch
prefetch ring over in-memory arrays, and an npz reader with a prefetch
thread. At first use it is compiled with ``g++ -O3 -fPIC -shared
-std=c++17 -include string ... -lpthread`` into ``build/native/`` under
the checkout,
as ``libdl4j_tpu_native-<digest>.so`` (the digest covers the source and
the flags, so an edited source rebuilds). A failed build or load raises:
unlike the JAX binding, nothing here falls back to Python when the
library is missing.

The plain numpy versions beside the library calls (``_read_idx_py``,
``_read_csv_py``, ``_shuffle_py``, ``_iter_py``, ``_read_npz_py``) are the
oracle the tests hold the library to; nothing calls them but by name.
The one per-file fallback kept is the JAX binding's for an npz the
library's parser declines (a compressed or ZIP64 member), which
``np.load`` reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "src" / "dl4j_tpu_native.cpp"
BUILD_DIR = REPO / "build" / "native"
# the source uses std::string without including <string>; older
# libstdc++ headers pulled it in through <vector> or <thread>, GCC 13's do
# not, so the build includes it ahead of the source (which stays as it is)
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-shared", "-std=c++17",
             "-include", "string")
LINK_FLAGS = ("-lpthread",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(b"\0" + " ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libdl4j_tpu_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is up to date; raises on failure.
    The compiler writes a temporary name in ``build/native/`` that one
    rename makes the library, so a concurrent build never maps a torn
    file."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native library build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native library build failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    lib.dl4j_read_idx.restype = ctypes.c_int
    lib.dl4j_read_idx.argtypes = [
        ctypes.c_char_p, ctypes.c_int, P(ctypes.c_int), P(ctypes.c_int64),
        P(P(ctypes.c_float))]
    lib.dl4j_free.argtypes = [ctypes.c_void_p]
    lib.dl4j_csv_read.restype = ctypes.c_int
    lib.dl4j_csv_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char, P(ctypes.c_int64),
        P(ctypes.c_int64), P(P(ctypes.c_float))]
    lib.dl4j_shuffle_indices.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, P(ctypes.c_int64)]
    lib.dl4j_prefetch_start.restype = ctypes.c_void_p
    lib.dl4j_prefetch_start.argtypes = [
        P(ctypes.c_float), P(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int]
    lib.dl4j_prefetch_next.restype = ctypes.c_int
    lib.dl4j_prefetch_next.argtypes = [
        ctypes.c_void_p, P(ctypes.c_float), P(ctypes.c_float)]
    lib.dl4j_prefetch_stop.argtypes = [ctypes.c_void_p]
    lib.dl4j_npz_open.restype = ctypes.c_void_p
    lib.dl4j_npz_open.argtypes = [ctypes.c_char_p]
    lib.dl4j_npz_count.restype = ctypes.c_int
    lib.dl4j_npz_count.argtypes = [ctypes.c_void_p]
    lib.dl4j_npz_member_info.restype = ctypes.c_int
    lib.dl4j_npz_member_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        P(ctypes.c_int), P(ctypes.c_int), P(ctypes.c_int64)]
    lib.dl4j_npz_member_data.restype = ctypes.c_int
    lib.dl4j_npz_member_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.dl4j_npz_close.argtypes = [ctypes.c_void_p]
    lib.dl4j_npz_prefetch_open.restype = ctypes.c_void_p
    lib.dl4j_npz_prefetch_open.argtypes = [
        P(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    lib.dl4j_npz_prefetch_next.restype = ctypes.c_int
    lib.dl4j_npz_prefetch_next.argtypes = [
        ctypes.c_void_p, P(ctypes.c_void_p)]
    lib.dl4j_npz_prefetch_close.argtypes = [ctypes.c_void_p]


def _load() -> ctypes.CDLL:
    """The library, built and bound at first use; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def loaded_path() -> Optional[str]:
    """The file of the loaded library, or None before first use."""
    return None if _lib is None else _lib._name


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# idx / CSV / shuffle
# ---------------------------------------------------------------------------


def read_idx(path: str, normalize: bool = True) -> np.ndarray:
    """An MNIST idx file as float32 (ubyte data / 255 when
    ``normalize``)."""
    lib = _load()
    ndim = ctypes.c_int()
    dims = (ctypes.c_int64 * 4)()
    data = ctypes.POINTER(ctypes.c_float)()
    rc = lib.dl4j_read_idx(os.fspath(path).encode(), int(normalize),
                           ctypes.byref(ndim), dims, ctypes.byref(data))
    if rc != 0:
        raise IOError(f"dl4j_read_idx({path}) failed: {rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape))
    out = np.ctypeslib.as_array(data, shape=(n,)).astype(
        np.float32).reshape(shape)
    lib.dl4j_free(data)
    return out


def _read_idx_py(path: str, normalize: bool) -> np.ndarray:
    """The library's parse in numpy; ubyte data scales by the float32
    ``1/255`` as the library does (the JAX binding's Python fallback
    divides by 255, which can differ in the last bit)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        dtype, ndim = magic[2], magic[3]
        shape = tuple(int.from_bytes(f.read(4), "big") for _ in range(ndim))
        if dtype == 0x08:
            arr = np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)
            out = arr.astype(np.float32)
            return (out * (np.float32(1.0) / np.float32(255.0))
                    if normalize else out)
        if dtype == 0x0D:
            return np.frombuffer(f.read(), dtype=">f4").reshape(
                shape).astype(np.float32)
    raise IOError(f"unsupported idx dtype {dtype:#x}")


def read_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """A numeric CSV as float32 [rows, cols]."""
    lib = _load()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    data = ctypes.POINTER(ctypes.c_float)()
    rc = lib.dl4j_csv_read(os.fspath(path).encode(),
                           delimiter.encode()[0:1], ctypes.byref(rows),
                           ctypes.byref(cols), ctypes.byref(data))
    if rc != 0:
        raise IOError(f"dl4j_csv_read({path}) failed: {rc}")
    if rows.value == 0:
        return np.zeros((0, 0), np.float32)
    n = rows.value * cols.value
    out = np.ctypeslib.as_array(data, shape=(n,)).astype(
        np.float32).reshape(rows.value, cols.value)
    lib.dl4j_free(data)
    return out


def _read_csv_py(path: str, delimiter: str = ",") -> np.ndarray:
    return np.loadtxt(path, delimiter=delimiter, ndmin=2).astype(np.float32)


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """A deterministic splitmix64 Fisher-Yates permutation of range(n)."""
    lib = _load()
    out = np.empty((n,), np.int64)
    lib.dl4j_shuffle_indices(
        n, seed & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def _splitmix64(state: int) -> Tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return state, z ^ (z >> 31)


def _shuffle_py(n: int, seed: int) -> np.ndarray:
    """The library's splitmix64 Fisher-Yates, bit for bit."""
    out = np.arange(n, dtype=np.int64)
    state = seed & 0xFFFFFFFFFFFFFFFF
    for i in range(n - 1, 0, -1):
        state, r = _splitmix64(state)
        j = r % (i + 1)
        out[i], out[j] = out[j], out[i]
    return out


class NativePrefetchIterator:
    """Minibatches of in-memory arrays, shuffled per epoch and gathered by
    the library's producer thread into a ring of ``capacity`` batches (the
    AsyncDataSetIterator role with assembly in native code). A trailing
    short batch is dropped."""

    def __init__(self, features: np.ndarray, labels: np.ndarray, batch: int,
                 epochs: int = 1, seed: int = 0, capacity: int = 4):
        self.features = np.ascontiguousarray(features, np.float32)
        self.labels = np.ascontiguousarray(labels, np.float32)
        self.batch = int(batch)
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.capacity = int(capacity)
        self._f_len = int(np.prod(self.features.shape[1:]))
        self._l_len = int(np.prod(self.labels.shape[1:]))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        lib = _load()
        f2 = self.features.reshape(len(self.features), self._f_len)
        l2 = self.labels.reshape(len(self.labels), self._l_len)
        handle = lib.dl4j_prefetch_start(
            f2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            l2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(f2), self._f_len, self._l_len, self.batch,
            self.epochs, self.seed & 0xFFFFFFFFFFFFFFFF, self.capacity)
        if not handle:
            raise RuntimeError(
                f"dl4j_prefetch_start refused {len(f2)} rows in batches "
                f"of {self.batch}")
        try:
            fshape = (self.batch,) + self.features.shape[1:]
            lshape = (self.batch,) + self.labels.shape[1:]
            while True:
                fb = np.empty((self.batch, self._f_len), np.float32)
                lb = np.empty((self.batch, self._l_len), np.float32)
                ok = lib.dl4j_prefetch_next(
                    handle,
                    fb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    lb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if not ok:
                    break
                yield fb.reshape(fshape), lb.reshape(lshape)
        finally:
            # stops and joins the producer thread, also when the consumer
            # leaves mid-pass (the generator is closed)
            lib.dl4j_prefetch_stop(handle)


def _iter_py(it: NativePrefetchIterator):
    """What ``NativePrefetchIterator`` yields, in numpy: the same
    splitmix64 chain of per-epoch shuffles."""
    state = it.seed & 0xFFFFFFFFFFFFFFFF
    for _ in range(it.epochs):
        state, derived = _splitmix64(state)
        idx = _shuffle_py(len(it.features), derived)
        for b in range(0, len(it.features) - it.batch + 1, it.batch):
            sel = idx[b:b + it.batch]
            yield it.features[sel], it.labels[sel]


# ---------------------------------------------------------------------------
# npz
# ---------------------------------------------------------------------------

_NPZ_DTYPES = {0: np.dtype("<f4"), 1: np.dtype("<f8"), 2: np.dtype("<i4"),
               3: np.dtype("<i8"), 4: np.dtype(np.bool_)}


def _npz_handle_to_dict(lib, handle) -> Optional[dict]:
    """Every member of an open npz handle as numpy arrays; None when the
    parser declines one."""
    n = lib.dl4j_npz_count(handle)
    if n < 0:
        return None
    out = {}
    for i in range(n):
        name = ctypes.create_string_buffer(512)
        dt = ctypes.c_int()
        nd = ctypes.c_int()
        dims = (ctypes.c_int64 * 8)()
        if lib.dl4j_npz_member_info(handle, i, name, 512, ctypes.byref(dt),
                                    ctypes.byref(nd), dims) != 0:
            return None
        shape = tuple(dims[j] for j in range(nd.value))
        arr = np.empty(shape, _NPZ_DTYPES[dt.value])
        if lib.dl4j_npz_member_data(
                handle, i, arr.ctypes.data_as(ctypes.c_void_p)) != 0:
            return None
        out[name.value.decode()] = arr
    return out


def _read_npz_py(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def read_npz(path: str) -> dict:
    """A numpy .npz as {name: array}, parsed by the library (an npz it
    declines, compressed or ZIP64, by ``np.load``, as the JAX binding
    does)."""
    path = os.fspath(path)
    lib = _load()
    handle = lib.dl4j_npz_open(path.encode())
    if handle:
        try:
            out = _npz_handle_to_dict(lib, handle)
        finally:
            lib.dl4j_npz_close(handle)
        if out is not None:
            return out
    return _read_npz_py(path)


def iter_npz(paths, capacity: int = 4) -> Iterator[dict]:
    """{name: array} for each of ``paths`` in order, the library's thread
    parsing ``capacity`` files ahead."""
    paths = [os.fspath(p) for p in paths]
    if not paths:
        return
    lib = _load()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.dl4j_npz_prefetch_open(arr, len(paths), capacity)
    if not handle:
        raise RuntimeError("dl4j_npz_prefetch_open failed")
    try:
        while True:
            nh = ctypes.c_void_p()
            idx = lib.dl4j_npz_prefetch_next(handle, ctypes.byref(nh))
            if idx < 0:
                break
            out = None
            if nh.value:
                try:
                    out = _npz_handle_to_dict(lib, nh)
                finally:
                    lib.dl4j_npz_close(nh)
            if out is None:  # the parser declined this file
                out = _read_npz_py(paths[idx])
            yield out
    finally:
        lib.dl4j_npz_prefetch_close(handle)
