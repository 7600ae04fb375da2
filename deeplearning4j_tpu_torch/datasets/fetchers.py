"""Local datasets for the port (counterpart:
``deeplearning4j_tpu/datasets/fetchers.py`` — ``data_dir``,
``read_idx_images`` :158, ``read_idx_labels`` :170, ``_find_mnist``,
``_synthetic_mnist`` :190, ``load_mnist_info`` :201, ``load_mnist`` and
``MnistDataSetIterator`` :249; ``load_iris`` :268 and
``IrisDataSetIterator``; ``read_cifar_batch`` :307, ``load_cifar10_info``
:328, ``load_cifar10`` and ``CifarDataSetIterator``; ``load_cifar_like``
:384; ``load_lfw_info`` :398 and ``LFWDataSetIterator``; ``load_curves``
:475).

Files are read where they already lie, under ``DL4J_TPU_DATA_DIR`` (the
JAX default being ``~/.deeplearning4j_tpu``): MNIST's idx files
(``MNIST/`` or the directory itself, plain or ``.gz``), ``iris.data``,
``cifar-10-batches-bin/`` and an extracted ``lfw/`` tree of per-person
image directories. The port downloads nothing (JAX's ``_download`` :81,
``fetch_mnist`` :104 and ``fetch_cifar10`` :123 are not ported) and looks
nowhere but the data directory. Without the files each loader uses the
JAX package's seeded stand-in, drawn from numpy's ``default_rng`` in the
same order, so bit-equal to the JAX package's, and the ``_info`` loaders
say so in the provenance (``"local"`` or ``"synthetic"``).
"""

from __future__ import annotations

import gzip
import logging
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.ops import env as envknob

logger = logging.getLogger("deeplearning4j_tpu_torch")


def data_dir() -> Path:
    return Path(envknob.raw("DL4J_TPU_DATA_DIR")
                or Path.home() / ".deeplearning4j_tpu")


def _open_maybe_gz(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx_images(path: Path) -> np.ndarray:
    with _open_maybe_gz(Path(path)) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: Path) -> np.ndarray:
    with _open_maybe_gz(Path(path)) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def _find_mnist(train: bool) -> Optional[Tuple[Path, Path]]:
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lbl = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for d in (data_dir() / "MNIST", data_dir()):
        for suffix in ("", ".gz"):
            ip, lp = d / (img + suffix), d / (lbl + suffix)
            if ip.exists() and lp.exists():
                return ip, lp
    return None


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The deterministic MNIST stand-in: 10 class templates + noise,
    28x28 uint8 images and uint8 labels."""
    rng = np.random.default_rng(seed)
    templates = rng.random((10, 28, 28)) > 0.8
    labels = rng.integers(0, 10, size=n)
    imgs = templates[labels].astype(np.float32)
    noise = rng.random((n, 28, 28)) < 0.05
    imgs = np.clip(imgs + noise.astype(np.float32), 0, 1) * 255.0
    return imgs.astype(np.uint8).reshape(n, 28, 28), labels.astype(np.uint8)


def load_mnist_info(train: bool = True, num_examples: Optional[int] = None,
                    binarize: bool = False, seed: int = 123
                    ) -> Tuple[np.ndarray, np.ndarray, str]:
    """(images [N, 28, 28, 1] f32 in [0, 1], one-hot labels [N, 10] f32,
    provenance "local" or "synthetic"). ``binarize`` thresholds at 0.5."""
    found = _find_mnist(train)
    if found is not None:
        imgs = read_idx_images(found[0])
        lbls = read_idx_labels(found[1])
        provenance = "local"
    else:
        logger.warning(
            "MNIST idx files not found under %s: using the deterministic "
            "SYNTHETIC stand-in (shapes and dtypes identical)", data_dir())
        imgs, lbls = _synthetic_mnist(60000 if train else 10000, seed)
        provenance = "synthetic"
    if num_examples is not None:
        imgs, lbls = imgs[:num_examples], lbls[:num_examples]
    x = imgs.astype(np.float32) / 255.0
    if binarize:
        x = (x > 0.5).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[lbls.astype(np.int64)]
    return x.reshape(-1, 28, 28, 1), y, provenance


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               binarize: bool = False, seed: int = 123
               ) -> Tuple[np.ndarray, np.ndarray]:
    x, y, _ = load_mnist_info(train, num_examples, binarize, seed)
    return x, y


class MnistDataSetIterator(ListDataSetIterator):
    """Minibatches of MNIST (or its stand-in); ``flatten`` gives
    [N, 784] rows for the dense stacks."""

    def __init__(self, batch: int, num_examples: int, train: bool = True,
                 binarize: bool = False, seed: int = 123,
                 flatten: bool = False):
        x, y = load_mnist(train, num_examples, binarize, seed)
        if flatten:
            x = x.reshape(x.shape[0], -1)
        super().__init__(x, y, batch)


# ---------------------------------------------------------------------------
# Iris: a local iris.data, or three separable seeded 4-d gaussian clusters
# of 50 each
# ---------------------------------------------------------------------------


def load_iris(seed: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    path = data_dir() / "iris.data"
    if path.exists():
        rows = []
        names = {"Iris-setosa": 0, "Iris-versicolor": 1, "Iris-virginica": 2}
        for line in path.read_text().strip().splitlines():
            parts = line.strip().split(",")
            if len(parts) == 5:
                rows.append([float(v) for v in parts[:4]] + [names[parts[4]]])
        arr = np.asarray(rows, dtype=np.float32)
        x, yi = arr[:, :4], arr[:, 4].astype(np.int64)
    else:
        rng = np.random.default_rng(seed)
        means = np.array(
            [[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]],
            dtype=np.float32,
        )
        x = np.concatenate(
            [m + 0.3 * rng.standard_normal((50, 4)).astype(np.float32)
             for m in means])
        yi = np.repeat(np.arange(3), 50)
    y = np.eye(3, dtype=np.float32)[yi]
    perm = np.random.default_rng(seed).permutation(len(x))
    return x[perm], y[perm]


class IrisDataSetIterator(ListDataSetIterator):
    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 6):
        x, y = load_iris(seed)
        super().__init__(x[:num_examples], y[:num_examples], batch)


# ---------------------------------------------------------------------------
# CIFAR-10 binary batches
# ---------------------------------------------------------------------------

_CIFAR_RECORD = 1 + 3 * 32 * 32  # label byte + CHW uint8 pixels


def read_cifar_batch(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 binary batch file: records of [label u8, 3072 u8
    pixels CHW]. Returns (images [N, 32, 32, 3] uint8 HWC, labels [N])."""
    raw = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    if raw.size % _CIFAR_RECORD != 0:
        raise ValueError(
            f"{path}: size {raw.size} is not a multiple of {_CIFAR_RECORD}")
    rec = raw.reshape(-1, _CIFAR_RECORD)
    labels = rec[:, 0].copy()
    imgs = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()
    return imgs, labels


def _find_cifar10() -> Optional[Path]:
    d = data_dir() / "cifar-10-batches-bin"
    return d if (d / "test_batch.bin").exists() else None


def load_cifar10_info(train: bool = True, num_examples: Optional[int] = None,
                      seed: int = 7) -> Tuple[np.ndarray, np.ndarray, str]:
    """(images [N, 32, 32, 3] float32 in [0, 1], one-hot labels [N, 10],
    provenance) from the local binary batches, or the seeded stand-in."""
    provenance = "local"
    d = _find_cifar10()
    if d is not None:
        files = ([d / f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else [d / "test_batch.bin"])
        parts = [read_cifar_batch(f) for f in files]
        imgs = np.concatenate([p[0] for p in parts])
        lbls = np.concatenate([p[1] for p in parts])
    else:
        logger.warning("CIFAR-10 binary batches not found under %s — using "
                       "the SYNTHETIC stand-in", data_dir())
        provenance = "synthetic"
        rng = np.random.default_rng(seed)
        n = 50000 if train else 10000
        imgs = (rng.random((n, 32, 32, 3)) * 255).astype(np.uint8)
        lbls = rng.integers(0, 10, size=n).astype(np.uint8)
    if num_examples is not None:
        imgs = imgs[:num_examples]
        lbls = lbls[:num_examples]
    x = imgs.astype(np.float32) / 255.0
    y = np.eye(10, dtype=np.float32)[lbls.astype(np.int64)]
    return x, y, provenance


def load_cifar10(train: bool = True, num_examples: Optional[int] = None,
                 seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    x, y, _ = load_cifar10_info(train, num_examples, seed)
    return x, y


class CifarDataSetIterator(ListDataSetIterator):
    def __init__(self, batch: int, num_examples: int, train: bool = True,
                 seed: int = 7):
        x, y = load_cifar10(train, num_examples, seed)
        super().__init__(x, y, batch)


def load_cifar_like(n: int, seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded CIFAR-shaped data, whatever lies on disk."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 32, 32, 3)).astype(np.float32)
    yi = rng.integers(0, 10, size=n)
    return x, np.eye(10, dtype=np.float32)[yi]


# ---------------------------------------------------------------------------
# LFW: an extracted lfw/ tree, or seeded smooth "face" templates
# ---------------------------------------------------------------------------


def load_lfw_info(num_examples: Optional[int] = None, height: int = 28,
                  width: int = 28, seed: int = 11
                  ) -> Tuple[np.ndarray, np.ndarray, List[str], str]:
    """Labeled Faces in the Wild from ``<data_dir>/lfw`` (person-name
    subdirectories of images, read through ``ImageRecordReader``), or a
    seeded stand-in. Returns (images [N, H, W, 1] float32 in [0, 1],
    one-hot labels, label names, provenance)."""
    from deeplearning4j_tpu_torch.datasets.image import ImageRecordReader

    d = data_dir() / "lfw"
    if d.is_dir():
        rr = ImageRecordReader(str(d), height=height, width=width,
                               channels=1, normalize=True)
        feats, labels = [], []
        if rr.num_labels() == 0:
            logger.warning("lfw dir %s has no class subdirectories; "
                           "skipping", d)
        else:
            for rec in rr:
                label = int(rec[-1])
                if label < 0:  # a file outside a class subdirectory
                    continue
                feats.append(rec[:-1])
                labels.append(label)
                if num_examples is not None and len(feats) >= num_examples:
                    break
            if not feats:
                logger.warning("lfw dir %s contains no readable images; "
                               "skipping", d)
        if feats:
            x = np.stack(feats).reshape(-1, height, width, 1)
            y = np.eye(rr.num_labels(), dtype=np.float32)[np.asarray(labels)]
            return x, y, rr.labels, "local"
    rng = np.random.default_rng(seed)
    n = num_examples or 1000
    n_cls = 10
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    templates = np.stack([
        0.5 + 0.5 * np.sin(yy / height * (2 + c) * np.pi)
        * np.cos(xx / width * (1 + c % 3) * np.pi)
        for c in range(n_cls)])
    labels = rng.integers(0, n_cls, size=n)
    x = templates[labels] + 0.1 * rng.standard_normal(
        (n, height, width)).astype(np.float32)
    x = np.clip(x, 0, 1).astype(np.float32).reshape(n, height, width, 1)
    y = np.eye(n_cls, dtype=np.float32)[labels]
    return x, y, [f"person_{i}" for i in range(n_cls)], "synthetic"


class LFWDataSetIterator(ListDataSetIterator):
    def __init__(self, batch: int, num_examples: int, height: int = 28,
                 width: int = 28):
        x, y, self.label_names, self.provenance = load_lfw_info(
            num_examples, height, width)
        super().__init__(x[:num_examples], y[:num_examples], batch)


# ---------------------------------------------------------------------------
# Curves: seeded images of random cubic Bezier curves (autoencoder data)
# ---------------------------------------------------------------------------


def load_curves(n: int = 2000, size: int = 28, seed: int = 17
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Images of random smooth parametric curves, regenerated from the
    seed; unsupervised, so labels == features. Returns (x [N, size*size]
    float32 in [0, 1], x)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, 64, dtype=np.float32)
    imgs = np.zeros((n, size, size), np.float32)
    for i in range(n):
        p = rng.random((4, 2)).astype(np.float32) * (size - 1)
        b = ((1 - t)[:, None] ** 3 * p[0]
             + 3 * ((1 - t) ** 2 * t)[:, None] * p[1]
             + 3 * ((1 - t) * t ** 2)[:, None] * p[2]
             + t[:, None] ** 3 * p[3])
        xi = np.clip(b[:, 0].round().astype(int), 0, size - 1)
        yi = np.clip(b[:, 1].round().astype(int), 0, size - 1)
        imgs[i, yi, xi] = 1.0
    x = imgs.reshape(n, size * size)
    return x, x
