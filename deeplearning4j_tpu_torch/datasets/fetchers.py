"""MNIST for the port (counterpart: ``deeplearning4j_tpu/datasets/fetchers.py``
— ``data_dir``, ``read_idx_images`` :158, ``read_idx_labels`` :170,
``_find_mnist``, ``_synthetic_mnist`` :190, ``load_mnist_info`` :201,
``load_mnist`` and ``MnistDataSetIterator`` :249).

The idx files are read where they already lie: under
``DL4J_TPU_DATA_DIR`` (``MNIST/`` or the directory itself, plain or
``.gz``), the JAX default being ``~/.deeplearning4j_tpu``. The port
downloads nothing; without the files it uses the JAX package's seeded
stand-in (ten class templates plus noise, from numpy's ``default_rng``,
so bit-equal to the JAX package's), and says so in the provenance
(``"local"`` or ``"synthetic"``). CIFAR-10, Iris and the downloads wait
for a later slice.
"""

from __future__ import annotations

import gzip
import logging
import struct
from pathlib import Path
from typing import Optional, Tuple

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
