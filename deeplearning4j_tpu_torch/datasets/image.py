"""Image ingest: ``ImageLoader`` and ``ImageRecordReader`` (counterpart:
``deeplearning4j_tpu/datasets/image.py``).

``ImageLoader`` reads an image file to a float32 array (``as_matrix``,
``as_row_vector``), its raw pixels (``from_file``) or renders an array
(``to_image``); ``ImageRecordReader`` walks a directory, one record an
image, the parent directory's name as the label index. Decoding and
resizing run on the host through PIL, imported only inside the functions
that decode (as the JAX module does at :47, :73 and :84), so importing
this module needs no PIL. Arrays come out as float32 HWC, the port's
NHWC layout.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.records import RecordReader

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm", ".tif", ".tiff")


class ImageLoader:
    """Load image files to arrays (reference util/ImageLoader.java:42).

    height/width: resize target (None keeps native size);
    channels: 1 (grayscale) or 3 (RGB); None keeps the file's mode.
    """

    def __init__(
        self,
        height: Optional[int] = None,
        width: Optional[int] = None,
        channels: Optional[int] = None,
    ):
        self.height = height
        self.width = width
        self.channels = channels

    def _open(self, path):
        from PIL import Image

        img = Image.open(path)
        if self.channels == 1:
            img = img.convert("L")
        elif self.channels == 3:
            img = img.convert("RGB")
        elif img.mode not in ("L", "RGB"):
            img = img.convert("RGB")
        if self.height is not None and self.width is not None:
            img = img.resize((self.width, self.height))
        return img

    def as_matrix(self, path) -> np.ndarray:
        """Image as float32 array, [H,W] (grayscale) or [H,W,C]
        (reference asMatrix :82)."""
        img = self._open(path)
        arr = np.asarray(img, dtype=np.float32)
        return arr

    def as_row_vector(self, path) -> np.ndarray:
        """Flattened [1, H*W*C] float32 (reference asRowVector :58)."""
        return self.as_matrix(path).reshape(1, -1)

    def from_file(self, path) -> np.ndarray:
        """Raw uint8 pixel matrix without resize (reference fromFile :90)."""
        from PIL import Image

        img = Image.open(path)
        if img.mode not in ("L", "RGB"):
            img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    @staticmethod
    def to_image(arr: np.ndarray):
        """Array -> PIL image; float arrays outside [0,255] are
        sigmoid-squashed like the reference render path (toImage :139-156)."""
        from PIL import Image

        a = np.asarray(arr)
        if a.dtype != np.uint8:
            if a.max() > 255.0 or a.min() < 0.0:
                a = 1.0 / (1.0 + np.exp(-a)) * 255.0
            elif a.max() <= 1.0:
                a = a * 255.0
            a = a.astype(np.uint8)
        if a.ndim == 3 and a.shape[2] == 1:
            a = a[:, :, 0]
        return Image.fromarray(a)


def list_image_files(root) -> List[Path]:
    out: List[Path] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name.lower().endswith(_EXTS):
                out.append(Path(dirpath) / name)
    return out


class ImageRecordReader(RecordReader):
    """Directory-walking image reader (Canova ImageRecordReader semantics:
    each image file is one record; when append_label=True the parent
    directory name is the label, appended as a class index in the record's
    last position). Labels are discovered from subdirectory names, sorted.
    """

    def __init__(
        self,
        root: str,
        height: Optional[int] = None,
        width: Optional[int] = None,
        channels: Optional[int] = None,
        append_label: bool = True,
        normalize: bool = False,
    ):
        self.root = Path(root)
        self.loader = ImageLoader(height, width, channels)
        self.append_label = append_label
        self.normalize = normalize
        self.labels = sorted(
            d.name for d in self.root.iterdir() if d.is_dir()
        ) if self.root.is_dir() else []
        self._label_idx = {name: i for i, name in enumerate(self.labels)}

    def num_labels(self) -> int:
        return len(self.labels)

    def __iter__(self):
        for path in list_image_files(self.root):
            arr = self.loader.as_matrix(path).reshape(-1)
            if self.normalize:
                arr = arr / 255.0
            if self.append_label:
                label = self._label_idx.get(path.parent.name, -1)
                arr = np.concatenate([arr, np.asarray([label], np.float32)])
            yield arr.astype(np.float32)
