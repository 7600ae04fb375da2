"""Checkpoint reading (counterpart:
``deeplearning4j_tpu/utils/serialization.py`` — ``read_flagship_zip``
:197 and the npz half of ``_npz_bytes_into_tree``).

The JAX package writes a ModelSerializer-layout zip: ``configuration.json``,
``coefficients.npz``, ``updater.npz`` and ``metadata.json``. Each npz key is
the leaf's pytree path as ``jax.tree_util.keystr`` prints it, e.g.
``['blocks']['Wq']``. This module reads those keys back into a nested dict
of numpy arrays without JAX. The writers and the MultiLayerNetwork /
ComputationGraph zips wait for later slices.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

_KEY_PART = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def read_flagship_zip(path: str, expected_class: str
                      ) -> Tuple[Dict[str, Any], bytes, Optional[bytes],
                                 Dict[str, Any]]:
    """(cfg_dict, coefficients_bytes, updater_bytes_or_None, metadata).
    A checkpoint of another model class is refused loudly."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json").decode())
        got = meta.get("model_class")
        if got != expected_class:
            raise ValueError(
                f"checkpoint holds {got!r}, not {expected_class}")
        cfg = json.loads(z.read("configuration.json").decode())
        coeff = z.read("coefficients.npz")
        upd = (z.read("updater.npz")
               if "updater.npz" in z.namelist() else None)
    return cfg, coeff, upd, meta


def keystr_path(key: str) -> Tuple[str, ...]:
    """``"['blocks']['Wq']"`` -> ``('blocks', 'Wq')``. Only dict keys
    occur in the flagship trees; anything else is refused."""
    parts = _KEY_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"unsupported npz key {key!r}: expected "
                         "['name']['name']... dict paths")
    return tuple(parts)


def npz_bytes_to_tree(data: bytes) -> Dict[str, Any]:
    """Nested dict of numpy arrays from an npz written by the JAX
    package's ``_tree_to_npz_bytes``."""
    tree: Dict[str, Any] = {}
    with np.load(io.BytesIO(data)) as npz:
        for key in npz.files:
            path = keystr_path(key)
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = npz[key]
    return tree
