"""Checkpoint reading (counterpart:
``deeplearning4j_tpu/utils/serialization.py`` — ``read_flagship_zip``
:197, the zip half of ``restore_multi_layer_network`` :300 and the npz
half of ``_npz_bytes_into_tree``).

The JAX package writes a ModelSerializer-layout zip: ``configuration.json``,
``coefficients.npz``, ``metadata.json`` and, as the model has them,
``state.npz`` and ``updater.npz``. Each npz key is the leaf's pytree path
as ``jax.tree_util.keystr`` prints it: dict keys as ``['name']`` and list
indices as ``[0]``, e.g. ``['blocks']['Wq']`` for the TransformerLM and
``[0]['W']`` for layer 0 of a MultiLayerNetwork. This module reads those
keys back into nested dicts of numpy arrays without JAX (a list index
becomes an int key). The writers and the ComputationGraph zip wait for
later slices.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

_KEY_PART = re.compile(r"\[(\d+)\]|\['((?:[^'\\]|\\.)*)'\]")


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


def read_multi_layer_zip(path: str) -> Tuple[str, bytes, Optional[bytes],
                                              Dict[str, Any]]:
    """(configuration_json, coefficients_bytes, state_bytes_or_None,
    metadata) of a MultiLayerNetwork zip. A checkpoint of another model
    class is refused loudly (a zip with no recorded class is taken as a
    MultiLayerNetwork, as the JAX package's restore does)."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json").decode())
        got = meta.get("model_class")
        if got not in (None, "MultiLayerNetwork"):
            raise ValueError(
                f"checkpoint holds {got!r}, not MultiLayerNetwork")
        conf = z.read("configuration.json").decode()
        coeff = z.read("coefficients.npz")
        state = (z.read("state.npz")
                 if "state.npz" in z.namelist() else None)
    return conf, coeff, state, meta


def keystr_path(key: str) -> Tuple[Union[int, str], ...]:
    """``"['blocks']['Wq']"`` -> ``('blocks', 'Wq')`` and ``"[0]['W']"``
    -> ``(0, 'W')``. A part that is neither ``[int]`` nor ``['name']`` is
    refused."""
    matches = list(_KEY_PART.finditer(key))
    if not matches or "".join(m.group(0) for m in matches) != key:
        raise ValueError(f"unsupported npz key {key!r}: expected a path "
                         "of [index] and ['name'] parts")
    return tuple(int(m.group(1)) if m.group(1) is not None else m.group(2)
                 for m in matches)


def npz_bytes_to_tree(data: bytes) -> Dict[Union[int, str], Any]:
    """Nested dict of numpy arrays from an npz written by the JAX
    package's ``_tree_to_npz_bytes``; a list index is an int key."""
    tree: Dict[Union[int, str], Any] = {}
    with np.load(io.BytesIO(data)) as npz:
        for key in npz.files:
            path = keystr_path(key)
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = npz[key]
    return tree
