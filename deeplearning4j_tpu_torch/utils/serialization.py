"""Checkpoints (counterpart: ``deeplearning4j_tpu/utils/serialization.py``
— ``write_model_parts`` :60 and ``_tree_to_npz_bytes`` :149 for
MultiLayerNetwork zips, ``write_flagship_zip`` :175 and
``read_flagship_zip`` :197 for the TransformerLM, the zip half of
``restore_multi_layer_network`` :300 and ``restore_computation_graph``
:326-345, ``ModelSerializer.restore``'s dispatch on ``model_class``
:382-411, the npz half of
``_npz_bytes_into_tree``, and the optional sections of
``write_model_parts`` :60-98 with their readers ``read_normalizer`` and
``read_quant`` :110-147, ``_jsonable_training_state`` :51,
``write_model_parts`` :60, ``read_training_state`` :101, and
``ModelSerializer`` with ``load_into`` :260,
``restore_multi_layer_network`` :300 and ``restore_computation_graph``
:326).

The JAX package writes a ModelSerializer-layout zip: ``configuration.json``,
``coefficients.npz``, ``metadata.json`` and, as the model has them,
``state.npz`` and ``updater.npz``. Each npz key is the leaf's pytree path
as ``jax.tree_util.keystr`` prints it: dict keys as ``['name']`` and list
indices as ``[0]``, e.g. ``['blocks']['Wq']`` for the TransformerLM and
``[0]['W']`` for layer 0 of a MultiLayerNetwork. This module reads those
keys back into nested dicts of numpy arrays without JAX (a list index
becomes an int key), and :func:`write_model` writes a MultiLayerNetwork
zip with the same keys, which the JAX package's
``ModelSerializer.restore_multi_layer_network`` reads: the configuration,
``coefficients.npz``, ``state.npz``, ``updater.npz`` (the updater state
in the JAX layout), ``training_state.json`` with the iteration and, when
given, ``normalizer.json`` (a fitted ``etl/normalize`` normalizer) and
``quant.json`` (an ``etl/calibrate.QuantSpec``), under the JAX entry
names, so serving applies the statistics the model was trained under;
:func:`write_flagship_zip` writes a TransformerLM zip (configuration,
coefficients, updater) that the JAX package's ``TransformerLM.load``
reads. A ComputationGraph's zip is the same layout keyed by vertex name
(``['name']['W']``), with the input shapes as a dict in the metadata.
:func:`restore` reads any of these zips by its recorded model class.

:func:`write_model_parts` is the one zip writer of both the live-net path
(:func:`write_model`) and the checkpoint manager, which hands it host
snapshots instead of the net (``resilience/checkpoint.py``).
``ModelSerializer.load_into`` restores a zip into a live network built
from the same configuration (the resume path of
``resilience/trainer.py``): it refuses a zip of another class, keeps the
net's device and the dtype of each of its leaves (an f64 net resumes in
f64), and applies the training-state section.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

FORMAT_VERSION = 1
TRAINING_STATE_ENTRY = "training_state.json"
NORMALIZER_ENTRY = "normalizer.json"
QUANT_ENTRY = "quant.json"
_KEY_PART = re.compile(r"\[(\d+)\]|\['((?:[^'\\]|\\.)*)'\]")


def write_flagship_zip(path: str, model_class: str, cfg, params, opt,
                       extra_meta: Optional[dict] = None) -> None:
    """The JAX package's flagship zip: ``configuration.json`` (the config
    dataclass's fields), ``coefficients.npz`` (params), ``updater.npz``
    (the optimizer dict) and ``metadata.json`` with ``model_class``.
    Stored uncompressed (the JAX writer deflates; its reader takes both):
    zlib at tens of MB/s would spend minutes on the bench transformer's
    2.6 GB of f32 params and Adam moments."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("configuration.json",
                   json.dumps(dataclasses.asdict(cfg)))
        z.writestr("coefficients.npz", tree_to_npz_bytes(params))
        z.writestr("updater.npz", tree_to_npz_bytes(opt))
        z.writestr("metadata.json", json.dumps({
            "format_version": FORMAT_VERSION, "model_class": model_class,
            **(extra_meta or {})}))


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


def read_model_zip(path: str, model_class: str = "MultiLayerNetwork"
                   ) -> Dict[str, Any]:
    """The sections of a MultiLayerNetwork or ComputationGraph zip:
    ``conf`` (the JSON string), ``coefficients``, ``state`` and
    ``updater`` (npz bytes, the last two None when absent), ``meta`` and
    ``training_state`` (dicts, the last empty when absent). A checkpoint
    of another model class is refused loudly (a zip with no recorded
    class is taken as a MultiLayerNetwork, as the JAX package's restore
    does)."""
    with zipfile.ZipFile(path, "r") as z:
        names = set(z.namelist())
        meta = json.loads(z.read("metadata.json").decode())
        got = meta.get("model_class") or "MultiLayerNetwork"
        if got != model_class:
            raise ValueError(
                f"checkpoint holds {got!r}, not {model_class}")
        opt = lambda name: z.read(name) if name in names else None
        ts = opt(TRAINING_STATE_ENTRY)
        return {"conf": z.read("configuration.json").decode(),
                "coefficients": z.read("coefficients.npz"),
                "state": opt("state.npz"), "updater": opt("updater.npz"),
                "meta": meta,
                "training_state": json.loads(ts.decode()) if ts else {}}


def _keystr(path: Tuple[Union[int, str], ...]) -> str:
    """``(0, 'cache', 'W')`` -> ``"[0]['cache']['W']"``, the key
    ``jax.tree_util.keystr`` prints for that leaf."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def tree_to_npz_bytes(tree) -> bytes:
    """An npz of every tensor leaf of a nest of lists and dicts, keyed by
    its path as the JAX package keys it; lists and dicts with no leaves
    write nothing, as a pytree with no leaves does."""
    arrays: Dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, path + (i,))
        elif isinstance(node, np.ndarray):
            arrays[_keystr(path)] = node
        else:
            arrays[_keystr(path)] = node.detach().cpu().numpy()

    visit(tree, ())
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _jsonable_training_state(ts: Dict[str, Any]) -> Dict[str, Any]:
    """Training state with an array-valued ``rng`` key (a JAX zip's) as a
    plain list, so the section stays JSON."""
    out = dict(ts)
    if out.get("rng") is not None:
        out["rng"] = np.asarray(out["rng"]).astype(np.uint32).tolist()
    return out


def write_model_parts(path: str, *, model_class: str, conf_json: str,
                      params, states=None, updater_state=None,
                      meta: Optional[dict] = None,
                      training_state: Optional[dict] = None,
                      normalizer=None, quant=None,
                      compression: int = zipfile.ZIP_DEFLATED) -> None:
    """The zip writer every container checkpoint shares: the entries of
    the JAX package's ``write_model_parts``, in its order. The trees hold
    tensors or numpy arrays; ``compression`` lets the checkpoint manager
    store uncompressed."""
    meta = {"format_version": FORMAT_VERSION, "model_class": model_class,
            **(meta or {})}
    with zipfile.ZipFile(path, "w", compression) as z:
        z.writestr("configuration.json", conf_json)
        z.writestr("coefficients.npz", tree_to_npz_bytes(params))
        if states is not None:
            z.writestr("state.npz", tree_to_npz_bytes(states))
        if updater_state is not None:
            z.writestr("updater.npz", tree_to_npz_bytes(updater_state))
        if training_state is not None:
            z.writestr(TRAINING_STATE_ENTRY, json.dumps(
                _jsonable_training_state(training_state)))
        if normalizer is not None:
            z.writestr(NORMALIZER_ENTRY, normalizer.to_json())
        if quant is not None:
            z.writestr(QUANT_ENTRY, quant.to_json())
        z.writestr("metadata.json", json.dumps(meta))


def read_training_state(path: str) -> Optional[Dict[str, Any]]:
    """The exact-resume section of a zip, or None for a zip without
    one."""
    with zipfile.ZipFile(path, "r") as z:
        if TRAINING_STATE_ENTRY not in z.namelist():
            return None
        return json.loads(z.read(TRAINING_STATE_ENTRY).decode())


def container_meta(net) -> Dict[str, Any]:
    """The metadata a container's zip records beyond the format and the
    class: the iteration and the input shape (a dict for a graph)."""
    if hasattr(net, "_input_shapes"):  # a ComputationGraph
        ishape = ({k: list(v) for k, v in net._input_shapes.items()}
                  if net._input_shapes else None)
    else:
        ishape = list(net._input_shape) if net._input_shape else None
    return {"iteration": int(net.iteration), "input_shape": ishape}


def write_model(net, path: str, save_updater: bool = True, *,
                normalizer=None, quant=None) -> None:
    """Write ``net`` (a MultiLayerNetwork or ComputationGraph of the port)
    as a zip that the JAX package's ``ModelSerializer.restore`` and the
    port's :func:`restore` read back, updater state and training state
    included; ``normalizer`` (fitted) and ``quant`` (a ``QuantSpec``)
    add their sections."""
    ModelSerializer.write_model(net, path, save_updater,
                                normalizer=normalizer, quant=quant)


def _into(template, data: bytes, what: str):
    """An npz section read into the layout of a live net's tree: the keys
    and shapes ``template`` implies (checked as ``load`` checks them),
    each leaf a tensor of its template leaf's dtype and device."""
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import _fill
    from deeplearning4j_tpu_torch.ops.lowprec import tree_map

    tree = npz_bytes_to_tree(data)
    loaded = (tree if isinstance(template, dict)
              else [tree.get(i, {}) for i in range(len(template))])
    filled = _fill(template, loaded, what)

    def leaf(t, v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.array(v)).to(device=t.device,
                                                dtype=t.dtype)

    return tree_map(leaf, template, filled)


class ModelSerializer:
    """The JAX package's ``ModelSerializer`` surface over this module's
    functions, and ``load_into``."""

    _container_meta = staticmethod(container_meta)

    @staticmethod
    def write_model(net, path: str, save_updater: bool = True,
                    training_state: Optional[dict] = None, normalizer=None,
                    quant=None) -> None:
        """A container zip; ``training_state`` (the net's own when None)
        may carry the step, epoch and iterator cursor too."""
        write_model_parts(
            path, model_class=type(net).__name__,
            conf_json=net.conf.to_json(), params=net.params,
            states=net.states,
            updater_state=net.updater_state if save_updater else None,
            meta=container_meta(net),
            training_state=(net.training_state() if training_state is None
                            else training_state),
            normalizer=normalizer, quant=quant)

    @staticmethod
    def load_into(net, path: str, load_updater: bool = True
                  ) -> Dict[str, Any]:
        """Restore a zip into ``net`` (a MultiLayerNetwork or
        ComputationGraph built from the same configuration): a zip of
        another class raises; an uninitialized net is initialized from
        the recorded input shape; params, states and (unless
        ``load_updater`` is False) the updater state are read by key, a
        layout mismatch raising; the iteration and the training-state
        section are applied. Returns the training-state dict ({} for a
        zip without one)."""
        z = read_model_zip(path, type(net).__name__)
        if net.params is None:
            ishape = z["meta"].get("input_shape")
            if isinstance(ishape, dict):
                net.init({k: tuple(v) for k, v in ishape.items()})
            else:
                net.init(tuple(ishape) if ishape else None)
        net.params = _into(net.params, z["coefficients"], "coefficients")
        if z["state"] is not None:
            net.states = _into(net.states, z["state"], "state")
        if load_updater and z["updater"] is not None:
            net.updater_state = _into(net.updater_state, z["updater"],
                                      "updater")
        net.iteration = int(z["meta"].get("iteration", 0))
        ts = z["training_state"]
        net.restore_training_state(ts)
        return ts

    @staticmethod
    def restore(path: str, load_updater: bool = True, *, device=None):
        """Any checkpoint zip, by its recorded class (:func:`restore`)."""
        return restore(path, load_updater, device=device)

    @staticmethod
    def restore_multi_layer_network(path: str, load_updater: bool = True,
                                    *, device=None):
        """A MultiLayerNetwork zip of either package (JAX :300)."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork.load(path, device=device,
                                      load_updater=load_updater)

    @staticmethod
    def restore_computation_graph(path: str, load_updater: bool = True, *,
                                  device=None):
        """A ComputationGraph zip of either package (JAX :326)."""
        return restore_computation_graph(path, load_updater, device=device)


def restore_computation_graph(path: str, load_updater: bool = True, *,
                              device=None):
    """A ComputationGraph zip of either package (``nn/graph.py``'s
    ``ComputationGraph.load``)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ComputationGraph.load(path, device=device,
                                 load_updater=load_updater)


def restore(path: str, load_updater: bool = True, *, device=None):
    """Any checkpoint zip, by the ``model_class`` its metadata records
    (``ModelSerializer.restore``): TransformerLM, BertMLM,
    BertClassifier, ComputationGraph, or MultiLayerNetwork (also a zip
    with no recorded class). Another class raises."""
    with zipfile.ZipFile(path, "r") as z:
        got = json.loads(z.read("metadata.json").decode()).get("model_class")
    if got == "TransformerLM":
        from deeplearning4j_tpu_torch.models.transformer import TransformerLM

        return TransformerLM.load(path, device=device,
                                  load_updater=load_updater)
    if got in ("BertMLM", "BertClassifier"):
        from deeplearning4j_tpu_torch.models import bert

        return getattr(bert, got).load(path, device=device,
                                       load_updater=load_updater)
    if got == "ComputationGraph":
        return restore_computation_graph(path, load_updater, device=device)
    if got not in (None, "MultiLayerNetwork"):
        raise ValueError(
            f"unknown checkpoint model_class {got!r} at {path}")
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork.load(path, device=device,
                                  load_updater=load_updater)


def _read_section(path: str, entry: str) -> Optional[str]:
    """An optional zip entry's text, or None for a directory, a file that
    is not a zip, or a zip without it."""
    if os.path.isdir(path) or not zipfile.is_zipfile(path):
        return None
    with zipfile.ZipFile(path, "r") as z:
        if entry not in z.namelist():
            return None
        return z.read(entry).decode()


def read_normalizer(path: str):
    """The fitted normalizer a checkpoint zip carries, or None."""
    payload = _read_section(path, NORMALIZER_ENTRY)
    if payload is None:
        return None
    from deeplearning4j_tpu_torch.etl.normalize import normalizer_from_json

    return normalizer_from_json(payload)


def read_quant(path: str):
    """The calibrated int8 spec (``QuantSpec``) a checkpoint zip carries,
    or None."""
    payload = _read_section(path, QUANT_ENTRY)
    if payload is None:
        return None
    from deeplearning4j_tpu_torch.etl.calibrate import quant_spec_from_json

    return quant_spec_from_json(payload)


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
