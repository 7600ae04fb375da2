"""Sharded checkpoint and resume: the multi-rank ModelSerializer
(counterpart: ``deeplearning4j_tpu/utils/sharded_checkpoint.py`` —
``_pointer_file`` :50, ``_resolve`` :54, ``_save_version`` :63,
``save_pytree`` :93, ``restore_pytree`` :107, ``save_lm`` :117,
``restore_lm`` :140).

The JAX package writes through orbax, which the port does not have; the
port writes its own payload, and orbax directories are not read here
(the interchange format between the packages stays the zip of
``utils/serialization.py``). Each rank writes the slices it holds of a
tree of tensors (a leaf split over mesh axes by a spec of
``models/transformer.param_specs_for_mesh``; a slice several ranks hold
is written once, by the one at index 0 on the axes it is not split
over) into ``shard-<rank>.pt``, and rank 0 writes ``index.json``: for
each leaf its global shape and dtype and the pieces that tile it (file,
offsets, shape); non-tensor leaves ride in the index as values. A
restore assembles each leaf from its pieces and takes the slice the
TARGET mesh gives the rank, so a checkpoint may land on another mesh
(TP 2 onto one device, pipe 2 onto TP 2).

Crash safety is the JAX package's: each save writes a fresh version
directory ``<path>.v<n>`` and commits it by atomically replacing the
pointer file ``<path>.current``; the previous versions are pruned after
the commit, and a version the pointer does not name is invisible. The
items of one save (params and Adam's state) are one version: they never
come from different generations.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_SEP = "/"


def _pointer_file(path: str) -> str:
    return path + ".current"


def _resolve(path: str) -> str:
    """The directory holding the committed data for ``path``."""
    ptr = _pointer_file(path)
    if os.path.isfile(ptr):
        with open(ptr) as f:
            return os.path.join(os.path.dirname(path), f.read().strip())
    return path


def _flatten(tree, prefix: str = "", seqs=(list, tuple)) -> Dict[str, Any]:
    """{path: leaf}; ``seqs`` are the sequence types walked into (a spec
    tree's tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}", seqs))
        return out
    if isinstance(tree, seqs):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}", seqs))
        return out
    return {prefix[:-len(_SEP)]: tree}


def _flatten_specs(specs) -> Dict[str, Any]:
    return _flatten(specs, seqs=(list,)) if specs else {}


def _unflatten_like(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}{_SEP}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, f"{prefix}{i}{_SEP}")
                          for i, v in enumerate(like))
    key = prefix[:-len(_SEP)]
    if key not in flat:
        raise ValueError(f"checkpoint missing leaf {key!r}")
    return flat[key]


def _unflatten(flat: Dict[str, Any]):
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node, parts = out, key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _rank(mesh) -> int:
    return 0 if mesh is None else dist.get_rank(mesh.world)


def _barrier(mesh) -> None:
    if mesh is not None and dist.get_world_size(mesh.world) > 1:
        dist.barrier(group=mesh.world)


def _gather_objects(obj, mesh):
    if mesh is None or dist.get_world_size(mesh.world) == 1:
        return [obj]
    out = [None] * dist.get_world_size(mesh.world)
    dist.all_gather_object(out, obj, group=mesh.world)
    return out


def _pieces(flat, specs, mesh, rank: int):
    """(this rank's payload {key: tensor}, its index entries)."""
    mine, entries = {}, {}
    for key, leaf in flat.items():
        if not torch.is_tensor(leaf):
            entries[key] = {"value": leaf}
            continue
        spec = tuple(specs.get(key, ())) if specs else ()
        split = {a for a in spec if a is not None}
        holder = mesh is None or all(mesh.index(a) == 0
                                     for a in mesh.axis_names
                                     if a not in split)
        offsets, gshape = [], []
        for d, n in enumerate(leaf.shape):
            axis = spec[d] if d < len(spec) else None
            size = 1 if (axis is None or mesh is None) else mesh.size(axis)
            idx = 0 if size == 1 else mesh.index(axis)
            offsets.append(idx * n)
            gshape.append(n * size)
        e = {"shape": gshape, "dtype": str(leaf.dtype).replace("torch.", ""),
             "pieces": []}
        if holder:
            mine[key] = leaf.detach().to("cpu", copy=True).contiguous()
            e["pieces"].append({"file": f"shard-{rank:05d}.pt",
                                "offsets": offsets,
                                "shape": list(leaf.shape)})
        entries[key] = e
    return mine, entries


def _merge_entries(all_entries):
    index: Dict[str, Any] = {}
    for entries in all_entries:
        for key, e in entries.items():
            if "value" in e:
                index.setdefault(key, e)
                continue
            got = index.setdefault(key, {"shape": e["shape"],
                                         "dtype": e["dtype"], "pieces": []})
            got["pieces"].extend(e["pieces"])
    return index


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_version(path: str, items: Dict[str, Any],
                  specs: Optional[Dict[str, Any]] = None, mesh=None) -> None:
    """Every item of ``items`` (this rank's slices; ``specs`` per item)
    into ONE fresh version directory, committed by one pointer flip on
    rank 0. Every rank of ``mesh`` must call."""
    path = os.path.abspath(path)
    rank = _rank(mesh)
    versions = sorted(glob.glob(path + ".v*"))
    n = 1 + max((int(v.rsplit(".v", 1)[1]) for v in versions
                 if v.rsplit(".v", 1)[1].isdigit()), default=0)
    n = _gather_objects(n, mesh)[0]  # rank 0's scan
    _barrier(mesh)  # nobody writes before every rank has scanned
    vdir = f"{path}.v{n}"
    for name, tree in items.items():
        idir = os.path.join(vdir, name)
        os.makedirs(idir, exist_ok=True)
        fspecs = _flatten_specs((specs or {}).get(name))
        mine, entries = _pieces(_flatten(tree), fspecs, mesh, rank)
        if mine:
            f = os.path.join(idir, f"shard-{rank:05d}.pt")
            torch.save(mine, f)
            _fsync(f)
        index = _merge_entries(_gather_objects(entries, mesh))
        if rank == 0:
            f = os.path.join(idir, "index.json")
            with open(f, "w") as fh:
                json.dump(index, fh)
                fh.flush()
                os.fsync(fh.fileno())
    _barrier(mesh)
    if rank == 0:
        ptr_tmp = f"{_pointer_file(path)}.tmp-{os.getpid()}"
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(vdir))
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, _pointer_file(path))
        for old in versions:
            if old != vdir and not old.endswith(".current"):
                shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
    _barrier(mesh)


def save_pytree(path: str, tree: Any, *, specs: Any = None,
                mesh=None) -> None:
    """Write a tree of tensors (dicts and lists of them; other leaves ride
    in the index): this rank's slices under ``specs`` on ``mesh`` (None:
    whole leaves, one process). Crash-safe overwrite (module
    docstring)."""
    _save_version(path, {"item": tree}, {"item": specs}, mesh)


def _assemble(idir: str, key: str, e: dict, cache: dict) -> torch.Tensor:
    dtype = getattr(torch, e["dtype"])
    pieces = e["pieces"]
    if len(pieces) == 1 and pieces[0]["shape"] == e["shape"]:
        return _load(idir, pieces[0]["file"], cache)[key]
    out = torch.empty(e["shape"], dtype=dtype)
    for p in pieces:
        sl = tuple(slice(o, o + s) for o, s in zip(p["offsets"], p["shape"]))
        out[sl] = _load(idir, p["file"], cache)[key]
    return out


def _load(idir: str, name: str, cache: dict):
    if name not in cache:
        cache[name] = torch.load(os.path.join(idir, name),
                                 map_location="cpu", weights_only=True)
    return cache[name]


def restore_pytree(path: str, like: Any = None, *, specs: Any = None,
                   mesh=None, item: str = "item", device=None) -> Any:
    """The committed tree at ``path``, each leaf this rank's slice under
    ``specs`` on ``mesh`` (whole leaves when None) on ``device`` (the
    card unless ``"cpu"``), in ``like``'s structure (nested dicts from
    the stored paths when None). Leaves keep their stored dtype."""
    from deeplearning4j_tpu_torch.ops.device import resolve_device
    from deeplearning4j_tpu_torch.parallel.expert_parallel import shard

    dev = resolve_device(device)
    base = _resolve(os.path.abspath(path))
    idir = os.path.join(base, item)
    ipath = os.path.join(idir, "index.json")
    if not os.path.isfile(ipath):
        raise FileNotFoundError(f"no committed checkpoint item {item!r} "
                                f"under {path}")
    with open(ipath) as f:
        index = json.load(f)
    fspecs = _flatten_specs(specs)
    sizes = {} if mesh is None else {a: mesh.size(a)
                                     for a in mesh.axis_names}
    indices = {} if mesh is None else dict(mesh.indices)
    cache: dict = {}
    flat = {}
    for key, e in index.items():
        if "value" in e:
            flat[key] = e["value"]
            continue
        whole = _assemble(idir, key, e, cache)
        flat[key] = shard(whole, tuple(fspecs.get(key, ())), sizes,
                          indices).to(dev)
    return _unflatten(flat) if like is None else _unflatten_like(like, flat)


def _opt_specs(specs, opt) -> dict:
    return {k: (specs if k in ("m", "v") else ()) for k in opt}


def save_lm(dirpath: str, lm) -> None:
    """A TransformerLM's checkpoint: ``configuration.json``,
    ``metadata.json`` and one committed version of ``state`` holding the
    params and Adam's state as two items (a weights-only restore reads
    the params alone). Under a mesh every rank calls and writes its
    shards."""
    from deeplearning4j_tpu_torch.models.transformer import (
        MeshGroups,
        param_specs_for_mesh,
    )

    dirpath = os.path.abspath(dirpath)
    mesh = lm.group if isinstance(lm.group, MeshGroups) else None
    if lm.group is not None and mesh is None:
        from deeplearning4j_tpu_torch.parallel.mesh import as_mesh

        mesh = as_mesh(lm.group)
    rank = _rank(mesh)
    if rank == 0:
        os.makedirs(dirpath, exist_ok=True)

        def write_json(name, obj):
            tmp = os.path.join(dirpath, f".{name}.tmp-{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(obj, f)
            os.replace(tmp, os.path.join(dirpath, name))

        write_json("configuration.json", dataclasses.asdict(lm.cfg))
        write_json("metadata.json", {"model_class": "TransformerLM",
                                     "format": "torch-shards"})
    _barrier(mesh)
    specs = param_specs_for_mesh(lm.cfg, mesh)
    opt = lm.opt
    _save_version(os.path.join(dirpath, "state"),
                  {"params": lm.params, "opt": opt},
                  {"params": specs, "opt": _opt_specs(specs, opt)}, mesh)


def restore_lm(dirpath: str, group=None, load_updater: bool = True,
               device=None):
    """A TransformerLM from :func:`save_lm`'s directory, its state sliced
    for ``group``'s mesh (the layout of ``param_specs_for_mesh``, which
    may differ from the one it was saved under) on ``device``."""
    from deeplearning4j_tpu_torch.models.transformer import (
        MeshGroups,
        TransformerConfig,
        TransformerLM,
        param_specs_for_mesh,
    )

    dirpath = os.path.abspath(dirpath)
    with open(os.path.join(dirpath, "configuration.json")) as f:
        cfg = TransformerConfig(**json.load(f))
    mesh = group if isinstance(group, MeshGroups) else None
    specs = param_specs_for_mesh(cfg, mesh)
    state = os.path.join(dirpath, "state")
    params = restore_pytree(state, specs=specs, mesh=mesh, item="params",
                            device=device)
    opt = None
    if load_updater:
        base = _resolve(os.path.abspath(state))
        with open(os.path.join(base, "opt", "index.json")) as f:
            keys = {k.split(_SEP)[0] for k in json.load(f)}
        opt = restore_pytree(state, specs=_opt_specs(specs, keys),
                             mesh=mesh, item="opt", device=device)
    return TransformerLM.from_state(cfg, params, opt, device=device,
                                    group=group, sharded=True)
