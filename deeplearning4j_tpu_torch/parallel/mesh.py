"""The JAX package's mesh axes as ``torch.distributed`` process groups
(counterpart: ``deeplearning4j_tpu/parallel/mesh.py`` — ``DATA_AXIS``,
``MODEL_AXIS``, ``PIPELINE_AXIS``, ``SEQUENCE_AXIS``, ``EXPERT_AXIS``,
``device_mesh`` :76 — and the collectives the ``shard_map`` bodies use:
``lax.ppermute``, ``lax.all_to_all``, ``lax.psum``, ``lax.all_gather``).

Where the JAX package shards one global array over a mesh axis inside
``shard_map``, the port runs one process per shard: ``gloo`` on the CPU,
``nccl`` on cards. Each process holds its own shard and calls the same
function; the group is the axis. :func:`init_seq_group` joins a world;
:func:`device_mesh` splits it into named axes (:class:`MeshGroups`:
ranks row-major over the axes in the order given, each rank's group and
index on each axis), :func:`mesh_groups` into the ring step's ``'data'``
x ``'seq'``. Nothing here reads the environment: the caller names the
store file, its rank and the sizes.

Every collective here is differentiable. :func:`ring_shift`'s backward
is a shift of the cotangent the other way, :func:`all_to_all`'s the
all-to-all with the axes swapped, as JAX transposes ``ppermute`` and
``all_to_all``. The Megatron pair: :func:`copy_to` (identity forward,
all-reduce backward) where a replicated tensor enters each rank's shard
of a computation, and :func:`psum` (all-reduce forward, identity
backward) where the shards' partial results are summed back into a
replicated one; :func:`gather_from` concatenates the ranks' shards into
a replicated tensor and its backward takes this rank's slice;
:func:`psum_transposed` sums the cotangents too. Each call is one
collective forward and one backward, so callers that move several
tensors together pack them into one buffer: collectives that autograd
would order differently on two ranks could match the wrong buffers.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPELINE_AXIS = "pipe"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, SEQUENCE_AXIS, MODEL_AXIS, EXPERT_AXIS, PIPELINE_AXIS)


def init_seq_group(store_path: str, rank: int, world_size: int, *,
                   backend: Optional[str] = None,
                   timeout_s: float = 60.0):
    """Join the ``'seq'`` group through a ``FileStore`` at ``store_path``
    (every rank names the same fresh file): ``nccl`` when a card is
    present, ``gloo`` otherwise, unless ``backend`` says. Init and every
    collective give up after ``timeout_s``. Returns the group (the default
    one); ``dist.destroy_process_group()`` leaves it."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """This rank's place in a mesh of named axes (the JAX package's
    ``Mesh`` of ``device_mesh(shape=..., axis_names=...)``): ``groups``
    maps each axis to the process group of the ranks that differ from
    this one on that axis only, ``indices`` to this rank's index on it,
    ``world`` is the whole mesh. An axis the mesh lacks has size 1 and no
    group. ``data`` and ``seq`` name the two axes of the ring step."""

    axis_names: tuple
    shape: tuple
    groups: dict
    indices: dict
    world: object

    def size(self, axis: str) -> int:
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.indices.get(axis, 0)

    def group(self, axis: str):
        """The axis's group, or None when the mesh lacks the axis."""
        return self.groups.get(axis)

    def has(self, axis: str) -> bool:
        return axis in self.axis_names

    @property
    def data(self):
        return self.group(DATA_AXIS)

    @property
    def seq(self):
        return self.group(SEQUENCE_AXIS)

    @property
    def data_index(self) -> int:
        return self.index(DATA_AXIS)

    @property
    def seq_index(self) -> int:
        return self.index(SEQUENCE_AXIS)


def as_mesh(group) -> MeshGroups:
    """``group`` as a :class:`MeshGroups`: a mesh passes through; a plain
    group (None: the default one) is a 1-D ``'seq'`` axis, its own
    world."""
    if isinstance(group, MeshGroups):
        return group
    group = dist.group.WORLD if group is None else group
    return MeshGroups(axis_names=(SEQUENCE_AXIS,),
                      shape=(dist.get_world_size(group),),
                      groups={SEQUENCE_AXIS: group},
                      indices={SEQUENCE_AXIS: dist.get_rank(group)},
                      world=group)


def device_mesh(shape, axis_names, world=None) -> MeshGroups:
    """The :class:`MeshGroups` of this rank in a mesh of ``shape`` over
    ``axis_names`` (any of ``data``, ``seq``, ``model``, ``expert``,
    ``pipe``, in the order the JAX package's ``device_mesh(shape=...,
    axis_names=...)`` would name them): ranks are laid out row-major, so
    in a ``("pipe", "data")`` mesh of 4 x 2 rank ``p * 2 + d`` sits at
    pipe index p, data index d. The world (``world``: its group, the
    default one when None) must hold ``prod(shape)`` ranks; every rank
    makes every group with ``dist.new_group``, in the same order."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ")
    bad = [a for a in axis_names if a not in AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad} (known: {AXES})")
    world = dist.group.WORLD if world is None else world
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size(world) != n:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the world has {dist.get_world_size(world)}")
    me = dist.get_rank(world)
    coords = np.unravel_index(np.arange(n), shape)
    mine = [int(c[me]) for c in coords]
    groups = {}
    for ax, name in enumerate(axis_names):
        for r in range(n):  # one group per line of ranks along this axis
            if coords[ax][r] != 0:
                continue
            line = [r + i * int(np.prod(shape[ax + 1:], dtype=np.int64))
                    for i in range(shape[ax])]
            g = dist.new_group([_peer(world, x) for x in line])
            if me in line:
                groups[name] = g
    return MeshGroups(axis_names=axis_names, shape=shape, groups=groups,
                      indices=dict(zip(axis_names, mine)), world=world)


def mesh_groups(data: int, seq: int, world=None) -> MeshGroups:
    """The ``'data'`` x ``'seq'`` mesh of :func:`device_mesh` (rank
    ``d * seq + s`` at data index d, sequence index s), the mesh of the
    ring step's DP x SP."""
    return device_mesh((data, seq), (DATA_AXIS, SEQUENCE_AXIS), world)


def group_size(group) -> int:
    """The size of ``group``; None (an axis the mesh lacks) is 1."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank (``lax.psum``), whose
    backward passes the cotangent through: the Megatron pair's second
    half, where every rank's loss is the same function of the sum. None
    or a world of 1 returns ``x``."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, False)


def psum_transposed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` whose backward sums the cotangents
    over the group too (``lax.psum`` under ``shard_map`` without the
    replication check): for a sum that enters each rank's own loss, when
    the gradients are then averaged over the group."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, True)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: the Megatron pair's first
    half, where a replicated tensor enters a computation each rank does
    on its own shard (the gradient is the sum of the ranks' parts).
    None or a world of 1 returns ``x``."""
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.chunk(world, dim=ctx.dim)[rank].contiguous(), None, None


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``) into a replicated tensor; the
    backward takes this rank's slice of the cotangent (each rank's loss
    is the same function of the whole). None or a world of 1 returns
    ``x``."""
    if group_size(group) == 1:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim())


def all_gather_ints(x: torch.Tensor, group) -> torch.Tensor:
    """[world, *x.shape]: every rank's ``x`` (no gradient) in rank order;
    None or a world of 1 gives ``x[None]``."""
    if group_size(group) == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _shift(t: torch.Tensor, group, by: int) -> torch.Tensor:
    """Send ``t`` to rank + by and return what rank - by sent: one P2P
    pair."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, _peer(group, (rank + by) % world),
                      group),
           dist.P2POp(dist.irecv, out, _peer(group, (rank - by) % world),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank + 1 and return what rank - 1 sent (the JAX
    bodies' ``ppermute`` with ``perm = [(i, (i + 1) % n)]``); its backward
    sends the cotangent to rank - 1. A world of 1 returns ``t`` without
    communicating."""
    if dist.get_world_size(group) == 1:
        return t
    return _RingShift.apply(t, group)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, group):
    world = dist.get_world_size(group)
    send = torch.stack(x.chunk(world, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, concat_axis, split_axis, ctx.group), None,
                None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    split ``x`` along ``split_axis`` into one chunk per rank, send chunk i
    to rank i, and concatenate what arrives along ``concat_axis`` in rank
    order; its backward is the all-to-all with the axes swapped. A world
    of 1 returns ``x``."""
    world = dist.get_world_size(group)
    if world == 1:
        return x
    if x.shape[split_axis] % world:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split {world} ways")
    return _AllToAll.apply(x, split_axis, concat_axis, group)
