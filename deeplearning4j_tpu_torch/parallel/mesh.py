"""The ``'data'`` and ``'seq'`` mesh axes as ``torch.distributed`` process
groups (counterpart: ``deeplearning4j_tpu/parallel/mesh.py`` ``DATA_AXIS``,
``SEQUENCE_AXIS``, ``device_mesh`` and the ``lax.ppermute`` /
``lax.all_to_all`` the ring and Ulysses bodies use).

Where the JAX package shards one global array over a mesh axis inside
``shard_map``, the port runs one process per shard: ``gloo`` on the CPU,
``nccl`` on cards. Each process holds its own shard and calls the same
function; the group is the axis. :func:`init_seq_group` joins a world
(a 1-D ``'seq'`` axis); :func:`mesh_groups` splits it into ``'data'`` x
``'seq'`` (:class:`MeshGroups`, the ``device_mesh(shape=(data, seq),
axis_names=('data', 'seq'))`` of the JAX package: rank ``d * seq + s``
sits at data index d, sequence index s). Nothing here reads the
environment: the caller names the store file, its rank and the sizes.

:func:`ring_shift` and :func:`all_to_all` are differentiable: the
backward of a shift to rank + 1 is a shift of the cotangent to rank - 1,
and the backward of ``all_to_all(x, s, c)`` is ``all_to_all(g, c, s)``,
as JAX transposes ``ppermute`` and ``all_to_all``. Each call is one
collective forward and one backward, so callers that move several
tensors together pack them into one buffer: collectives that autograd
would order differently on two ranks could match the wrong buffers.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQUENCE_AXIS = "seq"


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
    """This rank's place in a ``'data'`` x ``'seq'`` mesh: ``data`` the
    group of the ranks that share its sequence index (its batch axis),
    ``seq`` the group of those that share its data index (its sequence
    axis), ``world`` the whole mesh (gradients are averaged over it)."""

    data: object
    seq: object
    world: object
    shape: tuple

    @property
    def data_index(self) -> int:
        return 0 if self.data is None else dist.get_rank(self.data)

    @property
    def seq_index(self) -> int:
        return dist.get_rank(self.seq)


def as_mesh(group) -> MeshGroups:
    """``group`` as a :class:`MeshGroups`: a mesh passes through; a plain
    group (None: the default one) is a ``'seq'`` axis with a data axis of
    1, and is its own world."""
    if isinstance(group, MeshGroups):
        return group
    group = dist.group.WORLD if group is None else group
    return MeshGroups(data=None, seq=group, world=group,
                      shape=(1, dist.get_world_size(group)))


def mesh_groups(data: int, seq: int, world=None) -> MeshGroups:
    """The :class:`MeshGroups` of this rank in a world of ``data * seq``
    ranks joined by :func:`init_seq_group` (``world``: its group, the
    default one when None); every rank makes every group with
    ``dist.new_group``, in the same order."""
    world = dist.group.WORLD if world is None else world
    if dist.get_world_size(world) != data * seq:
        raise ValueError(f"a {data} x {seq} mesh needs {data * seq} ranks, "
                         f"the world has {dist.get_world_size(world)}")
    me = dist.get_rank(world)
    seq_groups = [dist.new_group([d * seq + s for s in range(seq)])
                  for d in range(data)]
    data_groups = [dist.new_group([d * seq + s for d in range(data)])
                   for s in range(seq)]
    return MeshGroups(data=data_groups[me % seq], seq=seq_groups[me // seq],
                      world=world, shape=(data, seq))


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
