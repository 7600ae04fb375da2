"""The ``'seq'`` mesh axis as a ``torch.distributed`` process group
(counterpart: ``deeplearning4j_tpu/parallel/mesh.py`` ``SEQUENCE_AXIS``,
``device_mesh`` and the ``lax.ppermute`` / ``lax.all_to_all`` the ring
and Ulysses bodies use).

Where the JAX package shards one global array over a mesh axis inside
``shard_map``, the port runs one process per shard: ``gloo`` on the CPU,
``nccl`` on cards. Each process holds its own shard and calls the same
function; the group is the axis. Nothing here reads the environment: the
caller names the store file, its rank and the world size.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist


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


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` in ``group``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank + 1 and return what rank - 1 sent (the JAX
    bodies' ``ppermute`` with ``perm = [(i, (i + 1) % n)]``). A world of 1
    returns ``t`` without communicating."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    rank = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, _peer(group, (rank + 1) % world),
                      group),
           dist.P2POp(dist.irecv, out, _peer(group, (rank - 1) % world),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    split ``x`` along ``split_axis`` into one chunk per rank, send chunk i
    to rank i, and concatenate what arrives along ``concat_axis`` in rank
    order. A world of 1 returns ``x``."""
    world = dist.get_world_size(group)
    if world == 1:
        return x
    if x.shape[split_axis] % world:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split {world} ways")
    send = torch.stack(x.chunk(world, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)
