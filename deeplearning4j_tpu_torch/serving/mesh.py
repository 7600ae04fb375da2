"""The serving mesh: the paged ``/generate`` tick with its attention heads
and KV arena sharded (counterpart: ``deeplearning4j_tpu/serving/mesh.py``
— ``serve_mesh_devices``, ``serve_role``, ``serving_mesh``,
``mesh_paged_decode_step`` and ``MeshPagedDecoder``).

The scheme is the JAX package's, chosen for byte identity with the dense
tick rather than for peak flops:

  * the arena's head axis is split: shard i of d holds the contiguous
    ``[L, n_blocks + 1, bt, H/d, hd]`` slice of heads ``[i H/d,
    (i+1) H/d)``, trash block 0 included; block tables, tokens,
    positions and params are replicated, so every shard writes and reads
    the same block indices and all host scheduling (admission, prefix
    sharing, preemption, SLO classes, crash eviction, streaming, k-step
    ticks) is ``serving/paged.PagedDecoder``'s, unchanged.
  * q/k/v are column slices of the replicated projections: a shard takes
    its heads' columns of ``x @ W`` (JAX slices the weights instead; a
    product of another width may sum in another order on the card, so
    the port slices the product, which keeps every value the dense
    tick's).
  * attention is per head, so each shard runs K6
    (``ops/paged_attention.paged_attention``) over its ``H/d`` heads and
    its own arena slice; K6 gives each head its own warp, and its
    context split and combine depend on the table and block size only,
    so a head's output is the dense tick's bit for bit.
  * the heads' outputs are re-joined by a CONCATENATION in shard order (an
    all-gather across ranks), never by a sum; Wo, the MLP, the final LN
    and the logits then run replicated on identical operands. A sum
    (Megatron's row-parallel Wo) would reorder the float reduction.
  * admission runs the full prefill replicated and each shard writes its
    heads of the new blocks; handed-off prefix blocks are adopted the
    same way.

Two placements. Without a ``group`` the ``devices`` shards live in this
process (on one card: the width-d tick of ``chip_smoke.py``; what the
engine builds under ``DL4J_TPU_SERVE_MESH``). With a ``torch.distributed``
group each rank holds one shard (shard index = group rank): rank 0 runs
the scheduler and broadcasts each device step (a tick's tokens, positions
and tables; an admission's window and write table; adopted blocks) to
the other ranks, which run their shard of it (``gloo`` on the CPU; NCCL
needs one card per rank). Sampling runs on rank 0, whose tokens are
broadcast each step.

Gates (loud at build, never a dense fallback): a width below 2, heads
not divisible by the width, an arena dtype other than the compute dtype
(``DL4J_TPU_SERVE_KV_DTYPE``) and speculative decoding
(``DL4J_TPU_SERVE_SPEC``) raise ``ValueError``; the engine refuses the
mesh on the fixed-slot pool.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _block,
    _layer,
    _ln,
)
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention
from deeplearning4j_tpu_torch.serving.decode import _sample_step
from deeplearning4j_tpu_torch.serving.paged import (
    PagedDecoder,
    _prefill_blocks,
)

# the commands rank 0 broadcasts to the other ranks of a group
_TICK, _ADMIT, _IMPORT, _STOP = 1, 2, 3, 4
_HEADER = 4  # int64 words of a command header

Shard = Tuple[int, dict]  # (shard index, its {k, v} arena slice)


def serve_mesh_devices() -> int:
    """The ``DL4J_TPU_SERVE_MESH`` width (0 = mesh serving off)."""
    return max(0, envknob.get_int("DL4J_TPU_SERVE_MESH", 0))


def serve_role() -> str:
    """The ``DL4J_TPU_SERVE_ROLE`` replica role ('' = both)."""
    role = (envknob.get_str("DL4J_TPU_SERVE_ROLE", "") or "").strip().lower()
    return role if role in ("", "prefill", "decode") else ""


def serving_mesh(devices: int, group=None) -> Tuple[int, List[int]]:
    """(width, the shard indices this process holds): every shard for an
    in-process mesh, this rank's one for a ``group`` of ``devices``
    ranks."""
    devices = int(devices)
    if group is None:
        return devices, list(range(devices))
    world = dist.get_world_size(group)
    if world != devices:
        raise ValueError(f"a serving mesh of {devices} over a group of "
                         f"{world} ranks")
    return devices, [dist.get_rank(group)]


def concat_gather(parts: List[torch.Tensor]) -> torch.Tensor:
    """The in-process gather: every shard's [S, H/d, hd] heads joined in
    shard order."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def group_gather(group) -> Callable[[List[torch.Tensor]], torch.Tensor]:
    """The cross-rank gather: this rank's heads all-gathered over
    ``group`` and joined in rank order (a concatenation, not a sum)."""
    world = dist.get_world_size(group)

    def gather(parts):
        (mine,) = parts
        mine = mine.contiguous()
        got = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(got, mine, group=group)
        return torch.cat(got, dim=1)

    return gather


def mesh_paged_decode_step(params, shards: Sequence[Shard], tok, pos, tables,
                           cfg: TransformerConfig, n_devices: int,
                           gather=concat_gather):
    """One decode tick over head-sharded arenas: the head-local mirror of
    ``serving/paged.paged_decode_step``. ``shards`` are the (index,
    {k, v} [L, B, bt, H/d, hd]) slices this process holds, written in
    place; ``gather`` joins the shards' [S, H/d, hd] head outputs of a
    layer into [S, H, hd] in shard order. Returns the logits [S, V] f32
    (replicated: every process computes the same)."""
    cdt = cfg.compute_dtype
    s = tok.shape[0]
    heads = cfg.n_heads
    hd = cfg.d_model // heads
    hl = heads // n_devices
    bt = shards[0][1]["k"].shape[2]
    pl = pos.long()
    h = (params["embed"][tok.long()] + params["pos"][pl])[:, None, :]
    h = h.to(cdt)
    wb = tables.long().gather(1, (pl // bt)[:, None])[:, 0]
    off = pl % bt
    for layer in range(cfg.n_layers):
        def attend(q, k, v, layer=layer):
            q3, k3, v3 = (a.reshape(s, heads, hd) for a in (q, k, v))
            outs = []
            for index, arena in shards:
                cols = slice(index * hl, (index + 1) * hl)
                ck, cv = arena["k"][layer], arena["v"][layer]
                ck[wb, off] = k3[:, cols].to(ck.dtype)
                cv[wb, off] = v3[:, cols].to(cv.dtype)
                outs.append(paged_attention(q3[:, cols].contiguous(), ck,
                                            cv, tables, pos))
            return gather(outs).reshape(s, 1, cfg.d_model).to(cdt)

        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    h = _ln(h[:, 0].float(), params["lnf_g"], params["lnf_b"])
    return h @ params["embed"].T


def _mesh_tick_for(cfg: TransformerConfig, k: int, n_devices: int, gather,
                   share_tokens=None):
    """k decode steps over the shards -> (shards, tokens [S, k]). Each
    step samples (``_sample_step``) where ``share_tokens`` is None (one
    process) or on rank 0, whose tokens ``share_tokens`` broadcasts."""
    def tick(params, shards, tok, pos, tables, temps, gens):
        out = []
        for _ in range(k):
            logits = mesh_paged_decode_step(params, shards, tok, pos, tables,
                                            cfg, n_devices, gather)
            tok = _sample_step(logits, temps, gens) if gens is not None \
                else torch.empty(tok.shape, dtype=torch.int64,
                                 device=tok.device)
            if share_tokens is not None:
                tok = share_tokens(tok)
            pos = pos + 1
            out.append(tok)
        return shards, torch.stack(out, dim=1)

    return tick


class MeshPagedDecoder(PagedDecoder):
    """A ``PagedDecoder`` whose tick runs head-sharded (see the module
    docstring): ``devices`` shards in this process, or one shard per rank
    of ``group`` (rank 0 schedules; the others follow until rank 0
    stops). Every host-side contract is the base class's; only the
    arena, the tick, the admission and the adoption of handed-off blocks
    are sharded."""

    def __init__(self, lm, *, devices: Optional[int] = None, group=None,
                 **kw) -> None:
        cfg = lm.cfg
        nd = int(devices) if devices is not None else (
            dist.get_world_size(group) if group is not None
            else serve_mesh_devices())
        if nd < 2:
            raise ValueError(
                f"DL4J_TPU_SERVE_MESH={nd} cannot shard the serving tick: "
                "a mesh needs >= 2 shards (one shard is PagedDecoder's "
                "job)")
        if cfg.n_heads % nd:
            raise ValueError(
                f"n_heads {cfg.n_heads} is not divisible by the serving "
                f"mesh width {nd}; head sharding needs an even split")
        if lowprec.kv_dtype(cfg) != cfg.compute_dtype:
            raise ValueError(
                "DL4J_TPU_SERVE_KV_DTYPE does not compose with "
                "DL4J_TPU_SERVE_MESH: the sharded tick's byte identity is "
                "held at the compute dtype; unset one of them")
        if lowprec.spec_mode():
            raise ValueError(
                "DL4J_TPU_SERVE_SPEC does not compose with "
                "DL4J_TPU_SERVE_MESH: the speculative round runs dense "
                "per-lane caches; unset one of them")
        self.mesh_devices, self.shard_indices = serving_mesh(nd, group)
        self.group = group
        # one card per rank: the arena's sizing budget is per shard
        self.arena_devices = nd if group is not None else 1
        self.leader = group is None or self.shard_indices[0] == 0
        if group is not None:
            self._src = dist.get_global_rank(group, 0)
            self._gather = group_gather(group)
        else:
            self._gather = concat_gather
        super().__init__(lm, **kw)

    # -- the sharded arena and device steps --------------------------------
    def _new_arena(self):
        hl = self.cfg.n_heads // self.mesh_devices
        return [(i, self._alloc_arena(hl)) for i in self.shard_indices]

    def _tick_fn(self, k: int):
        fn = self._ticks.get(k)
        if fn is None:
            share = self._share_tokens if self.group is not None else None
            fn = self._ticks[k] = _mesh_tick_for(
                self.cfg, k, self.mesh_devices, self._gather, share)
        if self.group is None or not self.leader:
            return fn

        def leader_tick(params, shards, tok, pos, tables, temps, gens):
            self._send([_TICK, k, tok.shape[0], tables.shape[1]],
                       [tok, pos, tables])
            return fn(params, shards, tok, pos, tables, temps, gens)

        return leader_tick

    def _admit_prefill(self, i: int, buf: np.ndarray, width: int,
                       write_table: np.ndarray) -> None:
        window = self._to_device(buf)
        table = self._to_device(write_table)
        if self.group is not None:
            self._send([_ADMIT, width, table.shape[0], 0], [window, table])
        self._admit_shards(window, table)

    def _admit_shards(self, window, write_table) -> None:
        """The full prefill, replicated; each shard writes its heads of
        the prompt's private blocks."""
        blocks = _prefill_blocks(self.lm.compute_params, window, self.cfg,
                                 self.block_tokens)
        self._write_heads(write_table.long(), *blocks)

    def _write_blocks(self, blocks: List[int], kb, vb) -> None:
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        kb, vb = kb.to(self.device), vb.to(self.device)
        if self.group is not None:
            self._send([_IMPORT, len(blocks), 0, 0], [ids, kb, vb])
        self._write_heads(ids, kb, vb)

    def _write_heads(self, ids, kb, vb) -> None:
        """Blocks ``ids`` of every local shard from dense K/V blocks
        [L, n, bt, H, hd]: each shard takes its heads."""
        hl = self.cfg.n_heads // self.mesh_devices
        for index, arena in self._arena:
            cols = slice(index * hl, (index + 1) * hl)
            for name, b in (("k", kb), ("v", vb)):
                arena[name][:, ids] = b[:, :, :, cols].to(arena[name].dtype)

    # -- the ranks of a group ----------------------------------------------
    def _send(self, header, tensors) -> None:
        """Rank 0: one command and its tensors to every rank."""
        head = torch.tensor(list(header) + [0] * (_HEADER - len(header)),
                            dtype=torch.int64, device=self.device)
        dist.broadcast(head, self._src, group=self.group)
        for t in tensors:
            dist.broadcast(t.contiguous(), self._src, group=self.group)

    def _recv(self, shape, dtype):
        t = torch.empty(shape, dtype=dtype, device=self.device)
        dist.broadcast(t, self._src, group=self.group)
        return t

    def _share_tokens(self, tok):
        tok = tok.to(torch.int64).contiguous()
        dist.broadcast(tok, self._src, group=self.group)
        return tok

    def _start_worker(self) -> None:
        if self.leader:
            super()._start_worker()
            return
        self._worker = threading.Thread(target=self._follow, daemon=True,
                                        name="mesh-follower")
        self._worker.start()

    def _follow(self) -> None:
        """A rank other than 0: run each broadcast device step on this
        rank's shard until rank 0 stops."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        i32, i64 = torch.int32, torch.int64
        with torch.inference_mode():
            while True:
                op, a, b, c = (int(x) for x in self._recv((_HEADER,), i64))
                if op == _STOP:
                    return
                if op == _TICK:
                    tok = self._recv((b,), i32)
                    pos = self._recv((b,), i32)
                    tables = self._recv((b, c), i32)
                    self._tick_fn(a)(self.lm.compute_params, self._arena,
                                     tok, pos, tables, [0.0] * b, None)
                elif op == _ADMIT:
                    window = self._recv((1, a), i32)
                    table = self._recv((b,), i32)
                    self._admit_shards(window, table)
                elif op == _IMPORT:
                    ids = self._recv((a,), i64)
                    shape = (cfg.n_layers, a, self.block_tokens,
                             cfg.n_heads, hd)
                    kb = self._recv(shape, self.kv_dtype)
                    vb = self._recv(shape, self.kv_dtype)
                    self._write_heads(ids, kb, vb)

    def submit(self, *args, **kw):
        if not self.leader:
            raise RuntimeError("requests go to rank 0 of the serving mesh")
        return super().submit(*args, **kw)

    def stop(self) -> None:
        if not self.leader:
            self._worker.join()  # until rank 0's stop
            return
        super().stop()
        if self.group is not None:
            self._send([_STOP], [])
