"""Paged-KV continuous decode: the block-pool ``/generate`` plane
(counterpart: ``deeplearning4j_tpu/serving/paged.py``).

One device-resident BLOCK ARENA of fixed-size KV blocks, per-request block
TABLES mapping logical token positions to physical blocks, admission gated
by the free-block count, eviction returning blocks to the free list
(PagedAttention, Kwon et al.), with iteration-level scheduling (Orca): the
device tick is one fixed-shape step over every lane, and all paging —
allocation, preemption, prefix sharing — is host-side bookkeeping between
ticks.

Layout and invariants (the JAX package's, carried over exactly):

  * arena k/v: ``[L, n_blocks+1, block_tokens, H, hd]`` in the compute
    dtype; physical block 0 is a TRASH block that is never allocated —
    inactive lanes and the unallocated tail of every table point at it,
    and the ``t <= pos`` mask keeps it out of every result.
  * the arena has ONE owner, the decoder's worker thread, which writes it
    IN PLACE: the tick writes the new K/V at ``(tables[s, pos//bt],
    pos % bt)`` and admission writes a prompt's private blocks. These
    in-place writes take the place of the JAX package's buffer donation.
  * the tick's attention is the paged-decode kernel
    (``ops/paged_attention.py``: the hand-written CUDA kernel on the card,
    the ``ck[tables]`` gather on the CPU). A lane's output depends on the
    VALUES in its blocks, not on their physical ids.
  * prefix cache: full prompt blocks strictly below a request's first
    write position are content-addressed (chained sha256 over the
    re-based window) and refcounted; a hit points the new request's read
    table at the shared blocks. The block holding the last prompt token
    is always PRIVATE, and shared blocks are never written after their
    creating prefill (the write table sends them to trash).
  * admission prefill runs ``prefill_cache`` at width
    ``min(max(bucket_size(keep), keep), max_len)`` and writes ONLY the
    private blocks.
  * on block exhaustion the YOUNGEST active request is preempted: its
    blocks return to the free list and it is re-queued at the front of
    its SLO class with prompt := window + generated-so-far and its own
    sampling generator, so the resumed stream continues where it stopped.

The tick always runs all ``lanes`` lanes, so a lane's matmul shapes are
the same whether it runs alone or beside others: a request's tokens do
not depend on its co-residents.

Not ported yet: k-step ticks, speculative decode, prefix export/import
(disaggregation), mesh hooks, chaos hooks.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _block,
    _layer,
    _ln,
    check_dense,
    prefill_cache,
)
from deeplearning4j_tpu_torch.ops import memory as opsmem
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size
from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention
from deeplearning4j_tpu_torch.serving.batcher import (
    QueueFullError,
    RequestTimeoutError,
)
from deeplearning4j_tpu_torch.serving.decode import _sample_step
from deeplearning4j_tpu_torch.serving.resilience import (
    ClientRequestError,
    WorkerDeadError,
)
from deeplearning4j_tpu_torch.serving.slo import SLOClass, default_classes
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats


def paged_decode_step(params, arena, tok, pos, tables,
                      cfg: TransformerConfig):
    """One decode tick over the block arena: tok [S] int, pos [S] int32,
    tables [S, max_len//bt] int32 -> (arena, logits [S, V] f32). The
    arena is updated IN PLACE: each lane's new K/V goes to
    ``(tables[s, pos//bt], pos % bt)`` before its attention reads the
    window. Active lanes write distinct blocks by allocation invariant;
    inactive lanes all write trash block 0, never visible."""
    check_dense(cfg)
    cdt = cfg.compute_dtype
    s = tok.shape[0]
    heads = cfg.n_heads
    hd = cfg.d_model // heads
    bt = arena["k"].shape[2]
    pl = pos.long()
    h = (params["embed"][tok.long()] + params["pos"][pl])[:, None, :]
    h = h.to(cdt)
    wb = tables.long().gather(1, (pl // bt)[:, None])[:, 0]
    off = pl % bt
    for layer in range(cfg.n_layers):
        ck, cv = arena["k"][layer], arena["v"][layer]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[wb, off] = k.reshape(s, heads, hd).to(ck.dtype)
            cv[wb, off] = v.reshape(s, heads, hd).to(cv.dtype)
            att = paged_attention(q.reshape(s, heads, hd), ck, cv, tables,
                                  pos)
            return att.reshape(s, 1, cfg.d_model).to(cdt)

        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    h = _ln(h[:, 0].float(), params["lnf_g"], params["lnf_b"])
    return arena, h @ params["embed"].T


def paged_admit(params, arena, window, write_table, cfg: TransformerConfig):
    """Admission prefill: window [1, width] int -> arena with the
    prompt's private blocks written in place. ``prefill_cache`` pads K/V
    to max_len, so the reshape covers every table entry; write_table
    sends shared-prefix and beyond-prompt entries to trash block 0."""
    bt = arena["k"].shape[2]
    m = cfg.max_len // bt
    hd = cfg.d_model // cfg.n_heads
    c1, _ = prefill_cache(params, window, cfg)
    idx = write_table.long()
    for name in ("k", "v"):
        blocks = c1[name][:, 0].reshape(cfg.n_layers, m, bt, cfg.n_heads,
                                        hd)
        arena[name][:, idx] = blocks.to(arena[name].dtype)
    return arena


class BlockArena:
    """Host-side allocator for the device block arena: a free list plus
    per-block refcounts (prefix-shared blocks are held by every reader
    AND the cache). Physical ids run 1..usable; 0 is trash. Only the
    worker thread touches it, under the decoder's lock."""

    def __init__(self, usable: int) -> None:
        self.usable = int(usable)
        self._free: List[int] = list(range(self.usable, 0, -1))
        self.refs = np.zeros((self.usable + 1,), np.int64)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        b = self._free.pop()
        self.refs[b] = 1
        return b

    def incref(self, block: int) -> None:
        self.refs[block] += 1

    def decref(self, block: int) -> None:
        self.refs[block] -= 1
        if self.refs[block] <= 0:
            self.refs[block] = 0
            self._free.append(block)


class PrefixCache:
    """Content-addressed block index: chained sha256 of the re-based
    prompt window -> physical block id, LRU-ordered. The cache holds one
    reference per entry; :meth:`reclaim` evicts least-recently-used
    entries nobody else references."""

    def __init__(self, arena: BlockArena) -> None:
        self._arena = arena
        self._map: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    @staticmethod
    def chain_hashes(window: np.ndarray, block_tokens: int,
                     limit: int) -> List[bytes]:
        """Digests for full blocks [0, limit) of the window; each digest
        covers all tokens up to its block's end."""
        out: List[bytes] = []
        h = b"paged-kv-v1"
        w = np.ascontiguousarray(window.astype(np.int32, copy=False))
        for i in range(limit):
            h = hashlib.sha256(
                h + w[i * block_tokens:(i + 1) * block_tokens].tobytes()
            ).digest()
            out.append(h)
        return out

    def lookup(self, hashes: List[bytes]) -> List[int]:
        """Longest-prefix hit (LRU-refreshed). Caller increfs what it
        keeps."""
        hits: List[int] = []
        for h in hashes:
            b = self._map.get(h)
            if b is None:
                break
            self._map.move_to_end(h)
            hits.append(b)
        return hits

    def insert(self, digest: bytes, block: int) -> bool:
        if digest in self._map:
            return False  # equal content already cached; keep ours private
        self._map[digest] = block
        self._arena.incref(block)
        return True

    def reclaim(self, n: int) -> int:
        """Evict up to n LRU entries whose only reference is the cache's
        own; returns how many blocks went back to the free list."""
        freed = 0
        for digest, block in list(self._map.items()):
            if freed >= n:
                break
            if self._arena.refs[block] == 1:
                del self._map[digest]
                self._arena.decref(block)
                freed += 1
        return freed


class _PendingReq:
    __slots__ = ("prompt", "n_new", "temperature", "seed", "future",
                 "deadline", "enqueued", "slo", "on_token", "tokens",
                 "gen", "seq")

    def __init__(self, prompt, n_new, temperature, seed, deadline, slo,
                 on_token, seq, future=None, tokens=None, gen=None,
                 enqueued=None) -> None:
        self.prompt = prompt
        self.n_new = n_new
        self.temperature = temperature
        self.seed = seed
        self.future = future if future is not None else Future()
        self.deadline = deadline
        self.enqueued = enqueued if enqueued is not None \
            else time.monotonic()
        self.slo = slo
        self.on_token = on_token
        self.tokens = tokens if tokens is not None else []
        self.gen = gen  # the preempted request's own generator
        self.seq = seq


class _Lane:
    __slots__ = ("future", "tokens", "remaining", "deadline", "enqueued",
                 "temperature", "seed", "slo", "on_token", "blocks",
                 "n_table", "window", "admit_seq")

    def __init__(self, req: _PendingReq, blocks: List[int], n_table: int,
                 window: np.ndarray, admit_seq: int) -> None:
        self.future = req.future
        self.tokens = req.tokens
        self.remaining = req.n_new
        self.deadline = req.deadline
        self.enqueued = req.enqueued
        self.temperature = req.temperature
        self.seed = req.seed
        self.slo = req.slo
        self.on_token = req.on_token
        self.blocks = blocks      # every block this lane holds a ref on
        self.n_table = n_table    # allocated read-table entries
        self.window = window      # re-based prompt (for preempt requeue)
        self.admit_seq = admit_seq


class PagedDecoder:
    """Block-pool continuous decode over a TransformerLM: submit /
    generate / drain / stop, SLO classes, youngest-victim preemption,
    prefix sharing and per-token ``on_token`` streaming callbacks. Runs on
    ``device`` (the card unless the caller passes ``device="cpu"``), which
    must be the model's."""

    supports_streaming = True

    def __init__(self, lm, *, block_tokens: int = 16,
                 n_blocks: Optional[int] = None,
                 lanes: Optional[int] = None, min_lanes: int = 4,
                 stats: Optional[ServingStats] = None,
                 default_timeout_s: float = 300.0,
                 slo_classes: Optional[List[SLOClass]] = None,
                 queue_cap: Optional[int] = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if self.device != lm.device:
            raise ValueError(f"model lives on {lm.device}, decoder asked "
                             f"for {self.device}")
        cfg = lm.cfg
        check_dense(cfg)
        self.lm = lm
        self.cfg = cfg
        self._params = lm.compute_params
        bt = max(1, min(int(block_tokens), cfg.max_len))
        while cfg.max_len % bt:
            bt //= 2
        self.block_tokens = bt
        self.table_width = cfg.max_len // bt
        self.kv_dtype = cfg.compute_dtype
        if n_blocks is None:
            n_blocks = opsmem.kv_arena_blocks(cfg, bt, device=self.device,
                                              params=lm.params,
                                              dtype=self.kv_dtype)
        self.n_blocks = int(n_blocks)
        if self.n_blocks < self.table_width + 1:
            raise ValueError(
                f"n_blocks {self.n_blocks} cannot hold one max_len "
                f"sequence ({self.table_width + 1} blocks)")
        if lanes is None:
            # sized so sequences averaging a quarter of max_len fill the
            # arena; min_lanes keeps a floor, 64 caps the tick's width
            est_seq = max(bt, cfg.max_len // 4)
            lanes = max(int(min_lanes),
                        min(64, max(1, self.n_blocks * bt // est_seq)))
        self.lanes = int(lanes)
        self.stats = stats if stats is not None else ServingStats()
        self.default_timeout_s = float(default_timeout_s)
        self.queue_cap = int(queue_cap) if queue_cap else None
        classes = list(slo_classes) if slo_classes else \
            default_classes(self.default_timeout_s)
        self._classes = classes
        self._class_map = {c.name: c for c in classes}
        self._default_class = classes[0].name
        self._pending: Dict[str, deque] = {c.name: deque() for c in classes}
        self._reset_arena()
        self._tables = np.zeros((self.lanes, self.table_width), np.int32)
        self._tok = np.zeros((self.lanes,), np.int32)
        self._pos = np.zeros((self.lanes,), np.int32)
        self._temps = np.ones((self.lanes,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.lanes
        self._slots: List[Optional[_Lane]] = [None] * self.lanes
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = True
        self._dead: Optional[str] = None
        self._seq = 0        # submit/requeue order (shed picks youngest)
        self._admit_seq = 0  # admission order (preemption picks youngest)
        self.peak_active = 0
        # host wall time of the device work, synchronised by each tick's
        # token read-back and each admission's next tick
        self.decode_ticks = 0
        self.tick_seconds = 0.0
        self.admissions = 0
        self.admit_seconds = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="paged-decoder")
        self._worker.start()

    def _reset_arena(self) -> None:
        """Fresh zeroed arena + allocator + prefix cache (construction and
        the pool-wide failure path)."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        shape = (cfg.n_layers, self.n_blocks + 1, self.block_tokens,
                 cfg.n_heads, hd)
        # inference tensors: only the worker thread writes them, inside
        # torch.inference_mode()
        with torch.inference_mode():
            self._arena = {
                "k": torch.zeros(shape, dtype=self.kv_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.kv_dtype,
                                 device=self.device)}
        self._blocks = BlockArena(self.n_blocks)
        self._prefix = PrefixCache(self._blocks)
        self.stats.set_kv_blocks(0, self.n_blocks)

    # -- client side ------------------------------------------------------
    def submit(self, prompt, n_new: int, temperature: float = 1.0,
               seed: int = 0, timeout_s: Optional[float] = None,
               slo: Optional[str] = None, on_token=None) -> Future:
        """Queue one prompt ([T] int ids) for n_new sampled tokens;
        returns a Future of the [n_new] int32 continuation. ``slo`` names
        a scheduling class (default: the highest-priority one);
        ``on_token`` is called with each token as it is sampled (on the
        decode thread — keep it fast)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if n_new < 1 or n_new >= self.cfg.max_len:
            raise ValueError(f"n_new {n_new} must be in [1, max_len)")
        cls = self._class_map.get(slo if slo is not None
                                  else self._default_class)
        if cls is None:
            raise ClientRequestError(
                f"unknown SLO class {slo!r} (have: "
                f"{sorted(self._class_map)})")
        keep = min(prompt.size, self.cfg.max_len - int(n_new))
        total_blocks = (keep + int(n_new) - 2) // self.block_tokens + 1
        if total_blocks > self.n_blocks:
            raise ValueError(
                f"request needs {total_blocks} blocks > arena "
                f"{self.n_blocks}; it could never be scheduled")
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else cls.deadline_s)
        self.stats.record_request()
        with self._cond:
            if not self._running:
                raise RuntimeError("decoder is stopped")
            if self._dead is not None:
                raise WorkerDeadError(
                    f"decoder worker died ({self._dead}); prompts would "
                    "queue forever")
            self._seq += 1
            req = _PendingReq(prompt, int(n_new), float(temperature),
                              int(seed), deadline, cls.name, on_token,
                              self._seq)
            if self.queue_cap is not None and \
                    self._total_pending() >= self.queue_cap:
                victim = self._shed_for(cls)
                if victim is None:
                    self.stats.record_shed(cls.name)
                    self.stats.record_rejected()
                    raise QueueFullError(
                        f"decode queue full ({self.queue_cap}) and no "
                        f"lower-priority work to shed below {cls.name!r}")
                self.stats.record_shed(victim.slo)
                self.stats.record_rejected()
                victim.future.set_exception(QueueFullError(
                    f"shed by higher-priority class {cls.name!r}"))
            self._pending[cls.name].append(req)
            self.stats.set_queue_depth(self._total_pending())
            self._cond.notify_all()
        return req.future

    def generate(self, prompts, n_new: int, temperature: float = 1.0,
                 seed: int = 0, timeout_s: Optional[float] = None,
                 slo: Optional[str] = None) -> np.ndarray:
        """Batch convenience: [N, T] prompts -> [N, n_new] continuations
        (independent requests; seeds offset per row)."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim == 1:
            prompts = prompts[None]
        futs = [self.submit(row, n_new, temperature=temperature,
                            seed=seed + i, timeout_s=timeout_s, slo=slo)
                for i, row in enumerate(prompts)]
        budget = timeout_s if timeout_s is not None \
            else self.default_timeout_s
        return np.stack([f.result(timeout=budget) for f in futs])

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=10)
        with self._cond:
            for q in self._pending.values():
                for req in q:
                    if not req.future.done():
                        req.future.set_exception(
                            RuntimeError("decoder stopped"))
                q.clear()
            for st in self._slots:
                if st is not None and not st.future.done():
                    st.future.set_exception(RuntimeError("decoder stopped"))

    def drain(self, timeout_s: float = 20.0) -> bool:
        """Bounded wait for the pending queues and every lane to empty."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._cond:
            while (self._total_pending()
                   or any(st is not None for st in self._slots)) \
                    and self._dead is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return self._dead is None

    # -- scheduler internals (call under self._cond) ----------------------
    def _total_pending(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def _shed_for(self, cls: SLOClass) -> Optional[_PendingReq]:
        """Pop the youngest pending request of the LOWEST class strictly
        below cls; None when nothing outranks-and-yields."""
        for c in reversed(self._classes):
            if c.priority <= cls.priority:
                break
            q = self._pending[c.name]
            if q:
                return q.pop()
        return None

    def _release_lane(self, i: int) -> None:
        lane = self._slots[i]
        if lane is None:
            return
        for b in lane.blocks:
            self._blocks.decref(b)
        self._tables[i, :] = 0
        self._slots[i] = None
        self._gens[i] = None
        self.stats.set_kv_blocks(self._blocks.in_use, self.n_blocks)

    def _youngest_active(self) -> Optional[int]:
        best, best_seq = None, -1
        for i, st in enumerate(self._slots):
            if st is not None and st.admit_seq > best_seq:
                best, best_seq = i, st.admit_seq
        return best

    def _preempt(self, i: int) -> None:
        """Free lane i's blocks and re-queue the request at the FRONT of
        its class with prompt := window + generated and its generator, so
        the resumed stream continues where it stopped (prefill recomputes
        the generated prefix's KV)."""
        lane = self._slots[i]
        prompt = np.concatenate(
            [lane.window, np.asarray(lane.tokens, np.int32)])
        self._seq += 1
        req = _PendingReq(prompt, lane.remaining, lane.temperature,
                          lane.seed, lane.deadline, lane.slo,
                          lane.on_token, self._seq, future=lane.future,
                          tokens=lane.tokens, gen=self._gens[i],
                          enqueued=lane.enqueued)
        self._release_lane(i)
        self._pending[lane.slo].appendleft(req)
        self.stats.record_preemption()
        self.stats.set_queue_depth(self._total_pending())

    def _grow(self, i: int) -> bool:
        """Ensure lane i's write block for position pos is allocated;
        preempts the youngest admission (possibly lane i itself) on
        exhaustion. Returns False iff lane i was preempted."""
        lane = self._slots[i]
        while int(self._pos[i]) // self.block_tokens >= lane.n_table:
            b = self._blocks.alloc()
            if b is None:
                self._prefix.reclaim(1)
                b = self._blocks.alloc()
            if b is None:
                j = self._youngest_active()
                self._preempt(j)
                if j == i:
                    return False
                continue
            lane.blocks.append(b)
            self._tables[i, lane.n_table] = b
            lane.n_table += 1
        self.stats.set_kv_blocks(self._blocks.in_use, self.n_blocks)
        return True

    def _pick_admission(self):
        """Pop the single next admissible request (highest SLO class
        first, FIFO within a class) and book its lane; None when nothing
        is admissible — including a head request the arena cannot fund
        right now (lower classes must not starve a blocked high class)."""
        free = next((i for i in range(self.lanes)
                     if self._slots[i] is None), None)
        if free is None:
            return None
        for c in self._classes:
            q = self._pending[c.name]
            if not q:
                continue
            req = q.popleft()
            booked = self._admit_bookkeeping(free, req)
            if booked is None:
                q.appendleft(req)
                return None
            self.stats.set_queue_depth(self._total_pending())
            return (free,) + booked
        return None

    def _admit_bookkeeping(self, i: int, req: _PendingReq):
        """Host-side admission under the lock: prefix lookup, block
        allocation, table setup. Returns (buf, write_table, inserts) for
        the device prefill (run OUTSIDE the lock), or None when the arena
        cannot fund the prompt right now."""
        cfg = self.cfg
        bt = self.block_tokens
        keep = min(req.prompt.size, cfg.max_len - req.n_new)
        window = np.ascontiguousarray(req.prompt[req.prompt.size - keep:])
        wb0 = (keep - 1) // bt        # first write block: always private
        nb_prompt = wb0 + 1
        hashes = PrefixCache.chain_hashes(window, bt, wb0)
        hits = self._prefix.lookup(hashes)
        if hashes:
            self.stats.record_prefix(len(hits), len(hashes))
        need = nb_prompt - len(hits)
        if self._blocks.free_count < need:
            self._prefix.reclaim(need - self._blocks.free_count)
        if self._blocks.free_count < need:
            return None
        for b in hits:
            self._blocks.incref(b)
        fresh = [self._blocks.alloc() for _ in range(need)]
        read_table = np.zeros((self.table_width,), np.int32)
        write_table = np.zeros((self.table_width,), np.int32)
        read_table[:len(hits)] = hits
        read_table[len(hits):nb_prompt] = fresh
        write_table[len(hits):nb_prompt] = fresh
        # cache candidates: private FULL blocks strictly below the write
        # block — fully prompt-covered and never written again
        inserts = [(hashes[j], int(read_table[j]))
                   for j in range(len(hits), wb0)]
        width = min(max(bucket_size(keep), keep), cfg.max_len)
        buf = np.zeros((1, width), np.int32)
        buf[0, :keep] = window
        self._tok[i] = int(window[-1])
        self._pos[i] = keep - 1  # re-consume the last prompt token
        self._temps[i] = req.temperature
        # the request's own sampling stream, seeded from its seed (a
        # preempted request brings the one it was drawing from)
        self._gens[i] = (req.gen if req.gen is not None else torch.Generator(
            device=self.device).manual_seed(req.seed))
        self._tables[i, :] = read_table
        self._admit_seq += 1
        self._slots[i] = _Lane(req, hits + fresh, nb_prompt, window,
                               self._admit_seq)
        self.stats.set_kv_blocks(self._blocks.in_use, self.n_blocks)
        return buf, write_table, inserts

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- worker side ------------------------------------------------------
    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._run_inner()
        except Exception as e:  # noqa: BLE001 — worker loop boundary
            with self._cond:
                self._dead = f"{type(e).__name__}: {e}"
                victims = [st for st in self._slots if st is not None]
                for i in range(self.lanes):
                    self._release_lane(i)
                for q in self._pending.values():
                    victims.extend(q)
                    q.clear()
                self.stats.set_queue_depth(0)
                self._cond.notify_all()
            self.stats.record_worker_death()
            err = WorkerDeadError(f"decoder worker died: {self._dead}")
            for v in victims:
                if not v.future.done():
                    v.future.set_exception(err)

    def _fail_active_lanes(self, exc: Exception) -> None:
        """Pool-wide device failure (one tick covers every lane): fail
        each active future with the real cause, return the blocks, keep
        the decoder alive for fresh traffic."""
        with self._cond:
            victims = [st for st in self._slots if st is not None]
            for i in range(self.lanes):
                self._release_lane(i)
            self._reset_arena()
            self._tables[:, :] = 0
            self._cond.notify_all()
        for st in victims:
            if not st.future.done():
                st.future.set_exception(exc)

    def _expire(self) -> None:
        """Fail lanes and queued requests past their deadline (504)."""
        with self._cond:
            now = time.monotonic()
            for i in range(self.lanes):
                st = self._slots[i]
                if st is not None and st.deadline < now:
                    if not st.future.done():
                        self.stats.record_timeout()
                        st.future.set_exception(RequestTimeoutError(
                            "generation exceeded its deadline"))
                    self._release_lane(i)
            for name, q in self._pending.items():
                alive = deque()
                for req in q:
                    if req.deadline < now and not req.future.done():
                        self.stats.record_timeout()
                        req.future.set_exception(RequestTimeoutError(
                            "generation request expired in queue"))
                    else:
                        alive.append(req)
                self._pending[name] = alive

    def _run_inner(self) -> None:
        while True:
            self._expire()
            # admission: ONE request per pick so a request admitted later
            # in the same pass can hit the prefix blocks an earlier
            # prefill just cached — inserts land only after the block
            # content is written (a crashed prefill never publishes)
            while True:
                with self._cond:
                    picked = self._pick_admission()
                if picked is None:
                    break
                i, buf, write_table, inserts = picked
                t0 = time.perf_counter()
                try:
                    paged_admit(self._params, self._arena,
                                self._to_device(buf),
                                self._to_device(write_table), self.cfg)
                except Exception as e:  # noqa: BLE001 — lane isolation boundary
                    # a crashed admission evicts ONLY its own lane; it
                    # wrote (at most) trash + this lane's private blocks,
                    # so co-residents' tokens are untouched
                    with self._cond:
                        st = self._slots[i]
                        self._release_lane(i)
                        self._cond.notify_all()
                    if st is not None and not st.future.done():
                        st.future.set_exception(e)
                    self.stats.record_slot_crash()
                else:
                    self.admissions += 1
                    self.admit_seconds += time.perf_counter() - t0
                    with self._cond:
                        for digest, block in inserts:
                            self._prefix.insert(digest, block)
            if not self._tick_phase():
                return

    def _tick_phase(self) -> bool:
        """One scheduling decision + device tick + host unpack. Returns
        False only when the worker should exit (stopped and idle)."""
        with self._cond:
            self.stats.set_queue_depth(self._total_pending())
            active = [i for i in range(self.lanes)
                      if self._slots[i] is not None]
            self.peak_active = max(self.peak_active, len(active))
            if not active:
                if not self._running:
                    return False
                self._cond.wait()
                return True
            for i in range(self.lanes):
                if self._slots[i] is not None:
                    self._grow(i)
            active = [i for i in range(self.lanes)
                      if self._slots[i] is not None]
            tok, pos = self._tok.copy(), self._pos.copy()
            tables = self._tables.copy()
            # idle lanes are greedy: they draw nothing from any stream
            temps = [float(self._temps[i]) if i in active else 0.0
                     for i in range(self.lanes)]
            gens = list(self._gens)
        if not active:
            return True
        # one fixed-shape device tick for the whole pool, no lock held
        t0 = time.perf_counter()
        try:
            _, logits = paged_decode_step(
                self._params, self._arena, self._to_device(tok),
                self._to_device(pos), self._to_device(tables), self.cfg)
            nxt = _sample_step(logits, temps, gens).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — device boundary
            self._fail_active_lanes(e)
            return True
        self.decode_ticks += 1
        self.tick_seconds += time.perf_counter() - t0
        callbacks = []
        completions = []
        with self._cond:
            for i in active:
                st = self._slots[i]
                if st is None:
                    continue
                t = int(nxt[i])
                st.tokens.append(t)
                self._tok[i] = t
                self._pos[i] += 1
                st.remaining -= 1
                self.stats.record_tokens(1)
                if st.on_token is not None:
                    callbacks.append((st.on_token, t))
                if (st.remaining <= 0
                        or self._pos[i] >= self.cfg.max_len - 1):
                    completions.append(st)
                    self._release_lane(i)
            self._cond.notify_all()  # drain() waiters see evictions
        # stream callbacks BEFORE resolving futures (a client iterating
        # tokens must see the last token before done), outside the lock
        for cb, t in callbacks:
            try:
                cb(t)
            except Exception:  # noqa: BLE001 — client callback boundary
                pass
        for st in completions:
            if not st.future.done():
                st.future.set_result(np.asarray(st.tokens, np.int32))
                self.stats.record_latency(time.monotonic() - st.enqueued)
        return True
