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

Decode planes (the JAX package's, carried over):

  * k-step ticks (``DL4J_TPU_SERVE_TICK_K``): ``_paged_tick_for(cfg, k)``
    runs k steps of the k = 1 body, tokens and pos + 1 fed from step to
    step on the device, over tables the worker grew k - 1 positions
    ahead (``_grow(i, lookahead)``) and held constant through the tick.
    The worker drops to k = 1 (never another k) while a prompt waits, a
    lane is within k tokens of its budget or of max_len, or the arena
    cannot fund every lane's lookahead without preempting (k single
    ticks would preempt inside those k steps, and only a k = 1 tick
    preempts where they would). So a k-step tick's tokens are those of k
    single ticks, sampled lanes and preemptions included (each generator
    advances once per token; greedy lanes draw nothing).
    In eager PyTorch a k-step tick launches what k single ticks launch:
    it saves the per-tick bookkeeping and read-backs, not launches.
  * the arena's dtype (``DL4J_TPU_SERVE_KV_DTYPE``): a bf16 arena under
    an f32 model halves a block's bytes, so the auto-sized arena holds
    ~2x the tokens; K6 runs its f32-query, bf16-arena instantiation
    there (the JAX package takes its XLA gather path at that spot).
  * the prefill/decode handoff: :meth:`PagedDecoder.export_prefix` runs
    an admission's prefill and returns a prompt's full blocks below its
    write block with their chained digests; :meth:`import_prefix` queues
    them for the worker, which adopts them between ticks as prefix-cache
    entries (it owns the arena). A later admission of the same window
    hits them, or recomputes the same bytes on any miss.

``chaos`` (``resilience/chaos.ServingChaos``) raises at an admission
before its prefill (JAX ``paged.py:1148-1149``): the crash-eviction path
then evicts that lane alone. Each tick runs inside a ``serve.batch``
span (``kind="decode.paged"``, ``lanes``, ``tick_k``) under
``DL4J_TPU_OBS``. The serving mesh (``serving/mesh.py``) subclasses this
decoder through its hooks: the arena's allocation (``_new_arena``), the
tick builder (``_tick_fn``), the admission (``_admit_prefill``) and the
adoption of handed-off blocks (``_write_blocks``); the dense decoder
computes what it computed before.
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
    prefill_cache,
    refuse_extended,
)
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops import memory as opsmem
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dispatch import DispatchStats, bucket_size
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
    refuse_extended(cfg, "the paged serving tick")
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


def _paged_tick_for(cfg: TransformerConfig, k: int = 1):
    """k decode steps in one tick over the block arena -> (arena, tokens
    [S, k] int64 on the device). Every step is the k = 1 body
    (``paged_decode_step`` then ``_sample_step``), its tokens and pos + 1
    fed to the next step on the device; the tables are constant through
    the tick (the worker grew them k - 1 positions ahead)."""
    def tick(params, arena, tok, pos, tables, temps, gens):
        out = []
        for _ in range(k):
            arena, logits = paged_decode_step(params, arena, tok, pos,
                                              tables, cfg)
            tok = _sample_step(logits, temps, gens)
            pos = pos + 1
            out.append(tok)
        return arena, torch.stack(out, dim=1)

    return tick


def _prefill_blocks(params, window, cfg: TransformerConfig, bt: int):
    """``prefill_cache`` of window [1, width] as blocks: (k, v), each
    [L, max_len // bt, bt, H, hd] in the compute dtype (prefill pads K/V
    to max_len, so the blocks cover every table entry)."""
    m = cfg.max_len // bt
    hd = cfg.d_model // cfg.n_heads
    c1, _ = prefill_cache(params, window, cfg)
    return tuple(c1[name][:, 0].reshape(cfg.n_layers, m, bt, cfg.n_heads,
                                        hd) for name in ("k", "v"))


def paged_admit(params, arena, window, write_table, cfg: TransformerConfig):
    """Admission prefill: window [1, width] int -> arena with the
    prompt's private blocks written in place; write_table sends
    shared-prefix and beyond-prompt entries to trash block 0."""
    blocks = _prefill_blocks(params, window, cfg, arena["k"].shape[2])
    idx = write_table.long()
    for name, b in zip(("k", "v"), blocks):
        arena[name][:, idx] = b.to(arena[name].dtype)
    return arena


def dtype_name(dtype: torch.dtype) -> str:
    """'float32' / 'bfloat16': the names numpy and the JAX package give
    (the handoff's wire format and ``kv_capacity``)."""
    return str(dtype).replace("torch.", "")


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

    def reclaimable(self) -> int:
        """Entries :meth:`reclaim` could evict now (nobody else holds
        their block)."""
        return sum(1 for b in self._map.values() if self._arena.refs[b] == 1)

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
    prefix sharing, per-token ``on_token`` streaming callbacks, k-step
    ticks (``tick_k``, default ``DL4J_TPU_SERVE_TICK_K``), the arena's
    dtype (``DL4J_TPU_SERVE_KV_DTYPE``) and the prefix handoff
    (:meth:`export_prefix`, :meth:`import_prefix`). Runs on ``device``
    (the card unless the caller passes ``device="cpu"``), which must be
    the model's."""

    supports_streaming = True
    # the serving mesh's width (``serving/mesh.py``), and how many devices
    # the arena's head shards spread over (the sizing budget is per device)
    mesh_devices = 1
    arena_devices = 1

    def __init__(self, lm, *, block_tokens: int = 16,
                 n_blocks: Optional[int] = None,
                 lanes: Optional[int] = None, min_lanes: int = 4,
                 stats: Optional[ServingStats] = None,
                 default_timeout_s: float = 300.0,
                 slo_classes: Optional[List[SLOClass]] = None,
                 queue_cap: Optional[int] = None,
                 tick_k: Optional[int] = None,
                 chaos=None, device=None) -> None:
        self.device = resolve_device(device)
        if self.device != lm.device:
            raise ValueError(f"model lives on {lm.device}, decoder asked "
                             f"for {self.device}")
        cfg = lm.cfg
        refuse_extended(cfg, "PagedDecoder")
        self.lm = lm
        self.cfg = cfg
        # resilience/chaos.ServingChaos: a fault per admission (on_admit)
        self._chaos = chaos
        bt = max(1, min(int(block_tokens), cfg.max_len))
        while cfg.max_len % bt:
            bt //= 2
        self.block_tokens = bt
        self.table_width = cfg.max_len // bt
        # the arena's dtype: a bf16 arena halves a block's bytes, so the
        # auto-sized arena holds ~2x the tokens on the same budget
        self.kv_dtype = lowprec.kv_dtype(cfg)
        if n_blocks is None:
            n_blocks = opsmem.kv_arena_blocks(cfg, bt, device=self.device,
                                              params=lm.params,
                                              dtype=self.kv_dtype,
                                              devices=self.arena_devices)
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
        # steady-state decode runs tick_k steps per tick, dropping to 1
        # whenever a prompt waits or a lane nears its budget
        self.tick_k = max(1, int(
            tick_k if tick_k is not None
            else envknob.get_int("DL4J_TPU_SERVE_TICK_K")))
        self.dispatch_stats = DispatchStats()
        # host wall time of the device work, synchronised by each tick's
        # token read-back and each admission's next tick
        self.decode_ticks = 0
        self.tick_seconds = 0.0
        self.admissions = 0
        self.admit_seconds = 0.0
        # handed-off prefix blocks waiting for the worker (it owns the
        # arena, so adoption runs on its thread between ticks)
        self._imports: deque = deque()
        self._ticks: Dict[int, object] = {}
        self._start_worker()

    def _tick_fn(self, k: int):
        """The k-step tick, memoised per k (the worker asks only for 1
        and ``tick_k``)."""
        fn = self._ticks.get(k)
        if fn is None:
            fn = self._ticks[k] = _paged_tick_for(self.cfg, k)
        return fn

    def _start_worker(self) -> None:
        """Start the decode thread (a subclass sets up its own state
        first: ``serving/speculate.py``)."""
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="paged-decoder")
        self._worker.start()

    def _alloc_arena(self, heads: int):
        """A zeroed {k, v} arena of ``heads`` heads: [L, n_blocks + 1,
        block_tokens, heads, hd] each (a mesh shard holds its slice)."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        shape = (cfg.n_layers, self.n_blocks + 1, self.block_tokens,
                 heads, hd)
        # inference tensors: only the worker thread writes them, inside
        # torch.inference_mode()
        with torch.inference_mode():
            return {"k": torch.zeros(shape, dtype=self.kv_dtype,
                                     device=self.device),
                    "v": torch.zeros(shape, dtype=self.kv_dtype,
                                     device=self.device)}

    def _new_arena(self):
        """The decoder's arena (``serving/mesh.py``: its head shards)."""
        return self._alloc_arena(self.cfg.n_heads)

    def _reset_arena(self) -> None:
        """Fresh zeroed arena + allocator + prefix cache (construction and
        the pool-wide failure path)."""
        self._arena = self._new_arena()
        self._blocks = BlockArena(self.n_blocks)
        self._prefix = PrefixCache(self._blocks)
        self.stats.set_kv_blocks(0, self.n_blocks)

    # -- capacity ---------------------------------------------------------
    def kv_capacity(self) -> Dict[str, object]:
        """/models KV report: what the arena can hold, in tokens."""
        with self._cond:
            in_use = self._blocks.in_use
            tokens_in_use = sum(
                int(self._pos[i]) + 1
                for i, st in enumerate(self._slots) if st is not None)
            cached = len(self._prefix)
        return {
            "scheme": "paged",
            "kv_dtype": dtype_name(self.kv_dtype),
            "block_tokens": self.block_tokens,
            "blocks_total": self.n_blocks,
            "blocks_in_use": in_use,
            "capacity_tokens": self.n_blocks * self.block_tokens,
            "tokens_in_use": tokens_in_use,
            "lanes": self.lanes,
            "prefix_blocks_cached": cached,
            "mesh_devices": self.mesh_devices,
        }

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
        # an idle lane decodes token 0 at position 0 into trash, so its
        # k-step positions stay inside the table
        self._tok[i] = 0
        self._pos[i] = 0
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

    def _grow(self, i: int, lookahead: int = 0) -> bool:
        """Ensure lane i's write blocks through position pos + lookahead
        are allocated (a k-step tick writes pos .. pos + k - 1, a verify
        pos .. pos + k); preempts the youngest admission (possibly lane i
        itself) on exhaustion. Returns False iff lane i was preempted."""
        lane = self._slots[i]
        while (int(self._pos[i]) + lookahead) // self.block_tokens \
                >= lane.n_table:
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

    def _can_fund(self, lookahead: int) -> bool:
        """True when every active lane's blocks through pos + lookahead
        can come from the free list and the cache's reclaimable entries,
        with no preemption."""
        need = 0
        for i, st in enumerate(self._slots):
            if st is not None:
                need += max(0, (int(self._pos[i]) + lookahead)
                            // self.block_tokens + 1 - st.n_table)
        free = self._blocks.free_count
        return need <= free or need <= free + self._prefix.reclaimable()

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
        allocation, table setup. Returns (buf, width, write_table,
        inserts) for the device prefill (run OUTSIDE the lock), or None
        when the arena cannot fund the prompt right now."""
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
        # hold the hits BEFORE reclaiming for the rest: a hit held only by
        # the cache is evictable, and reclaim would free it while this
        # lane reads it (and alloc could hand it out again as fresh)
        for b in hits:
            self._blocks.incref(b)
        need = nb_prompt - len(hits)
        if self._blocks.free_count < need:
            self._prefix.reclaim(need - self._blocks.free_count)
        if self._blocks.free_count < need:
            for b in hits:
                self._blocks.decref(b)
            return None
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
        return buf, width, write_table, inserts

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _admit_prefill(self, i: int, buf: np.ndarray, width: int,
                       write_table: np.ndarray) -> None:
        """The admission's device prefill (the lane index rides along so
        a subclass with per-lane state shares the crash-isolation
        boundary: ``serving/speculate.py`` prefills its draft here)."""
        paged_admit(self.lm.compute_params, self._arena, self._to_device(buf),
                    self._to_device(write_table), self.cfg)

    # -- prefill/decode handoff -------------------------------------------
    def export_prefix(self, prompt, n_new: int):
        """The prefill role's half of the handoff: the KV of a prompt's
        full blocks strictly below its write block, computed by the
        admission's prefill at the admission's width, with their chained
        digests (the ones the importer's own admission computes), without
        touching the arena or the worker. Returns (digests, k_blocks,
        v_blocks), the blocks [L, n, bt, H, hd] CPU tensors in the arena
        dtype; n is 0 for a prompt of one block."""
        cfg = self.cfg
        bt = self.block_tokens
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        n_new = int(n_new)
        if n_new < 1 or n_new >= cfg.max_len:
            raise ValueError(f"n_new {n_new} must be in [1, max_len)")
        keep = min(prompt.size, cfg.max_len - n_new)
        window = np.ascontiguousarray(prompt[prompt.size - keep:])
        wb0 = (keep - 1) // bt
        digests = PrefixCache.chain_hashes(window, bt, wb0)
        hd = cfg.d_model // cfg.n_heads
        if wb0 == 0:
            z = torch.zeros((cfg.n_layers, 0, bt, cfg.n_heads, hd),
                            dtype=self.kv_dtype)
            return [], z, z.clone()
        width = min(max(bucket_size(keep), keep), cfg.max_len)
        buf = np.zeros((1, width), np.int32)
        buf[0, :keep] = window
        # the admission's prefill at the admission's width, cast as its
        # write casts: the bytes the importer's own prefill would write
        with torch.inference_mode():
            kb, vb = _prefill_blocks(self.lm.compute_params,
                                     self._to_device(buf), cfg, bt)
            kb, vb = (b[:, :wb0].to(self.kv_dtype).cpu() for b in (kb, vb))
        self.stats.record_prefix_export()
        return digests, kb, vb

    def import_prefix(self, digests, k_blocks, v_blocks,
                      timeout_s: float = 60.0) -> int:
        """The decode role's half: queue handed-off blocks (tensors, or
        f32 numpy arrays) for adoption into the arena and the prefix
        cache by the worker. Returns how many blocks were adopted; an
        already-cached digest or a short free list shrinks the adopted
        run, and the next admission recomputes the rest."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        digests = [bytes(d) for d in digests]
        kb = torch.as_tensor(k_blocks)
        vb = torch.as_tensor(v_blocks)
        expect = (cfg.n_layers, len(digests), self.block_tokens,
                  cfg.n_heads, hd)
        if tuple(kb.shape) != expect or tuple(vb.shape) != expect:
            raise ClientRequestError(
                f"prefix blocks {tuple(kb.shape)}/{tuple(vb.shape)} do not "
                f"match the arena layout {expect}")
        if kb.dtype != self.kv_dtype or vb.dtype != self.kv_dtype:
            raise ClientRequestError(
                f"prefix blocks dtype {dtype_name(kb.dtype)}/"
                f"{dtype_name(vb.dtype)} != arena kv dtype "
                f"{dtype_name(self.kv_dtype)} (mismatched "
                "DL4J_TPU_SERVE_KV_DTYPE across roles)")
        if len(digests) >= self.table_width:
            raise ClientRequestError(
                f"{len(digests)} handed-off blocks >= table width "
                f"{self.table_width}; full blocks strictly below the "
                "write block can never reach it")
        if not digests:
            return 0
        fut = Future()
        with self._cond:
            if not self._running:
                raise RuntimeError("decoder is stopped")
            if self._dead is not None:
                raise WorkerDeadError(
                    f"decoder worker died ({self._dead}); imports would "
                    "queue forever")
            self._imports.append((digests, kb, vb, fut))
            self._cond.notify_all()
        return int(fut.result(timeout=timeout_s))

    def _apply_import(self, digests, kb, vb, fut) -> None:
        """Adopt handed-off blocks (worker thread): the leading run of
        digests the cache lacks goes into fresh blocks, then into the
        cache, which holds their only reference."""
        try:
            with self._cond:
                hits = self._prefix.lookup(digests)
                start = len(hits)
                need = len(digests) - start
                # the matched run stays cached through the reclaim, or
                # the adopted blocks would follow a broken chain
                for b in hits:
                    self._blocks.incref(b)
                if need and self._blocks.free_count < need:
                    self._prefix.reclaim(need - self._blocks.free_count)
                for b in hits:
                    self._blocks.decref(b)
                avail = min(need, self._blocks.free_count)
                fresh = [self._blocks.alloc() for _ in range(avail)]
                self.stats.set_kv_blocks(self._blocks.in_use,
                                         self.n_blocks)
            if not fresh:
                fut.set_result(0)
                return
            try:
                self._write_blocks(fresh, kb[:, start:start + avail],
                                   vb[:, start:start + avail])
            except Exception as e:  # noqa: BLE001 — device boundary
                # the fresh blocks were nobody's: give them back
                with self._cond:
                    for b in fresh:
                        self._blocks.decref(b)
                fut.set_exception(e)
                return
            with self._cond:
                for t, b in enumerate(fresh):
                    self._prefix.insert(digests[start + t], b)
                    # the cache's ref is the only owner; an admission
                    # that cached the digest first makes insert a no-op
                    # and this decref frees the duplicate
                    self._blocks.decref(b)
                self.stats.set_kv_blocks(self._blocks.in_use,
                                         self.n_blocks)
                self.stats.record_prefix_import(avail)
            fut.set_result(avail)
        except Exception as e:  # noqa: BLE001 — import isolation boundary
            if not fut.done():
                fut.set_exception(e)

    def _write_blocks(self, blocks: List[int], kb, vb) -> None:
        """Adopted blocks' K/V ([L, n, bt, H, hd]) into arena blocks
        ``blocks`` (worker thread)."""
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        for name, b in (("k", kb), ("v", vb)):
            self._arena[name][:, ids] = b.to(self.device)

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
                imports = list(self._imports)
                self._imports.clear()
                self.stats.set_queue_depth(0)
                self._cond.notify_all()
            self.stats.record_worker_death()
            err = WorkerDeadError(f"decoder worker died: {self._dead}")
            for item in imports:
                if not item[3].done():
                    item[3].set_exception(err)
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
            # adopt handed-off prefix blocks BEFORE admissions, so a
            # request admitted in this pass hits them
            while True:
                with self._cond:
                    item = self._imports.popleft() if self._imports \
                        else None
                if item is None:
                    break
                self._apply_import(*item)
            # admission: ONE request per pick so a request admitted later
            # in the same pass can hit the prefix blocks an earlier
            # prefill just cached — inserts land only after the block
            # content is written (a crashed prefill never publishes)
            while True:
                with self._cond:
                    picked = self._pick_admission()
                if picked is None:
                    break
                i, buf, width, write_table, inserts = picked
                t0 = time.perf_counter()
                try:
                    if self._chaos is not None:
                        self._chaos.on_admit()
                    self._admit_prefill(i, buf, width, write_table)
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
                # imports wake the worker too
                if not self._imports:
                    self._cond.wait()
                return True
            # adaptive k: a literal drop to 1, never another k, while a
            # prompt waits, a lane is within k tokens of its budget or of
            # max_len, or the lookahead would preempt: every lane ends,
            # and is preempted, where k = 1 would do it
            k = self.tick_k
            if k > 1:
                if self._total_pending():
                    k = 1
                else:
                    for i in active:
                        st = self._slots[i]
                        if (st.remaining < k
                                or int(self._pos[i]) + k
                                > self.cfg.max_len - 1):
                            k = 1
                            break
                if k > 1 and not self._can_fund(k - 1):
                    k = 1
            for i in range(self.lanes):
                if self._slots[i] is not None:
                    self._grow(i, lookahead=k - 1)
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
        # one fixed-shape device tick for the whole pool, no lock held:
        # k steps, tokens [S, k]
        t0 = time.perf_counter()
        try:
            # the tick's serve.batch span (JAX paged.py:1227-1228); the
            # tokens' read-back ends it
            with obs_trace.span("serve.batch", kind="decode.paged",
                                lanes=len(active), tick_k=k):
                _, nxt = self._tick_fn(k)(
                    self.lm.compute_params, self._arena,
                    self._to_device(tok), self._to_device(pos),
                    self._to_device(tables), temps, gens)
                nxt = nxt.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — device boundary
            self._fail_active_lanes(e)
            return True
        self.decode_ticks += 1
        self.tick_seconds += time.perf_counter() - t0
        self.dispatch_stats.decode_ticks += 1
        self.dispatch_stats.decode_tokens += len(active) * k
        callbacks = []
        completions = []
        with self._cond:
            for i in active:
                st = self._slots[i]
                if st is None:
                    continue
                # per-token bookkeeping and callbacks k times, in
                # emission order, as k single ticks would fire them
                for j in range(k):
                    t = int(nxt[i, j])
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
                        break
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
