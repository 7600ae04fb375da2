"""The fixed-slot ``/generate`` pool and the per-lane sampler
(counterpart: ``deeplearning4j_tpu/serving/decode.py`` —
``decode_step_slots`` :62, ``_sample_step`` :119, ``_tick_for`` :133,
``_admit_for`` :171 as ``slot_admit``, and ``ContinuousDecoder`` :217).

``ContinuousDecoder`` is the pool behind ``DL4J_TPU_SERVE_KV_BLOCK=0``:
each slot holds one sequence's KV stripe of ``max_len`` positions in a
dense ``[L, slots, max_len, H, hd]`` cache. A finished sequence is evicted
at a tick boundary and a queued prompt is admitted into the freed slot
by a prefill (``prefill_cache``: K4 on the card) that writes only that
slot's stripe. The tick always runs every slot, so a sequence's tokens do
not depend on the sequences beside it.

The tick's attention over the dense cache is plain PyTorch, as it is an
XLA einsum (no Pallas kernel) in the JAX package. It is the arithmetic of
the paged pool's gather (``ops/paged_attention.paged_attention_plain``:
the same f32 einsums, mask and softmax over the same ``max_len`` window),
so on the CPU the two pools give the same greedy tokens.

k-step ticks (``DL4J_TPU_SERVE_TICK_K``): ``_tick_for(cfg, k)`` runs k
steps of the k = 1 body back to back, each step's tokens fed to the next
on the device, and reads the [S, k] tokens back once. The worker drops to
k = 1 (never to another k) whenever a prompt waits or a slot is within k
tokens of its budget or of ``max_len``, so scheduling stays per token and
a k-step tick's tokens are those of k single ticks. In eager PyTorch a
k-step tick launches what k single ticks launch; it saves the host's
per-tick bookkeeping and read-backs, not launches.

Sampling: greedy lanes (temperature <= 0) take the argmax and draw
nothing. A sampled lane draws ``argmax(logits / T + Gumbel noise)``, its
uniforms from the request's own ``torch.Generator``, seeded from the
request's seed and advanced once per generated token. So a request's
tokens do not depend on the lanes beside it, and a preempted request
goes on with the same stream. The bits differ from ``jax.random``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

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
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dispatch import DispatchStats, bucket_size
from deeplearning4j_tpu_torch.serving.batcher import RequestTimeoutError
from deeplearning4j_tpu_torch.serving.resilience import WorkerDeadError
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats


def _sample_step(logits: torch.Tensor, temps: Sequence[float],
                 gens: Sequence[Optional[torch.Generator]]) -> torch.Tensor:
    """logits [S, V] f32; temps [S] (host floats); gens [S] generators
    (used only where temps > 0) -> next tokens [S] int64 on the device."""
    nxt = torch.argmax(logits, dim=-1)
    lanes = [i for i, t in enumerate(temps) if t > 0]
    if lanes:
        v = logits.shape[1]
        u = torch.stack([torch.rand((v,), generator=gens[i],
                                    device=logits.device) for i in lanes])
        gumbel = -torch.log(-torch.log(u))
        t = torch.tensor([max(float(temps[i]), 1e-6) for i in lanes],
                         dtype=logits.dtype, device=logits.device)
        idx = torch.tensor(lanes, dtype=torch.long, device=logits.device)
        nxt[idx] = torch.argmax(logits[idx] / t[:, None] + gumbel, dim=-1)
    return nxt


def slot_attention(q, ck, cv, pos):
    """q [S, H, hd], ck/cv [S, T, H, hd] (each slot's dense stripe), pos
    [S] -> att [S, H, hd] f32: token t of slot s is visible iff t <=
    pos[s]. The einsums, mask and softmax of ``paged_attention_plain``
    on its gathered window, in the same order."""
    s, h, hd = q.shape
    t_total = ck.shape[1]
    sc = torch.einsum("nhd,nthd->nht", q.float(), ck.float()) \
        * (1.0 / hd ** 0.5)
    t_idx = torch.arange(t_total, device=q.device)
    visible = t_idx[None, :] <= pos.long()[:, None]              # [S, T]
    sc = sc.masked_fill(~visible[:, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("nht,nthd->nhd", p, cv.float())


def decode_step_slots(params, cache, tok, pos, cfg: TransformerConfig):
    """One decode step with per-slot positions: tok [S] int, pos [S]
    int -> (cache, logits [S, V] f32). Each slot's new K/V goes to
    ``cache[:, s, pos[s]]`` (in place) before its attention reads the
    stripe."""
    refuse_extended(cfg, "decode_step_slots")
    cdt = cfg.compute_dtype
    s = tok.shape[0]
    heads = cfg.n_heads
    hd = cfg.d_model // heads
    pl = pos.long()
    h = (params["embed"][tok.long()] + params["pos"][pl])[:, None, :]
    h = h.to(cdt)
    rows = torch.arange(s, device=h.device)
    for layer in range(cfg.n_layers):
        ck, cv = cache["k"][layer], cache["v"][layer]

        def attend(q, k, v, ck=ck, cv=cv):
            ck[rows, pl] = k.reshape(s, heads, hd).to(ck.dtype)
            cv[rows, pl] = v.reshape(s, heads, hd).to(cv.dtype)
            att = slot_attention(q.reshape(s, heads, hd), ck, cv, pos)
            return att.reshape(s, 1, cfg.d_model).to(cdt)

        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    h = _ln(h[:, 0].float(), params["lnf_g"], params["lnf_b"])
    return cache, h @ params["embed"].T


def _tick_for(cfg: TransformerConfig, k: int = 1):
    """k decode steps in one tick -> (cache, tokens [S, k] int64 on the
    device). Every step is the k = 1 body (``decode_step_slots`` then
    ``_sample_step``), its tokens and pos + 1 fed to the next step on the
    device."""
    def tick(params, cache, tok, pos, temps, gens):
        out = []
        for _ in range(k):
            cache, logits = decode_step_slots(params, cache, tok, pos, cfg)
            tok = _sample_step(logits, temps, gens)
            pos = pos + 1
            out.append(tok)
        return cache, torch.stack(out, dim=1)

    return tick


def slot_admit(params, cache, window, slot: int, cfg: TransformerConfig):
    """Admission prefill (the JAX package's ``_admit_for`` program):
    window [1, width] int -> the prompt's K/V written into ``slot``'s
    stripe in place (``prefill_cache`` pads it to max_len with zeros)."""
    c1, _ = prefill_cache(params, window, cfg)
    for name in ("k", "v"):
        cache[name][:, slot] = c1[name][:, 0].to(cache[name].dtype)
    return cache


class _Slot:
    __slots__ = ("future", "tokens", "remaining", "deadline", "enqueued")

    def __init__(self, future: Future, remaining: int, deadline: float,
                 enqueued: float) -> None:
        self.future = future
        self.tokens: list = []
        self.remaining = remaining
        self.deadline = deadline
        self.enqueued = enqueued


class _PendingGen:
    __slots__ = ("prompt", "n_new", "temperature", "seed", "future",
                 "deadline", "enqueued")

    def __init__(self, prompt, n_new, temperature, seed, deadline) -> None:
        self.prompt = prompt
        self.n_new = n_new
        self.temperature = temperature
        self.seed = seed
        self.future: Future = Future()
        self.deadline = deadline
        self.enqueued = time.monotonic()


class ContinuousDecoder:
    """The fixed-slot ``/generate`` pool over a TransformerLM: submit /
    generate / drain / stop, FIFO admission, crash isolation (a failed
    admission fails its own request; a failed tick fails the active
    slots and the decoder keeps serving), and a dead worker failing
    every waiting request. Per request: ``temperature`` (<= 0 greedy)
    and ``seed`` (its own sampling stream). Runs on ``device`` (the card
    unless the caller passes ``device="cpu"``), which must be the
    model's."""

    supports_streaming = False

    def __init__(self, lm, slots: int = 4,
                 stats: Optional[ServingStats] = None,
                 default_timeout_s: float = 300.0,
                 tick_k: Optional[int] = None, chaos=None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if self.device != lm.device:
            raise ValueError(f"model lives on {lm.device}, decoder asked "
                             f"for {self.device}")
        cfg = lm.cfg
        self.lm = lm
        self.cfg = cfg
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.stats = stats if stats is not None else ServingStats()
        self.default_timeout_s = float(default_timeout_s)
        # resilience/chaos.ServingChaos: a fault per admission (on_admit,
        # JAX decode.py:263-266), which evicts only its own slot
        self._chaos = chaos
        hd = cfg.d_model // cfg.n_heads
        shape = (cfg.n_layers, self.slots, cfg.max_len, cfg.n_heads, hd)
        # inference tensors: only the worker writes them, in place
        with torch.inference_mode():
            self._cache = {
                "k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=self.device)}
        self._tok = np.zeros((self.slots,), np.int32)
        self._pos = np.zeros((self.slots,), np.int32)
        self._temps = np.ones((self.slots,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = True
        self._dead: Optional[str] = None
        self.peak_active = 0
        # steady-state decode runs tick_k steps per tick, dropping to 1
        # whenever a prompt waits or a slot nears its budget
        self.tick_k = max(1, int(
            tick_k if tick_k is not None
            else envknob.get_int("DL4J_TPU_SERVE_TICK_K")))
        self.dispatch_stats = DispatchStats()
        # host wall of the device work (each tick's read-back syncs it)
        self.decode_ticks = 0
        self.tick_seconds = 0.0
        self.admissions = 0
        self.admit_seconds = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="continuous-decoder")
        self._worker.start()

    def kv_capacity(self) -> Dict[str, object]:
        """/models KV report: every slot holds max_len positions, however
        long its request is."""
        with self._cond:
            active = [int(self._pos[i]) + 1
                      for i, st in enumerate(self._slots) if st is not None]
        return {
            "scheme": "fixed-slot",
            "slots": self.slots,
            "capacity_tokens": self.slots * self.cfg.max_len,
            "tokens_in_use": sum(active),
            "lanes": self.slots,
        }

    # -- client side ------------------------------------------------------
    def submit(self, prompt, n_new: int, temperature: float = 1.0,
               seed: int = 0,
               timeout_s: Optional[float] = None) -> Future:
        """Queue one prompt ([T] int ids) for n_new sampled tokens; returns
        a Future of the [n_new] int32 continuation."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if n_new < 1 or n_new >= self.cfg.max_len:
            raise ValueError(f"n_new {n_new} must be in [1, max_len)")
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.default_timeout_s)
        req = _PendingGen(prompt, int(n_new), float(temperature), int(seed),
                          deadline)
        self.stats.record_request()
        with self._cond:
            if not self._running:
                raise RuntimeError("decoder is stopped")
            if self._dead is not None:
                raise WorkerDeadError(
                    f"decoder worker died ({self._dead}); prompts would "
                    "queue forever")
            self._pending.append(req)
            self.stats.set_queue_depth(len(self._pending))
            self._cond.notify_all()
        return req.future

    def generate(self, prompts, n_new: int, temperature: float = 1.0,
                 seed: int = 0,
                 timeout_s: Optional[float] = None) -> np.ndarray:
        """Batch convenience: [N, T] prompts -> [N, n_new] continuations
        (independent requests; seeds offset per row)."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim == 1:
            prompts = prompts[None]
        futs = [self.submit(row, n_new, temperature=temperature,
                            seed=seed + i, timeout_s=timeout_s)
                for i, row in enumerate(prompts)]
        budget = timeout_s if timeout_s is not None else self.default_timeout_s
        return np.stack([f.result(timeout=budget) for f in futs])

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=10)
        with self._cond:
            for req in list(self._pending):
                if not req.future.done():
                    req.future.set_exception(RuntimeError("decoder stopped"))
            self._pending.clear()
            for st in self._slots:
                if st is not None and not st.future.done():
                    st.future.set_exception(RuntimeError("decoder stopped"))

    def drain(self, timeout_s: float = 20.0) -> bool:
        """Bounded wait for the queue and every slot to empty."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._cond:
            while (self._pending or any(st is not None
                                        for st in self._slots)) \
                    and self._dead is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return self._dead is None

    # -- worker side ------------------------------------------------------
    def _free_slot(self, i: int) -> None:
        """Evict slot i (under the lock). An idle slot decodes token 0 at
        position 0, so its k-step positions stay inside the cache."""
        self._slots[i] = None
        self._gens[i] = None
        self._tok[i] = 0
        self._pos[i] = 0

    def _admit_bookkeeping(self, i: int, req: _PendingGen):
        """Host-side slot setup under the lock; returns the padded window
        the device prefill (run outside the lock) takes."""
        cfg = self.cfg
        keep = min(req.prompt.size, cfg.max_len - req.n_new)
        window = req.prompt[req.prompt.size - keep:]
        width = min(max(bucket_size(keep), keep), cfg.max_len)
        buf = np.zeros((1, width), np.int32)
        buf[0, :keep] = window
        self._tok[i] = int(window[-1])
        self._pos[i] = keep - 1  # re-consume the last prompt token
        self._temps[i] = req.temperature
        self._gens[i] = torch.Generator(device=self.device).manual_seed(
            req.seed)
        self._slots[i] = _Slot(req.future, req.n_new, req.deadline,
                               req.enqueued)
        return buf

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _admit_prefill(self, i: int, buf: np.ndarray) -> None:
        slot_admit(self.lm.compute_params, self._cache, self._to_device(buf),
                   i, self.cfg)

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._run_inner()
        except Exception as e:  # noqa: BLE001 — worker loop boundary
            with self._cond:
                self._dead = f"{type(e).__name__}: {e}"
                victims = [st for st in self._slots if st is not None]
                for i in range(self.slots):
                    self._free_slot(i)
                victims.extend(self._pending)
                self._pending.clear()
                self.stats.set_queue_depth(0)
                self._cond.notify_all()
            self.stats.record_worker_death()
            err = WorkerDeadError(f"decoder worker died: {self._dead}")
            for v in victims:
                if not v.future.done():
                    v.future.set_exception(err)

    def _fail_active_slots(self, exc: Exception) -> None:
        """Pool-wide device failure (one tick covers every slot): fail
        each active future with the real cause and free the pool; the
        decoder stays alive for fresh traffic."""
        with self._cond:
            victims = [st for st in self._slots if st is not None]
            for i in range(self.slots):
                self._free_slot(i)
            self._cond.notify_all()
        for st in victims:
            if not st.future.done():
                st.future.set_exception(exc)

    def _expire(self) -> None:
        """Fail slots and queued requests past their deadline (under the
        lock)."""
        now = time.monotonic()
        for i in range(self.slots):
            st = self._slots[i]
            if st is not None and st.deadline < now:
                if not st.future.done():
                    self.stats.record_timeout()
                    st.future.set_exception(RequestTimeoutError(
                        "generation exceeded its deadline"))
                self._free_slot(i)
        alive = deque()
        for req in self._pending:
            if req.deadline < now and not req.future.done():
                self.stats.record_timeout()
                req.future.set_exception(RequestTimeoutError(
                    "generation request expired in queue"))
            else:
                alive.append(req)
        self._pending = alive

    def _run_inner(self) -> None:
        while True:
            with self._cond:
                self._expire()
                # admission: FIFO prompts into free slots; the device
                # prefills run below, outside the lock
                admits = []
                for i in range(self.slots):
                    if self._slots[i] is None and self._pending:
                        req = self._pending.popleft()
                        admits.append((i, self._admit_bookkeeping(i, req)))
                self.stats.set_queue_depth(len(self._pending))
                active = [i for i in range(self.slots)
                          if self._slots[i] is not None]
                self.peak_active = max(self.peak_active, len(active))
                if not active:
                    if not self._running:
                        return
                    self._cond.wait()
                    continue
                # adaptive k: a literal drop to 1, never another k, while
                # a prompt waits or a slot is within k of its budget or
                # of max_len, so every slot ends where k = 1 would end it
                k = self.tick_k
                if k > 1:
                    if self._pending:
                        k = 1
                    else:
                        for i in active:
                            st = self._slots[i]
                            if (st.remaining < k
                                    or int(self._pos[i]) + k
                                    > self.cfg.max_len - 1):
                                k = 1
                                break
            for i, buf in admits:
                t0 = time.perf_counter()
                try:
                    if self._chaos is not None:
                        self._chaos.on_admit()
                    self._admit_prefill(i, buf)
                except Exception as e:  # noqa: BLE001 — slot isolation boundary
                    # a crashed admission evicts ONLY its own slot: it
                    # wrote (at most) that slot's stripe
                    with self._cond:
                        st = self._slots[i]
                        self._free_slot(i)
                        self._cond.notify_all()
                    if st is not None and not st.future.done():
                        st.future.set_exception(e)
                    self.stats.record_slot_crash()
                    active = [j for j in active if j != i]
                else:
                    self.admissions += 1
                    self.admit_seconds += time.perf_counter() - t0
            if not active:
                continue
            with self._cond:
                tok, pos = self._tok.copy(), self._pos.copy()
                temps = [float(self._temps[i]) if i in active else 0.0
                         for i in range(self.slots)]
                gens = list(self._gens)
            # one fixed-shape tick for the whole pool: k steps, [S, k]
            t0 = time.perf_counter()
            try:
                _, nxt = _tick_for(self.cfg, k)(
                    self.lm.compute_params, self._cache,
                    self._to_device(tok), self._to_device(pos), temps, gens)
                nxt = nxt.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — device boundary
                self._fail_active_slots(e)
                continue
            self.decode_ticks += 1
            self.tick_seconds += time.perf_counter() - t0
            self.dispatch_stats.decode_ticks += 1
            self.dispatch_stats.decode_tokens += len(active) * k
            with self._cond:
                for i in active:
                    st = self._slots[i]
                    if st is None:
                        continue
                    # per-token bookkeeping k times, so a slot ends at
                    # the token it would end at under k = 1
                    for j in range(k):
                        t = int(nxt[i, j])
                        st.tokens.append(t)
                        self._tok[i] = t
                        self._pos[i] += 1
                        st.remaining -= 1
                        self.stats.record_tokens(1)
                        if (st.remaining <= 0
                                or self._pos[i] >= self.cfg.max_len - 1):
                            if not st.future.done():
                                st.future.set_result(
                                    np.asarray(st.tokens, np.int32))
                                self.stats.record_latency(
                                    time.monotonic() - st.enqueued)
                            self._free_slot(i)
                            break
                self._cond.notify_all()  # drain() waiters see evictions
