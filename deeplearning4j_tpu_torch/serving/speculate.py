"""Self-speculative decode over the paged pool (counterpart:
``deeplearning4j_tpu/serving/speculate.py`` — ``_verify_for`` :89 and
``SpeculativeDecoder`` :129-303).

A cheap draft proposes k tokens per lane and the target scores the k+1
positions in one round; greedy acceptance (the longest proposal prefix
equal to the target's own argmax, then the target's first correction)
commits 1..k+1 tokens that are exactly what target-only greedy decode
would commit. The draft changes how many rounds a transcript costs,
never its content. The drafts come from the target itself
(``ops/lowprec.draft_lm``: ``int8`` or ``layers:m``), one per record
(``ModelRecord.draft_net``).

A round (``pos`` is each lane's next consume position):

  * the draft runs k+1 steps of the fixed-slot tick
    (``serving/decode._tick_for``) on its own dense cache, one stripe per
    lane: consuming t0@p, d1@(p+1) .. dk@(p+k) proposes d1 .. d_{k+1};
    d_{k+1} is dropped, but its step writes the draft's KV at p+k, which
    a fully accepted round needs next round;
  * the target verifies [t0, d1 .. dk] at p .. p+k by k+1 calls of
    ``paged_decode_step`` at the tick's shape [S] (K6 in every layer of
    every call), taking the argmax at each: the arithmetic of k+1 greedy
    k = 1 ticks, so the acceptance is exact on the card too (a batched
    [S, k+1] forward would run GEMMs of other shapes);
  * the proposals are compared with the argmax on the host after the
    verify, and the commit goes through the per-token bookkeeping,
    streaming callbacks and eviction of a k = 1 tick.

The rejected suffix costs nothing to roll back: the verify wrote target
KV at p .. p+k, in place, and every position at or beyond the new consume
position is overwritten by a later step before its layer attends; K6
reads only t <= pos. Every lane's table is grown k positions ahead before
the verify and is constant through it. The draft cache's stale suffix is
the same case.

A round runs only when no prompt waits, every active lane is greedy,
every lane has k+1 tokens of budget and of max_len left, and the arena
can fund every lane's k-position lookahead without preempting, all
decided per iteration; otherwise the pool runs the base tick, so
preemptions fall where target-only decode has them.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.serving import decode
from deeplearning4j_tpu_torch.serving import paged
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder

def _verify_for(cfg: TransformerConfig, k: int):
    """The target's verify: toks [S, k+1] (the last committed token, then
    the k proposals), pos [S] int32 (the first consume position), tables
    [S, m] int32 -> (arena, greedy argmax [S, k+1] int64 on the device).
    Step j is ``paged_decode_step`` at pos + j, the k = 1 tick's body."""
    def verify(params, arena, toks, pos, tables):
        greedy = []
        for j in range(k + 1):
            arena, logits = paged.paged_decode_step(
                params, arena, toks[:, j], pos + j, tables, cfg)
            greedy.append(torch.argmax(logits, dim=-1))
        return arena, torch.stack(greedy, dim=1)

    return verify


class SpeculativeDecoder(PagedDecoder):
    """A ``PagedDecoder`` that runs a draft-then-verify round whenever the
    pool is eligible (see the module docstring); submit / generate /
    drain / stop, SLO classes, the prefix cache, preemption and crash
    isolation are the base pool's.

    ``draft``: a TransformerLM on the target's device with the target's
    vocab and max_len (``ops/lowprec.draft_lm``). ``spec_k``: proposals
    per round (default ``DL4J_TPU_SERVE_SPEC_K``). ``spec_chaos``
    (``resilience/chaos.SpecChaos``) corrupts proposals at comparison
    time, after the verify ran on the true ones."""

    def __init__(self, lm, *, draft, spec_k: Optional[int] = None,
                 spec_chaos=None, **kw) -> None:
        if draft is None:
            raise ValueError("SpeculativeDecoder needs a draft model "
                             "(ops/lowprec.draft_lm or record.draft_net)")
        dcfg, cfg = draft.cfg, lm.cfg
        if (dcfg.vocab_size != cfg.vocab_size
                or dcfg.max_len != cfg.max_len):
            raise ValueError(
                f"draft config (V={dcfg.vocab_size}, T={dcfg.max_len}) "
                f"must match target (V={cfg.vocab_size}, T={cfg.max_len})")
        if draft.device != lm.device:
            raise ValueError(f"draft lives on {draft.device}, target on "
                             f"{lm.device}")
        self._draft = draft
        self._draft_cfg = dcfg
        self.spec_k = max(1, int(
            spec_k if spec_k is not None
            else envknob.get_int("DL4J_TPU_SERVE_SPEC_K")))
        self._spec_chaos = spec_chaos
        self.spec_rounds = 0
        self.spec_seconds = 0.0  # host wall of the rounds' device work
        # the base constructor ends by starting the worker
        # (_start_worker below), so every field it reads exists by here
        super().__init__(lm, **kw)

    def _start_worker(self) -> None:
        # the draft's dense fixed-slot cache, one stripe per lane
        dcfg = self._draft_cfg
        hd = dcfg.d_model // dcfg.n_heads
        shape = (dcfg.n_layers, self.lanes, dcfg.max_len, dcfg.n_heads, hd)
        with torch.inference_mode():
            self._draft_cache = {
                "k": torch.zeros(shape, dtype=dcfg.compute_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=dcfg.compute_dtype,
                                 device=self.device)}
        # greedy draws nothing: zero temperatures, no generators
        self._zero_temps = [0.0] * self.lanes
        self._no_gens = [None] * self.lanes
        super()._start_worker()

    def _admit_prefill(self, i: int, buf: np.ndarray, width: int,
                       write_table: np.ndarray) -> None:
        # the target's prefill, then the draft's stripe: a failure of
        # either evicts exactly this lane, like any admission crash
        super()._admit_prefill(i, buf, width, write_table)
        decode.slot_admit(self._draft.compute_params, self._draft_cache,
                          self._to_device(buf), i, self._draft_cfg)

    def _tick_phase(self) -> bool:
        k = self.spec_k
        with self._cond:
            active = [i for i in range(self.lanes)
                      if self._slots[i] is not None]
            # decided per iteration: a waiting prompt must not wait out a
            # round, acceptance is exact only for greedy lanes, and a lane
            # must absorb a k+1-token commit inside its budget and max_len
            eligible = bool(active) and not self._total_pending()
            if eligible:
                for i in active:
                    st = self._slots[i]
                    if (st.temperature > 0.0
                            or st.remaining < k + 1
                            or int(self._pos[i]) + k + 1
                            > self.cfg.max_len - 1):
                        eligible = False
                        break
            # a round whose growth would preempt runs the base tick
            # instead, which preempts where target-only decode would
            if eligible and not self._can_fund(k):
                eligible = False
            if eligible:
                # the verify writes pos .. pos+k: grow k ahead; growth
                # that preempts (re-queueing work) voids the round
                for i in range(self.lanes):
                    if self._slots[i] is not None:
                        self._grow(i, lookahead=k)
                active = [i for i in range(self.lanes)
                          if self._slots[i] is not None]
                if not active or self._total_pending():
                    eligible = False
            if eligible:
                tok, pos = self._tok.copy(), self._pos.copy()
                tables = self._tables.copy()
        if not eligible:
            return super()._tick_phase()
        self.peak_active = max(self.peak_active, len(active))
        t0 = time.perf_counter()
        try:
            # the round's serve.batch span (JAX speculate.py:232)
            with obs_trace.span("serve.batch", kind="decode.spec",
                                lanes=len(active), spec_k=k):
                tok_d, pos_d = self._to_device(tok), self._to_device(pos)
                _, dtoks = decode._tick_for(self._draft_cfg, k + 1)(
                    self._draft.compute_params, self._draft_cache, tok_d,
                    pos_d, self._zero_temps, self._no_gens)
                toks = torch.cat([tok_d.long()[:, None], dtoks[:, :k]],
                                 dim=1)
                _, greedy = _verify_for(self.cfg, k)(
                    self.lm.compute_params, self._arena, toks, pos_d,
                    self._to_device(tables))
                dtoks = dtoks.cpu().numpy()            # [lanes, k+1]
                greedy = greedy.cpu().numpy()          # [lanes, k+1]
        except Exception as e:  # noqa: BLE001 — device boundary
            self._fail_active_lanes(e)
            return True
        self.spec_seconds += time.perf_counter() - t0
        # two dispatches a round (draft and verify); decode_tokens counts
        # what committed
        self.dispatch_stats.decode_ticks += 2
        rnd = self.spec_rounds
        self.spec_rounds += 1
        callbacks = []
        completions = []
        committed = 0
        with self._cond:
            for i in active:
                st = self._slots[i]
                if st is None:
                    continue
                d = dtoks[i, :k]
                g = greedy[i]
                if self._spec_chaos is not None:
                    d = self._spec_chaos.corrupt(rnd, d, g,
                                                 self.cfg.vocab_size)
                a = 0
                while a < k and int(d[a]) == int(g[a]):
                    a += 1
                # the accepted prefix and the target's own correction:
                # 1..k+1 tokens, all of the target's greedy stream
                commit = [int(d[j]) for j in range(a)] + [int(g[a])]
                self.stats.record_draft(k, a)
                committed += len(commit)
                for t in commit:
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
            self._cond.notify_all()
        self.dispatch_stats.decode_tokens += committed
        # as the base tick: callbacks before futures, outside the lock
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
