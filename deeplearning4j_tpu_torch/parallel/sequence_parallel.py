"""Sequence parallelism: ring attention and Ulysses over the ``'seq'``
process group (counterpart: ``deeplearning4j_tpu/parallel/
sequence_parallel.py`` — ``multi_head_attention`` :48,
``_ring_attention_body_flash`` :145, ``ring_attention_sharded`` :207,
``_ulysses_body`` :272, ``ulysses_attention_sharded`` :289 and
``mha_apply`` :318).

Where the JAX functions take a global array and a mesh and run their body
under ``shard_map``, these take each rank's own shard ``[N, T_local, H,
D]`` (and its key-mask shard ``[N, T_local]``) with the group
(``parallel/mesh.py``), and return the rank's output shard. Rank r holds
positions ``r * T_local .. (r + 1) * T_local - 1``.

The ring keeps each rank's Q shard and rotates K/V (and the mask shard
with them) to rank + 1 after every step but the last, so a world of 1
never communicates. Each step's local block product runs through K5
(:func:`ring_flash_step`): the offset ``(my - src) * T_local``
expresses shard-level causality (``T_local * P`` shows every key when the
attention is not causal), and the shards' results combine exactly in log
space through each block's lse; a block with no visible key has lse =
-inf and weighs nothing. The result is exact full attention. The JAX
package's einsum body (``_ring_attention_body`` :84, its
``use_flash=False``) is not carried over: the ring always runs K5 on the
card.

Both bodies are differentiable across processes, as the JAX package's
are under ``jax.grad``: each ring step's backward is K7 (through
:class:`FlashBlockFn`, with the lse cotangent the log-space combination
gives it), and the rotations' backward sends the K/V cotangents back
round the ring (``parallel/mesh.ring_shift``). K, V and the mask travel
as one packed buffer per step, so each step is one P2P pair forward and
one backward whatever order autograd picks; Ulysses sends q, k and v in
one all-to-all. The mask carries no gradient; its 0/1 values are exact
in K's dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.ops.flash_attention import (
    FlashBlockFn,
    FlashFn,
    attention_auto,
    key_keep,
)
from deeplearning4j_tpu_torch.parallel.mesh import all_to_all, ring_shift

RingState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _rows(a):
    """[N, H, Tq] -> [N, Tq, H, 1], to scale an [N, Tq, H, D] tensor."""
    return a.permute(0, 2, 1)[..., None]


# ---------------------------------------------------------------------------
# reference single-device attention
# ---------------------------------------------------------------------------


def multi_head_attention(q, k, v, *, causal: bool = False,
                         q_offset: int = 0, k_offset: int = 0,
                         key_mask=None):
    """q [N, Tq, H, D], k, v [N, Tk, H, D] -> [N, Tq, H, D]: plain softmax
    attention, scores in at least f32. Offsets give the shards' global
    positions for causal masking; key_mask [N, Tk] 0/1 leaves padded keys
    out. A row with no visible key gives 0."""
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d)
    s = s.to(softmax_dtype(s.dtype))
    if causal:
        qi = q_offset + torch.arange(q.shape[1], device=q.device)
        ki = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qi[:, None] >= ki[None, :]), float("-inf"))
    if key_mask is not None:
        s = s.masked_fill(~key_keep(key_mask)[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p,
                    torch.zeros_like(p))
    return torch.einsum("nhqk,nkhd->nqhd", p.to(q.dtype), v)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _rotate(k_blk, v_blk, km_blk, group):
    """K, V and the mask shard to rank + 1 as one buffer (one P2P pair
    forward, one backward); the mask rides in K's dtype."""
    parts = [k_blk.reshape(-1), v_blk.reshape(-1)]
    if km_blk is not None:
        parts.append(km_blk.reshape(-1).to(k_blk.dtype))
    buf = ring_shift(torch.cat(parts), group)
    nk = k_blk.numel()
    k_new = buf[:nk].view(k_blk.shape)
    v_new = buf[nk:2 * nk].view(v_blk.shape)
    km_new = None if km_blk is None else buf[2 * nk:].view(km_blk.shape)
    return k_new, v_new, km_new


def _mask_shard(key_mask):
    """The mask shard before it travels: f32 0/1 (it rotates in K's
    dtype)."""
    return None if key_mask is None else key_keep(key_mask).to(torch.float32)


def ring_flash_init(q) -> RingState:
    """The flash body's accumulators for a Q shard [N, Tq, H, D]: the
    running max M of the blocks' lse, the denominator l and the numerator
    o in M's scale, in at least f32."""
    n, tq, h, d = q.shape
    dt = softmax_dtype(q.dtype)
    return (torch.full((n, h, tq), float("-inf"), dtype=dt, device=q.device),
            torch.zeros((n, h, tq), dtype=dt, device=q.device),
            torch.zeros((n, tq, h, d), dtype=dt, device=q.device))


def ring_flash_step(state: RingState, q, k_blk, v_blk, km_blk=None, *,
                    my: int, src: int, t_local: int, n_dev: int,
                    causal: bool) -> RingState:
    """One step of the flash ring on rank ``my``, holding the K/V (and
    mask) shard of rank ``src``: K5 at offset ``(my - src) * t_local``
    (``t_local * n_dev`` when not causal), then the exact log-space update
    of (M, l, o). The distributed body calls it once per step; it is also
    how one process drives a whole ring over a list of shards."""
    off = (my - src) * t_local if causal else t_local * n_dev
    o_b, lse_b = FlashBlockFn.apply(q, k_blk, v_blk, km_blk, off)
    m, l, o = state
    lse_b = lse_b.to(m.dtype)
    m_new = torch.maximum(m, lse_b)
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    w = torch.exp(lse_b - m_safe)                       # lse -inf -> 0
    l = l * corr + w
    o = o * _rows(corr) + _rows(w) * o_b.to(o.dtype)
    return m_new, l, o


def ring_flash_finish(state: RingState, dtype: torch.dtype):
    """The output shard [N, Tq, H, D] from the accumulators: o / l, and 0
    on rows that saw no visible key (l = 0)."""
    _, l, o = state
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return (o / _rows(denom)).to(dtype)


def _ring_attention_body_flash(q, k, v, key_mask=None, *, causal: bool,
                               t_local: int, group=None):
    """Per-rank flash body: :func:`ring_flash_step` for each shard as it
    arrives, rotating after every step but the last."""
    n_dev, my = dist.get_world_size(group), dist.get_rank(group)
    state = ring_flash_init(q)
    k_blk, v_blk, km_blk = k, v, _mask_shard(key_mask)
    for step in range(n_dev):
        state = ring_flash_step(state, q, k_blk, v_blk, km_blk, my=my,
                                src=(my - step) % n_dev, t_local=t_local,
                                n_dev=n_dev, causal=causal)
        if step < n_dev - 1:
            k_blk, v_blk, km_blk = _rotate(k_blk, v_blk, km_blk, group)
    return ring_flash_finish(state, q.dtype)


def ring_attention_sharded(q, k, v, group=None, *, causal: bool = False,
                           key_mask=None):
    """Exact full attention with the sequence sharded over the group: q,
    k, v this rank's [N, T_local, H, D] shards, key_mask its [N, T_local]
    0/1 shard (rotating with its K/V). Returns this rank's output shard,
    through the flash body (K5 on the card, its plain version on the
    CPU)."""
    t_local = q.shape[1]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    return _ring_attention_body_flash(q, k, v, key_mask, causal=causal,
                                      t_local=t_local, group=group)


# ---------------------------------------------------------------------------
# Ulysses: all-to-all sequence parallelism
# ---------------------------------------------------------------------------


def _ulysses_body(q, k, v, *, causal: bool, group=None):
    """Swap the sharded axis from sequence to heads (each rank then holds
    every position for H/P heads; q, k and v stacked into one
    all-to-all), attend locally through K4
    (:class:`FlashFn`: causal or full attention over all T, its plain
    version on the CPU; the JAX body's einsum materialises the [T, T]
    scores), and swap back."""
    qh, kh, vh = all_to_all(torch.stack((q, k, v)), 3, 2,
                            group).unbind(0)
    att = FlashFn.apply(qh, kh, vh, causal)
    return all_to_all(att, 1, 2, group)


def ulysses_attention_sharded(q, k, v, group=None, *, causal: bool = False):
    """Exact full attention with the sequence sharded over the group, by
    head <-> sequence all-to-alls; H must divide by the world size. q, k,
    v and the result are this rank's [N, T_local, H, D] shards."""
    world = dist.get_world_size(group)
    if q.shape[2] % world:
        raise ValueError(f"num heads {q.shape[2]} not divisible by {world} "
                         "ranks (Ulysses shards heads; use ring attention "
                         "instead)")
    return _ulysses_body(q, k, v, causal=causal, group=group)


# ---------------------------------------------------------------------------
# the MultiHeadAttention layer's math
# ---------------------------------------------------------------------------


def mha_apply(params, x, num_heads: int, *, causal: bool = False,
              group=None, key_mask=None):
    """x [N, T, F] -> [N, T, F]: q/k/v projections, attention and the
    output projection. With a group, x is this rank's sequence shard and
    the attention is the ring; without one, :func:`attention_auto` (K5
    for a key mask, K4 without)."""
    n, t, _ = x.shape
    proj = params["Wq"].shape[1]
    head_dim = proj // num_heads

    def split(w):
        return (x @ w).reshape(n, t, num_heads, head_dim)

    q, k, v = split(params["Wq"]), split(params["Wk"]), split(params["Wv"])
    if group is not None:
        att = ring_attention_sharded(q, k, v, group, causal=causal,
                                     key_mask=key_mask)
    else:
        att = attention_auto(q, k, v, causal=causal, key_mask=key_mask)
    return att.reshape(n, t, proj) @ params["Wo"]
