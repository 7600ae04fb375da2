"""Mixture-of-experts FFN, sharded over an ``'expert'`` group
(counterpart: ``deeplearning4j_tpu/parallel/expert_parallel.py`` —
``init_moe_params`` :146, ``MOE_SPECS`` :164, ``shard_moe_params`` :173,
``_routing`` :180, ``expert_mlp`` :202, ``aux_loss_from_gates`` :212,
``moe_apply`` :227, ``moe_reference`` :257, ``load_balancing_loss``
:272).

The routing is the JAX package's, bit for bit: gates [T, E] softmaxed in
at least f32, the top k by value (ties toward the lower expert index, as
``lax.top_k`` and ``argmax`` break them), the k values renormalized to
sum 1 before any drop; every token's first choice takes its slot before
any token's second, slots fill in token order, and a slot past the
capacity C is dropped (its token's residual carries it).
:func:`_routing` is the JAX function itself (dispatch and combine
[T, E, C]), kept as the equivalence oracle with :func:`expert_mlp`'s
einsum chain.

The FFN computes the same function by index (:func:`moe_ffn`): each
(expert, slot) learns which token fills it, the tokens are gathered into
[E, C, d], the experts run as batched products (``torch.bmm``), and each
token sums its k outputs weighted by its gate values, in choice order.
At the bench MoE size the dense [T, E, C] tensors would be 671 M entries
a layer and their two einsums products of mostly zeros as large as the
experts; the index form moves T * k rows. Gathers run through
:class:`_Dispatch`, whose backward gathers too, so no float sum depends
on the order of atomic adds: two runs give the same bits.

Sharding: a rank holds E/p experts (:data:`MOE_SPECS`, leading expert
dim; under Megatron also d_ff over ``'model'``), computes the routing of
every token (the gates are replicated), runs its own experts' slots and
sums the tokens' outputs over the group (:func:`~.mesh.psum`). Where the
tokens themselves are spread over ``'data'`` or ``'seq'`` ranks
(:class:`RouteGroups`), the slot positions and the load-balance
statistics are those of the whole global batch in the JAX package's
token order, as GSPMD computes them: each rank gathers the others'
per-row counts (integers) and sums the gate means over the groups.

The dropless layer (:func:`moe_ffn_held`) is the Mellum 2 / Qwen-style
expert layer of one rank of an expert-parallel group: the router's
softmax over all E experts in f32, the top k, their weights renormalised
over the k, no capacity; the layer is told which experts it holds
(``W1``'s leading dim from ``expert_offset``) and computes only their
part of the result, SwiGLU experts without biases. On one device it has
no exchange: what absent experts would add is absent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    all_gather_ints,
    copy_to,
    group_size,
    psum,
    psum_transposed,
)

Params = Dict[str, torch.Tensor]

MOE_SPECS = {
    "Wg": (),
    "W1": (EXPERT_AXIS, None, None),
    "b1": (EXPERT_AXIS, None),
    "W2": (EXPERT_AXIS, None, None),
    "b2": (EXPERT_AXIS, None),
}


def init_moe_params(seed: int, d_model: int, d_ff: int, n_experts: int,
                    dtype=torch.float32, device=None) -> Params:
    """Gate and E expert MLPs (leading expert dim on the expert leaves),
    xavier-normal as the JAX package's; drawn from a ``torch.Generator``
    seeded with ``seed`` (the bits differ from ``jax.random``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def xavier(shape, fan_in, fan_out):
        return (torch.randn(shape, generator=gen, device=dev)
                * math.sqrt(2.0 / (fan_in + fan_out))).to(dtype)

    e, d, f = n_experts, d_model, d_ff
    return {
        "Wg": xavier((d, e), d, e),
        "W1": xavier((e, d, f), d, f),
        "b1": torch.zeros((e, f), dtype=dtype, device=dev),
        "W2": xavier((e, f, d), f, d),
        "b2": torch.zeros((e, d), dtype=dtype, device=dev),
    }


def shard(a: torch.Tensor, spec, sizes: Dict[str, int],
          indices: Dict[str, int]) -> torch.Tensor:
    """This rank's slice of ``a`` under ``spec`` (one axis name or None
    per leading dim, the JAX ``PartitionSpec``): each named dim split
    into ``sizes[axis]`` contiguous chunks, chunk ``indices[axis]``."""
    for dim, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n == 1:
            continue
        if a.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {a.shape[dim]} does not "
                             f"split {n} ways over {axis!r}")
        a = a.chunk(n, dim=dim)[indices.get(axis, 0)]
    return a.contiguous()


def shard_moe_params(params: Params, mesh) -> Params:
    """This rank's leaves under :data:`MOE_SPECS` on ``mesh`` (a
    ``MeshGroups``): E/p experts, the gate whole."""
    sizes = {a: mesh.size(a) for a in mesh.axis_names}
    return {k: shard(v, MOE_SPECS[k], sizes, mesh.indices)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) [T, k] of the k largest gates per row, ties to
    the lower index (``lax.top_k``): k rounds of ``argmax`` (which returns
    the first maximum) with the chosen entry masked out."""
    if not 1 <= k <= gates.shape[-1]:
        raise ValueError(f"top_k {k} must be in [1, {gates.shape[-1]}]")
    work = gates.detach()
    idx = []
    for _ in range(k):
        i = torch.argmax(work, dim=-1)
        idx.append(i)
        work = work.scatter(-1, i[:, None], float("-inf"))
    topi = torch.stack(idx, dim=-1)
    return torch.gather(gates, -1, topi), topi


def capacity_of(capacity_factor: float, n_tokens: int, top_k_: int,
                n_experts: int) -> int:
    """``max(1, int(factor * n_tokens * k / E))`` (``moe_apply`` :241)."""
    return max(1, int(capacity_factor * n_tokens * top_k_ / n_experts))


def _routing(gates: torch.Tensor, top_k_: int, capacity: int):
    """gates [T, E] -> (dispatch [T, E, C] 0/1, combine [T, E, C]): the
    JAX package's dense formulation, kept as the oracle of the index
    form."""
    t, e = gates.shape
    topv, topi = top_k(gates, top_k_)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    dispatch = torch.zeros((t, e, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros((e,), dtype=torch.int64, device=gates.device)
    for j in range(top_k_):
        onehot = F.one_hot(topi[:, j], e)
        pos = torch.cumsum(onehot, dim=0) - 1 + prior[None, :]
        prior = prior + onehot.sum(0)
        in_cap = (pos < capacity) & (onehot > 0)
        pos_oh = F.one_hot(torch.clamp(pos, 0, capacity - 1),
                           capacity).to(gates.dtype)
        slot = torch.where(in_cap[..., None], pos_oh,
                           torch.zeros((), dtype=gates.dtype,
                                       device=gates.device))
        dispatch = dispatch + slot
        combine = combine + topv[:, j, None, None] * slot
    return dispatch, combine


def expert_mlp(W1, b1, W2, b2, dispatch, combine, x):
    """The dense dispatch -> per-expert MLP -> combine einsum chain
    (the oracle of :func:`moe_ffn`)."""
    ex_in = torch.einsum("tec,tf->ecf", dispatch, x)
    h = F.gelu(torch.einsum("ecf,efh->ech", ex_in, W1) + b1[:, None, :],
               approximate="tanh")
    out = torch.einsum("ech,ehf->ecf", h, W2) + b2[:, None, :]
    return torch.einsum("tec,ecf->tf", combine, out)


def aux_loss_from_gates(gates: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss from softmax gates [T, E]:
    E * sum_e f_e * P_e (f_e the argmax-count fraction, P_e the mean
    gate)."""
    e = gates.shape[-1]
    hard = F.one_hot(torch.argmax(gates, -1), e).to(gates.dtype)
    return e * torch.sum(hard.mean(0) * gates.mean(0))


@dataclasses.dataclass(frozen=True)
class RouteGroups:
    """Where this rank's tokens sit in the global batch whose routing it
    shares: its ``'data'`` and ``'seq'`` groups and indices (None: the
    axis is absent). The global token order is the JAX package's
    row-major [N, T]: data index, then row, then sequence index, then
    position."""

    data: object = None
    data_index: int = 0
    seq: object = None
    seq_index: int = 0

    @property
    def size(self) -> int:
        return group_size(self.data) * group_size(self.seq)


@dataclasses.dataclass(frozen=True)
class ExpertGroups:
    """The groups an MoE FFN's shards span: ``expert`` (this rank holds
    experts ``index * E/p ..``) and ``model`` (d_ff split, Megatron)."""

    expert: object = None
    expert_index: int = 0
    model: object = None

    @property
    def expert_size(self) -> int:
        return group_size(self.expert)


def _positions(topi: torch.Tensor, n_experts: int, rows: int,
               route: Optional[RouteGroups]) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(pos [T, k] the slot of each (token, choice) in its expert, the
    global per-slot counts [k, E]). The local tokens are ``rows`` equal
    row blocks; with ``route`` every rank's per-row counts are gathered
    and each block's slots start after those of every choice before its
    own and of the blocks before it, in the global token order."""
    t, k = topi.shape
    onehot = F.one_hot(topi, n_experts)                     # [T, k, E]
    blocks = onehot.view(rows, t // rows, k, n_experts)
    within = torch.cumsum(blocks, dim=1) - 1                # [R, t_r, k, E]
    counts = blocks.sum(1)                                  # [R, k, E]
    if route is None:
        allc, mine = counts, torch.arange(rows, device=topi.device)
    else:
        by_seq = all_gather_ints(counts, route.seq)         # [S, R, k, E]
        by_all = all_gather_ints(by_seq, route.data)        # [D, S, R, k, E]
        d, s = by_all.shape[:2]
        allc = by_all.permute(0, 2, 1, 3, 4).reshape(d * rows * s, k,
                                                     n_experts)
        mine = ((route.data_index * rows
                 + torch.arange(rows, device=topi.device)) * s
                + route.seq_index)
    totals = allc.sum(0)                                    # [k, E]
    slot_prior = torch.cumsum(totals, dim=0) - totals       # choices before
    block_prior = torch.cumsum(allc, dim=0) - allc          # blocks before
    prefix = block_prior[mine] + slot_prior[None]           # [R, k, E]
    pos = (within + prefix[:, None]).view(t, k, n_experts)
    pos = torch.gather(pos, -1, topi[..., None])[..., 0]
    return pos, totals


class _Dispatch(torch.autograd.Function):
    """rows = x_pad[index] ([S] indices into [T + 1] rows, T the zero
    row); the backward sums each token's k cotangent rows in choice
    order through ``back`` [T, k] (slot of each (token, choice), S for
    none), so no two adds race."""

    @staticmethod
    def forward(ctx, x, index, back):
        ctx.save_for_backward(back)
        ctx.n_slots = index.shape[0]
        pad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        return pad[index]

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        picked = pad[back]                                  # [T, k, ...]
        out = picked[:, 0]
        for j in range(1, picked.shape[1]):
            out = out + picked[:, j]
        return out, None, None


def moe_ffn(x: torch.Tensor, bp: Params, *, top_k_: int, capacity: int,
            rows: int = 1, route: Optional[RouteGroups] = None,
            shards: Optional[ExpertGroups] = None,
            stats: Optional[dict] = None):
    """The MoE FFN on this rank's tokens x [T, d] (``rows`` equal row
    blocks of the global [N, T] batch): ``bp`` holds ``Wg`` [d, E] (the
    whole gate) and this rank's expert leaves ``W1`` [E_l, d, f_l],
    ``b1``, ``W2``, ``b2``. Returns (y [T, d] in x's dtype, aux): the
    tokens' weighted expert outputs summed over ``shards`` and the
    Switch load-balance loss over the routed batch (``route``). The gate
    softmax runs in at least f32 and the combine weights are cast to x's
    dtype (the JAX package's bf16 cast); each token's k terms are summed
    in f32. ``stats`` (a dict) gets ``dropped`` (slots past the capacity)
    and ``slots`` (T * k)."""
    t, d = x.shape
    shards = shards or ExpertGroups()
    scores = x @ bp["Wg"].to(x.dtype)
    gates = torch.softmax(scores.to(softmax_dtype(scores.dtype)), dim=-1)
    n_experts = gates.shape[-1]
    k = top_k_
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    pos, totals = _positions(topi, n_experts, rows, route)
    valid = pos < capacity
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + (~valid).sum()
        stats["slots"] = stats.get("slots", 0) + t * k
    e_local = bp["W1"].shape[0]
    e0 = shards.expert_index * e_local
    n_slots = e_local * capacity
    local = valid & (topi >= e0) & (topi < e0 + e_local)
    slot = torch.where(local, (topi - e0) * capacity + pos,
                       torch.full_like(pos, n_slots))       # [T, k]
    src = torch.full((n_slots + 1,), t * k, dtype=torch.long,
                     device=x.device)
    src[slot.reshape(-1)] = torch.arange(t * k, device=x.device)
    src = src[:n_slots]                                     # slot -> (t, j)
    token_of = src // k                                     # T where empty
    xe = copy_to(copy_to(x, shards.model), shards.expert)
    xin = _Dispatch.apply(xe, token_of, slot).view(e_local, capacity, d)
    h = F.gelu(torch.bmm(xin, bp["W1"].to(x.dtype))
               + bp["b1"].to(x.dtype)[:, None, :], approximate="tanh")
    out = psum(torch.bmm(h, bp["W2"].to(x.dtype)), shards.model)
    out = out + bp["b2"].to(x.dtype)[:, None, :]
    acc = softmax_dtype(x.dtype)  # bf16 -> f32; f32 and f64 stay
    w = copy_to(topv, shards.expert).to(x.dtype).to(acc)
    w = torch.where(local, w, torch.zeros_like(w))
    picked = _Dispatch.apply(out.view(n_slots, d), slot.reshape(-1),
                             src.view(n_slots, 1)).view(t, k, d)
    y = picked[:, 0].to(acc) * w[:, 0, None]
    for j in range(1, k):
        y = y + picked[:, j].to(acc) * w[:, j, None]
    y = psum(y.to(x.dtype), shards.expert)
    # the load-balance loss over the whole routed batch
    n_all = t * (1 if route is None else route.size)
    p_sum = gates.sum(0)
    if route is not None:
        p_sum = psum_transposed(psum_transposed(p_sum, route.seq),
                                route.data)
    frac = totals[0].to(gates.dtype) / n_all
    aux = n_experts * torch.sum(frac * (p_sum / n_all))
    return y, aux


def in_backward() -> bool:
    """Whether this call runs inside a backward pass (an activation
    checkpoint's recompute): counters and spans are taken once, in the
    forward."""
    return torch._C._current_graph_task_id() != -1


def grouped_products(a: torch.Tensor, b: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` [M, K] in groups times their group's ``b`` [G, K, N]
    -> [M, N]: group e is rows ``ends[e-1]:ends[e]`` (``ends`` [G] the
    groups' cumulative ends, on a's device); rows past ``ends[-1]`` are
    left unspecified. A bf16 product on a card of compute capability 9
    or more is one grouped GEMM that reads the ends on the card
    (``torch._grouped_mm``: no wait for the host); any other is
    :func:`grouped_products_plain`."""
    if (a.is_cuda and a.dtype == torch.bfloat16
            and torch.cuda.get_device_capability(a.device)[0] >= 9):
        return torch._grouped_mm(a, b, offs=ends.to(torch.int32))
    return grouped_products_plain(a, b, ends)


def grouped_products_plain(a: torch.Tensor, b: torch.Tensor,
                           ends: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_products` as one product a group, the ends read on
    the host; rows past the last end zero."""
    parts, start = [], 0
    for e, end in enumerate(ends.tolist()):
        parts.append(a[start:end] @ b[e])
        start = end
    parts.append(a.new_zeros((a.shape[0] - start, b.shape[-1])))
    return torch.cat(parts)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``ids``, on its device without
    a read-back (``torch.bincount`` reads the largest id on the host)."""
    return (ids.reshape(-1, 1) == torch.arange(n, device=ids.device)).sum(0)


def moe_ffn_held(x: torch.Tensor, Wr: torch.Tensor, W1: torch.Tensor,
                 W2: torch.Tensor, *, top_k_: int, expert_offset: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dropless expert layer on tokens x [T, d] -> (y [T, d] in x's
    dtype, aux, rows): ``Wr`` [d, E] the whole router, ``W1`` [E_h, d, 2f]
    (each held expert's gate columns, then its up columns) and ``W2``
    [E_h, f, d] the E_h experts held from ``expert_offset``; ``rows``
    [E_h] (on x's device) the rows each held expert computed.

    - logits = x Wr in at least f32 (``moe`` router), gates = softmax over
      all E; the top k (ties to the lower index) and their weights
      w = g / sum of the k (``norm_topk_prob``); nothing is dropped.
    - each held expert e computes ``(silu(x Wg_e) * (x Wu_e)) Wd_e`` for
      the rows routed to it, in x's dtype; y is the sum over each token's
      choices among the held experts of w (rounded to x's dtype) times
      that, accumulated in at least f32.
    - aux, the Switch load-balance term over all E: E * sum_e f_e P_e (f_e
      the share of tokens whose first choice is e, P_e the mean gate).

    Nothing is read back to the host, and every shape is fixed by T, k
    and the widths: the T k (token, choice) pairs are sorted by held
    expert, the others last, into T k rows, gathered by index
    (:class:`_Dispatch`, whose backward gathers too), the experts run as
    :func:`grouped_products` over the held rows, each token's k rows are
    gathered back (the pairs of experts held elsewhere read a zero row)
    and summed weighted by one batched product [1, k] x [k, d]. No float
    sum depends on the order of atomic adds."""
    t, d = x.shape
    k = top_k_
    acc = softmax_dtype(x.dtype)
    gates = torch.softmax(x.to(acc) @ Wr.to(acc), dim=-1)
    n_experts = gates.shape[-1]
    topv, topi = top_k(gates, k)
    topv = topv / topv.sum(-1, keepdim=True)
    held = W1.shape[0]
    mine = (topi >= expert_offset) & (topi < expert_offset + held)
    expert = torch.where(mine, topi - expert_offset, held).reshape(-1)
    n = t * k
    order = torch.argsort(expert, stable=True)              # row -> pair
    rows = _counts(expert, held)
    computed = torch.arange(n, device=x.device) < rows.sum()
    pair = torch.where(computed, order, n)                  # n: none
    back = torch.full((n + 1,), n, dtype=torch.long, device=x.device)
    back[pair] = torch.arange(n, device=x.device)           # pair -> row
    back = back[:n].view(t, k)
    token = torch.where(computed, order // k, t)            # t: zero row
    xin = _Dispatch.apply(x, token, back)                   # [n, d]
    f = W2.shape[1]
    ends = torch.cumsum(rows, 0)
    gu = grouped_products(xin, W1.to(x.dtype), ends)
    out = grouped_products(F.silu(gu[:, :f]) * gu[:, f:], W2.to(x.dtype),
                           ends)
    picked = _Dispatch.apply(out, back.view(n), pair.view(n, 1))
    w = torch.where(mine, topv, torch.zeros_like(topv)).to(x.dtype)
    y = torch.bmm(w.view(t, 1, k), picked.view(t, k, d)).view(t, d)
    first = _counts(topi[:, 0], n_experts).to(gates.dtype)
    aux = n_experts * torch.sum(first / t * gates.mean(0))
    return y, aux, rows


# ---------------------------------------------------------------------------
# the standalone layer (moe_apply / moe_reference)
# ---------------------------------------------------------------------------


def moe_apply(params: Params, x: torch.Tensor, group, *, top_k_: int = 2,
              capacity_factor: float = 1.25, expert_index: int = 0
              ) -> torch.Tensor:
    """The expert-parallel MoE FFN over ``group`` (``'expert'``): x
    [N, T, F] (or [T, F]) replicated, ``params`` this rank's
    :func:`shard_moe_params` leaves (the gate whole, E/p experts from
    ``expert_index * E/p``); returns the replicated output. The gate and
    the routing run on every rank; each rank runs its experts' slots,
    and one sum over the group replicates the result."""
    p_size = group_size(group)
    n_experts = params["Wg"].shape[1]
    if n_experts % p_size:
        raise ValueError(f"{n_experts} experts not divisible by "
                         f"expert-axis size {p_size}")
    if params["W1"].shape[0] * p_size != n_experts:
        raise ValueError("params are not this group's expert shards")
    xt = x.reshape(-1, x.shape[-1])
    cap = capacity_of(capacity_factor, xt.shape[0], top_k_, n_experts)
    y, _ = moe_ffn(xt, params, top_k_=top_k_, capacity=cap,
                   shards=ExpertGroups(expert=group,
                                       expert_index=expert_index))
    return y.reshape(x.shape)


def moe_reference(params: Params, x: torch.Tensor, *, top_k_: int = 2,
                  capacity_factor: float = 1.25) -> torch.Tensor:
    """One device, the dense chain (:func:`_routing`, :func:`expert_mlp`):
    the oracle."""
    xt = x.reshape(-1, x.shape[-1])
    n_experts = params["Wg"].shape[1]
    cap = capacity_of(capacity_factor, xt.shape[0], top_k_, n_experts)
    gates = torch.softmax(xt @ params["Wg"], dim=-1)
    dispatch, combine = _routing(gates, top_k_, cap)
    y = expert_mlp(params["W1"], params["b1"], params["W2"], params["b2"],
                   dispatch, combine, xt)
    return y.reshape(x.shape)


def load_balancing_loss(x: torch.Tensor, Wg: torch.Tensor) -> torch.Tensor:
    """The load-balance loss over raw activations x [..., d]."""
    xt = x.reshape(-1, x.shape[-1])
    return aux_loss_from_gates(torch.softmax(xt @ Wg, dim=-1))

