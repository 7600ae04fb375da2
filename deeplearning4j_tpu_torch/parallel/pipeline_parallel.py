"""Pipeline parallelism: the GPipe schedule over a ``'pipe'`` group
(counterpart: ``deeplearning4j_tpu/parallel/pipeline_parallel.py`` —
``shard_pipeline_params`` :42, ``_pipeline_body`` :54,
``pipeline_apply`` :122, ``pipeline_reference`` :184).

The layer stack is split into S equal stages, one per rank of the group;
a batch is split into M microbatches that flow through the ring. At tick
t (M + S - 1 ticks) stage s runs microbatch t - s when 0 <= t - s < M,
and every stage computes every tick: a bubble tick's output is garbage,
masked out of the outputs and (``with_aux``) out of the aux sum, and
kept in the graph with a zero cotangent. The stage
hop is ``parallel/mesh.ring_shift`` (one P2P pair a tick, the last tick
sends nothing); stage 0 reads its microbatch instead of what it received,
through a ``torch.where`` so every rank's graph holds every hop and the
backward (autograd through the ticks, in reverse) issues the same shifts
in the same order on every rank. Only the last stage's outputs are the
model's: they reach every rank through :func:`~.mesh.psum`, whose
backward hands each rank the cotangent of the whole output (the
non-last stages mask theirs to zero).

Stage params are a dict of leaves with a leading stage dim [S, ...]
(:func:`shard_pipeline_params` gives each rank its [1, ...] slice) or, in
the transformer, [L/S, ...] layers (:func:`pipeline_apply_local` takes
the rank's own).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (
    PIPELINE_AXIS,
    psum,
    ring_shift,
)

StageFn = Callable[[Any, torch.Tensor], Any]


def shard_pipeline_params(params: Dict[str, torch.Tensor], mesh,
                          axis: str = PIPELINE_AXIS
                          ) -> Dict[str, torch.Tensor]:
    """This rank's stage slice [1, ...] of stage-stacked leaves [S, ...]."""
    s, i = mesh.size(axis), mesh.index(axis)
    bad = [k for k, a in params.items() if a.shape[0] != s]
    if bad:
        raise ValueError(f"leaves {bad} do not have the pipe-axis size {s} "
                         "as their leading dim")
    return {k: a[i:i + 1].contiguous() for k, a in params.items()}


def pipeline_apply_local(params, xm: torch.Tensor, group, *,
                         stage_fn: StageFn, stage: int, n_stages: int,
                         with_aux: bool = False):
    """The GPipe schedule on this rank: ``params`` its stage's params,
    ``xm`` [M, mb, ...] its microbatches (used on stage 0), ``stage_fn
    (params, mb) -> (y, aux or None)`` shape-preserving. Returns (the
    last stage's outputs [M, mb, ...] on every rank, the sum of the valid
    ticks' aux over the stages, or None)."""
    n_micro = xm.shape[0]
    dev = xm.device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == n_stages - 1, device=dev)
    recv = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(n_micro)]
    aux_sum = None
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        inp = torch.where(is_first, xm[min(t, n_micro - 1)], recv)
        y, aux = stage_fn(params, inp)
        # a bubble tick's output stays in the graph with a zero
        # cotangent (as JAX's masked update keeps it), so every rank's
        # backward runs every tick's shift
        valid = torch.tensor(0 <= t - stage < n_micro, device=dev)
        mb = min(max(t - stage, 0), n_micro - 1)
        outs[mb] = torch.where(valid, y, outs[mb])
        if with_aux:
            a = torch.where(valid, aux, torch.zeros_like(aux))
            aux_sum = a if aux_sum is None else aux_sum + a
        if t < n_ticks - 1:
            recv = ring_shift(y, group)
    out = torch.stack(outs)
    out = psum(torch.where(is_last, out, torch.zeros_like(out)), group)
    if not with_aux:
        return out, None
    return out, psum(aux_sum, group)


def pipeline_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                   *, stage_fn: Callable, n_micro: int,
                   axis: str = PIPELINE_AXIS,
                   data_axis: Optional[str] = None,
                   with_aux: bool = False):
    """The pipelined model (``pipeline_apply`` :122): ``params`` this
    rank's :func:`shard_pipeline_params` slice ([1, ...] leaves), ``x``
    [B, ...] the GLOBAL batch (split into ``n_micro`` microbatches; with
    ``data_axis`` each microbatch's rows split over that axis too),
    ``stage_fn(stage_params, mb) -> mb`` (or ``(mb, aux)`` with
    ``with_aux``). Returns this rank's output rows [B / data, ...] in
    microbatch order (and the aux summed over every (stage, microbatch)
    group)."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    d = mesh.size(data_axis) if data_axis is not None else 1
    if mb % d != 0:
        raise ValueError(f"microbatch width {mb} not divisible by "
                         f"data-axis size {d}")
    xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    if d > 1:
        i = mesh.index(data_axis)
        xm = xm[:, i * (mb // d):(i + 1) * (mb // d)]
    mine = {k: a[0] for k, a in params.items()}
    fn = stage_fn if with_aux else (lambda p, h: (stage_fn(p, h), None))
    out, aux = pipeline_apply_local(
        mine, xm, mesh.group(axis), stage_fn=fn, stage=mesh.index(axis),
        n_stages=mesh.size(axis), with_aux=with_aux)
    out = out.reshape((-1,) + tuple(out.shape[2:]))
    return (out, aux) if with_aux else out


def pipeline_reference(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                       stage_fn: Callable, n_stages: int) -> torch.Tensor:
    """The S stages in sequence on one device (the oracle)."""
    y = x
    for s in range(n_stages):
        y = stage_fn({k: a[s] for k, a in params.items()}, y)
    return y

