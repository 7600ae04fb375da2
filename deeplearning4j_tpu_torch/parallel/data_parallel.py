"""Data-parallel trainers for MultiLayerNetwork and ComputationGraph
(counterpart: ``deeplearning4j_tpu/parallel/data_parallel.py`` —
``ParallelWrapper`` :43 with ``fit``, ``fit_batches``, ``fit_iterator``
and truncated BPTT; ``stack_rounds`` and ``ParameterAveragingTrainer``
:353, whose worker round, ``ParameterAveragingTrainer._local_round``,
plays ``container_calls`` and ``local_round_scan`` :271-350 through the
containers' own ``fit``; ``round_step_rngs`` :288 and ``local_round``, the
elastic fleet's split of a round (``parallel/fleet.py``), whose splits
share the round's steps' streams as JAX's share its keys).

Two modes, as in the JAX package:

1. :class:`ParallelWrapper`, synchronous gradient data parallelism. With
   a ``'data'`` process group each rank takes its rows of the batch, runs
   the net's own train step on them and the gradients (and the loss) are
   averaged over the group before the updater (the container's
   ``_grad_reduce`` hook in ``nn/common.train_iteration``), so every rank
   takes the same step. In one process the net's own step runs on the
   whole batch: what the JAX package's GSPMD computes over its devices.
   Layer states stay per rank (BN's batch statistics are those of the
   rank's rows).
2. :class:`ParameterAveragingTrainer`, the reference's parameter
   averaging: each worker fits ``averaging_frequency`` minibatches (its
   rows of each) from the same starting params through the net's own
   ``fit``, then params, and updater state under ``save_updater``, are
   averaged; layer states (BN's running statistics) are averaged too,
   recurrent stream states are not. With a ``'data'`` group each rank is
   a worker and the average is an all-reduce. Without one the n workers
   run in this process, one after another on the same device, from
   copies of the broadcast state, and the average is summed in worker
   order: the semantics of the JAX package's ``shard_map`` over n
   devices, and how one card runs parameter averaging with real work.

Each worker draws its own dropout streams (the containers' ``_worker``
seed, ``ops/rng.worker_seed``): the JAX package folds a worker index
into its keys the same way, with other bits.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.layers.factory import STATEFUL_RNN_CONFS
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel.mesh import group_size


def _is_graph(net) -> bool:
    return hasattr(net, "_as_inputs")


def _rows(a, sl: slice, axis: int = 0):
    """``a`` (an array, a list or dict of them, or None) cut to rows
    ``sl`` along ``axis``."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _rows(v, sl, axis) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_rows(v, sl, axis) for v in a]
    idx = (slice(None),) * axis + (sl,)
    return a[idx]


def _first(a):
    if isinstance(a, dict):
        return _first(next(iter(a.values())))
    if isinstance(a, (list, tuple)):
        return _first(a[0])
    return a


def _as_tensor(a, device):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _as_tensor(v, device) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_as_tensor(v, device) for v in a]
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _check_net_device(net, device: torch.device) -> None:
    if net.device.type != device.type:
        raise ValueError(f"the net lives on {net.device}, the trainer was "
                         f"given {device}")


def _mean_grads(group):
    """``net._grad_reduce`` for ``group``: the loss and every gradient
    leaf summed over the ranks and divided by their number."""
    world = group_size(group)

    def reduce(loss, grads):
        for x in [loss] + tree_leaves(grads):
            dist.all_reduce(x, group=group)
        return loss / world, tree_map(lambda g: g / world, grads)

    return reduce


class ParallelWrapper:
    """Synchronous gradient data parallelism (see the module docstring).
    ``group``: the ``'data'`` process group (every rank passes the same
    GLOBAL batch); without it, ``num_devices`` (default 1) is the number
    of devices the JAX package would shard over, and the batch must
    split evenly over it. ``device`` is where ``net`` lives: the card
    unless the caller passes ``device="cpu"``."""

    def __init__(self, net, num_devices: Optional[int] = None, group=None,
                 device=None):
        self.device = resolve_device(device)
        _check_net_device(net, self.device)
        self.net = net
        self.group = group
        self.n = (group_size(group) if group is not None
                  else int(num_devices or 1))
        self.rank = dist.get_rank(group) if group is not None else 0

    def _check_divisible(self, b: int) -> None:
        if b % self.n != 0:
            raise ValueError(
                f"batch {b} not divisible by {self.n} devices (pad or trim "
                "so every device takes an equal share)")

    def _mine(self, a, axis: int = 0):
        """This rank's rows of ``a`` (all of them in one process)."""
        if self.group is None or a is None:
            return a
        b = _first(a).shape[axis]
        per = b // self.n
        return _rows(a, slice(self.rank * per, (self.rank + 1) * per), axis)

    def _run(self, fn):
        net = self.net
        if net.params is None:
            net.init()
        if self.group is None:
            return fn()
        if net.conf.optimization_algo != "stochastic_gradient_descent":
            raise NotImplementedError(
                "ParallelWrapper averages the SGD step's gradients; "
                f"optimization_algo={net.conf.optimization_algo!r} "
                "requires the serial Solver path (net.fit)")
        net._grad_reduce = _mean_grads(self.group)
        try:
            return fn()
        finally:
            net._grad_reduce = None

    def fit(self, features, labels, mask=None, label_mask=None):
        """One data-parallel fit of the global batch (either container;
        TBPTT configurations step once per window, each averaged)."""
        self._check_divisible(_first(features).shape[0])
        x, y = self._mine(features), self._mine(labels)
        m, lm = self._mine(mask), self._mine(label_mask)
        return self._run(lambda: self.net.fit(x, y, m, lm))

    def fit_batches(self, features, labels):
        """K stacked batches [K, N, ...]: the net's ``fit_batches`` on
        this rank's rows of each, every step averaged."""
        self._check_divisible(_first(features).shape[1])
        x, y = self._mine(features, 1), self._mine(labels, 1)
        return self._run(lambda: self.net.fit_batches(x, y))

    def fit_iterator(self, iterator, num_epochs: int = 1):
        for _ in range(num_epochs):
            for ds in iterator:
                self.fit(ds.features, ds.labels, ds.features_mask,
                         ds.labels_mask)
            if hasattr(iterator, "reset"):
                iterator.reset()
        return self.net


# ---------------------------------------------------------------------------
# parameter averaging
# ---------------------------------------------------------------------------


def stack_rounds(a, averaging_frequency: int):
    """[freq * gb, ...] -> [freq, gb, ...]: one split feeds ``freq``
    minibatches (``ParameterAveragingTrainingMaster.java:148``); an array
    already [freq, gb, ...] passes through."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: stack_rounds(v, averaging_frequency) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [stack_rounds(v, averaging_frequency) for v in a]
    if a.ndim >= 2 and a.shape[0] != averaging_frequency:
        gb = a.shape[0] // averaging_frequency
        a = a[: gb * averaging_frequency].reshape(
            (averaging_frequency, gb) + tuple(a.shape[1:]))
    return a


def round_step_rngs(net, averaging_frequency: int) -> np.ndarray:
    """The round's step indices [freq] (JAX ``round_step_rngs`` :288,
    whose threefry keys the port's streams replace): with ``conf.seed``
    they fix every layer's dropout stream (``ops/rng.stream_seed``), so
    every split of an elastic round draws the same masks whichever
    worker runs it. The fleet ships them in the round state."""
    return np.arange(net.iteration, net.iteration + averaging_frequency,
                     dtype=np.int64)


def local_round(net, start, xs, ys, ms, lms, steps):
    """One split of an elastic averaging round (JAX ``local_round_scan``
    :321 as ``parallel/fleet.py`` runs it bare): from the broadcast
    ``start`` (params, states, updater state), one ``net.fit`` per
    minibatch of the split's [freq, b, ...] stacks, minibatch i at step
    ``steps[i]`` on the net's own streams. A pure function of (start,
    split, steps): the executor's identity never enters. Leaves the
    split's result on ``net``; returns (params, states, updater state,
    the [freq] losses)."""
    net.params, net.states, net.updater_state = _snapshot_of(start)
    net._worker = None
    if hasattr(net, "_reset_rnn_states"):
        net._reset_rnn_states(_first(xs).shape[1])
    losses = []
    for i in range(len(steps)):
        net.iteration = int(steps[i])
        pick = lambda a: None if a is None else _rows(a, i)
        losses.append(net.fit(pick(xs), pick(ys), pick(ms), pick(lms)))
    return (net.params, net.states, net.updater_state,
            torch.stack([torch.as_tensor(v) for v in losses]))


def _state_is_stream(net, key) -> bool:
    conf = (net.conf.vertices[key] if _is_graph(net)
            else net.conf.layers[key])
    return isinstance(conf, STATEFUL_RNN_CONFS)


def _state_keys(states):
    return list(states) if isinstance(states, dict) else range(len(states))


def average_trees(trees: List[Any]):
    """The leafwise mean of same-shaped trees, summed in list order
    (``((t0 + t1) + t2) ... / n``); non-float leaves come from the
    first."""
    n = len(trees)
    if isinstance(trees[0], dict):
        return {k: average_trees([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(average_trees(list(z)) for z in zip(*trees))
    first = trees[0]
    if not torch.is_tensor(first) or not first.is_floating_point():
        return first
    acc = first
    for t in trees[1:]:
        acc = acc + t
    return acc / n


def _all_reduce_mean(tree, group):
    n = group_size(group)

    def one(v):
        if not torch.is_tensor(v) or not v.is_floating_point():
            return v
        v = v.clone()
        dist.all_reduce(v, group=group)
        return v / n

    return tree_map(one, tree)


class ParameterAveragingTrainer:
    """Reference-exact parameter averaging (see the module docstring):
    ``fit`` is one round, features [freq * n * b, ...] or
    [freq, n * b, ...] (each minibatch's rows split over the n workers).
    ``group`` makes each rank a worker; otherwise ``num_workers`` (default
    1) run in this process. ``device`` is where ``net`` lives."""

    def __init__(self, net, num_workers: Optional[int] = None,
                 averaging_frequency: int = 5, save_updater: bool = True,
                 group=None, device=None):
        self.device = resolve_device(device)
        _check_net_device(net, self.device)
        self.net = net
        self.group = group
        self.n = (group_size(group) if group is not None
                  else int(num_workers or 1))
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.save_updater = save_updater

    def _local_round(self, x, y, m, lm, worker: int, start):
        """One worker's fits from the broadcast state ``start`` (params,
        states, updater state): its rows of each of the round's
        minibatches through ``net.fit``. Returns (its params, states,
        updater state, mean loss, iterations run)."""
        net = self.net
        freq = self.averaging_frequency
        b = _first(x).shape[1]
        per = b // self.n
        sl = slice(worker * per, (worker + 1) * per)
        it0 = net.iteration
        net.params, net.states, net.updater_state = start
        net._worker = worker
        try:
            if hasattr(net, "_reset_rnn_states"):
                net._reset_rnn_states(per)
            losses = []
            for i in range(freq):
                pick = lambda a: None if a is None else _rows(
                    _rows(a, slice(i, i + 1)), sl, 1)
                sq = lambda a: None if a is None else _rows(a, 0)
                xi, yi = sq(pick(x)), sq(pick(y))
                mi, lmi = sq(pick(m)), sq(pick(lm))
                losses.append(net.fit(xi, yi, mi, lmi))
        finally:
            net._worker = None
        ran = net.iteration - it0
        net.iteration = it0
        loss = losses[0]
        for v in losses[1:]:
            loss = loss + v
        return (net.params, net.states, net.updater_state,
                loss / len(losses), ran)

    def _combine_states(self, before, results):
        net = self.net
        out = dict(before) if isinstance(before, dict) else list(before)
        for key in _state_keys(before):
            if _state_is_stream(net, key):
                out[key] = before[key]  # recurrent stream: not averaged
            else:
                out[key] = average_trees([r[key] for r in results])
        return out

    def fit(self, features, labels, mask=None, label_mask=None):
        """One averaging round (either container); returns the mean loss
        of the workers' fits (a 0-d tensor)."""
        net = self.net
        if net.params is None:
            net.init()
        freq = self.averaging_frequency
        x = stack_rounds(_as_tensor(features, net.device), freq)
        y = stack_rounds(_as_tensor(labels, net.device), freq)
        m = stack_rounds(_as_tensor(mask, net.device), freq)
        lm = stack_rounds(_as_tensor(label_mask, net.device), freq)
        b = _first(x).shape[1]
        if b % self.n != 0:
            raise ValueError(f"minibatch {b} not divisible by {self.n} "
                             "workers")
        if hasattr(net, "_reset_rnn_states"):
            net._reset_rnn_states(b // self.n)
        start = _snapshot_of((net.params, net.states, net.updater_state))
        it0 = net.iteration
        if self.group is not None:
            me = dist.get_rank(self.group)
            p, st, upd, loss, ran = self._local_round(
                x, y, m, lm, me, _snapshot_of(start))
            params = _all_reduce_mean(p, self.group)
            upd = _all_reduce_mean(upd, self.group) if self.save_updater \
                else upd
            avg_st = _all_reduce_mean(st, self.group)
            states = self._combine_states(start[1], [avg_st])
            loss = _all_reduce_mean(loss, self.group)
        else:
            results = []
            for w in range(self.n):
                fresh = _snapshot_of(start)
                results.append(self._local_round(x, y, m, lm, w, fresh))
            ran = results[0][4]
            params = average_trees([r[0] for r in results])
            upd = (average_trees([r[2] for r in results])
                   if self.save_updater else results[0][2])
            states = self._combine_states(start[1], [r[1] for r in results])
            loss = average_trees([r[3] for r in results])
        net.params, net.states, net.updater_state = params, states, upd
        net.iteration = it0 + ran
        net._score = loss
        return loss


def _snapshot_of(state):
    """A copy of every tensor of ``state`` (params, states, updater
    state): the updaters write the params in place."""
    clone = lambda v: v.clone() if torch.is_tensor(v) else v
    return tuple(tree_map(clone, t) for t in state)
