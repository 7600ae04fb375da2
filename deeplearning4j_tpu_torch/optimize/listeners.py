"""Iteration listeners (counterpart:
``deeplearning4j_tpu/optimize/listeners.py`` — ``IterationListener``,
``ScoreIterationListener`` and ``CollectScoresIterationListener``, :18-45;
``StatsListener`` and its three ledger subclasses, :47-148;
``PerformanceListener``, :151).

A network calls ``iteration_done(model, iteration, score)`` on each of its
listeners after every optimizer iteration (one TBPTT window is one
iteration). Reading ``score`` as a float waits for the card, so a fit
with no listeners never synchronizes. The stats listeners wait for the
ledgers they read.
"""

from __future__ import annotations

import logging
import time
from typing import List, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int, score) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, int(print_iterations))

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d is %s", iteration,
                        float(score))


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) pairs every N iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class StatsListener(IterationListener):
    """Render a ``net.*_stats`` ledger through the listener chain in one
    format (JAX :47). ``attr`` names the ledger attribute on the model; a
    ledger is anything with ``snapshot()`` or a plain dict. Every N
    iterations the snapshot, with ``iteration`` added, is appended to
    ``snapshots`` and logged as sorted ``key=value`` pairs: floats to 3
    decimals, dict-valued entries collapsed to the sum of their numeric
    leaves. The rendered line equals JAX's for the same snapshot."""

    attr: str = ""
    title: str = ""

    def __init__(self, frequency: int = 100, attr: str = "",
                 title: str = ""):
        self.frequency = max(1, int(frequency))
        if attr:
            self.attr = attr
        if title:
            self.title = title
        elif not self.title:
            self.title = (self.attr[:-len("_stats")]
                          if self.attr.endswith("_stats") else self.attr)
        self.snapshots: List[dict] = []

    @staticmethod
    def _snapshot(stats) -> dict:
        return stats.snapshot() if hasattr(stats, "snapshot") else dict(stats)

    @staticmethod
    def _render_value(v):
        if isinstance(v, dict):
            total = 0.0
            for leaf in v.values():
                if isinstance(leaf, dict):
                    leaf = sum(x for x in leaf.values()
                               if isinstance(x, (int, float)))
                if isinstance(leaf, (int, float)):
                    total += leaf
            v = total
        if isinstance(v, float):
            return f"{v:.3f}"
        return str(v)

    def render(self, snap: dict) -> str:
        return " ".join(
            f"{k}={self._render_value(v)}"
            for k, v in sorted(snap.items())
            if k != "iteration" and isinstance(v, (int, float, dict)))

    def iteration_done(self, model, iteration, score):
        stats = getattr(model, self.attr, None)
        if stats is None or iteration % self.frequency != 0:
            return
        snap = dict(self._snapshot(stats), iteration=iteration)
        self.snapshots.append(snap)
        logger.info("iteration %d %s: %s", iteration, self.title,
                    self.render(snap))


class DispatchStatsListener(StatsListener):
    """``net.dispatch_stats`` (JAX :117): the port's eager dispatch ledger
    (``ops/dispatch.DispatchStats``) on the listener chain."""

    attr = "dispatch_stats"


class ResilienceStatsListener(StatsListener):
    """``net.resilience_stats`` (JAX :129): retries, reclaims, membership
    epoch, checkpoints, preemptions and resumes."""

    attr = "resilience_stats"


class PipelineStatsListener(StatsListener):
    """``net.pipeline_stats`` (JAX :142): the ingest ledger
    (``etl/stats.PipelineStats``); ``stall_fraction`` > 0 is the input
    pipeline starving the card."""

    attr = "pipeline_stats"


class PerformanceListener(IterationListener):
    """Iterations and samples a second over windows of ``frequency``
    iterations (JAX :151). It reads the host clock only and never waits
    for the card, so a window's rate is the host's enqueue rate unless
    another listener synchronizes."""

    def __init__(self, frequency: int = 10, batch_size: int = 0):
        self.frequency = max(1, int(frequency))
        self.batch_size = batch_size
        self._last_time = None
        self._last_iter = None

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            n_iters = iteration - self._last_iter
            if dt > 0 and n_iters > 0:
                ips = n_iters / dt
                msg = f"{ips:.1f} iter/s"
                if self.batch_size:
                    msg += f", {ips * self.batch_size:.1f} samples/s"
                logger.info("iteration %d: %s (score %s)", iteration, msg,
                            float(score))
            self._last_time = now
            self._last_iter = iteration
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
