"""ContinuousTrainer: incremental fit over a live stream, in rounds
(counterpart: ``deeplearning4j_tpu/online/trainer.py``).

A ``StreamSource`` feeds an ``InputPipeline`` (the resume cursor), and
each ROUND drives ``ResilientTrainer.fit(..., num_epochs=1)`` over one
poll window of the stream (the pass ends when the feed idles).

  * every round ends with a BLOCKING checkpoint carrying the pipeline
    cursor (which IS the stream offset, ``online/stream.py``), and every
    round BEGINS by restoring the latest checkpoint through
    ``ResilientTrainer``'s own resume path: a kill at stream offset k and
    a resume is the same code path as a round turnover, bit-exact.
  * each delivered batch is offered to the ``DriftMonitor`` BEFORE the
    fit step (the drift window sees exactly what the net trained on).
  * every ``DL4J_TPU_ONLINE_SNAPSHOT_ROUNDS`` rounds the net is written as
    a CANDIDATE zip (with the serving normalizer), the artifact
    ``online/promote.ShadowPromoter`` stages.

SIGTERM during a round is ``ResilientTrainer``'s checkpoint-before-death:
``Preempted`` propagates with the goodbye checkpoint committed. The net,
the pipeline's staging and the trainer live on ``device`` (``cuda``
unless ``"cpu"``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.etl.pipeline import InputPipeline
from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.online.stats import OnlineStats
from deeplearning4j_tpu_torch.resilience.trainer import ResilientTrainer

logger = logging.getLogger(__name__)

SNAPSHOT_ROUNDS_ENV = "DL4J_TPU_ONLINE_SNAPSHOT_ROUNDS"


class _RoundView:
    """One round's iterator face over the pipeline: forwards the resume
    protocol, hooks every delivered batch (drift observation + round
    accounting), and deliberately exposes NO ``reset`` — the trainer's
    end-of-epoch ``hasattr(iterator, "reset")`` must never rewind a live
    stream's cursor."""

    def __init__(self, owner: "ContinuousTrainer") -> None:
        self._owner = owner

    def __iter__(self):
        owner = self._owner
        for ds in owner.pipe:
            if owner.drift is not None:
                owner.drift.observe(ds.features)
            owner.online_stats.bump("round_batches")
            yield ds

    def state(self):
        return self._owner.pipe.state()

    def restore_state(self, state) -> None:
        self._owner.pipe.restore_state(state)

    def batch_size(self) -> int:
        return self._owner.pipe.batch_size()

    def total_examples(self) -> int:
        return self._owner.pipe.total_examples()


class ContinuousTrainer:
    def __init__(self, net, source, *, manager=None, drift=None,
                 normalizer=None, workers: int = 1, shard=None,
                 device_put: bool = True,
                 candidate_path: Optional[str] = None,
                 snapshot_rounds: Optional[int] = None,
                 chaos=None, handle_signals: bool = True,
                 stats: Optional[OnlineStats] = None, device=None) -> None:
        self.online_stats = stats if stats is not None else OnlineStats()
        self.source = source
        if getattr(source, "stats", None) is None:
            source.stats = self.online_stats
        self.drift = drift
        if drift is not None and getattr(drift, "stats", None) is None:
            drift.stats = self.online_stats
        self.normalizer = normalizer
        self.pipe = InputPipeline(source, workers=workers, shard=shard,
                                  device_put=device_put, device=device)
        self.resilient = ResilientTrainer(
            net, manager, chaos=chaos, save_on_exit=False,
            handle_signals=handle_signals, device=device)
        self.net = self.resilient.net
        self.manager = manager
        self.candidate_path = candidate_path
        self.snapshot_rounds = int(
            snapshot_rounds if snapshot_rounds is not None
            else envknob.get_int(SNAPSHOT_ROUNDS_ENV, 1))
        self.rounds_done = 0
        # the loop's ledger joins the central registry beside the net's
        # dispatch/pipeline/resilience ledgers
        self.net.online_stats = self.online_stats
        obs_registry.register_net(self.net)

    # -- the round loop ----------------------------------------------------
    def fit_round(self) -> List[float]:
        """One fit round = one stream poll window. Restores the latest
        checkpoint (round turnover IS the resume path), fits until the
        feed idles, commits a blocking round-end checkpoint with the
        stream cursor, and exports a candidate on cadence. Returns the
        round's losses. ``Preempted`` propagates (goodbye checkpoint
        already on disk)."""
        n0 = len(self.resilient.losses)
        view = _RoundView(self)
        self.resilient.fit(view, num_epochs=1)
        losses = self.resilient.losses[n0:]
        if losses:
            self.rounds_done += 1
            self.online_stats.bump("rounds")
            if self.manager is not None:
                self.manager.save(
                    self.net, step=self.resilient.step, epoch=0,
                    iterator_state=self.pipe.state(), block=True)
            obs_journal.event(
                "online.round", round=self.rounds_done,
                step=self.resilient.step, batches=len(losses),
                offset=self.source.state().get("offset")
                if hasattr(self.source, "state") else None)
            if (self.candidate_path and self.snapshot_rounds > 0
                    and self.rounds_done % self.snapshot_rounds == 0):
                self.export_candidate(self.candidate_path)
        return losses

    def run(self, max_rounds: Optional[int] = None):
        """Round loop until the stream is closed AND drained (or
        ``max_rounds``). An idle open stream just polls again — each
        empty pass costs one idle window, never a busy spin."""
        while max_rounds is None or self.rounds_done < max_rounds:
            self.fit_round()
            if self.source.closed and self.source.backlog == 0:
                break
        return self.net

    # -- candidate export --------------------------------------------------
    def export_candidate(self, path: str) -> str:
        """Snapshot the live net as a promotable artifact: the model zip
        plus the serving normalizer (the training-time statistics the
        DriftMonitor compares against ride WITH the candidate)."""
        from deeplearning4j_tpu_torch.utils.serialization import write_model

        write_model(self.net, path, normalizer=self.normalizer)
        self.online_stats.bump("snapshots")
        obs_journal.event("online.candidate", step=self.resilient.step,
                          round=self.rounds_done, path=str(path))
        return path

    # -- introspection -----------------------------------------------------
    @property
    def step(self) -> int:
        return self.resilient.step

    @property
    def losses(self) -> List[float]:
        return self.resilient.losses

    def snapshot(self) -> Dict[str, Any]:
        return self.online_stats.snapshot()
