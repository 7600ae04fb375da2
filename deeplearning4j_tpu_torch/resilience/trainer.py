"""ResilientTrainer: preemptible, exactly resumable fit loops
(counterpart: ``deeplearning4j_tpu/resilience/trainer.py`` —
``Preempted`` and ``ResilientTrainer``).

It drives a MultiLayerNetwork's or ComputationGraph's fit loop and adds:

  * cadence checkpoints through :class:`CheckpointManager` (async by
    default: the loop stalls for the host snapshot only);
  * SIGTERM preemption: a checkpoint at the next batch boundary, then
    :class:`Preempted` (the handler is installed on the main thread
    only, and restored after the fit);
  * restore-and-continue: a fresh process pointed at the same directory
    reloads the params, updater state, iteration, loss scale, step,
    epoch and the iterator's cursor, so a resumed run consumes exactly
    the remaining batches and ends bit-equal to an uninterrupted one
    (the dropout streams come from ``conf.seed`` and the iteration);
  * transient-fault retry with a capped, deterministically jittered
    exponential backoff (the JAX package's salt rule);
  * an end-of-fit checkpoint at ``epoch == num_epochs``, so rerunning the
    same command resumes past the loop.

``float(loss)`` each step is a sync point on the card: the losses list is
the contract. With no manager and no chaos this is a plain fit loop.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.resilience.chaos import (
    ChaosMonkey,
    TransientDeviceError,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager

logger = logging.getLogger("deeplearning4j_tpu_torch")


class Preempted(RuntimeError):
    """Raised after a preemption signal once the goodbye checkpoint has
    committed; carries the checkpoint step so callers can log it."""

    def __init__(self, step: int, path: Optional[str]):
        super().__init__(
            f"preempted after step {step}; checkpoint at {path}")
        self.step = step
        self.path = path


class ResilientTrainer:
    """See the module docstring. ``device`` is where the trainee lives:
    the card unless ``device="cpu"`` (with no card it raises); a trainee
    on another device is refused."""

    def __init__(
        self,
        trainee,
        manager: Optional[CheckpointManager] = None,
        *,
        chaos: Optional[ChaosMonkey] = None,
        resume: bool = True,
        save_on_exit: bool = True,
        handle_signals: bool = True,
        preempt_signals=(signal.SIGTERM,),
        max_step_retries: int = 0,
        retry_backoff_s: float = 0.05,
        retry_backoff_max_s: float = 2.0,
        retry_jitter: float = 0.25,
        retry_salt: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.trainee = trainee
        # a parallel trainer carries the state-owning container on .net
        self.net = trainee.net if hasattr(trainee, "net") else trainee
        net_dev = getattr(self.net, "device", None)
        if net_dev is not None and torch.device(net_dev).type \
                != self.device.type:
            raise ValueError(f"the trainee lives on {net_dev}, the "
                             f"trainer was given {self.device}")
        self.manager = manager
        self.chaos = chaos
        self.resume = resume
        self.save_on_exit = save_on_exit
        self.handle_signals = handle_signals
        self.preempt_signals = tuple(preempt_signals)
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self.retry_jitter = float(retry_jitter)
        # a per-process salt: peers hitting the same fault at the same
        # step must not sleep the same jittered backoffs (the multihost
        # process id, else the pid). Overridable for reproducible runs.
        if retry_salt is None:
            pid = envknob.get_opt_int("DL4J_TPU_PROCESS_ID")
            retry_salt = pid if pid is not None else os.getpid()
        self.retry_salt = int(retry_salt)
        self._preempt_requested = False
        self._old_handlers = {}
        self._open = None  # the pass's iterator while fit runs it
        self.losses: List[float] = []
        self.resumed_step: Optional[int] = None  # set when a restore ran
        self.step = 0  # completed batches (trainer steps), incl. restored
        # fault-plane telemetry beside dispatch_stats: a trainee that
        # already carries the dict shares it
        self.resilience_stats = getattr(trainee, "resilience_stats", None)
        if self.resilience_stats is None:
            self.resilience_stats = {}
        for key, zero in (("retries", 0), ("reclaims", 0),
                          ("backoff_seconds", 0.0), ("preemptions", 0),
                          ("resumes", 0),
                          # the step of the last checkpoint this trainer
                          # saved, to join a journal timeline against the
                          # checkpoints on disk
                          ("last_checkpoint_step", -1)):
            self.resilience_stats.setdefault(key, zero)
        self.net.resilience_stats = self.resilience_stats
        # the fault-plane ledger joins the metrics registry beside the
        # net's own ledgers (obs/registry.py)
        obs_registry.register_net(self.net)

    # ---------------------------------------------------------------- signals
    def _install_handlers(self) -> None:
        if not self.handle_signals:
            return
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "ResilientTrainer: not on the main thread; preemption "
                "signal handling disabled for this fit")
            return
        for sig in self.preempt_signals:
            self._old_handlers[sig] = signal.signal(sig, self._on_signal)

    def _restore_handlers(self) -> None:
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        # handler does the MINIMUM: flag it. The loop checkpoints at the
        # next batch boundary — saving from inside a signal handler could
        # interrupt an in-flight step's own bookkeeping.
        logger.warning(
            "preemption signal %s received: checkpoint-before-death at "
            "the next batch boundary", signum)
        self._preempt_requested = True

    # ------------------------------------------------------------------- fit
    def fit(self, iterator, num_epochs: int = 1):
        """The reference fit(DataSetIterator) loop (MultiLayerNetwork
        .java:1017) under the fault plane. Returns the trained net."""
        net = self.net
        if net.params is None and not (self.manager and self.resume):
            net.init()
        start_epoch, pending_iter_state = 0, None
        if self.manager is not None and self.resume:
            restored = self.manager.restore_latest(net)
            if restored is not None:
                self.step = int(restored["step"])
                self.resumed_step = self.step
                self.resilience_stats["resumes"] += 1
                self.resilience_stats["last_checkpoint_step"] = self.step
                start_epoch = int(restored["epoch"])
                pending_iter_state = restored.get("iterator_state")
                obs_journal.event(
                    "resume", step=self.step, epoch=start_epoch,
                    path=restored["path"],
                    membership_epoch=self.resilience_stats.get("epoch"))
                logger.info(
                    "resumed from %s (step %d, epoch %d)",
                    restored["path"], self.step, start_epoch)
                # (start_epoch == num_epochs is the designed happy path —
                # the end-of-fit checkpoint resumes PAST the loop, so no
                # epoch replays and no warning is due)
                if (pending_iter_state is None and self.step > 0
                        and start_epoch < num_epochs):
                    logger.warning(
                        "resume checkpoint has no iterator cursor: the "
                        "epoch restarts from its first batch (exact "
                        "resume needs a resumable iterator — "
                        "datasets/iterator.py state()/restore_state())")
        if net.params is None:
            net.init()
        self._preempt_requested = False
        self._install_handlers()
        try:
            for epoch in range(start_epoch, num_epochs):
                if pending_iter_state is not None:
                    iterator.restore_state(pending_iter_state)
                    pending_iter_state = None
                batches = iter(iterator)
                self._open = batches
                for ds in batches:
                    # NOTE: no preemption check before the step — the
                    # iterator cursor already counts the in-hand batch, so
                    # a checkpoint here would skip it on resume
                    loss = self._step_with_retry(ds)
                    self.step += 1
                    self.losses.append(float(loss))
                    if (self.manager is not None
                            and self.manager.should_save(self.step)):
                        self.manager.save(
                            net, step=self.step, epoch=epoch,
                            iterator_state=self._iter_state(iterator))
                        self.resilience_stats["last_checkpoint_step"] = \
                            self.step
                    if self.chaos is not None:
                        self.chaos.after_step(self.step)
                    self._check_preempt(epoch, iterator)
                self._open = None
                if hasattr(iterator, "reset"):
                    iterator.reset()
            if self.manager is not None and self.save_on_exit:
                # end-of-fit checkpoint: epoch == num_epochs with a fresh
                # cursor, so a restart of the SAME command resumes past
                # the loop instead of re-training the last epoch
                self.manager.save(net, step=self.step, epoch=num_epochs,
                                  iterator_state=None, block=True)
        finally:
            # a pass left by an exception (Preempted, InjectedKill, a
            # failed step) closes its iterator now: an input pipeline's
            # dispatcher, workers and stager, and a native prefetch
            # thread, stop and join before the exception leaves fit
            if self._open is not None and hasattr(self._open, "close"):
                self._open.close()
            self._open = None
            self._restore_handlers()
            if self.manager is not None:
                self.manager.flush()
        return net

    # ----------------------------------------------------------------- steps
    def _retry_backoff(self, attempts: int) -> float:
        """Exponential backoff with a cap and DETERMINISTIC jitter:
        uncapped doubling can sleep past the preemption budget, and
        jitterless retries from N workers re-collide on every attempt
        (thundering herd). The jitter fraction derives from (step,
        attempt, per-process salt) via a Weyl-style integer mix — no RNG
        state, so the bit-exact resume contract is untouched (sleep
        never enters the numerics), while peers hitting the same fault
        at the same step still sleep DIFFERENT amounts (the salt is what
        actually decorrelates the herd)."""
        base = min(self.retry_backoff_max_s,
                   self.retry_backoff_s * (2 ** (attempts - 1)))
        mix = ((self.step + 1) * 2654435761 + attempts * 40503
               + (self.retry_salt + 1) * 83492791) % (2 ** 32)
        return base * (1.0 + self.retry_jitter * (mix / 2.0 ** 32))

    def _step_with_retry(self, ds) -> float:
        attempts = 0
        while True:
            try:
                if self.chaos is not None:
                    self.chaos.before_step(self.step + 1)
                return self._fit_one(ds)
            except TransientDeviceError as e:
                attempts += 1
                if attempts > self.max_step_retries:
                    raise
                backoff = self._retry_backoff(attempts)
                self.resilience_stats["retries"] += 1
                self.resilience_stats["backoff_seconds"] += backoff
                logger.warning(
                    "transient device error at step %d (attempt %d/%d): "
                    "%s — retrying in %.2fs", self.step + 1, attempts,
                    self.max_step_retries, e, backoff)
                time.sleep(backoff)

    def _fit_one(self, ds) -> float:
        # MultiLayerNetwork.fit(features, labels, mask, label_mask) and
        # ComputationGraph.fit(features, labels, masks, label_masks) share
        # the positional contract
        if hasattr(ds, "features_list"):
            return self.trainee.fit(ds.features_list, ds.labels_list,
                                    ds.features_masks, ds.labels_masks)
        return self.trainee.fit(ds.features, ds.labels,
                                ds.features_mask, ds.labels_mask)

    @staticmethod
    def _iter_state(iterator) -> Optional[dict]:
        return iterator.state() if hasattr(iterator, "state") else None

    def _check_preempt(self, epoch: int, iterator) -> None:
        if not self._preempt_requested:
            return
        self.resilience_stats["preemptions"] += 1
        path = None
        if self.manager is not None:
            path = self.manager.save(
                self.net, step=self.step, epoch=epoch,
                iterator_state=self._iter_state(iterator), block=True)
            self.manager.flush()
            self.resilience_stats["last_checkpoint_step"] = self.step
        # the goodbye checkpoint just committed; the journal's timeline
        # (spans, checkpoint commits, this marker) is fsync'd the same way
        # (obs/journal.py; a no-op unless DL4J_TPU_OBS is on)
        obs_journal.event(
            "preempt", step=self.step, epoch=epoch, path=path,
            membership_epoch=self.resilience_stats.get("epoch"))
        obs_journal.flush(fsync=True)
        raise Preempted(self.step, path)
