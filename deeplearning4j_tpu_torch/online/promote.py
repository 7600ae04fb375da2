"""ShadowPromoter: zero-downtime candidate promotion behind live gates
(counterpart: ``deeplearning4j_tpu/online/promote.py`` —
``PromotionRefused``, ``ShadowMirror`` and ``ShadowPromoter``).

  stage      load the candidate zip and warm it (a failure lands the
             record BROKEN; the serving default never moves), then
             attach a :class:`ShadowMirror` to the engine: a fraction of
             answered /predict traffic (a deterministic stride, no RNG)
             is re-run against the candidate OFF the client thread, on
             one worker thread behind a bounded queue that drops and
             counts. Shadow answers never reach clients, never block the
             answer path and never vote a breaker: with mirroring on the
             client-visible outputs stay byte-identical.
  evaluate   the promotion gates over the mirror's telemetry (minimum
             mirrored volume, zero shadow errors, argmax agreement with
             the primary) and the ``DriftMonitor`` verdict.
  promote    every gate green: swap the serving default
             (``registry.serve``; in-flight requests finish on the old
             version, none fails across the swap). A red gate marks the
             candidate BROKEN and raises ``PromotionRefused``; the
             default never moves on drift or a failed gate. A drain
             racing the promotion hits the sealed registry first. The
             mirror is detached either way.
  rollback   re-serve the lineage's recorded prior default.

``promote_fleet`` runs the same local gates, then hands the swap to
``FleetRouter.rollout``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.online.stats import OnlineStats

FRACTION_ENV = "DL4J_TPU_ONLINE_SHADOW_FRACTION"
SHADOW_MIN_ENV = "DL4J_TPU_ONLINE_SHADOW_MIN"
GATE_AGREE_ENV = "DL4J_TPU_ONLINE_GATE_AGREE"


class PromotionRefused(RuntimeError):
    """A promotion gate failed (or drift is alarmed); the serving
    default did not move and the candidate landed broken."""

    def __init__(self, report: Dict[str, Any]):
        super().__init__(
            f"promotion refused: {', '.join(report.get('failed', []))}")
        self.report = report


class ShadowMirror:
    """Mirrors answered /predict traffic to a candidate record.

    ``offer(x, primary_out)`` is called on the CLIENT answer path
    (engine._offer_shadow) and therefore never raises, never blocks and
    never votes: a deterministic fraction stride (accumulated
    ``DL4J_TPU_ONLINE_SHADOW_FRACTION`` — no RNG, so a replay picks the
    same requests) selects requests into a bounded queue; a queue at
    capacity DROPS (counted) rather than stalls. One worker thread
    shapes the rows for the candidate (its OWN input_shape/normalizer)
    and runs ``model.output`` under a private lock — the candidate's
    dispatches never contend with the primary's serving lock."""

    def __init__(self, rec, *, fraction: Optional[float] = None,
                 stats: Optional[OnlineStats] = None,
                 queue_cap: int = 256) -> None:
        self.rec = rec
        f = (fraction if fraction is not None
             else envknob.get_float(FRACTION_ENV, 1.0))
        self.fraction = min(1.0, max(0.0, float(f)))
        self.stats = stats if stats is not None else OnlineStats()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_cap)))
        self._accum_lock = threading.Lock()
        self._accum = 0.0
        self._count_lock = threading.Lock()
        self.compared_rows = 0
        self.agreed_rows = 0
        self._shadow_lock = threading.Lock()  # serializes candidate output()
        self._busy = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name="shadow-mirror", daemon=True)
        self._thread.start()

    # -- the answer-path hook (MUST be non-throwing / non-blocking) --------
    def offer(self, x, primary_out) -> None:
        try:
            with self._accum_lock:
                self._accum += self.fraction
                take = self._accum >= 1.0
                if take:
                    self._accum -= 1.0
            if not take:
                self.stats.bump("mirror_skipped")
                return
            self._q.put_nowait((np.asarray(x), np.asarray(primary_out)))
        except queue.Full:
            self.stats.bump("mirror_dropped")
        except Exception:  # noqa: BLE001 — the client path is sacred
            self.stats.bump("mirror_errors")

    # -- the worker --------------------------------------------------------
    def _worker(self) -> None:
        from deeplearning4j_tpu_torch.serving.engine import ServingEngine

        while not self._stop.is_set():
            try:
                x, primary = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self._busy = True
            try:
                x2 = ServingEngine._shape_rows(self.rec, x)
                with self._shadow_lock:
                    out = self.rec.model.output(x2)
                out = out[0] if isinstance(out, (list, tuple)) else out
                out0 = (out.detach().to("cpu").numpy()
                        if torch.is_tensor(out) else np.asarray(out))
                self.stats.bump("mirrored")
                self._compare(primary, out0)
            except Exception:  # noqa: BLE001 — shadow failure is telemetry
                self.stats.bump("mirror_errors")
            finally:
                self._busy = False

    def _compare(self, primary: np.ndarray, shadow: np.ndarray) -> None:
        """Per-row argmax agreement — the cheap label-level fidelity
        signal the agreement gate consumes (regression outputs with no
        class axis just skip the comparison)."""
        if primary.ndim < 2 or shadow.shape != primary.shape:
            return
        agree = int(np.sum(np.argmax(primary, axis=-1)
                           == np.argmax(shadow, axis=-1)))
        rows = int(primary.shape[0])
        with self._count_lock:
            self.compared_rows += rows
            self.agreed_rows += agree
        if agree < rows:
            self.stats.bump("mirror_disagreements", rows - agree)

    # -- lifecycle / reporting ---------------------------------------------
    def wait_idle(self, timeout_s: float = 5.0) -> bool:
        """Block until the mirror queue is drained (tests/bench sync)."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.empty() and not self._busy:
                return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def report(self) -> Dict[str, Any]:
        snap = self.stats.snapshot()
        with self._count_lock:
            compared, agreed = self.compared_rows, self.agreed_rows
        return {
            "candidate": self.rec.key,
            "fraction": self.fraction,
            "mirrored": snap["mirrored"],
            "skipped": snap["mirror_skipped"],
            "dropped": snap["mirror_dropped"],
            "errors": snap["mirror_errors"],
            "disagreements": snap["mirror_disagreements"],
            "agreement": (agreed / compared) if compared else None,
        }


class ShadowPromoter:
    def __init__(self, engine, *, drift=None,
                 fraction: Optional[float] = None,
                 min_mirrored: Optional[int] = None,
                 gate_agree: Optional[float] = None,
                 gate_fn: Optional[Callable[[Dict[str, Any]],
                                            Optional[str]]] = None,
                 stats: Optional[OnlineStats] = None) -> None:
        self.engine = engine
        self.drift = drift
        self.fraction = fraction
        self.min_mirrored = int(
            min_mirrored if min_mirrored is not None
            else envknob.get_int(SHADOW_MIN_ENV, 32))
        self.gate_agree = float(
            gate_agree if gate_agree is not None
            else envknob.get_float(GATE_AGREE_ENV, 0.0))
        self.gate_fn = gate_fn
        self.online_stats = stats if stats is not None else OnlineStats()
        # the promotion ledger joins the central registry beside the
        # engine's serving_stats
        obs_registry.default_registry().register_ledger(
            self, "online_stats", self.online_stats)
        self.candidate = None
        self.mirror: Optional[ShadowMirror] = None

    # -- stage -------------------------------------------------------------
    def stage(self, name: str, model_path: Optional[str] = None,
              model=None, *, input_shape=None, normalizer=None,
              max_batch: int = 64, sample_row=None):
        """Load + warm the candidate and start mirroring. A load/warmup
        failure lands the record broken and re-raises — the
        serving default never moves, nothing was attached."""
        registry = self.engine.registry
        rec = registry.load(name, model=model, model_path=model_path,
                            input_shape=input_shape, normalizer=normalizer)
        registry.warmup(rec.name, rec.version, max_batch=max_batch,
                        sample_row=sample_row)
        self.candidate = rec
        self.mirror = ShadowMirror(rec, fraction=self.fraction,
                                   stats=self.online_stats)
        self.engine.attach_shadow(self.mirror)
        obs_journal.event("online.shadow_staged", candidate=rec.key,
                          fraction=self.mirror.fraction)
        return rec

    # -- gates -------------------------------------------------------------
    def evaluate(self) -> Dict[str, Any]:
        """Render every promotion gate over the current shadow window.
        Side-effect-free: safe to poll while traffic flows."""
        if self.candidate is None or self.mirror is None:
            raise RuntimeError("no staged candidate (call stage() first)")
        report = self.mirror.report()
        failed = []
        if self.drift is not None:
            verdict = self.drift.check()
            report["drift"] = verdict
            if verdict["alarmed"]:
                failed.append("drift_alarm")
        if report["mirrored"] < self.min_mirrored:
            failed.append(
                f"min_mirrored ({report['mirrored']}/{self.min_mirrored})")
        if report["errors"] > 0:
            failed.append(f"mirror_errors ({report['errors']})")
        if self.gate_agree > 0:
            agreement = report["agreement"]
            if agreement is None or agreement < self.gate_agree:
                failed.append(
                    f"agreement ({agreement} < {self.gate_agree})")
        if self.gate_fn is not None:
            why = self.gate_fn(dict(report))
            if why:
                failed.append(str(why))
        report["failed"] = failed
        report["ok"] = not failed
        return report

    # -- promote / refuse --------------------------------------------------
    def _detach(self) -> None:
        if self.mirror is not None:
            self.engine.detach_shadow(self.mirror)
            self.mirror.close()

    def _refuse(self, report: Dict[str, Any]) -> None:
        """The refusal path: candidate lands BROKEN (auditable, never
        promotable by a later stray serve()), mirror detached, journaled."""
        self._detach()
        self.engine.registry.mark_broken(
            self.candidate.name, self.candidate.version,
            error="promotion refused: " + ", ".join(report["failed"]))
        self.online_stats.bump("promotion_refusals")
        obs_journal.event("online.promotion_refused",
                          candidate=self.candidate.key,
                          failed=report["failed"])
        raise PromotionRefused(report)

    def promote(self) -> Dict[str, Any]:
        """Evaluate the gates and, all green, atomically swap the serving
        default to the candidate. Gate failure → ``PromotionRefused``
        (default unmoved, candidate broken). A drain racing this call
        hits the sealed registry: DrainingError propagates, the default
        never moved, the mirror is detached (the candidate record stays
        warm — a drain is not a verdict on the model)."""
        report = self.evaluate()
        if not report["ok"]:
            self._refuse(report)
        try:
            rec = self.engine.registry.serve(self.candidate.name,
                                             self.candidate.version)
        finally:
            # success or DrainingError: the mirror's job is done either way
            self._detach()
        self.online_stats.bump("promotions")
        obs_journal.event("online.promoted", candidate=rec.key,
                          prior=rec.prior_default,
                          mirrored=report["mirrored"],
                          agreement=report["agreement"])
        report["promoted"] = rec.key
        report["prior_default"] = rec.prior_default
        return report

    def abort(self, reason: str = "aborted by operator") -> None:
        """Tear down a staged shadow without promoting (candidate marked
        broken so the staging attempt is auditable)."""
        if self.candidate is None:
            return
        self._detach()
        try:
            self.engine.registry.mark_broken(
                self.candidate.name, self.candidate.version, error=reason)
        except ValueError:
            pass  # already the default (promoted elsewhere) — leave it
        self.online_stats.bump("promotion_refusals")
        obs_journal.event("online.shadow_aborted",
                          candidate=self.candidate.key, reason=reason)

    def rollback(self):
        """Re-serve the lineage's recorded prior default."""
        target = self.engine.registry.rollback_target()
        if target is None:
            raise ValueError("no promotable rollback target in lineage")
        rec = self.engine.registry.serve(*target)
        self.online_stats.bump("rollbacks")
        obs_journal.event("online.rollback", to=rec.key)
        return rec

    # -- fleet-scoped promotion --------------------------------------------
    def promote_fleet(self, router, name: str, path: str, *,
                      input_shape=None, max_batch: Optional[int] = None,
                      gen_tokens: int = 0) -> Dict[str, Any]:
        """Same local gates, fleet-scoped swap: delegates to
        ``FleetRouter.rollout`` (per-replica load → warmup → serve with
        auto-rollback). A rollout that rolled back counts as a refusal."""
        report = self.evaluate()
        if not report["ok"]:
            self._refuse(report)
        res = router.rollout(name, path, input_shape=input_shape,
                             max_batch=max_batch, gen_tokens=gen_tokens)
        report["rollout"] = res
        if not res.get("ok"):
            self.online_stats.bump("promotion_refusals")
            self._detach()
            raise PromotionRefused({**report,
                                    "failed": ["fleet_rollout_rolled_back"]})
        self._detach()
        self.online_stats.bump("promotions")
        obs_journal.event("online.promoted_fleet", model=name,
                          replicas=len(res.get("replicas", [])))
        return report
