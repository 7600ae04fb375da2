"""The serving resilience plane: failure types, per-model circuit
breakers and the hung-inference watchdog (counterpart:
``deeplearning4j_tpu/serving/resilience.py`` — the knob readers :101-110,
the failure types :113-155, ``CircuitBreaker`` :158-330 and
``InferenceWatchdog`` :331-416).

:class:`CircuitBreaker` — a model's health state machine: SERVING ->
DEGRADED (failures seen, still admitting) -> BROKEN (requests fast-fail
with :class:`BreakerOpenError`, HTTP 503 with Retry-After). It opens on
``fails`` consecutive failures or on a failure rate of at least ``rate``
over the last ``window_s`` seconds once ``min_window`` outcomes exist.
After ``cooldown_s`` exactly one half-open probe is admitted: its success
closes the breaker, its failure re-opens it with a fresh cooldown; a
probe with no verdict past ``probe_ttl_s`` forfeits its slot. ``trip``
force-opens it (the watchdog's verdict, a dead worker). The clock is
injectable (``clock``), so a test drives the transitions
deterministically.

:class:`InferenceWatchdog` — a monitor thread over armed deadlines. The
batcher arms a token before every dispatch and disarms it when the
dispatch returns (the model's answer already copied to the host); a token
whose deadline passes gets one ``on_wedged(meta)`` call on the watchdog's
thread, never on the hung one.

Knobs (``ops/env.py``, read by the engine at construction):
``DL4J_TPU_SERVE_BREAKER_FAILS`` (default 5; 0 disables breakers),
``DL4J_TPU_SERVE_WATCHDOG_S`` (30; 0 disables the watchdog) and
``DL4J_TPU_SERVE_DRAIN_S`` (20).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from deeplearning4j_tpu_torch.ops import env as envknob

ENV_BREAKER_FAILS = "DL4J_TPU_SERVE_BREAKER_FAILS"
ENV_WATCHDOG_S = "DL4J_TPU_SERVE_WATCHDOG_S"
ENV_DRAIN_S = "DL4J_TPU_SERVE_DRAIN_S"

# health states, in degradation order
SERVING = "serving"
DEGRADED = "degraded"
BROKEN = "broken"


def breaker_fails_default() -> int:
    return int(envknob.get_float(ENV_BREAKER_FAILS))


def watchdog_s_default() -> float:
    return envknob.get_float(ENV_WATCHDOG_S)


def drain_s_default() -> float:
    return envknob.get_float(ENV_DRAIN_S)


class BreakerOpenError(RuntimeError):
    """The model's circuit breaker is open (or the record is broken):
    fast-fail instead of queueing onto a doomed worker. HTTP 503 with a
    Retry-After of :attr:`retry_after_s` seconds, rounded up."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class DrainingError(RuntimeError):
    """The engine is draining or stopped: admission is closed (HTTP 503
    with Retry-After)."""

    retry_after_s = 1.0


class ModelWedgedError(RuntimeError):
    """The watchdog expired an in-flight dispatch: the device call hung
    past its wall deadline. Every future of the wedged batch carries it
    (HTTP 503 "Wedged"), a diagnosis instead of a 504 by queue rot."""


class ClientRequestError(ValueError):
    """A malformed request, refused before the model runs (wrong row
    width, a normalizer shape mismatch, the wrong endpoint for the model
    type): HTTP 400, and no vote on the model's breaker."""


class WorkerDeadError(RuntimeError):
    """A worker thread (the batcher's, the decode loop's) died and was not
    replaced: submit fast-fails instead of queueing requests nobody will
    serve (HTTP 503)."""


class CircuitBreaker:
    """One model's health state machine (module docstring). Thread-safe;
    the engine keeps one per record key. Transitions go to ``stats``
    (``ServingStats`` counters) and to ``on_transition(old, new,
    reason)``."""

    def __init__(self, *, fails: Optional[int] = None,
                 cooldown_s: float = 2.0,
                 window_s: float = 30.0, rate: float = 0.5,
                 min_window: int = 10,
                 probe_ttl_s: float = 60.0,
                 key: str = "", stats=None,
                 on_transition: Optional[Callable[[str, str, str],
                                                  None]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.fails = int(fails if fails is not None
                         else breaker_fails_default())
        self.cooldown_s = float(cooldown_s)
        self.window_s = float(window_s)
        self.rate = float(rate)
        self.min_window = int(min_window)
        self.probe_ttl_s = float(probe_ttl_s)
        self.key = key
        self.stats = stats
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = SERVING
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0
        self._outcomes: deque = deque()  # (clock, ok) for the rate window
        self.open_reason = ""

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, new: str, reason: str):
        """Under the lock: the (old, new, reason) triple for the caller to
        emit after releasing it (counters and the hook never run under
        this lock)."""
        old, self._state = self._state, new
        return None if old == new else (old, new, reason)

    def _emit(self, transition) -> None:
        if transition is None:
            return
        old, new, reason = transition
        if self.stats is not None:
            if new == BROKEN:
                self.stats.record_breaker_open()
            elif old == BROKEN and new == SERVING:
                self.stats.record_breaker_close()
        if self.on_transition is not None:
            self.on_transition(old, new, reason)

    def check(self) -> bool:
        """The admission gate, per request before it queues. True when
        the admitted request is the half-open probe; raises
        :class:`BreakerOpenError` while the breaker is open and it is not
        probe time (or a probe is already out)."""
        if self.fails <= 0:  # breakers disabled
            return False
        with self._lock:
            if self._state != BROKEN:
                return False
            now = self._clock()
            waited = now - self._opened_at
            probe_free = (not self._probing
                          or now - self._probe_started > self.probe_ttl_s)
            if waited >= self.cooldown_s and probe_free:
                self._probing = True
                self._probe_started = now
                if self.stats is not None:
                    self.stats.record_breaker_probe()
                return True
            retry = max(self.cooldown_s - waited, 0.05)
            reason = self.open_reason
        if self.stats is not None:
            self.stats.record_fast_fail()
        raise BreakerOpenError(
            f"model {self.key or '<default>'} breaker open"
            f" ({reason}); retry after {retry:.2f}s",
            retry_after_s=retry)

    def record_success(self) -> None:
        if self.fails <= 0:
            return
        transition = None
        with self._lock:
            self._consecutive = 0
            self._push_outcome(True)
            if self._state == DEGRADED:
                transition = self._set_state(SERVING, "recovered")
            elif self._state == BROKEN and self._probing:
                self._probing = False
                self._outcomes.clear()
                transition = self._set_state(SERVING, "probe succeeded")
        self._emit(transition)

    def record_failure(self, reason: str = "inference error") -> None:
        if self.fails <= 0:
            return
        transition = None
        with self._lock:
            self._consecutive += 1
            self._push_outcome(False)
            if self._state == BROKEN:
                if self._probing:
                    # outcomes come per coalesced dispatch, without
                    # request identity: a failure while the probe is out
                    # is taken as the probe's (recovery slips one
                    # cooldown at worst)
                    self._probing = False
                    self._opened_at = self._clock()
                    self.open_reason = f"probe failed: {reason}"
            elif self._consecutive >= self.fails:
                transition = self._open(
                    f"{self._consecutive} consecutive failures: {reason}")
            elif self._window_tripped():
                transition = self._open(
                    f"failure rate over {self.window_s:.0f}s window >= "
                    f"{self.rate:.0%}: {reason}")
            elif self._state == SERVING:
                transition = self._set_state(DEGRADED, reason)
        self._emit(transition)

    def trip(self, reason: str) -> None:
        """Force-open (the watchdog's verdict, a dead worker): categorical
        evidence, no vote counting."""
        if self.fails <= 0:
            return
        with self._lock:
            self._probing = False
            transition = self._open(reason)
        self._emit(transition)

    def _open(self, reason: str):
        self._opened_at = self._clock()
        self.open_reason = reason
        return self._set_state(BROKEN, reason)

    def _push_outcome(self, ok: bool) -> None:
        now = self._clock()
        self._outcomes.append((now, ok))
        horizon = now - self.window_s
        while self._outcomes and self._outcomes[0][0] < horizon:
            self._outcomes.popleft()

    def _window_tripped(self) -> bool:
        if len(self._outcomes) < self.min_window:
            return False
        bad = sum(1 for _, ok in self._outcomes if not ok)
        return bad / len(self._outcomes) >= self.rate

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "open_reason": self.open_reason if
                    self._state == BROKEN else ""}


class InferenceWatchdog:
    """A monitor thread over armed in-flight deadlines: ``arm(meta)``
    returns a token, ``disarm(token)`` on completion; a token past its
    deadline gets one ``on_wedged(meta)`` call on this thread. It sleeps
    until the nearest deadline (or until something is armed)."""

    def __init__(self, timeout_s: float,
                 on_wedged: Callable[[Any], None],
                 name: str = "inference-watchdog") -> None:
        self.timeout_s = float(timeout_s)
        self.on_wedged = on_wedged
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._armed: Dict[int, tuple] = {}  # token -> (deadline, meta)
        self._next_token = 1
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def arm(self, meta: Any = None,
            timeout_s: Optional[float] = None) -> Optional[int]:
        if not self.enabled:
            return None
        budget = timeout_s if timeout_s is not None else self.timeout_s
        with self._cond:
            token = self._next_token
            self._next_token += 1
            self._armed[token] = (time.monotonic() + budget, meta)
            self._cond.notify_all()
        return token

    def disarm(self, token: Optional[int]) -> bool:
        """True when the token was still armed (the dispatch finished
        first); False when the watchdog already declared it wedged, so the
        caller's late completion is fenced."""
        if token is None:
            return True
        with self._cond:
            return self._armed.pop(token, None) is not None

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._armed.clear()
            self._cond.notify_all()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                if not self._armed:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                expired = [(tok, meta) for tok, (dl, meta)
                           in self._armed.items() if dl <= now]
                for tok, _ in expired:
                    del self._armed[tok]
                if not expired:
                    nearest = min(dl for dl, _ in self._armed.values())
                    self._cond.wait(timeout=max(0.005, nearest - now))
                    continue
            for _, meta in expired:
                try:
                    self.on_wedged(meta)
                except Exception:  # noqa: BLE001 — the monitor outlives its handler
                    pass
