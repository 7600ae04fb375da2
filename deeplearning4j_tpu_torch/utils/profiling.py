"""Profiler traces of the port (counterpart:
``deeplearning4j_tpu/utils/profiling.py`` — ``xplane_trace`` :32,
``link_stats`` :62 and ``XplaneTraceListener`` :72).

The JAX package captures an XLA xplane trace; the port captures a
``torch.profiler`` trace with the CPU activity and, where a card is
present, the CUDA activity, and writes it as a Chrome trace
(``export_chrome_trace``: ``<logdir>/trace_<pid>_<ns>.json``, opened by
``chrome://tracing`` or Perfetto). It is not an xplane: the names stay
the JAX package's so callers need no change. The trace holds the host's
operator spans and the card's kernels by name, the hand-written ones
(K1's ``lstm_scan_fwd``, K2's ``lstm_scan_bwd``...) among them.

  - ``xplane_trace(logdir)``: a context manager around any region; it
    yields a one-entry dict whose ``"path"`` holds the file once the
    region has ended.
  - ``XplaneTraceListener``: an iteration listener that traces iterations
    [start_iteration, start_iteration + num_iterations) of a fit; its
    ``path`` names the file once the window has closed.
  - ``link_stats(stats, logdir)``: records the trace directory as a
    ``parallel/stats.TrainingStats`` event, ``xplane_trace:<abs path>``.

As in the JAX package, a profiler that cannot start is logged and the
region runs untraced: profiling never stops a run. A caller that needs
the trace checks the file (the smoke does).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(logdir: str) -> str:
    return os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")


def _start(logdir: str) -> Optional[torch.profiler.profile]:
    """A started profiler, or None (logged) when it cannot start."""
    os.makedirs(logdir, exist_ok=True)
    try:
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        return prof
    except (RuntimeError, AssertionError) as e:
        logger.warning("profiler trace failed (%s: %s); region runs "
                       "untraced", type(e).__name__, e)
        return None


def _stop(prof: torch.profiler.profile, logdir: str) -> Optional[str]:
    """Stop and export; the file's path, or None (logged) on failure."""
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = _trace_path(logdir)
        prof.export_chrome_trace(path)
        return path
    except (RuntimeError, AssertionError, OSError) as e:
        logger.warning("profiler trace stop failed: %s", e)
        return None


@contextlib.contextmanager
def xplane_trace(logdir: str, enabled: bool = True):
    """Trace the enclosed region into a Chrome trace file in ``logdir``.
    Yields ``{"path": None}``; ``"path"`` is set when the region ends.
    With ``enabled=False`` nothing is made. An exception raised inside
    the region propagates unchanged."""
    out = {"path": None}
    if not enabled:
        yield out
        return
    prof = _start(logdir)
    try:
        yield out
    finally:
        if prof is not None:
            out["path"] = _stop(prof, logdir)


def link_stats(stats, logdir: str) -> None:
    """Record the trace directory in a TrainingStats timeline, so its
    exports point at the device-side trace."""
    if stats is None:
        return
    stats.record("xplane_trace:" + os.path.abspath(logdir),
                 stats.time_source.current_time_millis(), 0.0)


class XplaneTraceListener:
    """Trace a window of training iterations: capture starts when
    ``start_iteration`` is reached and stops after ``num_iterations``
    more have completed; ``stop()`` closes an open window early (and is
    idempotent). ``path`` names the trace file once written."""

    def __init__(self, logdir: str, start_iteration: int = 2,
                 num_iterations: int = 3, stats=None):
        self.logdir = logdir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self.stats = stats
        self.path: Optional[str] = None
        self._prof = None
        self._stop_at = 0
        self._done = False

    def iteration_done(self, model, iteration: int, score) -> None:
        if self._done:
            return
        if self._prof is None and iteration >= self.start_iteration:
            self._prof = _start(self.logdir)
            if self._prof is None:
                self._done = True
            else:
                self._stop_at = iteration + self.num_iterations
            return
        if self._prof is not None and iteration >= self._stop_at:
            self.stop()

    def stop(self) -> None:
        """Stop the trace if one is open, write it and link the stats."""
        if self._prof is not None:
            self.path = _stop(self._prof, self.logdir)
            self._prof = None
            self._done = True
            link_stats(self.stats, self.logdir)

    def __del__(self):
        # a window still open when the listener goes (a fit cut short)
        # would leave the process's profiler recording
        self.stop()
