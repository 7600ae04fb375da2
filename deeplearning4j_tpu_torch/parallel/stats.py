"""Distributed-training instrumentation (counterpart:
``deeplearning4j_tpu/parallel/stats.py`` — ``TimeSource``,
``SystemClockTimeSource``, ``NTPTimeSource``, ``EventStats``,
``TrainingStats`` with ``timed``, ``summary``, ``export_html`` and
``export_json``; pure Python, the same code).

Timestamped per-phase events (the reference Spark stats' EventStats)
aggregated by ``TrainingStats`` and exported as a self-contained HTML
timeline or JSON, with a pluggable time source (the host clock by
default; ``NTPTimeSource`` is an offset hook, it contacts no server).
"""

from __future__ import annotations

import html
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List


class TimeSource:
    """spark/time/TimeSource.java: currentTimeMillis()."""

    def current_time_millis(self) -> int:
        return int(time.time() * 1000)


class SystemClockTimeSource(TimeSource):
    pass


class NTPTimeSource(TimeSource):
    """Reference NTPTimeSource queries 0.pool.ntp.org for a cross-node clock
    offset. This environment has no network egress; the offset hook is kept
    so a deployment can inject one (e.g. from chrony) without touching
    callers."""

    def __init__(self, offset_millis: int = 0):
        self.offset_millis = offset_millis

    def current_time_millis(self) -> int:
        return int(time.time() * 1000) + self.offset_millis


@dataclass
class EventStats:
    """BaseEventStats: machine/worker ids + start time + duration."""

    event_type: str
    start_time_ms: int
    duration_ms: float
    worker_id: str = "worker-0"
    example_count: int = 0


@dataclass
class TrainingStats:
    """ParameterAveragingTrainingMasterStats-equivalent collection."""

    events: List[EventStats] = field(default_factory=list)
    time_source: TimeSource = field(default_factory=SystemClockTimeSource)

    def record(self, event_type: str, start_ms: int, duration_ms: float,
               worker_id: str = "worker-0", example_count: int = 0) -> None:
        self.events.append(
            EventStats(event_type, start_ms, duration_ms, worker_id, example_count)
        )

    class _Timer:
        def __init__(self, stats: "TrainingStats", event_type: str,
                     worker_id: str, example_count: int):
            self.stats = stats
            self.event_type = event_type
            self.worker_id = worker_id
            self.example_count = example_count

        def __enter__(self):
            self.t0 = self.stats.time_source.current_time_millis()
            self.p0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dur = (time.perf_counter() - self.p0) * 1000.0
            self.stats.record(self.event_type, self.t0, dur,
                              self.worker_id, self.example_count)
            return False

    def timed(self, event_type: str, worker_id: str = "worker-0",
              example_count: int = 0) -> "TrainingStats._Timer":
        return TrainingStats._Timer(self, event_type, worker_id, example_count)

    # -- aggregation ------------------------------------------------------
    def durations(self, event_type: str) -> List[float]:
        return [e.duration_ms for e in self.events if e.event_type == event_type]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for e in self.events:
            s = out.setdefault(
                e.event_type, {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            )
            s["count"] += 1
            s["total_ms"] += e.duration_ms
            s["max_ms"] = max(s["max_ms"], e.duration_ms)
        for s in out.values():
            s["mean_ms"] = s["total_ms"] / max(1, s["count"])
        return out

    # -- export (StatsUtils.exportStatsAsHtml) -----------------------------
    def export_html(self, path: str, title: str = "Training stats") -> None:
        """Self-contained HTML timeline + summary table."""
        if self.events:
            t0 = min(e.start_time_ms for e in self.events)
        else:
            t0 = 0
        rows = []
        lanes = sorted({e.worker_id for e in self.events})
        colors = ["#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
                  "#b279a2", "#ff9da6", "#9d755d"]
        types = sorted({e.event_type for e in self.events})
        color_of = {t: colors[i % len(colors)] for i, t in enumerate(types)}
        total_span = max(
            (e.start_time_ms - t0 + e.duration_ms for e in self.events),
            default=1.0,
        )
        total_span = max(total_span, 1e-6)  # all-zero-duration guard
        for e in self.events:
            left = 100.0 * (e.start_time_ms - t0) / total_span
            width = max(0.2, 100.0 * e.duration_ms / total_span)
            lane = lanes.index(e.worker_id)
            rows.append(
                f'<div class="ev" style="left:{left:.2f}%;width:{width:.2f}%;'
                f"top:{lane * 28}px;background:{color_of[e.event_type]}\" "
                f'title="{html.escape(e.event_type)} {e.duration_ms:.1f}ms '
                f'({html.escape(e.worker_id)})"></div>'
            )
        summary_rows = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v['count']:.0f}</td>"
            f"<td>{v['mean_ms']:.2f}</td><td>{v['max_ms']:.2f}</td>"
            f"<td>{v['total_ms']:.2f}</td></tr>"
            for k, v in sorted(self.summary().items())
        )
        legend = "".join(
            f'<span class="lg"><span class="sw" style="background:'
            f'{color_of[t]}"></span>{html.escape(t)}</span>'
            for t in types
        )
        doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title><style>
body{{font-family:sans-serif;margin:2em}}
.timeline{{position:relative;height:{max(1, len(lanes)) * 28 + 10}px;
border:1px solid #ccc;background:#fafafa}}
.ev{{position:absolute;height:22px;border-radius:3px;opacity:.85}}
table{{border-collapse:collapse;margin-top:1.5em}}
td,th{{border:1px solid #ccc;padding:4px 10px;text-align:right}}
th{{background:#eee}}.lg{{margin-right:1em}}
.sw{{display:inline-block;width:12px;height:12px;margin-right:4px;
border-radius:2px;vertical-align:middle}}</style></head><body>
<h2>{html.escape(title)}</h2><div>{legend}</div>
<div class="timeline">{''.join(rows)}</div>
<table><tr><th>event</th><th>count</th><th>mean ms</th><th>max ms</th>
<th>total ms</th></tr>{summary_rows}</table>
</body></html>"""
        with open(path, "w", encoding="utf-8") as f:
            f.write(doc)

    def export_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                [e.__dict__ for e in self.events], f, indent=1, sort_keys=True
            )
