"""What the ``program_span`` metrics read: the port's own training spans
(``deeplearning4j_tpu_torch/obs/trace.py``), which a ``torch.profiler``
session turns on, so the traced slice's steps and nothing else leave
them in the tracer's ring.

Of the last ``trace_steps`` ``train.step`` spans in the ring (the traced
slice's steps), the spans of one name among their descendants (by
``parent_id``), summed and divided by the steps those ``train.step``
spans ran (their ``steps``). None where the ring holds no such span or
where one's reading is missing (a device time not yet resolved), as on
a program without these spans.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def per_step_ms(spans: List[Dict], steps: int, name: str,
                clock: str) -> Optional[float]:
    """Milliseconds of ``clock`` (``device_s`` or ``duration_s``) of the
    ``name`` spans under the last ``steps`` ``train.step`` spans of
    ``spans`` (ring order), per step."""
    roots = [s for s in spans if s["name"] == "train.step"][-steps:]
    if not roots:
        return None
    chosen = {s["span_id"] for s in roots}
    parent = {s["span_id"]: s["parent_id"] for s in spans}

    def under(span_id):
        while span_id is not None:
            if span_id in chosen:
                return True
            span_id = parent.get(span_id)
        return False

    picked = [s for s in spans
              if s["name"] == name and under(s["parent_id"])]
    values = [s.get(clock) for s in picked]
    if not values or any(v is None for v in values):
        return None
    n = sum(int(s["attrs"].get("steps", 1)) for s in roots)
    return 1e3 * sum(values) / n


def read(run, name: str, clock: str) -> Optional[float]:
    """:func:`per_step_ms` of the port's tracer ring in this process."""
    from deeplearning4j_tpu_torch.obs import trace

    return per_step_ms(trace.tracer().spans(),
                       int(run.cell.traffic["trace_steps"]), name, clock)
