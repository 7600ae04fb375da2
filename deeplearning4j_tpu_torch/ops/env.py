"""Env knobs the port reads — its own copy of the serving entries of the
JAX package's table (``deeplearning4j_tpu/ops/env.py``), same names and
same defaults. Only the knobs the paged ``/generate`` path reads are
here; the rest of the table waits for the slices that read them.

A read of a name that is not in this table raises, so a typo fails
loudly instead of silently meaning "default" (the JAX table's rule).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict


class KnobError(KeyError):
    """Read of a knob name that is not in this table."""


@dataclass(frozen=True)
class Knob:
    name: str
    default: str  # raw default, as the env string
    kind: str     # int | float
    doc: str


KNOBS: Dict[str, Knob] = {}


def _register(name: str, default: str, kind: str, doc: str) -> None:
    KNOBS[name] = Knob(name, default, kind, doc)


_register("DL4J_TPU_SERVE_QUEUE_CAP", "512", "int",
          "request queue cap; past it /generate answers 429")
_register("DL4J_TPU_SERVE_TIMEOUT_S", "60", "float",
          "per-request deadline; past it /generate answers 504")
_register("DL4J_TPU_SERVE_SLOTS", "4", "int",
          "lane floor of the paged decode pool")
_register("DL4J_TPU_SERVE_KV_BLOCK", "16", "int",
          "paged-KV block size in tokens for /generate")
_register("DL4J_TPU_SERVE_KV_BLOCKS", "0", "int",
          "paged-KV arena size in blocks (0 = auto-size from the "
          "device's memory via ops/memory.kv_arena_blocks)")


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KnobError(f"{name} is not a knob of the port's table "
                        "(deeplearning4j_tpu_torch/ops/env.py)") from None


def raw(name: str) -> str:
    """The env string, or the table default when unset or empty."""
    k = knob(name)
    v = os.environ.get(name)
    return k.default if v is None or v == "" else v


def get_int(name: str) -> int:
    """Integer value; garbage falls back to the table default."""
    try:
        return int(raw(name).strip())
    except ValueError:
        return int(knob(name).default)


def get_float(name: str) -> float:
    """Float value; garbage falls back to the table default."""
    try:
        return float(raw(name).strip())
    except ValueError:
        return float(knob(name).default)
