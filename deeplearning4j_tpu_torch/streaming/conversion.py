"""Record <-> array conversion and the base64 record serde
(counterpart: ``deeplearning4j_tpu/streaming/conversion.py``): a record
is a flat list of values, an array a float32 vector; base64 wraps the raw
little-endian float32 bytes (``/predict``'s ``record_base64``)."""

from __future__ import annotations

import base64
from typing import List, Sequence

import numpy as np


def record_to_array(record: Sequence) -> np.ndarray:
    """One record (a sequence of numbers or numeric strings) -> a float32
    vector."""
    return np.array([float(v) for v in record], np.float32)


def array_to_record(arr: np.ndarray) -> List[float]:
    return [float(v) for v in np.asarray(arr).reshape(-1)]


def encode_record_base64(record: Sequence) -> str:
    """Record -> base64 of its little-endian float32 bytes."""
    return base64.b64encode(record_to_array(record).tobytes()).decode("ascii")


def decode_record_base64(payload: str) -> np.ndarray:
    """base64 of float32 bytes -> a float32 vector."""
    raw = base64.b64decode(payload)
    if len(raw) % 4 != 0:
        raise ValueError("payload length not a multiple of float32 size")
    return np.frombuffer(raw, dtype=np.float32).copy()
