"""The base64 record of ``/predict``'s ``record_base64`` (counterpart:
``deeplearning4j_tpu/streaming/conversion.py`` ``decode_record_base64``
:34-38): the raw little-endian float32 bytes of one flat record."""

from __future__ import annotations

import base64

import numpy as np


def decode_record_base64(payload: str) -> np.ndarray:
    """base64 of float32 bytes -> a float32 vector."""
    raw = base64.b64decode(payload)
    if len(raw) % 4 != 0:
        raise ValueError("payload length not a multiple of float32 size")
    return np.frombuffer(raw, dtype=np.float32).copy()
