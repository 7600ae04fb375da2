"""Shape bucketing (counterpart: ``deeplearning4j_tpu/ops/dispatch.py``
``bucket_size`` :360, the "off" test of ``bucketing_mode``, ``pad_axis0``
:378 and ``inference_bucket`` :387).

Admission prefill pads a prompt to a bucket width, and
``MultiLayerNetwork.output`` pads a ragged batch to a bucket row count, so
a stream of arbitrary sizes meets a small set of shapes (the batcher's
warm-up covers every bucket). Inference padding is safe: every op of the
ported layers is row-independent. Donation, jit caches and dispatch
stats have no counterpart here: PyTorch runs eagerly and the port updates
its single-owner buffers in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import env as envknob

_OFF = ("0", "off", "false", "no")


def bucket_size(n: int) -> int:
    """Smallest size >= n in {1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, ...}:
    powers of two and 1.5x powers of two, so padding stays under 50%."""
    if n <= 2:
        return max(n, 1)
    p = 1
    while p < n:
        p <<= 1
    mid = (p >> 1) + (p >> 2)  # 1.5 * (p/2), sits between p/2 and p
    return mid if (p >= 4 and n <= mid) else p


def bucketing_off() -> bool:
    """``DL4J_TPU_BUCKET_BATCHES`` set to 0/off/false/no. Its other values
    (the JAX package's "auto" and "always") both pad at inference."""
    return envknob.raw("DL4J_TPU_BUCKET_BATCHES").strip().lower() in _OFF


def inference_bucket(n: int) -> Optional[int]:
    """The padded row count for an inference batch of ``n`` rows, or None
    when no padding applies (bucketing off, or n already a bucket)."""
    if bucketing_off():
        return None
    target = bucket_size(n)
    return None if target == n else target


def pad_axis0(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad axis 0 up to ``target`` rows (no-op when already there)."""
    if x.shape[0] == target:
        return x
    pad = x.new_zeros((target - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)
