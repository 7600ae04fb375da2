"""Shape bucketing (counterpart: ``deeplearning4j_tpu/ops/dispatch.py:360``).

Admission prefill pads a prompt to a bucket width so a stream of prompts
of arbitrary length meets a small set of shapes. Donation, jit caches and
dispatch stats have no counterpart here: PyTorch runs eagerly and the
port updates its single-owner buffers in place.
"""

from __future__ import annotations


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
