"""Numerics policy helpers (counterpart: ``deeplearning4j_tpu/ops/dtypes.py``).

Only the softmax accumulation rule is ported: the training-time policy
objects wait for the training slice.
"""

from __future__ import annotations

import torch


def softmax_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for softmax upcasts: AT LEAST float32, never a
    downcast — bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return torch.promote_types(dtype, torch.float32)
