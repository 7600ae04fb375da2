"""Numerics policy (counterpart: ``deeplearning4j_tpu/ops/dtypes.py`` —
``DtypePolicy`` :23, ``STRICT`` and ``PERFORMANCE``, ``get_policy`` and
``set_policy``, ``softmax_dtype`` and ``float32_strict`` :73).

Two policies, as in the JAX package:

  - ``STRICT``: params, compute and outputs in f32, matmul precision
    "highest";
  - ``PERFORMANCE``: f32 params, bf16 compute, matmul precision
    "default".

``float32_strict()`` makes ``STRICT`` the policy for its body and pins
f32 products, TF32 off in cuBLAS and cuDNN, the port's counterpart of
JAX's ``default_matmul_precision('highest')``; on exit it restores what
was set. The port's entry points already pin TF32 off on the card
(``ops/device.resolve_device``). The policy is process state, as in the
JAX package; bf16 loss-scaled training is ``ops/lowprec.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    # 'default' | 'float32' | 'highest', as in the JAX package
    matmul_precision: str = "highest"

    def cast_compute(self, x):
        return torch.as_tensor(x).to(self.compute_dtype)

    def cast_param(self, x):
        return torch.as_tensor(x).to(self.param_dtype)

    def cast_output(self, x):
        return torch.as_tensor(x).to(self.output_dtype)


STRICT = DtypePolicy()
PERFORMANCE = DtypePolicy(compute_dtype=torch.bfloat16,
                          matmul_precision="default")

_policy: DtypePolicy = STRICT


def get_policy() -> DtypePolicy:
    return _policy


def set_policy(policy: DtypePolicy) -> None:
    global _policy
    _policy = policy


def softmax_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for softmax upcasts: AT LEAST float32, never a
    downcast — bf16/f16 -> f32, f32 -> f32, f64 -> f64."""
    return torch.promote_types(dtype, torch.float32)


@contextlib.contextmanager
def float32_strict():
    """``STRICT`` and full f32 products for the body."""
    prev = _policy
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_dnn = torch.backends.cudnn.allow_tf32
    set_policy(STRICT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        set_policy(prev)
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_dnn
