"""Products of the plain references in a given precision, for the
control that has to fail the comparison: every matrix product of the
reference with its operands rounded to the lower format and summed in
f32, as the tensor cores do.

- ``f32``: ``torch.matmul`` (the references turn TF32 off).
- ``tf32``: operands rounded to TF32 (10 mantissa bits, to nearest even),
  and the backward's incoming gradient too: the control of a strict f32
  configuration.
- ``fp8``: operands scaled per tensor into e4m3 and back, the backward's
  incoming gradient into e5m2 (the usual fp8 training recipe): the
  control of a bf16 configuration.
"""

from __future__ import annotations

from typing import Callable

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (to nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    """x scaled so its largest magnitude is the format's largest, cast
    to the fp8 format and back, and unscaled."""
    top = E4M3_MAX if fmt == torch.float8_e4m3fn else E5M2_MAX
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class _Round(torch.autograd.Function):
    """Forward: ``fn(x)``; backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Forward: x unchanged; backward: ``fn(gradient)``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def matmul(precision: str) -> Callable:
    """The product ``mm(a, b)`` (``torch.matmul``'s broadcasting) of the
    given precision."""
    if precision == "f32":
        return torch.matmul
    if precision == "tf32":
        def mm(a, b):
            y = torch.matmul(_Round.apply(a, round_tf32),
                             _Round.apply(b, round_tf32))
            return _RoundGrad.apply(y, round_tf32)
        return mm
    if precision == "fp8":
        fwd = lambda t: round_fp8(t, torch.float8_e4m3fn)  # noqa: E731
        bwd = lambda t: round_fp8(t, torch.float8_e5m2)  # noqa: E731

        def mm(a, b):
            y = torch.matmul(_Round.apply(a, fwd), _Round.apply(b, fwd))
            return _RoundGrad.apply(y, bwd)
        return mm
    raise ValueError(f"unknown precision {precision!r}")


class strict_f32:
    """A context in which f32 products and convolutions run in full f32
    (TF32 off), restored on exit."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
        return False
