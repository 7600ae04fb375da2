"""Shape bucketing (counterpart: ``deeplearning4j_tpu/ops/dispatch.py``
``bucketing_mode`` :338, ``bucket_size`` :360, ``pad_axis0`` :378,
``inference_bucket`` :387, ``pad_rows`` :403 and ``row_validity_mask``
:422; the decode half of ``DispatchStats`` :151 and its
``loss_scale_skips``).

Admission prefill pads a prompt to a bucket width,
``MultiLayerNetwork.output`` pads a ragged batch to a bucket row count,
and ``fit`` pads a ragged training batch to its bucket with the pad rows
masked out of the loss, so a stream of arbitrary sizes meets a small set
of shapes. Inference padding is safe: every op of the ported layers is
row-independent. Donation, jit caches and the trace counters have no
counterpart here: PyTorch runs eagerly and the port updates its
single-owner buffers in place. ``DispatchStats`` keeps the decode
pools' ledger (ticks dispatched and the tokens they committed) and, for
the containers, the bf16 steps skipped on non-finite gradients.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.ops import env as envknob

_OFF = ("0", "off", "false", "no")
_ON = ("1", "on", "true", "yes", "force")


def bucketing_mode() -> str:
    """``DL4J_TPU_BUCKET_BATCHES``, read at call time: "off" (never pad),
    "always" (every fit pads) or "auto", the default: pad inside
    ``fit_iterator`` and in inference, and leave a direct ``fit`` exact."""
    v = envknob.raw("DL4J_TPU_BUCKET_BATCHES").strip().lower()
    if v in _OFF:
        return "off"
    if v in _ON:
        return "always"
    return "auto"


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


def inference_bucket(n: int) -> Optional[int]:
    """The padded row count for an inference batch of ``n`` rows, or None
    when no padding applies (bucketing off, or n already a bucket)."""
    if bucketing_mode() == "off":
        return None
    target = bucket_size(n)
    return None if target == n else target


def pad_axis0(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad axis 0 up to ``target`` rows (no-op when already there)."""
    if x.shape[0] == target:
        return x
    pad = x.new_zeros((target - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)


def pad_rows(target: int, arrays: Sequence[Optional[torch.Tensor]]
             ) -> List[Optional[torch.Tensor]]:
    """Each tensor padded along axis 0 to ``target`` (None passes)."""
    return [None if a is None else pad_axis0(a, target) for a in arrays]


def row_validity_mask(n_real: int, n_padded: int,
                      time_steps: Optional[int] = None, *,
                      device=None) -> torch.Tensor:
    """1.0 for real rows, 0.0 for pad rows, [n_padded] or
    [n_padded, time_steps]: fed as the label mask, so the masked-mean loss
    divides by the real example count (and equals the plain mean on an
    unpadded batch)."""
    m = (torch.arange(n_padded, device=device) < n_real).to(torch.float32)
    if time_steps is not None:
        m = m[:, None].expand(n_padded, time_steps)
    return m


class DispatchStats:
    """A decode pool's dispatch ledger (the JAX ``DispatchStats``'s
    ``decode_ticks`` / ``decode_tokens``): device ticks dispatched (a
    k-step tick is one, a speculative round two: draft and verify) and
    the tokens they committed over every lane. ``tokens_per_dispatch``
    is what the per-tick host cost divides by. ``loss_scale_skips`` is
    a container's count of bf16 steps skipped (synced when its
    ``loss_scale`` is read)."""

    def __init__(self) -> None:
        self.decode_ticks = 0
        self.decode_tokens = 0
        self.loss_scale_skips = 0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "loss_scale_skips": self.loss_scale_skips,
            "decode_ticks": self.decode_ticks,
            "decode_tokens": self.decode_tokens,
            "tokens_per_dispatch": (
                round(self.decode_tokens / self.decode_ticks, 4)
                if self.decode_ticks else None),
        }
