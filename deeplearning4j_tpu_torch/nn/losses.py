"""Loss functions of the output layers (counterpart:
``deeplearning4j_tpu/nn/losses.py``).

The eight losses of the reference's ``LossFunction`` enum. Every loss
takes ``(labels, output, mask)`` and reduces to the mean per example: the
per-element loss is summed over the feature axis, then averaged over the
examples (and, for a sequence output [N, T, F], over the steps); a mask
broadcastable to the leading axes keeps the entries where it is 1 and
divides by its sum. Softmax with ``mcxent`` or ``negativeloglikelihood``
is computed from the logits through log-softmax
(:func:`mcxent_from_logits`), the numerically stable path the output
layer takes (:func:`fused_with_softmax`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

_EPS = 1e-10


def _masked_mean_per_example(per_elem: torch.Tensor,
                             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Sum over the feature axis, mean over examples (and masked steps)."""
    per_row = per_elem.sum(dim=-1)
    if mask is not None:
        mask = torch.as_tensor(mask, device=per_row.device).to(per_row.dtype)
        mask = torch.broadcast_to(mask, per_row.shape)
        return (per_row * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return per_row.mean()


def mse(labels, output, mask=None):
    return _masked_mean_per_example(0.5 * (output - labels) ** 2, mask)


def squared_loss(labels, output, mask=None):
    return _masked_mean_per_example((output - labels) ** 2, mask)


def rmse_xent(labels, output, mask=None):
    return _masked_mean_per_example(
        torch.sqrt((output - labels) ** 2 + _EPS), mask)


def xent(labels, output, mask=None):
    """Binary cross entropy on a post-sigmoid output."""
    p = torch.clamp(output, _EPS, 1.0 - _EPS)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _masked_mean_per_example(per, mask)


def mcxent_from_logits(labels, logits, mask=None):
    """Softmax and multi-class cross entropy fused through log-softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return _masked_mean_per_example(-labels * logp, mask)


def mcxent(labels, output, mask=None):
    """Multi-class cross entropy on an already activated output."""
    return _masked_mean_per_example(
        -labels * torch.log(torch.clamp(output, _EPS, 1.0)), mask)


def negativeloglikelihood(labels, output, mask=None):
    return mcxent(labels, output, mask)


def expll(labels, output, mask=None):
    """Exponential log likelihood: mean(output - labels * log(output))."""
    return _masked_mean_per_example(
        output - labels * torch.log(torch.clamp(output, min=_EPS)), mask)


def reconstruction_crossentropy(labels, output, mask=None):
    return xent(labels, output, mask)


LOSSES: Dict[str, Callable] = {
    "mse": mse,
    "squared_loss": squared_loss,
    "rmse_xent": rmse_xent,
    "xent": xent,
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "expll": expll,
    "reconstruction_crossentropy": reconstruction_crossentropy,
}

# losses with the stable fused-from-logits path when paired with softmax
_FUSED_SOFTMAX = {"mcxent", "negativeloglikelihood"}


def loss_fn(name: str) -> Callable:
    try:
        return LOSSES[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown loss '{name}'. Known: {sorted(LOSSES)}") from None


def fused_with_softmax(name: str) -> bool:
    return name.lower() in _FUSED_SOFTMAX
