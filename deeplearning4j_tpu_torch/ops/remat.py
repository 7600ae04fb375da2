"""Activation-rematerialization policy (counterpart:
``deeplearning4j_tpu/ops/remat.py`` — ``ENV_REMAT``, ``POLICIES``,
``remat_policy`` :56 and ``remat_wrap`` :86).

One knob, ``DL4J_TPU_REMAT``, a three-rung ladder (each rung less
activation memory, more recompute in the backward):

  ``none``   store every activation;
  ``dots``   a selective checkpoint: keep the outputs of the matrix
             products (``aten.mm``, ``aten.bmm``, ``aten.addmm``) and of
             K4's forward (the ``dl4j_tpu_torch::flash_attention``
             operator of ``ops/flash_attention.FlashFn``), recompute the
             rest (``create_selective_checkpoint_contexts`` of
             ``torch.utils.checkpoint``);
  ``block``  store only the function's inputs and recompute all of it
             (``torch.utils.checkpoint.checkpoint``, non-reentrant).

An explicit policy wins; ``"auto"`` (the config default) defers to the
knob, whose absence means ``none``; an unknown name raises. The JAX
package resolves the policy when it traces a step; the port runs eagerly
and resolves it where it wraps (each training forward).

Consumed by ``models/transformer.forward`` (each block, when gradients
are being recorded) and the containers' per-layer remat
(``nn/common.apply_layer``: ``conf.gradient_checkpointing`` is the
``block`` rung).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import env as envknob

ENV_REMAT = "DL4J_TPU_REMAT"

# ladder order: increasing memory savings, increasing backward recompute
POLICIES = ("none", "dots", "block")


def remat_policy(configured: Optional[str] = "auto") -> str:
    """The active policy: ``configured`` when it names one; ``"auto"``
    (or None or empty) defers to ``DL4J_TPU_REMAT``, unset meaning
    ``none``. Unknown names raise."""
    v = (configured or "auto").strip().lower()
    if v == "auto":
        v = envknob.raw(ENV_REMAT).strip().lower() or "none"
    if v not in POLICIES:
        raise ValueError(
            f"unknown remat policy {v!r} (known: {', '.join(POLICIES)}, "
            "or 'auto' to defer to DL4J_TPU_REMAT)")
    return v


def saved_ops():
    """The operators whose outputs the ``dots`` rung keeps."""
    import deeplearning4j_tpu_torch.ops.flash_attention  # noqa: F401 (op)

    aten = torch.ops.aten
    return [aten.mm.default, aten.bmm.default, aten.addmm.default,
            torch.ops.dl4j_tpu_torch.flash_attention.default]


def checkpoint_kwargs(policy: str) -> dict:
    """kwargs for ``torch.utils.checkpoint.checkpoint`` implementing one
    active rung (``none`` is not one: callers skip the wrap)."""
    if policy == "block":
        return {"use_reentrant": False}
    if policy == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        return {"use_reentrant": False,
                "context_fn": functools.partial(
                    create_selective_checkpoint_contexts, saved_ops())}
    raise ValueError(f"no checkpoint kwargs for policy {policy!r}")


def remat_wrap(fn, policy: Optional[str] = "auto"):
    """``fn`` under the resolved policy; ``none`` returns it untouched.
    The wrap checkpoints only while gradients are recorded: without them
    it calls ``fn`` as it is."""
    pol = remat_policy(policy)
    if pol == "none":
        return fn
    kwargs = checkpoint_kwargs(pol)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, **kwargs, **kw)

    return wrapped
