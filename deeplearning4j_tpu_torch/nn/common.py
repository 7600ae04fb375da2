"""The per-layer application policy of the containers (counterpart:
``deeplearning4j_tpu/nn/common.py`` — ``tbptt_backprop_window``,
``compute_dtype_of``, ``cast_for_compute``, ``apply_layer``,
``cast_loss_input``, ``remat_apply`` and ``decay_lr_scale_entry``).

Under ``dtype_policy="performance"`` a layer's f32 params and input are
cast to bf16 for its computation; output and normalization layers (BN's
batch statistics, LRN's square sums) are never downcast (a bf16 input is
upcast to f32 for them), and a cast layer's returned
recurrent state is cast back to f32 so stored states keep one dtype.
In training a layer runs under the remat ladder (``ops/remat.py``): a
``DL4J_TPU_REMAT`` policy other than ``none`` wins, else
``conf.gradient_checkpointing`` means ``block``. The policy is read in
training only (the JAX package reads it at every trace).
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayerImpl
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalizationImpl,
    LocalResponseNormalizationImpl,
)
from deeplearning4j_tpu_torch.ops.lowprec import tree_map
from deeplearning4j_tpu_torch.ops.remat import remat_policy, remat_wrap

# layers that compute in f32 under the performance policy
_NEVER_CAST = (OutputLayerImpl, BatchNormalizationImpl,
               LocalResponseNormalizationImpl)


def tbptt_backprop_window(conf) -> Optional[int]:
    """The in-window TBPTT backward length, or None when it is not shorter
    than the forward length."""
    back = conf.tbptt_back_length
    if back and back < conf.tbptt_fwd_length:
        return back
    return None


def compute_dtype_of(conf) -> Optional[torch.dtype]:
    """bf16 for the ``performance`` policy, None for strict f32."""
    if getattr(conf, "dtype_policy", "strict") == "performance":
        return torch.bfloat16
    return None


def cast_for_compute(params, x, dtype):
    """Cast the input and the layer's f32 params to ``dtype``; only f32 is
    downcast (f64 and integer tensors pass through)."""
    cast = lambda a: a.to(dtype) if a.dtype == torch.float32 else a
    return tree_map(cast, params), cast(x)


def apply_layer(layer, conf, params, state, x, gen, mask, kwargs=None, *,
                train: bool = False):
    """One layer under the container's policy: the dtype cast, then
    ``layer.apply`` with the dropout generator ``gen``, the mask and the
    layer's extra ``kwargs`` (carry_state, backprop_window)."""
    compute_dtype = compute_dtype_of(conf)
    cast_active = (compute_dtype is not None
                   and not isinstance(layer, _NEVER_CAST))
    if cast_active:
        params, x = cast_for_compute(params, x, compute_dtype)
    elif compute_dtype is not None and x.dtype == compute_dtype:
        x = x.to(torch.float32)
    effective = "none"
    if train:
        env_policy = remat_policy("auto")
        effective = env_policy if env_policy != "none" else (
            "block" if conf.gradient_checkpointing else "none")
    if effective != "none":
        y, new_state = remat_apply(layer, params, state, x, gen, mask,
                                   kwargs, policy=effective)
    else:
        y, new_state = layer.apply(params, state, x, train=train, gen=gen,
                                   mask=mask, **(kwargs or {}))
    if cast_active and new_state:
        new_state = {k: v.to(torch.float32) if v.dtype == compute_dtype
                     else v for k, v in new_state.items()}
    return y, new_state


def cast_loss_input(x: torch.Tensor) -> torch.Tensor:
    """Loss math stays at f32 or wider: bf16 and f16 are upcast."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32)
    return x


def remat_apply(layer, params, state, x, gen, mask, kwargs, policy: str):
    """A training ``layer.apply`` under a rung of the remat ladder: the
    backward recomputes the layer's activations (``block``) or all but its
    products' outputs (``dots``). The dropout generator is replayed from
    its state at the call, so the recompute draws the same masks."""
    gen_state = None if gen is None else gen.get_state()

    def run(p, s, xx):
        g = gen
        if gen_state is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(gen_state)
        return layer.apply(p, s, xx, train=True, gen=g, mask=mask,
                           **(kwargs or {}))

    return remat_wrap(run, policy)(params, state, x)


def decay_lr_scale_entry(state, rate: float):
    """One layer's updater state with its ``lr_scale`` (the ``score`` LR
    policy's cumulative decay) multiplied by ``rate``; a state without it
    passes through."""
    if isinstance(state, dict) and "lr_scale" in state:
        return {**state, "lr_scale": state["lr_scale"] * rate}
    return state
