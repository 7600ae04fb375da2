"""The per-layer application policy of the containers (counterpart:
``deeplearning4j_tpu/nn/common.py`` — ``compute_dtype_of``,
``cast_for_compute`` and ``apply_layer``, :20-100).

Only the dtype policy is ported: under ``dtype_policy="performance"`` a
layer's f32 params and input are cast to bf16 for its computation, output
layers are never downcast (a bf16 input is upcast to f32 for them), and a
cast layer's returned recurrent state is cast back to f32 so stored
states keep one dtype. Remat is training and waits for the training
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayerImpl


def compute_dtype_of(conf) -> Optional[torch.dtype]:
    """bf16 for the ``performance`` policy, None for strict f32."""
    if getattr(conf, "dtype_policy", "strict") == "performance":
        return torch.bfloat16
    return None


def cast_for_compute(params, x, dtype):
    """Cast the input and the layer's f32 params to ``dtype``; only f32 is
    downcast (f64 and integer tensors pass through)."""
    cast = lambda a: a.to(dtype) if a.dtype == torch.float32 else a
    return {k: cast(v) for k, v in params.items()}, cast(x)


def apply_layer(layer, conf, params, state, x, mask):
    compute_dtype = compute_dtype_of(conf)
    cast_active = (compute_dtype is not None
                   and not isinstance(layer, OutputLayerImpl))
    if cast_active:
        params, x = cast_for_compute(params, x, compute_dtype)
    elif compute_dtype is not None and x.dtype == compute_dtype:
        x = x.to(torch.float32)
    y, new_state = layer.apply(params, state, x, mask=mask)
    if cast_active and new_state:
        new_state = {k: v.to(torch.float32) if v.dtype == compute_dtype
                     else v for k, v in new_state.items()}
    return y, new_state
