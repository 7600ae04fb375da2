"""Paged-KV and vector-index arena sizing and a model's resident bytes
(counterpart: ``deeplearning4j_tpu/ops/memory.py`` ``hbm_budget_gb`` :56,
``kv_block_bytes`` :332 and ``kv_arena_blocks`` :355 with their
``devices`` argument, ``ann_row_bytes`` :391, ``ann_arena_rows`` :396
and ``model_resident_bytes`` :430).

Same closed form as the JAX package, priced at the arena's dtype
(``ops/lowprec.kv_dtype``: the model's compute dtype unless
``DL4J_TPU_SERVE_KV_DTYPE`` says otherwise, so a bf16 arena on an f32
model gets ~2x the blocks on the same budget). The budget is an explicit
byte count, the ``DL4J_TPU_HBM_GB`` budget where the placement plane
passes it (``hbm_budget_gb``), or else the device's own memory —
``torch.cuda.get_device_properties(dev).total_memory`` on the card, the
host's physical memory on the CPU; the index arena is sized the same
way.

``transformer_preflight`` (JAX :158) and ``auto_fit_transformer`` (JAX
:293) size one TransformerLM training step against the budget. Param,
optimizer and gradient bytes are exact: the port's own ``init_params``
and ``init_opt_state`` run under ``FakeTensorMode``, whose tensors are
backed by the ``meta`` device, so nothing is allocated and the leaves'
shapes and dtypes are those of a real init (the JAX package counts
``jax.eval_shape``'s). Activations and logits are the JAX package's
analytic count. The XLA AOT memory ledger (``measure_memory``,
``MemoryStats``) is not ported: on the card
``torch.cuda.max_memory_allocated`` measures a step's peak.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of ``device``: the card's, or the host's RAM."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nest of dicts, lists and tuples
    (None and non-tensor leaves count nothing)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if torch.is_tensor(tree):
        return int(tree.numel() * tree.element_size())
    return 0


# the attributes of a served model that hold its tensors: the masters,
# layer states, optimizer state and (TransformerLM) the compute copy
MODEL_BUFFER_ATTRS = ("params", "states", "updater_state", "_opt",
                      "_compute")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def model_resident_bytes(model) -> int:
    """Device bytes a loaded model keeps resident (its
    ``MODEL_BUFFER_ATTRS`` trees, and a wrapper's ``base`` model's), each
    storage counted once however many trees share it. Shape arithmetic:
    no device read."""
    seen, total = set(), 0
    stack = [model]
    while stack:
        m = stack.pop()
        for attr in MODEL_BUFFER_ATTRS:
            for t in _leaves(getattr(m, attr, None)):
                key = (t.device, t.untyped_storage().data_ptr())
                if key in seen:
                    continue
                seen.add(key)
                total += int(t.untyped_storage().nbytes())
        base = getattr(m, "base", None)
        if base is not None:
            stack.append(base)
    return total


def hbm_budget_gb(default: float = 16.0) -> float:
    """The per-card memory budget in GB the placement and fleet sizers
    fit against: ``DL4J_TPU_HBM_GB``, else ``default`` (JAX :56)."""
    from deeplearning4j_tpu_torch.ops import env as envknob

    return float(envknob.get_float("DL4J_TPU_HBM_GB", default))


def kv_block_bytes(cfg, block_tokens: int,
                   dtype: Optional[torch.dtype] = None,
                   devices: int = 1) -> int:
    """Bytes of ONE paged KV block across all layers on one shard: K and
    V, ``[n_layers, block_tokens, n_heads / devices, head_dim]`` each, in
    the arena dtype (``ops/lowprec.kv_dtype`` unless given). ``devices``
    is the serving mesh's width (``serving/mesh.py`` head-shards the
    arena; ceil for an off-grid count, as JAX :332 prices it)."""
    if dtype is None:
        from deeplearning4j_tpu_torch.ops import lowprec

        dtype = lowprec.kv_dtype(cfg)
    devices = max(1, int(devices))
    hd = cfg.d_model // cfg.n_heads
    heads_local = -(-cfg.n_heads // devices)
    return (2 * cfg.n_layers * int(block_tokens) * heads_local * hd
            * _itemsize(dtype))


def kv_arena_blocks(cfg, block_tokens: int, *, device=None,
                    budget_bytes: Optional[int] = None, params=None,
                    kv_fraction: float = 0.5, max_blocks: int = 4096,
                    dtype: Optional[torch.dtype] = None,
                    hbm_gb: Optional[float] = None,
                    devices: int = 1) -> int:
    """How many KV blocks the arena can afford: (budget - 2 x parameter
    bytes) x ``kv_fraction`` / :func:`kv_block_bytes` at ``devices``
    shards (the budget is per shard; the serving mesh replicates the
    params), clamped to [one max_len sequence + 1, ``max_blocks``]. The
    budget is ``budget_bytes``, else ``hbm_gb`` GB (the placement's
    ``DL4J_TPU_HBM_GB``), else the memory of ``device``."""
    if budget_bytes is None and hbm_gb is not None:
        budget_bytes = float(hbm_gb) * 2.0 ** 30
    if budget_bytes is None:
        if device is None:
            raise ValueError("kv_arena_blocks needs a device or a budget")
        budget_bytes = device_memory_bytes(device)
    budget = float(budget_bytes)
    if params is not None:
        budget -= 2.0 * tree_bytes(params)
    per_block = kv_block_bytes(cfg, block_tokens, dtype, devices)
    blocks = int(max(0.0, budget) * float(kv_fraction) / per_block)
    floor = cfg.max_len // int(block_tokens) + 1
    return max(floor, min(int(max_blocks), blocks))


def ann_row_bytes(dim: int, dtype: torch.dtype = torch.float32) -> int:
    """Device bytes of ONE index row: a [dim] vector in the arena dtype."""
    return int(dim) * _itemsize(dtype)


def ann_arena_rows(dim: int, *, device=None,
                   budget_bytes: Optional[int] = None, params=None,
                   ann_fraction: float = 0.25, max_rows: int = 1 << 20,
                   min_rows: int = 1024,
                   dtype: torch.dtype = torch.float32) -> int:
    """How many vector rows the retrieval arena can afford, the sizing
    behind ``DL4J_TPU_ANN_ROWS=0`` (``retrieval/store.VectorStore``):
    (budget - 2 x the encoder's parameter bytes) x ``ann_fraction`` over
    three row copies (the staging arena, the published generation and the
    one a publish packs beside it), clamped to [min_rows, max_rows].
    ``budget_bytes`` defaults to the memory of ``device``. Closed form:
    no device read."""
    if budget_bytes is None:
        if device is None:
            raise ValueError("ann_arena_rows needs a device or a budget")
        budget_bytes = device_memory_bytes(device)
    budget = float(budget_bytes)
    if params is not None:
        budget -= 2.0 * tree_bytes(params)
    per_row = 3 * ann_row_bytes(dim, dtype)
    rows = int(max(0.0, budget) * float(ann_fraction) / per_row)
    return max(int(min_rows), min(int(max_rows), rows))


def _abstract_state_bytes(cfg) -> Tuple[int, int]:
    """(param bytes, optimizer-state bytes) of ``cfg``'s TransformerLM,
    from an init under ``FakeTensorMode`` (meta-backed: no allocation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deeplearning4j_tpu_torch.models.transformer import (
        init_opt_state,
        init_params,
    )

    with FakeTensorMode():
        params = init_params(cfg, device="cpu")
        # Adam's m, v and t, and under DL4J_TPU_BF16 the loss-scale state
        opt = init_opt_state(params)
        return tree_bytes(params), tree_bytes(opt)


def transformer_preflight(cfg, batch: int, *, accum_steps: int = 1,
                          remat: Optional[str] = None,
                          hbm_gb: Optional[float] = None,
                          ) -> Tuple[bool, Dict[str, Any]]:
    """The memory estimate of one TransformerLM training step under a
    remat policy and gradient-accumulation factor: (fits, report).

    Params, optimizer state and gradients are exact. Activations are the
    analytic per-layer residual count of the JAX package, scaled by the
    remat rung: ``none`` keeps every layer's residuals (~6 [B,S,D] + 2
    [B,S,F] buffers + the flash o/lse a layer); ``dots`` keeps each
    layer's dot outputs (5 [B,S,D] + 1 [B,S,F]) plus one layer's full set
    as the recompute peak; ``block`` keeps the [B,S,D] carry a layer plus
    one full set. With ``accum_steps`` A > 1 activations and logits are
    sized per microbatch (batch / A) and the gradient tree counts twice
    (the accumulator and the microbatch's). Logits count [mb, S, V] f32
    twice; the total carries 1.25x slack."""
    from deeplearning4j_tpu_torch.ops import lowprec
    from deeplearning4j_tpu_torch.ops.remat import remat_policy

    policy = remat_policy(remat if remat is not None else cfg.remat)
    if batch % accum_steps:
        raise ValueError(f"batch {batch} not divisible by accum_steps "
                         f"{accum_steps}")
    budget_gb = hbm_budget_gb() if hbm_gb is None else float(hbm_gb)
    seq = cfg.max_len
    # bf16 residuals under the performance policy or bf16 training
    bf16_acts = cfg.dtype_policy == "performance" or lowprec.train_policy()
    ib = 2 if bf16_acts else 4
    L = cfg.n_layers

    param_b, opt_b = _abstract_state_bytes(cfg)
    grad_b = param_b * (2 if accum_steps > 1 else 1)

    mb = batch // accum_steps
    bsd = mb * seq * cfg.d_model
    ff = mb * seq * cfg.d_ff
    layer_full = 6 * bsd + 2 * ff + bsd + 2 * mb * seq
    if policy == "none":
        act_b = L * layer_full * ib
    elif policy == "dots":
        act_b = (L * (5 * bsd + ff) + layer_full) * ib
    else:  # block
        act_b = (L * bsd + layer_full) * ib
    logit_b = 2 * mb * seq * cfg.vocab_size * 4
    total = (param_b + opt_b + grad_b + act_b + logit_b) * 1.25

    report = {
        "params_gb": round(param_b / 2**30, 2),
        "opt_gb": round(opt_b / 2**30, 2),
        "grads_gb": round(grad_b / 2**30, 2),
        "activations_gb_est": round(act_b / 2**30, 2),
        "logits_gb": round(logit_b / 2**30, 2),
        "total_gb_est": round(total / 2**30, 2),
        "hbm_gb": budget_gb,
        "batch": batch,
        "accum_steps": accum_steps,
        "remat": policy,
        "train_dtype": "bf16" if bf16_acts else "f32",
        "estimate": "analytic",
        "bytes": {"params": param_b, "opt": opt_b, "grads": grad_b,
                  "activations": act_b, "logits": logit_b},
    }
    return total <= budget_gb * 2**30, report


def auto_fit_transformer(cfg, *, batches=(32, 16, 8, 4),
                         accum_steps=(1, 2, 4), policies=None,
                         hbm_gb: Optional[float] = None,
                         ) -> Optional[Dict[str, Any]]:
    """The largest (batch, accum_steps, remat) whose preflight fits the
    budget (``DL4J_TPU_HBM_GB`` unless given): the largest global batch
    first, then accum_steps ascending, then the remat rungs weakest
    first. {"batch", "accum_steps", "remat", "report"}, or None when
    nothing fits."""
    from deeplearning4j_tpu_torch.ops.remat import POLICIES

    if policies is None:
        policies = POLICIES
    for b in sorted(set(batches), reverse=True):
        for a in sorted(set(accum_steps)):
            if b % a:
                continue
            for p in policies:
                fits, rep = transformer_preflight(
                    cfg, b, accum_steps=a, remat=p, hbm_gb=hbm_gb)
                if fits:
                    return {"batch": b, "accum_steps": a, "remat": p,
                            "report": rep}
    return None
