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
way. Preflight, remat sizing and the AOT
memory ledger (``measure_memory``) wait for a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

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
