"""Paged-KV arena sizing (counterpart: ``deeplearning4j_tpu/ops/memory.py``
``kv_block_bytes`` :332 and ``kv_arena_blocks`` :355).

Same closed form as the JAX package. The budget is the device's own
memory — ``torch.cuda.get_device_properties(dev).total_memory`` on the
card, the host's physical memory on the CPU — instead of the JAX
package's ``DL4J_TPU_HBM_GB`` knob. Preflight and remat sizing wait for
the training slice.
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
    """Bytes of every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return int(tree.numel() * tree.element_size())


def kv_block_bytes(cfg, block_tokens: int,
                   dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of ONE paged KV block across all layers: K and V,
    ``[n_layers, block_tokens, n_heads, head_dim]`` each, in the arena
    dtype (the model's compute dtype unless given)."""
    if dtype is None:
        dtype = cfg.compute_dtype
    hd = cfg.d_model // cfg.n_heads
    return (2 * cfg.n_layers * int(block_tokens) * cfg.n_heads * hd
            * _itemsize(dtype))


def kv_arena_blocks(cfg, block_tokens: int, *, device=None,
                    budget_bytes: Optional[int] = None, params=None,
                    kv_fraction: float = 0.5, max_blocks: int = 4096,
                    dtype: Optional[torch.dtype] = None) -> int:
    """How many KV blocks the arena can afford: (budget - 2 x parameter
    bytes) x ``kv_fraction`` / :func:`kv_block_bytes`, clamped to
    [one max_len sequence + 1, ``max_blocks``]. ``budget_bytes``
    defaults to the memory of ``device``."""
    if budget_bytes is None:
        if device is None:
            raise ValueError("kv_arena_blocks needs a device or a budget")
        budget_bytes = device_memory_bytes(device)
    budget = float(budget_bytes)
    if params is not None:
        budget -= 2.0 * tree_bytes(params)
    per_block = kv_block_bytes(cfg, block_tokens, dtype)
    blocks = int(max(0.0, budget) * float(kv_fraction) / per_block)
    floor = cfg.max_len // int(block_tokens) + 1
    return max(floor, min(int(max_blocks), blocks))
