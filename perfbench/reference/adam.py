"""Plain Adam for the references, over flat ``{path: tensor}`` dicts:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g², and
p -= lr · sqrt(1 - b2^t) / (1 - b1^t) · m / (sqrt(v) + eps)."""

from __future__ import annotations

import math
from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested parameter dict flattened by path (``blocks.Wq``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def init(params: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, Dict], t: int, lr: float
         ) -> Dict[str, torch.Tensor]:
    """Step ``t`` (1-based): the new params; ``state`` updated in place."""
    corr = math.sqrt(1 - B2 ** t) / (1 - B1 ** t)
    out = {}
    for k, p in params.items():
        g = grads[k]
        m = state["m"][k].mul_(B1).add_(g, alpha=1 - B1)
        v = state["v"][k].mul_(B2).addcmul_(g, g, value=1 - B2)
        out[k] = p - lr * corr * m / (torch.sqrt(v) + EPS)
    return out
