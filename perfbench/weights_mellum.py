"""Weights of a ``mellum_lm`` configuration, made from the run's seed on
the device as ``weights.py`` makes GPT-2's: one ``torch.randn`` for every
normally distributed leaf, cut into views and scaled, in f32. The same
seed on the same device gives the same bits, so a driver can make them
again for the reference once the program is gone.

The layout is the port's parameter dict for its extended options
(``models/transformer._init_extended``): ``embed`` and ``lm_head`` [V, d],
``lnf_g`` [d], and ``blocks`` with per-layer leaves stacked [L, ...]:
``ln1_g``, ``Wq`` [d, H hd], ``Wk``/``Wv`` [d, H_kv hd], ``Wo`` [H hd, d],
``ln2_g``, the router ``Wr`` [d, E] and the held experts' ``W1``
[E_h, d, 2 f] (gate columns, then up) and ``W2`` [E_h, f, d]. The scales
are the port's own init: xavier-normal q/k/v, router and ``W1``,
0.02/sqrt(2L) ``Wo`` and ``W2``, 0.02 ``embed`` and ``lm_head``; unit norm
scales. The plain reference reads the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    d, f, L = m["d_model"], m["d_ff"], m["n_layers"]
    qd = m["n_heads"] * m["head_dim"]
    kvd = m["n_kv_heads"] * m["head_dim"]
    return [("embed", (m["vocab_size"], d)),
            ("lm_head", (m["vocab_size"], d)),
            ("Wq", (L, d, qd)), ("Wk", (L, d, kvd)), ("Wv", (L, d, kvd)),
            ("Wo", (L, qd, d)), ("Wr", (L, d, m["experts"])),
            ("W1", (L, m["experts_held"], d, 2 * f)),
            ("W2", (L, m["experts_held"], f, d))]


def _scales(m: Dict) -> Dict[str, float]:
    depth = 0.02 / math.sqrt(2 * m["n_layers"])
    out = {}
    for name, shape in _shapes(m):
        if name in ("embed", "lm_head"):
            out[name] = 0.02
        elif name in ("Wo", "W2"):
            out[name] = depth
        else:
            out[name] = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return out


def count(model: Dict) -> int:
    """Parameters of the configuration as held here."""
    d, L = model["d_model"], model["n_layers"]
    return sum(math.prod(s) for _, s in _shapes(model)) + (2 * L + 1) * d


def make(model: Dict, seed: int, device) -> Dict:
    """The parameter dict of ``model`` (the ``model`` block of a
    configuration file) drawn from ``seed`` on ``device``."""
    shapes = _shapes(model)
    scales = _scales(model)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    leaves, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        leaves[name] = flat[at:at + n].view(shape).mul_(scales[name])
        at += n
    d, L = model["d_model"], model["n_layers"]

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    blocks = {"ln1_g": ones((L, d)), "Wq": leaves["Wq"], "Wk": leaves["Wk"],
              "Wv": leaves["Wv"], "Wo": leaves["Wo"], "ln2_g": ones((L, d)),
              "Wr": leaves["Wr"], "W1": leaves["W1"], "W2": leaves["W2"]}
    return {"embed": leaves["embed"], "lm_head": leaves["lm_head"],
            "lnf_g": ones((d,)), "blocks": blocks}
