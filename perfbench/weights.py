"""Weights made from the run's seed on the device, in a few large calls:
one ``torch.randn`` for every normally distributed leaf, cut into views
and scaled, in f32 (the masters the port trains and serves from). The
same seed on the same device gives the same bits, so a driver can make
them again for the reference once the program is gone.

The layout is the port's parameter dict (``embed``, ``pos``, ``lnf_g``,
``lnf_b``, and ``blocks`` with per-layer leaves stacked [L, ...]); the
plain references read the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    d, f, L = m["d_model"], m["d_ff"], m["n_layers"]
    return [("embed", (m["vocab_size"], d)), ("pos", (m["max_len"], d)),
            ("Wq", (L, d, d)), ("Wk", (L, d, d)), ("Wv", (L, d, d)),
            ("Wo", (L, d, d)), ("W1", (L, d, f)), ("W2", (L, f, d))]


def _scales(m: Dict) -> Dict[str, float]:
    """Standard deviations of each normal leaf: the port's own init
    (``models/transformer.init_params``: xavier-normal q/k/v/W1,
    0.02/sqrt(2L) Wo/W2, 0.02 embed, 0.01 pos) for ``"transformer"``, and
    BERT's N(0, 0.02) everywhere for ``"bert"``."""
    d, f, L = m["d_model"], m["d_ff"], m["n_layers"]
    if m["init"] == "bert":
        return {k: 0.02 for k, _ in _shapes(m)}
    depth = 0.02 / math.sqrt(2 * L)
    xd = math.sqrt(2.0 / (d + d))
    return {"embed": 0.02, "pos": 0.01, "Wq": xd, "Wk": xd, "Wv": xd,
            "Wo": depth, "W1": math.sqrt(2.0 / (d + f)), "W2": depth}


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
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    blocks = {"ln1_g": const((L, d), 1.0), "ln1_b": const((L, d), 0.0),
              "Wq": leaves["Wq"], "Wk": leaves["Wk"], "Wv": leaves["Wv"],
              "Wo": leaves["Wo"],
              "ln2_g": const((L, d), 1.0), "ln2_b": const((L, d), 0.0),
              "W1": leaves["W1"], "b1": const((L, f), 0.0),
              "W2": leaves["W2"], "b2": const((L, d), 0.0)}
    return {"embed": leaves["embed"], "pos": leaves["pos"],
            "lnf_g": const((d,), 1.0), "lnf_b": const((d,), 0.0),
            "blocks": blocks}


def named(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a parameter dict by path (``blocks.Wq``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
