"""Plain GPT-2 training, the reference of the ``transformer_lm`` cells:
float32 PyTorch with TF32 off, no kernels, no cache, no batching tricks.
It imports nothing of the port and takes nothing the port made: it reads
the benchmark's seeded weights and token rows.

The model is GPT-2 as the configuration runs it (its ``departures``):
learned positions, pre-LN blocks (LN eps from the file), causal softmax
attention over ``n_heads`` heads of d/n_heads, the tanh GELU MLP with its
biases, a final LN and the head tied to the token embedding; the loss is
the mean next-token cross-entropy over every position of the batch.
Adam (b1 0.9, b2 0.999, eps 1e-8, the bias correction folded into the
step) at the file's fixed rate.

The batch's gradient is summed over blocks of rows, so the activations
of one block at a time are held (``rows`` per block).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import adam
from perfbench.reference.lowprec import matmul, strict_f32


def layer_norm(x, g, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def causal_attention(q, k, v, n_heads: int, mm: Callable):
    n, t, d = q.shape
    hd = d // n_heads
    q, k, v = (a.reshape(n, t, n_heads, hd).transpose(1, 2)
               for a in (q, k, v))
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    hidden = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
    return mm(p, v).transpose(1, 2).reshape(n, t, d)


def logits(params: Dict, tokens, model: Dict, mm: Callable = torch.matmul):
    """tokens [N, T] -> logits [N, T, V], f32."""
    eps = model["ln_eps"]
    t = tokens.shape[1]
    h = params["embed"][tokens] + params["pos"][:t][None]
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(model["n_layers"]):
        b = {k: v[i] for k, v in blocks.items()}
        x = layer_norm(h, b["ln1_g"], b["ln1_b"], eps)
        a = causal_attention(mm(x, b["Wq"]), mm(x, b["Wk"]), mm(x, b["Wv"]),
                             model["n_heads"], mm)
        h = h + mm(a, b["Wo"])
        x = layer_norm(h, b["ln2_g"], b["ln2_b"], eps)
        h = h + mm(F.gelu(mm(x, b["W1"]) + b["b1"], approximate="tanh"),
                   b["W2"]) + b["b2"]
    h = layer_norm(h, params["lnf_g"], params["lnf_b"], eps)
    return mm(h, params["embed"].T)


def loss_and_grads(params: Dict, tokens, targets, model: Dict,
                   mm: Callable, rows: int):
    """The batch's mean cross-entropy and its gradient for every leaf,
    summed over blocks of ``rows`` rows."""
    names = list(adam.leaves(params))
    live = {k: v.detach().requires_grad_(True)
            for k, v in adam.leaves(params).items()}
    tree = adam.unflatten(live)
    n = tokens.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grads = {k: torch.zeros_like(v) for k, v in live.items()}
    for r0 in range(0, n, rows):
        x, y = tokens[r0:r0 + rows], targets[r0:r0 + rows]
        with torch.enable_grad():
            lg = logits(tree, x, model, mm)
            nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                                  y.reshape(-1), reduction="sum")
            part = nll / targets.numel()
            g = torch.autograd.grad(part, [live[k] for k in names])
        total = total + part.detach()
        for k, gk in zip(names, g):
            grads[k] += gk
        del lg, nll, part, g
    return total, grads


def train_readings(params0: Dict, batches: List, model: Dict,
                   precision: str = "f32", rows: int = 4,
                   keep_rows: Optional[int] = None) -> Dict:
    """Three (or ``len(batches)``) Adam steps from ``params0`` on
    ``batches`` ([(tokens, targets)], each [N, T]): each step's loss, the
    first gradient's norm per leaf, and each leaf's change after the last
    step. ``keep_rows`` trains on the first rows of each batch only (the
    half-batch fault)."""
    mm = matmul(precision)
    with strict_f32():
        p = {k: v.detach().clone() for k, v in adam.leaves(params0).items()}
        state = adam.init(p)
        losses, first = [], None
        for step, (x, y) in enumerate(batches, start=1):
            if keep_rows is not None:
                x, y = x[:keep_rows], y[:keep_rows]
            loss, g = loss_and_grads(adam.unflatten(p), x.long(), y.long(),
                                     model, mm, rows)
            losses.append(float(loss))
            if first is None:
                first = {k: float(v.norm()) for k, v in g.items()}
            p = adam.step(p, g, state, step, model["learning_rate"])
            del g
        start = adam.leaves(params0)
        change = {k: float((p[k] - start[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
