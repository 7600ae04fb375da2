"""Plain BERT masked-LM training, the reference of the ``bert_mlm``
cells: float32 PyTorch with TF32 off, no kernels. It imports nothing of
the port and takes nothing the port made: it reads the benchmark's
seeded weights and rows, and draws the masks itself from the run's seed.

The model is BERT-base as the configuration runs it (its
``departures``): token and learned position embeddings, pre-LN encoder
blocks (LN eps from the file) with bidirectional softmax attention whose
pad keys are hidden from every query, the tanh GELU MLP, a final LN and
the head tied to the token embedding. The loss is the cross-entropy of
the selected positions, averaged over them. Masks follow the 80/10/10
recipe: a position that is not pad is selected with probability
``mlm_prob``; of the selected, 80 % become the [MASK] id, 10 % a random
id other than pad, 10 % stay; at least one position is selected.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.reference import adam
from perfbench.reference.gpt2 import layer_norm
from perfbench.reference.lowprec import matmul, strict_f32


def draw_masks(tokens: np.ndarray, model: Dict, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inputs, targets, weights) of one batch under the recipe, drawn
    from ``rng`` in this order: the selection, the roll, the random ids."""
    tokens = np.asarray(tokens)
    pad, vocab = model["pad_token_id"], model["vocab_size"]
    selectable = tokens != pad
    sel = (rng.random(tokens.shape) < model["mlm_prob"]) & selectable
    if not sel.any():
        cand = np.argwhere(selectable)
        if len(cand):
            r, c = cand[rng.integers(0, len(cand))]
            sel[r, c] = True
    roll = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[sel & (roll < 0.8)] = model["mask_token_id"]
    rand = sel & (roll >= 0.8) & (roll < 0.9)
    ids = rng.integers(0, vocab - 1, int(rand.sum()))
    ids[ids >= pad] += 1
    inputs[rand] = ids
    return inputs, tokens, sel.astype(np.float32)


def bidirectional_attention(q, k, v, n_heads: int, keep, mm: Callable):
    """keep [N, T] bool: the keys every query may see."""
    n, t, d = q.shape
    hd = d // n_heads
    q, k, v = (a.reshape(n, t, n_heads, hd).transpose(1, 2)
               for a in (q, k, v))
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, v).transpose(1, 2).reshape(n, t, d)


def logits(params: Dict, tokens, model: Dict, mm: Callable = torch.matmul):
    """tokens [N, T] -> MLM logits [N, T, V], f32."""
    eps = model["ln_eps"]
    t = tokens.shape[1]
    keep = tokens != model["pad_token_id"]
    h = params["embed"][tokens] + params["pos"][:t][None]
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(model["n_layers"]):
        b = {k: v[i] for k, v in blocks.items()}
        x = layer_norm(h, b["ln1_g"], b["ln1_b"], eps)
        a = bidirectional_attention(mm(x, b["Wq"]), mm(x, b["Wk"]),
                                    mm(x, b["Wv"]), model["n_heads"], keep,
                                    mm)
        h = h + mm(a, b["Wo"])
        x = layer_norm(h, b["ln2_g"], b["ln2_b"], eps)
        h = h + mm(torch.nn.functional.gelu(mm(x, b["W1"]) + b["b1"],
                                            approximate="tanh"),
                   b["W2"]) + b["b2"]
    h = layer_norm(h, params["lnf_g"], params["lnf_b"], eps)
    return mm(h, params["embed"].T)


def loss_and_grads(params: Dict, inputs, targets, weights, model: Dict,
                   mm: Callable, rows: int):
    """The selected positions' mean cross-entropy over the whole batch
    and its gradient, summed over blocks of ``rows`` rows."""
    names = list(adam.leaves(params))
    live = {k: v.detach().requires_grad_(True)
            for k, v in adam.leaves(params).items()}
    tree = adam.unflatten(live)
    denom = weights.sum().clamp(min=1.0)
    total = torch.zeros((), dtype=torch.float32, device=inputs.device)
    grads = {k: torch.zeros_like(v) for k, v in live.items()}
    for r0 in range(0, inputs.shape[0], rows):
        x = inputs[r0:r0 + rows]
        y, w = targets[r0:r0 + rows], weights[r0:r0 + rows]
        with torch.enable_grad():
            lg = logits(tree, x, model, mm)
            logp = torch.log_softmax(lg, dim=-1)
            nll = -torch.gather(logp, -1, y[..., None])[..., 0]
            part = (nll * w).sum() / denom
            g = torch.autograd.grad(part, [live[k] for k in names])
        total = total + part.detach()
        for k, gk in zip(names, g):
            grads[k] += gk
        del lg, logp, nll, part, g
    return total, grads


def train_readings(params0: Dict, batches: List[np.ndarray], model: Dict,
                   seed: int, device, precision: str = "f32", rows: int = 8,
                   keep_rows: Optional[int] = None) -> Dict:
    """Adam steps from ``params0`` on ``batches`` (host [N, T] ids), each
    masked from ``np.random.default_rng(seed)`` in turn: each step's loss,
    the first gradient's norm per leaf, each leaf's change after the last
    step. ``keep_rows``: the first rows of each batch only (the
    half-batch fault; the masks are still drawn for the whole batch)."""
    mm = matmul(precision)
    rng = np.random.default_rng(seed)
    with strict_f32():
        p = {k: v.detach().clone() for k, v in adam.leaves(params0).items()}
        state = adam.init(p)
        losses, first = [], None
        for step, batch in enumerate(batches, start=1):
            x, y, w = (torch.as_tensor(a, device=device)
                       for a in draw_masks(batch, model, rng))
            if keep_rows is not None:
                x, y, w = x[:keep_rows], y[:keep_rows], w[:keep_rows]
            loss, g = loss_and_grads(adam.unflatten(p), x.long(), y.long(),
                                     w.float(), model, mm, rows)
            losses.append(float(loss))
            if first is None:
                first = {k: float(v.norm()) for k, v in g.items()}
            p = adam.step(p, g, state, step, model["learning_rate"])
            del g
        start = adam.leaves(params0)
        change = {k: float((p[k] - start[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
