"""Plain Mellum 2 training, the reference of the ``mellum_lm`` cells:
float32 PyTorch with TF32 off, no kernels, no cache, no batching tricks.
It imports nothing of the port and takes nothing the port made: it reads
the benchmark's seeded weights (``perfbench/weights_mellum.py``) and token
rows. The equations, with the ``config.json`` keys they come from:

- every norm is RMSNorm, ``x / sqrt(mean(x^2) + eps) * g``
  (``rms_norm_eps``), before attention, before the expert layer and at
  the end;
- attention (``num_attention_heads`` H, ``num_key_value_heads`` H_kv,
  ``head_dim`` hd, ``attention_bias`` false): q = x Wq, k = x Wk,
  v = x Wv; RoPE rotate-half on q and k, the angles pos * inv_freq of
  ``rope_parameters[layer type]`` (the default ``theta^(-2i/hd)``, or
  YaRN's blend with cos and sin times ``attention_factor``); query head i
  reads K/V head i // (H / H_kv); causal softmax(q k / sqrt(hd)) v, and
  on ``sliding_attention`` layers key j hidden from query i where
  i - j >= ``sliding_window``; then o Wo. Scores are computed per block
  of queries against only the keys the block can see;
- the expert layer (``num_experts`` E, ``num_experts_per_tok`` k,
  ``norm_topk_prob``, ``moe_intermediate_size`` f, SiLU): softmax over
  the E router logits x Wr, the top k, weights renormalised over the k;
  each held expert e computes ``(silu(x Wg_e) * x Wu_e) Wd_e`` for the
  tokens that chose it, weighted and summed into the output. Only the
  experts held here (``experts_held`` from ``expert_offset``) add;
- the head is untied (``tie_word_embeddings`` false): logits = h lm_head^T;
- the loss: the mean next-token cross-entropy plus ``aux_coef`` times the
  mean over layers of the Switch load-balance term E * sum_e f_e P_e (f_e
  the share of the batch's tokens whose first choice is e, P_e the mean
  gate), over the whole batch as the program routes it: the f_e of a
  step come from a forward without gradients first (:func:`routing`), and
  the P_e are summed over the blocks of rows.

Adam (b1 0.9, b2 0.999, eps 1e-8, the bias correction folded into the
step) at the file's fixed rate, in place leaf by leaf. Each layer and
each block of queries is an activation checkpoint, and the batch's
gradient is accumulated over blocks of rows, so a row of 8192 positions
fits beside the state of 2.44 B parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import adam
from perfbench.reference.lowprec import matmul, strict_f32

FULL, SLIDING = "full_attention", "sliding_attention"
Q_BLOCK = 1024  # queries a block of the attention


def rms(x, g, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def inv_freq(model: Dict, kind: str) -> torch.Tensor:
    """[hd/2] f64: ``theta^(-2i/hd)``, or on a YaRN layer type the blend
    of that (extrapolation, below the low correction dim) and it divided
    by ``factor`` (interpolation, above the high one), linear between."""
    rp = model["rope"][kind]
    hd, theta = model["head_dim"], float(rp["rope_theta"])
    base = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    if rp.get("rope_type", "default") != "yarn":
        return base

    def corr_dim(rot):
        return (hd * math.log(rp["original_max_position_embeddings"]
                              / (rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr_dim(rp["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rp["beta_slow"])), hd - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(hd // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0.0, 1.0)
    extrapolate = 1.0 - ramp
    return base / rp["factor"] * (1.0 - extrapolate) + base * extrapolate


def rotary(model: Dict, kind: str, t: int, device,
           dtype=torch.float32):
    """(cos, sin) [T, hd] of a layer type (``attention_factor`` on
    YaRN), computed in f64 and rounded to ``dtype``."""
    f = inv_freq(model, kind).to(device)
    ang = torch.outer(torch.arange(t, dtype=torch.float64, device=device), f)
    ang = torch.cat([ang, ang], dim=-1)
    scale = float(model["rope"][kind].get("attention_factor", 1.0))
    return ((ang.cos() * scale).to(dtype), (ang.sin() * scale).to(dtype))


def rope(x, cos, sin):
    """x [N, T, heads, hd]; rotate-half."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def attention(q, k, v, window: int, mm: Callable):
    """q [N, T, H, hd], k, v [N, T, H_kv, hd] -> [N, T, H * hd]: causal,
    a sliding window where ``window`` > 0, per block of ``Q_BLOCK``
    queries (each a checkpoint) against the keys it can see."""
    n, t, heads, hd = q.shape
    kv = k.shape[2]
    g = heads // kv
    qh = q.reshape(n, t, kv, g, hd).permute(0, 2, 3, 1, 4)   # N,KV,g,T,hd
    kh = k.permute(0, 2, 1, 3)[:, :, None]                   # N,KV,1,T,hd
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    scale = 1.0 / math.sqrt(hd)

    def block(qb, kb, vb, q0, k0):
        s = mm(qb, kb.transpose(-1, -2)) * scale
        qi = torch.arange(q0, q0 + qb.shape[-2], device=q.device)[:, None]
        ki = torch.arange(k0, k0 + kb.shape[-2], device=q.device)[None, :]
        seen = ki <= qi
        if window:
            seen = seen & (qi - ki < window)
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        return mm(p, vb)

    outs = []
    for q0 in range(0, t, Q_BLOCK):
        q1 = min(t, q0 + Q_BLOCK)
        k0 = max(0, q0 - window + 1) if window else 0
        outs.append(checkpoint(block, qh[..., q0:q1, :], kh[..., k0:q1, :],
                               vh[..., k0:q1, :], q0, k0,
                               use_reentrant=False))
    o = torch.cat(outs, dim=-2)                               # N,KV,g,T,hd
    return o.permute(0, 3, 1, 2, 4).reshape(n, t, heads * hd)


def experts(x, b: Dict, model: Dict, mm: Callable, routes: Optional[List],
            first=None, n_all: int = 1):
    """The held experts' part of the expert layer on x [T, d] -> (y, aux):
    aux this block's part of the batch's load-balance term, E * sum_e
    ``first``[e] * (sum of this block's gates of e) / ``n_all`` (0 without
    ``first``); the chosen experts [T, k] appended to ``routes`` when it
    is a list."""
    t, d = x.shape
    n_exp, k, f = model["experts"], model["top_k"], model["d_ff"]
    gates = torch.softmax(mm(x, b["Wr"]), dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    if routes is not None:
        routes.append(topi.detach())
    w = topv / topv.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    e0 = model["expert_offset"]
    for e in range(model["experts_held"]):
        tok, slot = torch.nonzero(topi == e0 + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        gate = mm(xe, b["W1"][e][:, :f])
        up = mm(xe, b["W1"][e][:, f:])
        out = mm(F.silu(gate) * up, b["W2"][e])
        y = y.index_add(0, tok, out * w[tok, slot][:, None])
    if first is None:
        return y, torch.zeros((), device=x.device)
    return y, n_exp * torch.sum(first.to(gates.dtype) * gates.sum(0)) / n_all


def layer(h, b: Dict, model: Dict, kind: str, cos, sin, mm: Callable,
          routes: Optional[List] = None, first=None, n_all: int = 1):
    """One block -> (h, aux)."""
    n, t, d = h.shape
    eps = model["rms_eps"]
    heads, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    x = rms(h, b["ln1_g"], eps)
    q = rope(mm(x, b["Wq"]).reshape(n, t, heads, hd), cos, sin)
    k = rope(mm(x, b["Wk"]).reshape(n, t, kv, hd), cos, sin)
    v = mm(x, b["Wv"]).reshape(n, t, kv, hd)
    window = model["sliding_window"] if kind == SLIDING else 0
    h = h + mm(attention(q, k, v, window, mm), b["Wo"])
    y, aux = experts(rms(h, b["ln2_g"], model["rms_eps"]).reshape(n * t, d),
                     b, model, mm, routes, first, n_all)
    return h + y.reshape(n, t, d), aux


def trunk(params: Dict, tokens, model: Dict, mm: Callable,
          routes: Optional[List] = None, firsts=None, n_all: int = 1):
    """The embedding and every block on tokens [N, T] -> (h, the sum over
    layers of their aux parts); each layer a checkpoint while gradients
    are recorded."""
    t = tokens.shape[1]
    h = params["embed"][tokens]
    tables = {kind: rotary(model, kind, t, tokens.device, h.dtype)
              for kind in set(model["layer_types"])}
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    aux = torch.zeros((), device=h.device)
    for i, kind in enumerate(model["layer_types"]):
        b = {k: v[i] for k, v in blocks.items()}
        first = None if firsts is None else firsts[i]
        if torch.is_grad_enabled():
            h, a = checkpoint(layer, h, b, model, kind, *tables[kind], mm,
                              None, first, n_all, use_reentrant=False)
        else:
            h, a = layer(h, b, model, kind, *tables[kind], mm, routes,
                         first, n_all)
        aux = aux + a
    return h, aux


def loss_of(params: Dict, tokens, targets, model: Dict, mm: Callable,
            firsts, n_all: int):
    """These rows' part of the batch's loss: their summed cross-entropy
    over the batch's ``n_all`` positions plus ``aux_coef`` times their
    part of the mean over layers of the batch's aux term (``firsts``: each
    layer's f_e over the batch)."""
    h, aux = trunk(params, tokens, model, mm, None, firsts, n_all)
    lg = mm(rms(h, params["lnf_g"], model["rms_eps"]), params["lm_head"].T)
    nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1),
                          reduction="sum")
    return nll / n_all + model["aux_coef"] * aux / model["n_layers"]


def routing(params: Dict, tokens, model: Dict, mm: Callable = torch.matmul,
            rows: int = 1) -> List[torch.Tensor]:
    """The chosen experts [N T, k] of every layer for tokens [N, T] (no
    gradient, blocks of ``rows`` rows), in the order of the batch's
    tokens."""
    per_block = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], rows):
            routes: List[torch.Tensor] = []
            trunk(params, tokens[r0:r0 + rows], model, mm, routes)
            per_block.append(routes)
    return [torch.cat(layer_routes) for layer_routes in zip(*per_block)]


def first_shares(routes: List[torch.Tensor], n_experts: int):
    """Each layer's f_e: the share of tokens whose first choice is e."""
    return [torch.bincount(r[:, 0], minlength=n_experts).double() / len(r)
            for r in routes]


def train_readings(params0: Callable, batches: List, model: Dict,
                   precision: str = "f32", rows: int = 1,
                   keep_rows: Optional[int] = None) -> Dict:
    """Adam steps from ``params0()`` (a maker of the seeded weights,
    called twice: the start and, at the end, the change's origin) on
    ``batches`` ([(tokens, targets)], each [N, T]): each step's loss, the
    first gradient's norm per leaf, and each leaf's change after the last
    step, and ``routes``: the chosen experts of every layer in the first
    step (:func:`routing`). ``keep_rows`` trains on the first rows of each
    batch only (the half-batch fault)."""
    mm = matmul(precision)
    with strict_f32():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in adam.leaves(params0()).items()}
        state = adam.init(p)
        losses, first, routes = [], None, None
        for step, (x, y) in enumerate(batches, start=1):
            if keep_rows is not None:
                x, y = x[:keep_rows], y[:keep_rows]
            x, y = x.long(), y.long()
            tree = adam.unflatten(p)
            step_routes = routing(tree, x, model, mm, rows)
            routes = routes or step_routes
            firsts = first_shares(step_routes, model["experts"])
            del step_routes
            total = 0.0
            for r0 in range(0, x.shape[0], rows):
                part = loss_of(tree, x[r0:r0 + rows], y[r0:r0 + rows],
                               model, mm, firsts, y.numel())
                part.backward()
                total += float(part.detach())
                del part
            losses.append(total)
            if first is None:
                first = {k: float(v.grad.norm()) for k, v in p.items()}
            corr = math.sqrt(1 - adam.B2 ** step) / (1 - adam.B1 ** step)
            with torch.no_grad():
                for k, v in p.items():
                    g = v.grad
                    m = state["m"][k].mul_(adam.B1).add_(g, alpha=1 - adam.B1)
                    s = state["v"][k].mul_(adam.B2).addcmul_(
                        g, g, value=1 - adam.B2)
                    v.grad = None
                    del g
                    v.sub_(model["learning_rate"] * corr * m
                           / (torch.sqrt(s) + adam.EPS))
        del state
        start = adam.leaves(params0())
        change = {k: float((p[k].detach() - start[k]).norm()) for k in p}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "routes": routes}
