"""Transformer language model: inference, training and sampling
(counterpart: ``deeplearning4j_tpu/models/transformer.py``).

Ported: ``TransformerConfig`` (same fields and defaults), ``init_params``
(same distributions, a ``torch.Generator`` in place of ``jax.random``),
``_ln``, ``_attention``, ``forward`` (:316), ``nll_loss`` (:381),
``loss_fn``, ``prefill_cache`` (:756), ``decode_step`` (:808),
``ring_forward`` (:695, the long-context forward with attention
sequence-parallel over the ``'seq'`` group, ``parallel/sequence_parallel.py``),
the training step (``init_opt_state`` :409, ``_clip_by_global_norm``,
``_decay_mask``, ``_adam_update``, ``_validate_schedule``,
``_scheduled_lr``, ``_build_step`` :540 with gradient accumulation and
the bf16 loss-scaled branch of ``ops/lowprec.py``, ``make_train_step``
:642, ``make_train_multi_step`` :669, ``_multi_from_step`` :1133) and
the sequence-parallel training step (``make_ring_train_step`` :860,
``_build_ring_step`` :880, ``_ring_step_shardings`` :907 as
:func:`ring_step_block`, ``make_ring_train_multi_step`` :919: ring or
Ulysses over the ``'seq'`` group, DP x SP over a ``parallel/mesh``
``MeshGroups``) and ``TransformerLM`` (:1155: ``fit``, ``fit_batches``,
``fit_iterator``, ``evaluate``, ``output``, ``save``/``load`` in the JAX
zip layout, ``from_state``, ``generate`` with top-k/top-p and its two
samplers, and the sequence mode ``_sequence_mode`` :1198 / ``_make_step``
:1201: ``TransformerLM(cfg, group=...)``), plus :func:`params_from_numpy`
for a JAX parameter tree handed over as numpy. Not ported yet: the
pipeline mode, MoE (an MoE config raises) and ``measure_memory`` (an XLA
AOT ledger; ``torch.cuda.max_memory_allocated`` stands in on the card).

What GSPMD does for the JAX ring step is explicit here: each rank takes
its [N / data, T / seq] block of the global batch, runs
:func:`ring_forward` on it and differentiates its own mean NLL; the ring's
and Ulysses' collectives carry the cotangents between the ranks of the
``'seq'`` group, so each rank's gradient is that of the sum of its
group's losses. The loss and every gradient leaf are then summed over
the whole ``data x seq`` world and divided by its size (equal blocks: the
mean of the ranks' means is the global mean, and the sum of the ranks'
``pos`` slices is its gradient), and every rank runs the same clip and
Adam on the same bits, so the params stay bit-equal on every rank.

Parameters are a dict in the JAX layout: ``embed`` [V, d], ``pos``
[max_len, d], ``lnf_g``/``lnf_b`` [d], and ``blocks`` whose leaves are
stacked per layer as [L, ...]. Under ``dtype_policy="performance"`` the
blocks compute in bf16: training casts each f32 master to bf16 at each
use inside the autograd graph, as the JAX forward does, so gradients
reach the masters in f32; inference reads one compute-dtype copy of the
block weights (:func:`compute_params`, rebuilt after each optimizer
step) — the cast gives the same values. ``embed``, ``pos`` and the final
LN stay f32: the tied head is ``h @ embed.T`` after an f32 final LN (at
least f32: f64 stays f64, the gradient-check mode of the tests).

Attention with ``use_flash`` goes through ``ops/flash_attention.FlashFn``
on both devices: K4 forward and K7 backward on the card, their plain
versions (the same autograd function) on the CPU.

Steps are plain functions over the params dict, returning ``(params,
opt, loss)``; every scalar of the schedule, Adam's bias correction and
the loss scale stays a 0-d tensor on the device, so a step never waits
for the host. The multi step is a Python loop over K. A step returns new
param and moment tensors (it updates nothing its caller passed in).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.ops.flash_attention import attention_auto
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops.remat import remat_wrap
from deeplearning4j_tpu_torch.parallel.mesh import as_mesh

Params = Dict[str, Any]

TOP_KEYS = ("embed", "pos", "lnf_g", "lnf_b")
BLOCK_KEYS = ("ln1_g", "ln1_b", "Wq", "Wk", "Wv", "Wo", "ln2_g", "ln2_b",
              "W1", "b1", "W2", "b2")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 512
    max_len: int = 256
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 1e-2
    dtype_policy: str = "strict"  # "strict" f32 | "performance" bf16 compute
    learning_rate: float = 3e-4
    warmup_steps: int = 0
    lr_schedule: str = "none"
    total_steps: int = 0
    accum_steps: int = 1
    seed: int = 0
    # flash attention (FlashFn: K4 forward, K7 backward on the card,
    # their plain versions on the CPU); False keeps the dense masked
    # softmax of the JAX package's _attention
    use_flash: bool = True
    pipeline_microbatches: int = 4
    weight_decay: float = 0.0
    clip_grad_norm: float = 0.0
    remat: str = "auto"

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.dtype_policy == "performance"
                else torch.float32)


def check_dense(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise ValueError("MoE transformers are not ported yet (capacity "
                         "routing is batch-dependent; dense configs only)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, *, device=None) -> Params:
    """Random f32 params with the JAX package's distributions
    (``transformer.py:115-165``): xavier-normal q/k/v/W1, depth-scaled
    N(0, 0.02/sqrt(2L)) Wo/W2, N(0, 0.02) embed, N(0, 0.01) pos, unit LN
    scales, zero biases. Drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` on ``device``; the bits differ from ``jax.random``."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def norm(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * float(scale)

    def xavier(shape):
        return norm(shape, math.sqrt(2.0 / (shape[-2] + shape[-1])))

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    depth = 0.02 / math.sqrt(2 * L)
    blocks = {
        "ln1_g": ones((L, d)), "ln1_b": zeros((L, d)),
        "Wq": xavier((L, d, d)), "Wk": xavier((L, d, d)),
        "Wv": xavier((L, d, d)), "Wo": norm((L, d, d), depth),
        "ln2_g": ones((L, d)), "ln2_b": zeros((L, d)),
        "W1": xavier((L, d, f)), "b1": zeros((L, f)),
        "W2": norm((L, f, d), depth), "b2": zeros((L, d)),
    }
    return {
        "embed": norm((cfg.vocab_size, d), 0.02),
        "pos": norm((cfg.max_len, d), 0.01),
        "lnf_g": ones((d,)), "lnf_b": zeros((d,)),
        "blocks": blocks,
    }


def params_from_numpy(tree: Params, *, device=None) -> Params:
    """The port's params from a JAX parameter tree handed over as numpy
    arrays in the JAX layout (top level ``embed``/``pos``/``lnf_g``/
    ``lnf_b``, per-layer leaves stacked under ``blocks``). The f32 values
    are carried bit for bit."""
    dev = resolve_device(device)
    want = set(TOP_KEYS) | {"blocks"}
    if set(tree) != want or set(tree["blocks"]) != set(BLOCK_KEYS):
        raise ValueError(
            f"not a dense TransformerLM tree: top {sorted(tree)}, blocks "
            f"{sorted(tree.get('blocks', {}))}")

    def leaf(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
        return torch.from_numpy(a.copy()).to(dev)

    out = {k: leaf(tree[k]) for k in TOP_KEYS}
    out["blocks"] = {k: leaf(tree["blocks"][k]) for k in BLOCK_KEYS}
    return out


def compute_params(params: Params, cfg: TransformerConfig) -> Params:
    """The params the forward reads: block weights in the compute dtype
    (one copy, made here; the same tensors under ``strict``), ``embed``,
    ``pos`` and the final LN in f32."""
    cdt = cfg.compute_dtype
    out = {k: params[k] for k in TOP_KEYS}
    out["blocks"] = {k: v.to(cdt) for k, v in params["blocks"].items()}
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ln(x, g, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _attention(q, k, v, n_heads: int, use_flash: bool = False):
    """q, k, v [N, T, d] -> [N, T, d], causal. ``use_flash``:
    ``attention_auto`` (``FlashFn``: K4 and K7 on the card, their plain
    versions on the CPU, differentiable on both); otherwise the JAX
    package's dense masked softmax."""
    n, t, d = q.shape
    hd = d // n_heads
    q = q.reshape(n, t, n_heads, hd)
    k = k.reshape(n, t, n_heads, hd)
    v = v.reshape(n, t, n_heads, hd)
    if use_flash:
        return attention_auto(q, k, v, causal=True).reshape(n, t, d)
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -1e9)
    p = torch.softmax(s.to(softmax_dtype(s.dtype)), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p, v).reshape(n, t, d)


def _layer(blocks: Params, layer: int) -> Params:
    return {k: v[layer] for k, v in blocks.items()}


def _layers(blocks: Params):
    """Every layer's params, one ``unbind`` per stacked leaf: its backward
    stacks the layers' gradients in one kernel, where indexing each layer
    zero-fills an [L, ...] gradient per layer and sums them."""
    per_leaf = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _block(bp: Params, h, cfg: TransformerConfig, attend):
    """One dense block in the compute dtype (the JAX package's
    ``_dense_block_f32`` with the same cast discipline): pre-LN
    attention, residual, pre-LN tanh-GELU MLP, residual. ``attend`` maps
    (q, k, v) [N, T, d] to the attention output."""
    cdt = cfg.compute_dtype
    c = lambda a: a.to(cdt)
    x = _ln(h, c(bp["ln1_g"]), c(bp["ln1_b"]))
    q, k, v = x @ c(bp["Wq"]), x @ c(bp["Wk"]), x @ c(bp["Wv"])
    h = h + attend(q, k, v) @ c(bp["Wo"])
    x = _ln(h, c(bp["ln2_g"]), c(bp["ln2_b"]))
    # jax.nn.gelu defaults to the tanh approximation
    inner = F.gelu(x @ c(bp["W1"]) + c(bp["b1"]), approximate="tanh")
    return h + inner @ c(bp["W2"]) + c(bp["b2"])


def _embed(params: Params, tokens, cfg: TransformerConfig, start: int = 0):
    t = tokens.shape[1]
    h = params["embed"][tokens.long()] + params["pos"][start:start + t][None]
    return h.to(cfg.compute_dtype)


def _at_least_f32(x):
    """bf16 -> f32; f32 and f64 stay (the JAX package's f32 casts, with
    f64 kept for the gradient checks)."""
    return x.to(softmax_dtype(x.dtype))


def _final_ln(params: Params, h):
    return _ln(_at_least_f32(h), params["lnf_g"], params["lnf_b"])


def _head(params: Params, h):
    """The tied head on the final LN's output: h @ embed.T in h's dtype."""
    return h @ params["embed"].to(h.dtype).T


def forward(params: Params, tokens, cfg: TransformerConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [N, T] int -> (logits [N, T, V] f32, aux_loss 0): the JAX
    ``forward`` for dense models (aux is the MoE load-balance loss). While
    gradients are recorded each block runs under the remat policy
    (``cfg.remat``, ``ops/remat.py``)."""
    check_dense(cfg)
    h = _embed(params, tokens, cfg)
    attend = lambda q, k, v: _attention(q, k, v, cfg.n_heads,
                                        use_flash=cfg.use_flash)
    block = (remat_wrap(_block, cfg.remat) if torch.is_grad_enabled()
             else _block)
    for bp in _layers(params["blocks"]):
        h = block(bp, h, cfg, attend)
    logits = _at_least_f32(_head(params, _final_ln(params, h)))
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def nll_loss(logits, targets, mask=None):
    """Mean next-token NLL, the cross-entropy of the training loss and of
    ``evaluate``, in at least f32. ``mask`` ([N, T] 0/1): masked positions
    leave the numerator and the denominator."""
    dt = softmax_dtype(logits.dtype)
    v = logits.shape[-1]
    nll = F.cross_entropy(logits.reshape(-1, v).to(dt),
                          targets.reshape(-1).long(), reduction="none")
    if mask is None:
        return nll.mean()
    m = mask.reshape(-1).to(dt)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def loss_fn(params: Params, tokens, targets, cfg: TransformerConfig):
    logits, aux = forward(params, tokens, cfg)
    return nll_loss(logits, targets) + cfg.moe_aux_coef * aux


def ring_forward(params: Params, tokens, cfg: TransformerConfig, group,
                 strategy: str = "ring") -> torch.Tensor:
    """The forward with attention sequence-parallel over ``group``, for
    sequences sharded over ranks: ``tokens`` [N, T_local] is this rank's
    shard (rank r holds positions r * T_local ..), embedded with its own
    slice of ``pos``; every block runs :func:`_block` with the sharded
    attention (``strategy="ring"``: K/V shards rotate, each step through
    K5; ``"ulysses"``: two head <-> sequence all-to-alls around K4 over
    all T, heads divisible by the world size). Returns this rank's
    logits [N, T_local, V] f32. Dense configs only. Differentiable across
    the group (``parallel/sequence_parallel.py``)."""
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        ring_attention_sharded,
        ulysses_attention_sharded,
    )

    check_dense(cfg)
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    sharded_att = (ring_attention_sharded if strategy == "ring"
                   else ulysses_attention_sharded)
    n, t = tokens.shape
    hd = cfg.d_model // cfg.n_heads

    def attend(q, k, v):
        split = lambda a: a.reshape(n, t, cfg.n_heads, hd)
        out = sharded_att(split(q), split(k), split(v), group, causal=True)
        return out.reshape(n, t, cfg.d_model)

    h = _embed(params, tokens, cfg, start=dist.get_rank(group) * t)
    for bp in _layers(params["blocks"]):
        h = _block(bp, h, cfg, attend)
    return _at_least_f32(_head(params, _final_ln(params, h)))


def prefill_cache(params: Params, tokens, cfg: TransformerConfig
                  ) -> Tuple[Params, torch.Tensor]:
    """Run the prompt once: (cache, hidden). cache leaves are
    [L, N, max_len, H, hd] in the compute dtype, zero beyond the prompt
    (decode's position mask never reads them); hidden [N, T, d] is f32
    after the final LN. Same block body and casts as :func:`forward`."""
    check_dense(cfg)
    n, t = tokens.shape
    hd = cfg.d_model // cfg.n_heads
    h = _embed(params, tokens, cfg)
    shape = (cfg.n_layers, n, cfg.max_len, cfg.n_heads, hd)
    ks = torch.zeros(shape, dtype=cfg.compute_dtype, device=h.device)
    vs = torch.zeros(shape, dtype=cfg.compute_dtype, device=h.device)
    for layer in range(cfg.n_layers):
        def attend(q, k, v, layer=layer):
            ks[layer, :, :t] = k.reshape(n, t, cfg.n_heads, hd)
            vs[layer, :, :t] = v.reshape(n, t, cfg.n_heads, hd)
            return _attention(q, k, v, cfg.n_heads, use_flash=cfg.use_flash)

        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    return {"k": ks, "v": vs}, _final_ln(params, h)


def decode_step(params: Params, cache: Params, tok, pos: int,
                cfg: TransformerConfig) -> Tuple[Params, torch.Tensor]:
    """One autoregressive step: consume the token ``tok`` [N] at position
    ``pos`` (writing its K/V into the dense cache of
    :func:`prefill_cache`, in place) and return (cache, logits [N, V] for
    position pos + 1). Attention reads the whole max_len cache under an
    ``arange <= pos`` mask, in f32, as a plain einsum (XLA's in the JAX
    package). Same block body and casts as :func:`forward`."""
    check_dense(cfg)
    n = tok.shape[0]
    hd = cfg.d_model // cfg.n_heads
    h = (params["embed"][tok.long()] + params["pos"][pos])[:, None, :]
    h = h.to(cfg.compute_dtype)
    scale = 1.0 / float(np.sqrt(hd))
    visible = (torch.arange(cfg.max_len, device=h.device) <= pos)[None, None]
    for layer in range(cfg.n_layers):
        def attend(q, k, v, layer=layer):
            ck, cv = cache["k"][layer], cache["v"][layer]
            ck[:, pos] = k.reshape(n, cfg.n_heads, hd).to(ck.dtype)
            cv[:, pos] = v.reshape(n, cfg.n_heads, hd).to(cv.dtype)
            s = torch.einsum("nhd,nthd->nht",
                             q.reshape(n, cfg.n_heads, hd).float(),
                             ck.float()) * scale
            p = torch.softmax(s.masked_fill(~visible, float("-inf")), -1)
            att = torch.einsum("nht,nthd->nhd", p, cv.float())
            return att.reshape(n, 1, cfg.d_model).to(q.dtype)

        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    h = _ln(h[:, 0].float(), params["lnf_g"], params["lnf_b"])
    return cache, _head(params, h)


# ---------------------------------------------------------------------------
# training (Adam)
# ---------------------------------------------------------------------------


def init_opt_state(params: Params,
                   loss_scaled: Optional[bool] = None) -> Params:
    """Adam's moments (zeros like the params), the step count ``t`` (0-d
    int32) and, for a loss-scaled step, the loss-scale state riding the
    same dict (``lowprec.OPT_SCALE_KEYS``), as the JAX package keeps it.
    ``loss_scaled`` is the step's ``loss_scaled``; None reads
    ``DL4J_TPU_BF16`` now."""
    dev = tree_leaves(params)[0].device
    opt = {"m": tree_map(torch.zeros_like, params),
           "v": tree_map(torch.zeros_like, params),
           "t": torch.zeros((), dtype=torch.int32, device=dev)}
    if loss_scaled is None:
        loss_scaled = lowprec.train_policy()
    if loss_scaled:
        opt.update(lowprec.opt_scale_entries(dev))
    return opt


def _named(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves by path ("blocks.Wq"), in the tree's order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _clip_by_global_norm(grads: Params, max_norm: float):
    """Global-norm clip over the whole tree through the port's shared
    gradient normalization (``optimize/updaters.normalize_gradients``,
    ``clip_l2_per_layer``): (clipped grads, the norm before)."""
    from deeplearning4j_tpu_torch.optimize.updaters import (
        _global_norm,
        normalize_gradients,
    )

    flat = _named(grads)
    clipped = normalize_gradients(flat, "clip_l2_per_layer", max_norm)
    it = iter(clipped[k] for k in flat)
    return tree_map(lambda _: next(it), grads), _global_norm(flat)


def _decay_mask(params: Params) -> Params:
    """AdamW decays weight matrices only: leaves named ``W*`` and the tied
    ``embed`` (by name: stacked block leaves carry a leading [L] axis)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else (k.startswith("W") or k == "embed")
                for k, v in tree.items()}
    return walk(params)


def _adam_update(params: Params, grads: Params, opt: Params, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_grad_norm: float = 0.0):
    """(new params, {"m", "v", "t"}): Adam, with decoupled weight decay on
    the :func:`_decay_mask` leaves and a global-norm clip first. The bias
    correction is computed in f32 from the step count as f32 (``lr`` a 0-d
    f32 tensor), as the JAX package computes it."""
    if clip_grad_norm:
        grads, _ = _clip_by_global_norm(grads, clip_grad_norm)
    t = opt["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt["v"], grads)
    tf = t.to(torch.float32)
    corr = torch.sqrt(1 - torch.pow(b2, tf)) / (1 - torch.pow(b1, tf))
    if weight_decay:
        new = tree_map(
            lambda p, m_, v_, d: p - lr * (
                corr * m_ / (torch.sqrt(v_) + eps)
                + (weight_decay * p if d else 0.0)),
            params, m, v, _decay_mask(params))
    else:
        new = tree_map(lambda p, m_, v_: p - lr * corr * m_
                       / (torch.sqrt(v_) + eps), params, m, v)
    return new, {"m": m, "v": v, "t": t}


def _validate_schedule(cfg: TransformerConfig) -> None:
    if cfg.lr_schedule not in ("none", "cosine"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                         "(known: none, cosine)")
    if cfg.lr_schedule == "cosine" and cfg.total_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs total_steps > 0 "
                         "(otherwise the decay is silently dropped)")


def _scheduled_lr(cfg: TransformerConfig, t) -> torch.Tensor:
    """The f32 learning rate at step ``t`` (1-based, a 0-d tensor):
    linear warmup over ``warmup_steps``, then an optional cosine decay to
    zero at ``total_steps``."""
    tf = t.to(torch.float32)
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32,
                      device=tf.device)
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp(tf / cfg.warmup_steps, max=1.0)
    if cfg.lr_schedule == "cosine" and cfg.total_steps > 0:
        frac = torch.clamp((tf - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


def value_and_grad(loss_of, params: Params):
    """(loss, grads): ``loss_of(params)`` and its gradient for every leaf,
    the tree's layout (``jax.value_and_grad`` for a params dict)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_of(live)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _build_step(cfg: TransformerConfig):
    """The optimizer step of :func:`make_train_step`: loss and gradients
    (a loop of ``accum_steps`` microbatches whose mean-of-means equals the
    full batch's), the bf16 loss-scaled branch under ``DL4J_TPU_BF16``
    (read here, and kept as the step's ``loss_scaled``: its opt dict must
    come from ``init_opt_state(params, step.loss_scaled)``), Adam.
    Validates the config loudly."""
    check_dense(cfg)
    _validate_schedule(cfg)
    accum_steps = cfg.accum_steps
    lp = lowprec.train_policy()

    def step(params, opt, tokens, targets):
        if lp:
            # f32 masters cast to bf16 inside the graph, the loss scaled;
            # the f32 gradients are unscaled before Adam
            ls = lowprec.opt_scale_state(opt)
            base = {"m": opt["m"], "v": opt["v"], "t": opt["t"]}
            scale = ls["scale"]

            def grad_loss(p, x, y):
                return loss_fn(lowprec.cast_tree(p), x, y,
                               cfg).to(torch.float32) * scale
        else:
            ls, base = None, opt

            def grad_loss(p, x, y):
                return loss_fn(p, x, y, cfg)

        if accum_steps == 1:
            loss, grads = value_and_grad(
                lambda p: grad_loss(p, tokens, targets), params)
        else:
            b = tokens.shape[0]
            if b % accum_steps != 0:
                raise ValueError(
                    f"batch {b} not divisible by accum_steps {accum_steps}")
            mb = b // accum_steps
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            grads = tree_map(torch.zeros_like, params)
            for i in range(accum_steps):
                x, y = (a[i * mb:(i + 1) * mb] for a in (tokens, targets))
                loss_i, grads_i = value_and_grad(
                    lambda p: grad_loss(p, x, y), params)
                grads = tree_map(lambda a, g: a + g / accum_steps, grads,
                                 grads_i)
                loss = loss + loss_i / accum_steps

        if lp:
            loss = loss / scale  # report the unscaled loss
            grads = lowprec.unscale(grads, scale)
            finite = lowprec.finite_tree(grads)
            lr = _scheduled_lr(cfg, base["t"] + 1)
            new_params, new_base = _adam_update(
                params, grads, base, lr, weight_decay=cfg.weight_decay,
                clip_grad_norm=cfg.clip_grad_norm)
            params = lowprec.select_trees(finite, new_params, params)
            # 't' too: a skipped step moves neither the schedule nor the
            # bias correction
            base = lowprec.select_trees(finite, new_base, base)
            ls = lowprec.advance_scale(ls, finite)
            return params, lowprec.opt_with_scale(base, ls), loss

        lr = _scheduled_lr(cfg, opt["t"] + 1)
        params, opt = _adam_update(params, grads, opt, lr,
                                   weight_decay=cfg.weight_decay,
                                   clip_grad_norm=cfg.clip_grad_norm)
        return params, opt, loss

    step.loss_scaled = lp
    return step


def make_train_step(cfg: TransformerConfig):
    """``step(params, opt, tokens, targets) -> (params, opt, loss)``, one
    optimizer step; ``cfg.accum_steps`` > 1 splits the batch into that
    many microbatches whose gradients are averaged before one update (for
    dense configs the full-batch step at 1/A the activation memory)."""
    return _build_step(cfg)


def _multi_from_step(step):
    """K steps over stacked batches: ``multi(params, opt, *stacks)`` with
    each stack [K, ...] -> (params, opt, the K losses)."""
    def multi(params, opt, *stacks):
        losses = []
        for xs in zip(*stacks):
            params, opt, loss = step(params, opt, *xs)
            losses.append(loss)
        return params, opt, torch.stack(losses)

    return multi


def make_train_multi_step(cfg: TransformerConfig):
    """K optimizer steps over tokens/targets stacked [K, N, T]: the same
    results as K calls of :func:`make_train_step`'s step."""
    return _multi_from_step(_build_step(cfg))


# ---------------------------------------------------------------------------
# sequence-parallel training
# ---------------------------------------------------------------------------


def _reject_lowprec(path: str) -> None:
    """bf16 loss scaling is refused on the sequence-parallel step, as the
    JAX package refuses it there."""
    if lowprec.train_policy():
        raise ValueError(
            f"DL4J_TPU_BF16 is not supported on the {path} training path "
            "yet — unset it (the dense and accum paths support it)")


def ring_step_block(batch, group):
    """This rank's block of a global batch [..., N, T]: rows ``data_index
    * N / data`` on, positions ``seq_index * T / seq`` on (the JAX
    package's ``P('data', 'seq')`` token sharding, ``_ring_step_shardings``
    :907). ``group`` is the ``'seq'`` group or a ``MeshGroups``."""
    mesh = as_mesh(group)
    d, s = mesh.shape
    n, t = batch.shape[-2:]
    if n % d or t % s:
        raise ValueError(f"batch {n} x {t} does not split over a {d} x {s} "
                         "('data', 'seq') mesh")
    i, j = mesh.data_index, mesh.seq_index
    nl, tl = n // d, t // s
    return batch[..., i * nl:(i + 1) * nl, j * tl:(j + 1) * tl]


def _mean_over(group, loss, grads):
    """The loss and every gradient leaf summed over ``group`` and divided
    by its size, in the tree's order (the same collectives on every rank;
    a world of 1 passes them through)."""
    world = dist.get_world_size(group)
    if world == 1:
        return loss, grads
    for x in [loss] + tree_leaves(grads):
        dist.all_reduce(x, group=group)
    return loss / world, tree_map(lambda g: g / world, grads)


def _build_ring_step(cfg: TransformerConfig, group, strategy: str):
    """The optimizer step of :func:`make_ring_train_step`; every
    sequence-parallel factory validates here."""
    if cfg.accum_steps != 1:
        raise ValueError("cfg.accum_steps must be 1 under sequence-parallel "
                         "training (shard 'data' for more batch instead)")
    _reject_lowprec("sequence-parallel")
    _validate_schedule(cfg)
    check_dense(cfg)
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    mesh = as_mesh(group)

    def step(params, opt, tokens, targets):
        x, y = ring_step_block(tokens, mesh), ring_step_block(targets, mesh)
        loss, grads = value_and_grad(
            lambda p: nll_loss(ring_forward(p, x, cfg, mesh.seq, strategy),
                               y), params)
        loss, grads = _mean_over(mesh.world, loss, grads)
        lr = _scheduled_lr(cfg, opt["t"] + 1)
        params, opt = _adam_update(params, grads, opt, lr,
                                   weight_decay=cfg.weight_decay,
                                   clip_grad_norm=cfg.clip_grad_norm)
        return params, opt, loss

    step.loss_scaled = False
    return step


def make_ring_train_step(cfg: TransformerConfig, group=None, *,
                         strategy: str = "ring"):
    """``step(params, opt, tokens, targets) -> (params, opt, loss)``, the
    long-context training step: the same objective as
    :func:`make_train_step` (the mean NLL of the GLOBAL batch, which every
    rank passes and every rank gets back), with attention
    sequence-parallel over the ``'seq'`` group (``strategy="ring"``: K5
    each ring step forward, K7 backward with the lse cotangent;
    ``"ulysses"``: all-to-alls around ``FlashFn``, K4 and K7) and, for a
    ``MeshGroups``, the batch split over ``'data'``. Params stay
    replicated, bit-equal on every rank. Refuses ``accum_steps != 1``,
    ``DL4J_TPU_BF16``, a bad schedule and MoE."""
    return _build_ring_step(cfg, group, strategy)


def make_ring_train_multi_step(cfg: TransformerConfig, group=None, *,
                               strategy: str = "ring"):
    """K sequence-parallel steps over global batches stacked [K, N, T]:
    the same results as K calls of :func:`make_ring_train_step`'s step."""
    return _multi_from_step(_build_ring_step(cfg, group, strategy))


# ---------------------------------------------------------------------------
# the model object
# ---------------------------------------------------------------------------


def _categorical(logits, gen: torch.Generator):
    """One sample per row of ``softmax(logits)`` as ``argmax(logits +
    Gumbel noise)``, the uniforms from ``gen`` (``jax.random.categorical``
    draws the same way, with other bits)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _tree_like(template, stored, device, path: str = ""):
    """``stored`` (nested dicts of numpy arrays, an npz read back) in the
    layout of ``template``, each leaf as stored; a leaf the template has
    and the checkpoint lacks raises."""
    if isinstance(template, dict):
        stored = stored if isinstance(stored, dict) else {}
        return {k: _tree_like(v, stored.get(k), device, f"{path}[{k!r}]")
                for k, v in template.items()}
    if stored is None:
        raise ValueError(f"checkpoint missing parameter {path}")
    return torch.from_numpy(np.array(stored)).to(device)


class TransformerLM:
    """The flagship LM: ``cfg``, the f32 master ``params``, Adam's ``opt``
    (made at first use), ``iteration`` (the optimizer step count), and
    ``compute_params`` (one compute-dtype copy of the block weights that
    inference reads, rebuilt after each optimizer step). Lives on
    ``device`` — the card unless the caller passes ``device="cpu"``.

    With ``group`` (the ``'seq'`` process group, or a ``MeshGroups`` for
    DP x SP) it trains in the sequence mode: every rank builds the same
    model and passes the same GLOBAL batch to :meth:`fit` and
    :meth:`fit_batches`, each rank trains on its own block through the
    ring step (:func:`make_ring_train_step`), and only the mesh's rank 0
    writes in :meth:`save`."""

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 params: Optional[Params] = None,
                 opt: Optional[Params] = None, group=None) -> None:
        check_dense(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.group = group
        self.params = (params if params is not None
                       else init_params(cfg, device=self.device))
        self._opt = opt
        self.iteration = 0 if opt is None else int(opt["t"])
        self._step = (make_train_step(cfg) if group is None
                      else make_ring_train_step(cfg, group))
        self._multi_step = _multi_from_step(self._step)
        self._compute: Optional[Params] = None

    @property
    def opt(self) -> Params:
        if self._opt is None:
            self._opt = init_opt_state(self.params, self._step.loss_scaled)
        return self._opt

    @opt.setter
    def opt(self, value: Params) -> None:
        self._opt = value

    @property
    def compute_params(self) -> Params:
        if self._compute is None:
            self._compute = compute_params(self.params, self.cfg)
        return self._compute

    def _set_state(self, params: Params, opt: Params) -> None:
        self.params, self._opt, self._compute = params, opt, None

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device)

    def _sequence_mode(self) -> bool:
        return self.group is not None

    @classmethod
    def from_state(cls, cfg: TransformerConfig, params: Params,
                   opt: Optional[Params] = None, *,
                   device=None, group=None) -> "TransformerLM":
        """An LM around existing state, with no random init; the
        iteration is ``opt["t"]``."""
        return cls(cfg, device=device, params=params, opt=opt, group=group)

    @classmethod
    def load(cls, path: str, *, device=None, load_updater: bool = True,
             group=None) -> "TransformerLM":
        """Read a zip written by :meth:`save` or by the JAX package's
        ``TransformerLM.save`` (``transformer.py:1347``). With the updater
        section, Adam's state comes back and the iteration is its ``t``.
        With ``group``, every rank reads it into the sequence mode."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_flagship_zip,
        )

        cfg_dict, coeff, upd, _meta = read_flagship_zip(path,
                                                        "TransformerLM")
        cfg = TransformerConfig(**cfg_dict)
        params = params_from_numpy(npz_bytes_to_tree(coeff), device=device)
        lm = cls(cfg, device=device, params=params, group=group)
        if load_updater and upd is not None:
            lm.opt = _tree_like(init_opt_state(params, lm._step.loss_scaled),
                                npz_bytes_to_tree(upd), params["embed"].device)
            lm.iteration = int(lm.opt["t"])
        return lm

    def save(self, path: str) -> None:
        """A zip in the JAX package's flagship layout (configuration,
        coefficients, updater: ``utils/serialization.write_flagship_zip``),
        which the JAX ``TransformerLM.load`` reads. In the sequence mode
        only the mesh's rank 0 writes (the params are bit-equal on every
        rank)."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            write_flagship_zip,
        )

        if self._sequence_mode() and dist.get_rank(
                as_mesh(self.group).world) != 0:
            return
        write_flagship_zip(path, "TransformerLM", self.cfg, self.params,
                           self.opt)

    # -- training -----------------------------------------------------------
    def fit(self, tokens, targets) -> torch.Tensor:
        """One optimizer step on tokens/targets [N, T]; the loss (a 0-d
        device tensor: reading it waits for the card). In the sequence
        mode the global batch: this rank trains on its block, and the
        loss is the global batch's."""
        params, opt, loss = self._step(self.params, self.opt,
                                       self._tokens(tokens),
                                       self._tokens(targets))
        self._set_state(params, opt)
        self.iteration += 1
        return loss

    def fit_batches(self, tokens_k, targets_k) -> torch.Tensor:
        """K optimizer steps on tokens/targets stacked [K, N, T]; the K
        losses. The same as K :meth:`fit` calls."""
        tokens_k, targets_k = self._tokens(tokens_k), self._tokens(targets_k)
        params, opt, losses = self._multi_step(self.params, self.opt,
                                               tokens_k, targets_k)
        self._set_state(params, opt)
        self.iteration += int(tokens_k.shape[0])
        return losses

    def fit_iterator(self, iterator, num_epochs: int = 1,
                     listeners=()) -> "TransformerLM":
        """``fit`` over an iterator of DataSets (token ids as features
        [N, T], next ids as labels), ``num_epochs`` passes; each listener
        (``optimize/listeners.py``) gets ``iteration_done(self, iteration,
        loss)`` after every step, the loss read back only then. The
        iteration carries over between calls."""
        for _ in range(num_epochs):
            for ds in iterator:
                loss = self.fit(ds.features, ds.labels)
                if listeners:
                    score = float(loss)
                    for lst in listeners:
                        lst.iteration_done(self, self.iteration, score)
            if hasattr(iterator, "reset"):
                iterator.reset()
        return self

    def evaluate(self, iterator) -> Dict[str, float]:
        """Mean next-token cross-entropy and perplexity over an iterator
        of DataSets, weighted by tokens: ``labels_mask`` (else
        ``features_mask``) positions count in neither the loss nor the
        token total. The per-batch losses stay on the device until one
        readback."""
        losses, counts = [], []
        with torch.inference_mode():
            for ds in iterator:
                x, y = self._tokens(ds.features), self._tokens(ds.labels)
                m = (ds.labels_mask if ds.labels_mask is not None
                     else ds.features_mask)
                if m is None:
                    m_arr = torch.ones(x.shape, dtype=torch.float32,
                                       device=self.device)
                    counts.append(x.shape[0] * x.shape[1])
                else:
                    m_arr = torch.as_tensor(np.asarray(m, np.float32),
                                            device=self.device)
                    counts.append(float(np.asarray(m).sum()))
                logits, _ = forward(self.compute_params, x, self.cfg)
                losses.append(nll_loss(logits, y, m_arr))
        if hasattr(iterator, "reset"):
            iterator.reset()
        if not losses:
            return {"loss": float("nan"), "perplexity": float("nan"),
                    "tokens": 0}
        w = np.asarray(counts, np.float64)
        ls = torch.stack(losses).double().cpu().numpy()  # one readback
        mean = float((ls * w).sum() / w.sum())
        return {"loss": mean, "perplexity": float(np.exp(mean)),
                "tokens": int(w.sum())}

    # -- inference ----------------------------------------------------------
    def logits(self, tokens) -> torch.Tensor:
        """tokens [N, T] -> logits [N, T, V] f32."""
        with torch.inference_mode():
            return forward(self.compute_params, self._tokens(tokens),
                           self.cfg)[0]

    def output(self, tokens) -> torch.Tensor:
        """The containers' inference surface: token ids in, logits out."""
        return self.logits(tokens)

    def ring_logits(self, tokens, group, strategy: str = "ring"
                    ) -> torch.Tensor:
        """This rank's token shard [N, T_local] -> its logits [N, T_local,
        V] f32, attention sequence-parallel over ``group``
        (:func:`ring_forward`)."""
        with torch.inference_mode():
            return ring_forward(self.compute_params, self._tokens(tokens),
                                self.cfg, group, strategy)

    @staticmethod
    def _filter_logits(logits, top_k: Optional[int], top_p):
        """Top-k, then nucleus (top-p) filtering of tempered logits: k
        first, then the smallest set of the remaining tokens whose
        cumulative probability reaches ``top_p`` (the top token always
        survives: the mass before it is 0). Filtered entries are -inf."""
        neg = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, neg, logits)
        if top_p is not None:
            sorted_desc = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_desc, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep_sorted = (cum - probs) < top_p  # mass before the token
            thresh = torch.where(keep_sorted, sorted_desc, -neg).min(
                dim=-1, keepdim=True).values
            logits = torch.where(logits < thresh, neg, logits)
        return logits

    def _sample_fn(self, buf, pos0: int, n_new: int, gen, temperature,
                   top_k, top_p):
        """The full-forward sampler: each token from a forward over the
        whole right-padded window (causal masking hides the padding)."""
        out = []
        for i in range(n_new):
            logits, _ = forward(self.compute_params, buf, self.cfg)
            pos = pos0 + i  # next write index; condition on pos - 1
            tempered = logits[:, pos - 1] / max(float(temperature), 1e-6)
            nxt = _categorical(self._filter_logits(tempered, top_k, top_p),
                               gen)
            buf[:, pos] = nxt
            out.append(nxt)
        return torch.stack(out, dim=1)

    def _sample_kv_fn(self, buf, pos0: int, n_new: int, gen, temperature,
                      top_k, top_p):
        """The KV-cache sampler: prefill the window once, then one
        :func:`decode_step` per token (O(max_len) each)."""
        params = self.compute_params
        cache, _ = prefill_cache(params, buf, self.cfg)
        tok = buf[:, pos0 - 1]
        out = []
        for i in range(n_new):
            cache, logits = decode_step(params, cache, tok, pos0 - 1 + i,
                                        self.cfg)
            tempered = logits / max(float(temperature), 1e-6)
            tok = _categorical(self._filter_logits(tempered, top_k, top_p),
                               gen)
            out.append(tok)
        return torch.stack(out, dim=1)

    def generate(self, prompt, n_new: int, temperature: float = 1.0,
                 seed: int = 0, use_cache: Optional[bool] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
        """Sample ``n_new`` tokens after each prompt row ([N, T] ids) ->
        [N, n_new] on the device. Prompt length + n_new must fit max_len;
        longer prompts keep their last (max_len - n_new) tokens, right-
        padded with zeros that causal masking hides. ``use_cache`` (the
        default for dense models): prefill + :func:`decode_step`;
        otherwise a full forward per token. The uniforms come from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        cfg = self.cfg
        if n_new >= cfg.max_len:
            raise ValueError(f"n_new {n_new} must be < max_len {cfg.max_len}")
        if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k {top_k} must be in [1, vocab_size]")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p {top_p} must be in (0, 1]")
        if use_cache is None:
            use_cache = not cfg.moe_experts
        with torch.inference_mode():
            prompt = self._tokens(prompt).long()
            t = prompt.shape[1]
            keep = min(t, cfg.max_len - n_new)
            width = (cfg.max_len - n_new) if use_cache else cfg.max_len
            buf = torch.zeros((prompt.shape[0], width), dtype=torch.long,
                              device=self.device)
            buf[:, :keep] = prompt[:, t - keep:]
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            fn = self._sample_kv_fn if use_cache else self._sample_fn
            return fn(buf, keep, int(n_new), gen, temperature, top_k, top_p)
