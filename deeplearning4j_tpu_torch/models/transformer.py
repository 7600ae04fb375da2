"""Transformer language model: inference, training and sampling
(counterpart: ``deeplearning4j_tpu/models/transformer.py``).

Ported: ``TransformerConfig`` (same fields and defaults), ``init_params``
(same distributions, dense and MoE, a ``torch.Generator`` in place of
``jax.random``), ``_ln``, ``_attention``, ``_dense_block_f32`` (as
:func:`_block`), ``_moe_ffn`` :293, ``_moe_block`` :321, ``forward``
:340 (MoE aux included), ``nll_loss`` :381, ``loss_fn`` :398,
``ring_forward`` :695 (the long-context forward with attention
sequence-parallel over the ``'seq'`` group, MoE routing over the whole
sequence), ``prefill_cache`` :756, ``_moe_ffn_decode`` :796 and
``decode_step`` :808, the training step (``init_opt_state`` :409,
``_clip_by_global_norm``, ``_decay_mask``, ``_adam_update``,
``_validate_schedule``, ``_scheduled_lr``, ``_build_step`` :540 with
gradient accumulation, the grouped MoE objective and the bf16
loss-scaled branch of ``ops/lowprec.py``, ``make_train_step`` :642 and
``make_train_multi_step`` :669 with or without a ``data`` x ``model`` x
``expert`` mesh, ``_multi_from_step`` :1133), the layout of a mesh's
params (``param_specs`` :168, ``pipeline_param_shardings`` :1025 and
``param_shardings_for_mesh`` :211 as :func:`param_specs_for_mesh`, with
:func:`shard_params` and :func:`gather_params`), the sequence-parallel
step (``make_ring_train_step`` :860, ``_build_ring_step`` :880,
``_ring_step_shardings`` :907 as :func:`ring_step_block`,
``make_ring_train_multi_step`` :919), the pipeline (``pipeline_forward``
:941, ``make_pipeline_train_step`` :1054, ``_build_pipeline_step``
:1074, ``make_pipeline_train_multi_step`` :1114) and ``TransformerLM``
(:1155: ``fit``, ``fit_batches``, ``fit_iterator``, ``evaluate``,
``output``, ``save``/``load`` in the JAX zip layout, ``from_state``,
``generate`` with top-k/top-p and its two samplers, and the dispatch on
the group's mesh :1158-1207), plus :func:`params_from_numpy` for a JAX
parameter tree handed over as numpy. Not ported: ``measure_memory`` (an
XLA AOT ledger; ``torch.cuda.max_memory_allocated`` stands in on the
card).

What GSPMD does for the JAX mesh steps is explicit here: each rank takes
its share of the GLOBAL batch and runs the forward on its shards, with
the collectives of ``parallel/mesh.py`` where GSPMD would put them.
Sequence mode: each rank runs :func:`ring_forward` on its [N / data,
T / seq] block; the ring's and Ulysses' collectives carry the cotangents
between the ranks of the ``'seq'`` group; the loss and every gradient
leaf are summed over the ``data x seq`` world and divided by its size.
Megatron mode (:func:`make_train_step` with a mesh): a rank holds the
column shards of ``Wq``/``Wk``/``Wv``/``W1`` (its heads and d_ff
columns), the row shards of ``Wo``/``W2``, its d columns of ``embed``
and its experts; ``copy_to`` and ``psum`` pair up around each block's
two products and the tied head; the MoE routing gathers the ``'data'``
ranks' counts so the slots are the global batch's; the loss and the
gradients are averaged over ``'data'``. Pipeline mode: each rank holds
its stage's layers and runs the GPipe schedule of
``parallel/pipeline_parallel.py``. In every mode each rank runs the same
clip and Adam on the same bits wherever it holds a replica, so the
replicas stay bit-equal. The JAX package turns flash attention off under
a mesh (its Pallas call does not partition under GSPMD); here every rank
keeps ``FlashFn`` on its own heads.

Parameters are a dict in the JAX layout: ``embed`` [V, d], ``pos``
[max_len, d], ``lnf_g``/``lnf_b`` [d], and ``blocks`` whose leaves are
stacked per layer as [L, ...] (MoE: ``Wg`` [L, d, E], ``W1``
[L, E, d, f], ``b1`` [L, E, f], ``W2`` [L, E, f, d], ``b2`` [L, E, d]).
Under ``dtype_policy="performance"`` the blocks compute in bf16:
training casts each f32 master to bf16 at each use inside the autograd
graph, as the JAX forward does, so gradients reach the masters in f32;
inference reads one compute-dtype copy of the block weights
(:func:`compute_params`, rebuilt after each optimizer step) — the cast
gives the same values. ``embed``, ``pos`` and the final LN stay f32: the
tied head is ``h @ embed.T`` after an f32 final LN (at least f32: f64
stays f64, the gradient-check mode of the tests).

Attention with ``use_flash`` goes through ``ops/flash_attention.FlashFn``
on both devices: K4 forward and K7 backward on the card, their plain
versions (the same autograd function) on the CPU. The MoE FFN computes
the JAX package's dispatch and combine by index
(``parallel/expert_parallel.moe_ffn``); its expert products are
``torch.bmm``.

An :class:`ExtendedConfig` is the Mellum 2 block, which the JAX package
does not have (GQA, RoPE with YaRN on full layers, sliding-window layers
through a windowed K4/K7, RMSNorm, an untied f32 head, SwiGLU experts of
which this device holds a share, routed with no capacity): it sends
:func:`forward` to :func:`_forward_extended`, whose docstrings hold the
equations. Training and inference on one device take it; the decode,
serving, sequence-parallel, Megatron and pipeline paths refuse it
(:func:`refuse_extended`).

Steps are plain functions over the params dict, returning ``(params,
opt, loss)``; every scalar of the schedule, Adam's bias correction and
the loss scale stays a 0-d tensor on the device, so a step never waits
for the host. The multi step is a Python loop over K. A step returns new
param and moment tensors (it updates nothing its caller passed in),
except where a second copy of the optimizer's state would not fit on the
device: then Adam writes into the tensors it is given
(:func:`_adam_in_place`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.ops.f32_gemm import tied_head
from deeplearning4j_tpu_torch.ops.flash_attention import (
    attention_auto,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops.remat import remat_wrap
from deeplearning4j_tpu_torch.parallel import expert_parallel as ep
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    MeshGroups,
    as_mesh,
    copy_to,
    gather_from,
    group_size,
    psum,
)

Params = Dict[str, Any]

TOP_KEYS = ("embed", "pos", "lnf_g", "lnf_b")
BLOCK_KEYS = ("ln1_g", "ln1_b", "Wq", "Wk", "Wv", "Wo", "ln2_g", "ln2_b",
              "W1", "b1", "W2", "b2")
MOE_BLOCK_KEYS = BLOCK_KEYS[:8] + ("Wg",) + BLOCK_KEYS[8:]


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


@dataclasses.dataclass(frozen=True)
class ExtendedConfig(TransformerConfig):
    """A :class:`TransformerConfig` (the JAX package's fields) of the
    Mellum 2 block, which :func:`_forward_extended` runs: pre-RMSNorm,
    RoPE on q and k (YaRN on the full layers with ``rope_yarn``), GQA,
    sliding-window and full layers, SwiGLU experts of which this device
    holds a share, routed with no capacity, and an untied f32 head. The
    fields below are its options; every ``ExtendedConfig`` takes that
    path, and a :class:`TransformerConfig` never does."""

    head_dim: int = 0          # 0: d_model // n_heads
    n_kv_heads: int = 0        # 0: n_heads; fewer: GQA
    norm_eps: float = 1e-6     # the RMSNorm eps (rms_norm_eps)
    rope_theta: float = 0.0    # the rotation's base: must be set (> 0)
    # YaRN on the full layers: (factor, original positions, beta_fast,
    # beta_slow, attention_factor); () the default rotation everywhere
    rope_yarn: Tuple[float, ...] = ()
    # per layer "full_attention" or "sliding_attention"; () all full
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 0
    moe_experts_held: int = 0  # of moe_experts, held here (0: all)
    moe_expert_offset: int = 0  # the first expert held here

    @property
    def head_size(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def experts_held(self) -> int:
        return self.moe_experts_held or self.moe_experts


def _validate_moe(cfg: TransformerConfig) -> None:
    """An MoE config's top-k must name experts that exist; an
    :class:`ExtendedConfig` must make a model (:func:`_validate_extended`)."""
    if cfg.moe_experts and not 1 <= cfg.moe_top_k <= cfg.moe_experts:
        raise ValueError(f"MoE moe_top_k {cfg.moe_top_k} must be in "
                         f"[1, moe_experts={cfg.moe_experts}]")
    _validate_extended(cfg)


FULL, SLIDING = "full_attention", "sliding_attention"


def refuse_extended(cfg: TransformerConfig, what: str) -> None:
    """Raise where ``what`` (an entry point that computes the
    GPT-2-style block only: decoding, serving, the sequence-parallel,
    Megatron and pipeline steps) is handed an :class:`ExtendedConfig`."""
    if isinstance(cfg, ExtendedConfig):
        raise ValueError(f"{what} does not support the options of an "
                         "ExtendedConfig (TransformerLM.fit, evaluate and "
                         "logits on one device do)")


def _validate_extended(cfg: TransformerConfig) -> None:
    if not isinstance(cfg, ExtendedConfig):
        return
    heads, kv = cfg.n_heads, cfg.kv_heads
    if heads % kv:
        raise ValueError(f"n_heads {heads} not a multiple of n_kv_heads {kv}")
    kinds = cfg.layer_types or (FULL,) * cfg.n_layers
    if len(kinds) != cfg.n_layers or set(kinds) - {FULL, SLIDING}:
        raise ValueError(f"layer_types must name {cfg.n_layers} layers of "
                         f"{FULL!r} or {SLIDING!r}")
    if SLIDING in kinds and cfg.sliding_window <= 0:
        raise ValueError("sliding layers need sliding_window > 0")
    if cfg.rope_theta <= 0:
        raise ValueError("an ExtendedConfig rotates q and k: rope_theta > 0")
    if cfg.rope_yarn and len(cfg.rope_yarn) != 5:
        raise ValueError("rope_yarn is (factor, original positions, "
                         "beta_fast, beta_slow, attention_factor)")
    if not cfg.moe_experts:
        raise ValueError("an ExtendedConfig's FFN is its experts: "
                         "moe_experts > 0")
    if not (0 <= cfg.moe_expert_offset and cfg.moe_expert_offset
            + cfg.experts_held <= cfg.moe_experts):
        raise ValueError(
            f"experts {cfg.moe_expert_offset}.."
            f"{cfg.moe_expert_offset + cfg.experts_held - 1} held of "
            f"{cfg.moe_experts}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, *, device=None) -> Params:
    """Random f32 params with the JAX package's distributions
    (``transformer.py:115-165``): xavier-normal q/k/v/W1, depth-scaled
    N(0, 0.02/sqrt(2L)) Wo/W2, N(0, 0.02) embed, N(0, 0.01) pos, unit LN
    scales, zero biases; with ``moe_experts`` E, a gate ``Wg`` [L, d, E]
    and E experts a layer (``W1`` [L, E, d, f], ``W2`` [L, E, f, d], their
    biases). Drawn from a ``torch.Generator`` seeded with ``cfg.seed`` on
    ``device``; the bits differ from ``jax.random``."""
    _validate_moe(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    if isinstance(cfg, ExtendedConfig):
        return _init_extended(cfg, gen, dev)

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
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        blocks.update({
            "Wg": xavier((L, d, E)),
            "W1": xavier((L, E, d, f)), "b1": zeros((L, E, f)),
            "W2": norm((L, E, f, d), depth), "b2": zeros((L, E, d)),
        })
    else:
        blocks.update({
            "W1": xavier((L, d, f)), "b1": zeros((L, f)),
            "W2": norm((L, f, d), depth), "b2": zeros((L, d)),
        })
    return {
        "embed": norm((cfg.vocab_size, d), 0.02),
        "pos": norm((cfg.max_len, d), 0.01),
        "lnf_g": ones((d,)), "lnf_b": zeros((d,)),
        "blocks": blocks,
    }


def _init_extended(cfg: ExtendedConfig, gen, dev) -> Params:
    """The params of an :class:`ExtendedConfig`, the same distributions
    as :func:`init_params`: xavier-normal q/k/v, the router ``Wr`` and the
    experts' gate|up ``W1``; N(0, 0.02/sqrt(2L)) ``Wo`` and ``W2``;
    N(0, 0.02) ``embed`` and ``lm_head``; unit RMSNorm scales. ``Wq``
    [L, d, H hd], ``Wk``/``Wv`` [L, d, H_kv hd], ``Wo`` [L, H hd, d],
    ``Wr`` [L, d, E], ``W1`` [L, E_h, d, 2 d_ff], ``W2`` [L, E_h, d_ff,
    d], ``lm_head`` [V, d]; no biases, no ``pos``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_size, cfg.kv_heads * cfg.head_size
    E, Eh = cfg.moe_experts, cfg.experts_held

    def norm(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * float(scale)

    def xavier(shape):
        return norm(shape, math.sqrt(2.0 / (shape[-2] + shape[-1])))

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    depth = 0.02 / math.sqrt(2 * L)
    blocks = {"ln1_g": ones((L, d)),
              "Wq": xavier((L, d, qd)), "Wk": xavier((L, d, kvd)),
              "Wv": xavier((L, d, kvd)), "Wo": norm((L, qd, d), depth),
              "ln2_g": ones((L, d)),
              "Wr": xavier((L, d, E)), "W1": xavier((L, Eh, d, 2 * f)),
              "W2": norm((L, Eh, f, d), depth)}
    return {"embed": norm((cfg.vocab_size, d), 0.02),
            "lm_head": norm((cfg.vocab_size, d), 0.02),
            "lnf_g": ones((d,)), "blocks": blocks}


def params_from_numpy(tree: Params, *, device=None) -> Params:
    """The port's params from a JAX parameter tree handed over as numpy
    arrays in the JAX layout (top level ``embed``/``pos``/``lnf_g``/
    ``lnf_b``, per-layer leaves stacked under ``blocks``, dense or MoE).
    The f32 values are carried bit for bit."""
    dev = resolve_device(device)
    want = set(TOP_KEYS) | {"blocks"}
    got = set(tree.get("blocks", {}))
    if set(tree) != want or got not in (set(BLOCK_KEYS), set(MOE_BLOCK_KEYS)):
        raise ValueError(
            f"not a dense TransformerLM tree nor an MoE one: top "
            f"{sorted(tree)}, blocks {sorted(got)}")

    def leaf(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
        return torch.from_numpy(a.copy()).to(dev)

    out = {k: leaf(tree[k]) for k in TOP_KEYS}
    keys = MOE_BLOCK_KEYS if "Wg" in got else BLOCK_KEYS
    out["blocks"] = {k: leaf(tree["blocks"][k]) for k in keys}
    return out


def compute_params(params: Params, cfg: TransformerConfig) -> Params:
    """The params the forward reads: block weights in the compute dtype
    (one copy, made here; the same tensors under ``strict``), ``embed``,
    ``pos`` and the final LN in f32."""
    cdt = cfg.compute_dtype
    out = {k: v for k, v in params.items() if k != "blocks"}
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


@dataclasses.dataclass(frozen=True)
class Shards:
    """How one rank's share of a step is laid out (the JAX package's
    GSPMD shardings, made explicit): ``model`` the Megatron group (heads,
    d_ff and ``embed``'s d split over it), ``experts`` the expert shards
    of the MoE FFN, ``route`` the ranks whose tokens share one MoE
    routing (``'data'``/``'seq'``). Absent groups are None."""

    model: object = None
    experts: Optional[ep.ExpertGroups] = None
    route: Optional[ep.RouteGroups] = None


def _block(bp: Params, h, cfg: TransformerConfig, attend, ffn=None,
           model=None):
    """One block in the compute dtype (the JAX package's
    ``_dense_block_f32`` with the same cast discipline): pre-LN
    attention, residual, pre-LN FFN, residual. ``attend`` maps (q, k, v)
    [N, T, d_local] to the attention output; ``ffn`` maps the normed
    input to the FFN's residual delta (default: the tanh-GELU MLP, or for
    an MoE config the no-drop MoE of :func:`_moe_ffn_decode`). ``model``:
    the Megatron group — the block's weights are this rank's column and
    row shards, and the two sums after ``Wo`` and ``W2`` run over it."""
    cdt = cfg.compute_dtype
    c = lambda a: a.to(cdt)
    x = copy_to(_ln(h, c(bp["ln1_g"]), c(bp["ln1_b"])), model)
    q, k, v = x @ c(bp["Wq"]), x @ c(bp["Wk"]), x @ c(bp["Wv"])
    h = h + psum(attend(q, k, v) @ c(bp["Wo"]), model)
    x = _ln(h, c(bp["ln2_g"]), c(bp["ln2_b"]))
    if ffn is None and cfg.moe_experts:
        ffn = lambda xx: _moe_ffn_decode(bp, xx, cfg)
    if ffn is not None:
        return h + ffn(x)
    x = copy_to(x, model)
    # jax.nn.gelu defaults to the tanh approximation
    inner = F.gelu(x @ c(bp["W1"]) + c(bp["b1"]), approximate="tanh")
    return h + psum(inner @ c(bp["W2"]), model) + c(bp["b2"])


def _moe_ffn(bp: Params, x, cfg: TransformerConfig, capacity: int = 0,
             shards: Optional[Shards] = None, stats=None):
    """The MoE FFN of one block (``transformer.py:293``): x [N, T, d]
    (this rank's tokens) -> (y, aux). ``capacity`` 0 is the standard
    ``int(factor * N * T * k / E)`` over the routed batch (every rank of
    ``shards.route``); ``parallel/expert_parallel.moe_ffn`` routes by
    index."""
    n, t, d = x.shape
    shards = shards or Shards()
    route = shards.route
    if not capacity:
        n_all = n * (1 if route is None else group_size(route.data))
        t_all = t * (1 if route is None else group_size(route.seq))
        capacity = max(1, int(cfg.moe_capacity_factor * n_all * t_all
                              * cfg.moe_top_k / cfg.moe_experts))
    y, aux = ep.moe_ffn(x.reshape(n * t, d), bp, top_k_=cfg.moe_top_k,
                        capacity=capacity, rows=n, route=route,
                        shards=shards.experts, stats=stats)
    return y.reshape(n, t, d), aux


def _moe_ffn_decode(bp: Params, x, cfg: TransformerConfig):
    """The MoE FFN of a decode step (``transformer.py:796``): the no-drop
    capacity N * T (a streamed token competes only with its own step's),
    so decode matches the batch forward wherever that drops nothing."""
    n, t, _ = x.shape
    return _moe_ffn(bp, x, cfg, capacity=n * t)[0]


def _moe_block(bp: Params, h, cfg: TransformerConfig, attend,
               shards: Optional[Shards] = None, stats=None,
               capacity: int = 0):
    """One block with the MoE FFN (``transformer.py:321``) -> (h, aux)."""
    shards = shards or Shards()
    cap = {}

    def ffn(x):
        y, cap["aux"] = _moe_ffn(bp, x, cfg, capacity=capacity,
                                 shards=shards, stats=stats)
        return y

    h = _block(bp, h, cfg, attend, ffn=ffn, model=shards.model)
    return h, cap["aux"]


def _embed(params: Params, tokens, cfg: TransformerConfig, start: int = 0,
           model=None):
    """Token and position embeddings in the compute dtype; under
    ``model`` each rank holds ``embed``'s d columns of its shard, and the
    rows are gathered whole."""
    t = tokens.shape[1]
    e = gather_from(params["embed"][tokens.long()], model, dim=-1)
    h = e + params["pos"][start:start + t][None]
    return h.to(cfg.compute_dtype)


def _at_least_f32(x):
    """bf16 -> f32; f32 and f64 stay (the JAX package's f32 casts, with
    f64 kept for the gradient checks)."""
    return x.to(softmax_dtype(x.dtype))


def _final_ln(params: Params, h):
    return _ln(_at_least_f32(h), params["lnf_g"], params["lnf_b"])


def _head(params: Params, h, model=None):
    """The tied head on the final LN's output: h @ embed.T in h's dtype,
    through ``ops/f32_gemm.tied_head`` (K8 on the card for an f32 h of
    enough rows). Under ``model`` a rank holds d/p columns of ``embed``:
    its logits are a partial sum over its columns, summed over the
    group."""
    if group_size(model) == 1:
        return tied_head(h, params["embed"].to(h.dtype))
    import torch.distributed as tdist

    dl = params["embed"].shape[1]
    i = tdist.get_rank(model)
    h = copy_to(h, model)[..., i * dl:(i + 1) * dl]
    return psum(h @ params["embed"].to(h.dtype).T, model)


def _local_heads(cfg: TransformerConfig, model) -> int:
    p = group_size(model)
    if cfg.n_heads % p:
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by "
                         f"model-axis size {p}")
    return cfg.n_heads // p


def forward(params: Params, tokens, cfg: TransformerConfig,
            shards: Optional[Shards] = None, stats=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [N, T] int -> (logits [N, T, V] f32, aux): the JAX
    ``forward`` (:340); aux is the MoE load-balance loss averaged over
    the layers (0 for dense models). While gradients are recorded each
    block runs under the remat policy (``cfg.remat``, ``ops/remat.py``).
    ``shards``: this rank's share of a Megatron / expert-parallel step
    (``params`` then hold this rank's shards, :func:`shard_params`)."""
    if isinstance(cfg, ExtendedConfig):
        if shards is not None and shards != Shards():
            refuse_extended(cfg, "the Megatron / expert-parallel forward")
        return _forward_extended(params, tokens, cfg)
    shards = shards or Shards()
    model = shards.model
    h = _embed(params, tokens, cfg, model=model)
    heads = _local_heads(cfg, model)
    attend = lambda q, k, v: _attention(q, k, v, heads,
                                        use_flash=cfg.use_flash)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.moe_experts:
        def body(bp, h):
            return _moe_block(bp, h, cfg, attend, shards=shards,
                              stats=stats)
    else:
        def body(bp, h):
            return _block(bp, h, cfg, attend, model=model), None
    block = (remat_wrap(body, cfg.remat) if torch.is_grad_enabled()
             else body)
    for bp in _layers(params["blocks"]):
        h, a = block(bp, h)
        if a is not None:
            aux = aux + a
    logits = _at_least_f32(_head(params, _final_ln(params, h), model))
    return logits, aux / cfg.n_layers


# ---------------------------------------------------------------------------
# the extended block: GQA, RoPE / YaRN, sliding windows, RMSNorm, SwiGLU
# experts held here, an untied head
# ---------------------------------------------------------------------------


def rope_inv_freq(cfg: TransformerConfig, kind: str) -> torch.Tensor:
    """The inverse frequencies [hd/2] (f64) of a layer of ``kind``: the
    default rotation ``theta^(-2i/hd)`` (``rope_theta``), or on full
    layers with ``rope_yarn`` = (s, L0, b_fast, b_slow, m) YaRN's blend
    (HF ``_compute_yarn_parameters``): with
    ``dim(r) = hd ln(L0 / (2 pi r)) / (2 ln theta)``, lo =
    floor(dim(b_fast)) and hi = ceil(dim(b_slow)) clamped to [0, hd-1],
    ramp_i = clamp((i - lo) / (hi - lo), 0, 1), and
    ``inv_i = f_i / s * ramp_i + f_i * (1 - ramp_i)`` over the default
    f_i: extrapolated (unchanged) below lo, interpolated by 1/s above hi.
    Its cos and sin are scaled by m (``attention_factor``)."""
    hd, theta = cfg.head_size, float(cfg.rope_theta)
    base = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    if kind != FULL or not cfg.rope_yarn:
        return base
    factor, orig, fast, slow, _ = (float(x) for x in cfg.rope_yarn)

    def dim(rot):
        return hd * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(dim(fast)), 0)
    hi = min(math.ceil(dim(slow)), hd - 1)
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(hd // 2, dtype=torch.float64) - lo)
                       / (hi - lo), 0.0, 1.0)
    return base / factor * ramp + base * (1.0 - ramp)


def rope_tables(cfg: TransformerConfig, kind: str, t: int, device):
    """(cos, sin) [T, hd] f64 of positions 0..T-1 for a layer of
    ``kind``: angles pos * inv_freq, each half of hd repeated
    (rotate-half), times YaRN's ``attention_factor`` on full YaRN
    layers."""
    inv = rope_inv_freq(cfg, kind).to(device)
    ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    scale = (float(cfg.rope_yarn[4]) if kind == FULL and cfg.rope_yarn
             else 1.0)
    return ang.cos() * scale, ang.sin() * scale


def _rotate(x, cos, sin):
    """RoPE (rotate-half) on x [N, T, H, hd]: x cos + rot(x) sin with
    rot(x) = (-x2, x1) over the halves, in at least f32 (the tables
    rounded to it), back to x's dtype."""
    xf = _at_least_f32(x)
    cos, sin = cos.to(xf.dtype)[:, None], sin.to(xf.dtype)[:, None]
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def _rms_norm(x, g, eps: float):
    """RMSNorm: x * rsqrt(mean(x^2) + eps), in at least f32, back to x's
    dtype, times g (``rms_norm_eps``; no bias)."""
    xf = _at_least_f32(x)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * g


def _moe_span(cfg: TransformerConfig):
    """The ``train.moe`` span of an expert layer's forward (router
    through combine), on the device too; none in a checkpoint's recompute
    (the backward's thread, under no ``train.step``)."""
    if ep.in_backward():
        return contextlib.nullcontext(obs_trace.NULL_SPAN)
    return obs_trace.span("train.moe", device=True,
                          experts_held=cfg.experts_held)


class _HeldRows:
    """The expert layer's counters on the port's registry, read from the
    card without a wait: ``moe.routed_rows`` (rows the held experts
    computed), ``moe.dropped_rows`` (0: nothing is dropped) and the gauge
    ``moe.max_expert_rows`` (the most rows one held expert took in one
    call since the process started). Each forward call's rows per held
    expert, and their sum, are copied into pinned host memory behind the
    layer's work; the registry takes them once the copy has landed, at a
    later call or at :func:`expert_counters`, which waits for it."""

    def __init__(self):
        self.pending = collections.deque()
        self.max_rows = 0.0

    def add(self, rows: torch.Tensor) -> torch.Tensor:
        """Queue one call's ``rows`` [E_h] -> their sum: off the CPU a
        host tensor that holds it once the copy has landed."""
        counts = torch.cat([rows, rows.sum()[None]])
        done = None
        if counts.is_cuda:
            host = torch.empty(counts.shape, dtype=counts.dtype,
                               pin_memory=True)
            host.copy_(counts, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            counts = host
        self.pending.append((done, counts))
        self.take(wait=False)
        return counts[-1] if done is not None else int(counts[-1])

    def take(self, wait: bool) -> None:
        from deeplearning4j_tpu_torch.obs.registry import default_registry

        reg = default_registry()
        while self.pending:
            done, counts = self.pending[0]
            if done is not None:
                if wait:
                    done.synchronize()
                elif not done.query():
                    return
            self.pending.popleft()
            vals = counts.tolist()
            reg.counter("moe.routed_rows", float(vals[-1]))
            reg.counter("moe.dropped_rows", 0.0)
            self.max_rows = max(self.max_rows, float(max(vals[:-1])))
            reg.gauge("moe.max_expert_rows", self.max_rows)


_HELD_ROWS = _HeldRows()


def expert_counters() -> None:
    """Bring the held-expert layer's counters on the port's registry up
    to date (:class:`_HeldRows`): waits for the copies of the calls not
    yet taken, and so for the card's work before them."""
    _HELD_ROWS.take(wait=True)


def _ffn_extended(bp: Params, x, cfg: ExtendedConfig):
    """The block's expert layer on the normed x [N, T, d] -> (delta,
    aux): SwiGLU experts held here (``parallel/expert_parallel.
    moe_ffn_held``), under ``train.moe`` with its counters."""
    n, t, d = x.shape
    with _moe_span(cfg) as sp:
        y, aux, rows = ep.moe_ffn_held(
            x.reshape(n * t, d), bp["Wr"], bp["W1"], bp["W2"],
            top_k_=cfg.moe_top_k, expert_offset=cfg.moe_expert_offset)
        if not ep.in_backward():
            sp.set_attr("rows_routed", _HELD_ROWS.add(rows))
    return y.reshape(n, t, d), aux


def _block_extended(bp: Params, h, cfg: ExtendedConfig, kind: str, rope):
    """One block of an :class:`ExtendedConfig`, in the compute dtype ->
    (h, aux): x = RMSNorm(h) with ``ln1_g``; q = x Wq [T, H, hd], k = x Wk
    and v = x Wv [T, H_kv, hd] (``num_key_value_heads``), RoPE on q and k
    (``rope``: this layer kind's (cos, sin)); K and V
    repeated to the H query heads (head i reads K/V head i // (H/H_kv);
    autograd sums each group back); causal softmax(q k / sqrt(hd)) v,
    keys with i - j >= ``sliding_window`` hidden on sliding layers
    (``attention_auto``: K4 and K7 on the card); h += o Wo; h +=
    experts(RMSNorm(h) with ``ln2_g``) (:func:`_ffn_extended`)."""
    n, t, _ = h.shape
    c = lambda a: a.to(cfg.compute_dtype)
    heads, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_size
    x = _rms_norm(h, c(bp["ln1_g"]), cfg.norm_eps)
    q = (x @ c(bp["Wq"])).view(n, t, heads, hd)
    k = (x @ c(bp["Wk"])).view(n, t, kv, hd)
    v = (x @ c(bp["Wv"])).view(n, t, kv, hd)
    q, k = _rotate(q, *rope), _rotate(k, *rope)
    if kv != heads:
        k = k.repeat_interleave(heads // kv, dim=2)
        v = v.repeat_interleave(heads // kv, dim=2)
    window = cfg.sliding_window if kind == SLIDING else 0
    if cfg.use_flash:
        o = attention_auto(q, k, v, causal=True, window=window)
    else:
        o = flash_attention_plain(q, k, v, causal=True, window=window)[0]
    h = h + o.reshape(n, t, heads * hd) @ c(bp["Wo"])
    y, aux = _ffn_extended(bp, _rms_norm(h, c(bp["ln2_g"]), cfg.norm_eps),
                           cfg)
    return h + y, aux


def _forward_extended(params: Params, tokens, cfg: ExtendedConfig):
    """:func:`forward` of an :class:`ExtendedConfig` -> (logits [N, T, V]
    f32, aux): the token embedding in the compute dtype, every block under
    the remat policy while gradients are recorded, the final RMSNorm
    (``lnf_g``) in at least f32, the untied head ``h @ lm_head.T`` through
    ``ops/f32_gemm.tied_head``; aux the mean over the layers."""
    h = params["embed"][tokens.long()].to(cfg.compute_dtype)
    kinds = cfg.layer_types or (FULL,) * cfg.n_layers
    ropes = {kind: rope_tables(cfg, kind, tokens.shape[1], h.device)
             for kind in set(kinds)}
    block = (remat_wrap(_block_extended, cfg.remat)
             if torch.is_grad_enabled() else _block_extended)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for bp, kind in zip(_layers(params["blocks"]), kinds):
        h, a = block(bp, h, cfg, kind, ropes[kind])
        aux = aux + a
    h = _rms_norm(_at_least_f32(h), params["lnf_g"], cfg.norm_eps)
    head = params["lm_head"]
    logits = _at_least_f32(tied_head(h, head.to(h.dtype)))
    return logits, aux / cfg.n_layers


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


def loss_fn(params: Params, tokens, targets, cfg: TransformerConfig,
            shards: Optional[Shards] = None):
    logits, aux = forward(params, tokens, cfg, shards)
    return nll_loss(logits, targets) + cfg.moe_aux_coef * aux


def ring_forward(params: Params, tokens, cfg: TransformerConfig, group,
                 strategy: str = "ring", return_aux: bool = False,
                 route: Optional[ep.RouteGroups] = None):
    """The forward with attention sequence-parallel over ``group``, for
    sequences sharded over ranks: ``tokens`` [N, T_local] is this rank's
    shard (rank r holds positions r * T_local ..), embedded with its own
    slice of ``pos``; every block runs :func:`_block` with the sharded
    attention (``strategy="ring"``: K/V shards rotate, each step through
    K5; ``"ulysses"``: two head <-> sequence all-to-alls around K4 over
    all T, heads divisible by the world size). Returns this rank's
    logits [N, T_local, V] f32. Differentiable across the group
    (``parallel/sequence_parallel.py``). MoE blocks route the tokens of
    every rank of ``route`` as one batch (by default the ``'seq'`` group:
    the whole sequence, as GSPMD routes the JAX ring step's global
    array); ``return_aux`` also returns the load-balance loss (the SP
    training objective, :753)."""
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        ring_attention_sharded,
        ulysses_attention_sharded,
    )

    refuse_extended(cfg, "ring_forward")
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
    if route is None:
        route = ep.RouteGroups(seq=group, seq_index=dist.get_rank(group))
    shards = Shards(route=route)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for bp in _layers(params["blocks"]):
        if cfg.moe_experts:
            h, a = _moe_block(bp, h, cfg, attend, shards=shards)
            aux = aux + a
        else:
            h = _block(bp, h, cfg, attend)
    logits = _at_least_f32(_head(params, _final_ln(params, h)))
    if return_aux:
        return logits, aux / cfg.n_layers
    return logits


def prefill_cache(params: Params, tokens, cfg: TransformerConfig
                  ) -> Tuple[Params, torch.Tensor]:
    """Run the prompt once: (cache, hidden). cache leaves are
    [L, N, max_len, H, hd] in the compute dtype, zero beyond the prompt
    (decode's position mask never reads them); hidden [N, T, d] is f32
    after the final LN. Same block body and casts as :func:`forward`
    (MoE blocks route the prompt with the standard capacity)."""
    refuse_extended(cfg, "prefill_cache")
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

        bp = _layer(params["blocks"], layer)
        if cfg.moe_experts:
            h, _ = _moe_block(bp, h, cfg, attend)
        else:
            h = _block(bp, h, cfg, attend)
    return {"k": ks, "v": vs}, _final_ln(params, h)


def decode_step(params: Params, cache: Params, tok, pos: int,
                cfg: TransformerConfig) -> Tuple[Params, torch.Tensor]:
    """One autoregressive step: consume the token ``tok`` [N] at position
    ``pos`` (writing its K/V into the dense cache of
    :func:`prefill_cache`, in place) and return (cache, logits [N, V] for
    position pos + 1). Attention reads the whole max_len cache under an
    ``arange <= pos`` mask, in f32, as a plain einsum (XLA's in the JAX
    package). Same block body and casts as :func:`forward`; MoE blocks
    route through :func:`_moe_ffn_decode` (no-drop capacity)."""
    refuse_extended(cfg, "decode_step")
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


def _clip_by_global_norm(grads: Params, max_norm: float, norm_of=None):
    """Global-norm clip over the whole tree through the port's shared
    gradient normalization (``optimize/updaters.normalize_gradients``,
    ``clip_l2_per_layer``): (clipped grads, the norm before). On a sharded
    mesh ``norm_of(grads)`` gives the norm of the whole tree
    (:func:`sharded_global_norm`) and the same scale applies."""
    from deeplearning4j_tpu_torch.optimize.updaters import (
        _global_norm,
        normalize_gradients,
    )

    flat = _named(grads)
    if norm_of is None:
        clipped = normalize_gradients(flat, "clip_l2_per_layer", max_norm)
        it = iter(clipped[k] for k in flat)
        return tree_map(lambda _: next(it), grads), _global_norm(flat)
    norm = norm_of(grads)
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-12),
                        torch.ones_like(norm))
    return tree_map(lambda g: g * scale, grads), norm


def sharded_global_norm(cfg: TransformerConfig, mesh):
    """``norm_of(grads)``: the global L2 norm of a tree of this rank's
    gradient shards, as GSPMD computes ``_global_norm`` over the whole
    tree (JAX ``_adam_update`` :456 under a mesh). Each leaf's squared
    sum is summed over the groups of the axes its
    :func:`param_specs_for_mesh` entry splits it on; a replicated leaf
    is counted once. One all-reduce per (set of split axes), in a fixed
    order on every rank. None (the plain norm) on a mesh that splits no
    leaf."""
    if all(mesh.size(a) == 1 for a in (MODEL_AXIS, EXPERT_AXIS,
                                       PIPELINE_AXIS)):
        return None
    specs = param_specs_for_mesh(cfg, mesh)

    def norm_of(grads):
        sums: Dict[tuple, list] = {}

        def visit(g, spec):
            axes = tuple(a for a in dict.fromkeys(spec)
                         if a is not None and mesh.size(a) > 1)
            sums.setdefault(axes, []).append(torch.sum(g * g))
            return g

        _spec_map(visit, grads, specs)
        total = None
        for axes in sorted(sums):
            s = torch.stack(sums[axes]).sum()
            for a in axes:
                dist.all_reduce(s, group=mesh.group(a))
            total = s if total is None else total + s
        return torch.sqrt(total)

    return norm_of


def _finite_on_every_shard(finite, mesh):
    """The bf16 step's finite flag agreed over the mesh's ``'model'`` and
    ``'expert'`` groups (a MIN all-reduce): every rank of a shard group
    skips, or takes, the same step, as GSPMD's one global check does."""
    flag = None
    for axis in (MODEL_AXIS, EXPERT_AXIS):
        if mesh.size(axis) > 1:
            if flag is None:
                flag = finite.to(torch.int32).reshape(())
            dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                            group=mesh.group(axis))
    return finite if flag is None else flag > 0


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
                 weight_decay: float = 0.0, clip_grad_norm: float = 0.0,
                 norm_of=None, in_place: bool = False):
    """(new params, {"m", "v", "t"}): Adam, with decoupled weight decay on
    the :func:`_decay_mask` leaves and a global-norm clip first (the norm
    from ``norm_of`` on a sharded mesh). The bias
    correction is computed in f32 from the step count as f32 (``lr`` a 0-d
    f32 tensor), as the JAX package computes it. Leaf by leaf:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g, p -= lr (corr m /
    (sqrt(v) + eps) + wd p). ``in_place`` writes each leaf's last sum
    into the params and moments it is given (:func:`_adam_in_place`)
    rather than into new tensors: the same operations, so the same bits.
    The ``train.optimizer`` span, on the device too."""
    with obs_trace.span("train.optimizer", device=True) as sp:
        if sp is not obs_trace.NULL_SPAN:
            sp.set_attr("leaves", len(tree_leaves(params)))
        if clip_grad_norm:
            grads, _ = _clip_by_global_norm(grads, clip_grad_norm, norm_of)
        t = opt["t"] + 1
        tf = t.to(torch.float32)
        corr = torch.sqrt(1 - torch.pow(b2, tf)) / (1 - torch.pow(b1, tf))

        def into(x):
            return {"out": x} if in_place else {}

        new, m, v = [], [], []
        for p, m_, v_, g, d in zip(
                tree_leaves(params), tree_leaves(opt["m"]),
                tree_leaves(opt["v"]), tree_leaves(grads),
                tree_leaves(_decay_mask(params))):
            m.append(torch.add(b1 * m_, (1 - b1) * g, **into(m_)))
            v.append(torch.add(b2 * v_, (1 - b2) * g * g, **into(v_)))
            if weight_decay:
                upd = lr * (corr * m[-1] / (torch.sqrt(v[-1]) + eps)
                            + (weight_decay * p if d else 0.0))
            else:
                upd = lr * corr * m[-1] / (torch.sqrt(v[-1]) + eps)
            new.append(torch.sub(p, upd, **into(p)))
        like = lambda leaves: tree_map(lambda _: next(leaves), params)
    return like(iter(new)), {"m": like(iter(m)), "v": like(iter(v)), "t": t}


def _adam_in_place(params: Params) -> bool:
    """Where Adam writes (:func:`_adam_update`'s ``in_place``), the one
    rule: into the tensors it is given when the functional step's seven
    copies of the parameters (params, m and v old and new, and the
    gradients) would pass half the device's memory, as at 2.44 B f32
    parameters (68 GB of an 80 GB card, where the functional step ran out
    of memory or remapped it every step); as new tensors otherwise, and
    always off a CUDA device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    if dev.type != "cuda":
        return False
    size = sum(x.numel() * x.element_size() for x in leaves)
    return 7 * size > torch.cuda.get_device_properties(dev).total_memory / 2


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
    the tree's layout (``jax.value_and_grad`` for a params dict). The
    ``train.forward`` and ``train.backward`` spans, on the device too
    (the backward's exit event is recorded once ``grad`` has returned,
    behind every backward kernel on the forward's stream)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        with obs_trace.span("train.forward", device=True):
            loss = loss_of(live)
        with obs_trace.span("train.backward", device=True):
            grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _build_step(cfg: TransformerConfig, mesh: Optional[MeshGroups] = None):
    """The optimizer step of :func:`make_train_step`: loss and gradients
    (a loop of ``accum_steps`` microbatches: for dense configs their
    mean-of-means is the full batch's, for MoE the grouped objective,
    one routing group per microbatch), the bf16 loss-scaled branch under
    ``DL4J_TPU_BF16`` (read here, and kept as the step's ``loss_scaled``:
    its opt dict must come from ``init_opt_state(params, step.loss_scaled)``),
    Adam. With ``mesh`` (``data`` x ``model`` x ``expert``) each rank
    takes its rows of every microbatch, its params are its
    :func:`shard_params` shards, and the loss and the gradients are
    averaged over ``'data'``. Validates the config loudly."""
    _validate_moe(cfg)
    _validate_schedule(cfg)
    accum_steps = cfg.accum_steps
    lp = lowprec.train_policy()
    shards, data, norm_of = None, None, None
    if mesh is not None:
        refuse_extended(cfg, "make_train_step on a mesh")
        if mesh.has(SEQUENCE_AXIS) or mesh.has(PIPELINE_AXIS):
            raise ValueError("make_train_step's mesh is data x model x "
                             "expert (the ring and pipeline steps take "
                             "'seq' and 'pipe')")
        norm_of = sharded_global_norm(cfg, mesh)
        shards = mesh_shards(mesh)
        data = mesh.group(DATA_AXIS)

    def step(params, opt, tokens, targets):
        if lp:
            # f32 masters cast to bf16 inside the graph, the loss scaled;
            # the f32 gradients are unscaled before Adam
            ls = lowprec.opt_scale_state(opt)
            base = {"m": opt["m"], "v": opt["v"], "t": opt["t"]}
            scale = ls["scale"]

            def grad_loss(p, x, y):
                return loss_fn(lowprec.cast_tree(p), x, y, cfg,
                               shards).to(torch.float32) * scale
        else:
            ls, base = None, opt

            def grad_loss(p, x, y):
                return loss_fn(p, x, y, cfg, shards)

        b = tokens.shape[0]
        if b % accum_steps != 0:
            raise ValueError(
                f"batch {b} not divisible by accum_steps {accum_steps}")
        mb = b // accum_steps
        loss, grads = None, None
        for i in range(accum_steps):
            x, y = (_data_rows(a[i * mb:(i + 1) * mb], mesh)
                    for a in (tokens, targets))
            loss_i, grads_i = value_and_grad(
                lambda p: grad_loss(p, x, y), params)
            if accum_steps == 1:
                loss, grads = loss_i, grads_i
                break
            if grads is None:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
                grads = tree_map(torch.zeros_like, params)
            grads = tree_map(lambda a, g: a + g / accum_steps, grads,
                             grads_i)
            loss = loss + loss_i / accum_steps
        loss, grads = _mean_over(data, loss, grads)

        if lp:
            loss = loss / scale  # report the unscaled loss
            grads = lowprec.unscale(grads, scale)
            finite = lowprec.finite_tree(grads)
            if mesh is not None:
                finite = _finite_on_every_shard(finite, mesh)
            lr = _scheduled_lr(cfg, base["t"] + 1)
            new_params, new_base = _adam_update(
                params, grads, base, lr, weight_decay=cfg.weight_decay,
                clip_grad_norm=cfg.clip_grad_norm, norm_of=norm_of)
            params = lowprec.select_trees(finite, new_params, params)
            # 't' too: a skipped step moves neither the schedule nor the
            # bias correction
            base = lowprec.select_trees(finite, new_base, base)
            ls = lowprec.advance_scale(ls, finite)
            return params, lowprec.opt_with_scale(base, ls), loss

        lr = _scheduled_lr(cfg, opt["t"] + 1)
        params, opt = _adam_update(params, grads, opt, lr,
                                   weight_decay=cfg.weight_decay,
                                   clip_grad_norm=cfg.clip_grad_norm,
                                   norm_of=norm_of,
                                   in_place=_adam_in_place(params))
        return params, opt, loss

    step.loss_scaled = lp
    return step


def make_train_step(cfg: TransformerConfig,
                    mesh: Optional[MeshGroups] = None):
    """``step(params, opt, tokens, targets) -> (params, opt, loss)``, one
    optimizer step (``transformer.py:642``); ``cfg.accum_steps`` > 1
    splits the batch into that many microbatches whose gradients are
    averaged before one update (for dense configs the full-batch step at
    1/A the activation memory). With ``mesh`` (a :class:`MeshGroups` of
    ``data``, ``model``, ``expert`` axes) every rank passes the GLOBAL
    batch and its own :func:`shard_params` shards: it runs its rows
    (``'data'``), its heads, d_ff columns and ``embed`` columns
    (``'model'``: two sums a block, one for the tied head) and its
    experts (``'expert'``: the MoE routing over the whole microbatch, as
    GSPMD routes it); the loss and gradients are averaged over
    ``'data'``."""
    return _build_step(cfg, mesh)


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


def make_train_multi_step(cfg: TransformerConfig,
                          mesh: Optional[MeshGroups] = None):
    """K optimizer steps over tokens/targets stacked [K, N, T]: the same
    results as K calls of :func:`make_train_step`'s step."""
    return _multi_from_step(_build_step(cfg, mesh))


# ---------------------------------------------------------------------------
# the layout of a mesh's params (param_specs, transformer.py:168)
# ---------------------------------------------------------------------------


def param_specs(cfg: TransformerConfig) -> Params:
    """The Megatron layout (``transformer.py:168``): per leaf, one mesh
    axis or None per dim (a ``PartitionSpec``). Column-parallel weights
    split their output dim over ``'model'``, row-parallel their input
    dim; MoE expert leaves also split the expert dim over ``'expert'``;
    ``embed`` splits d over ``'model'``."""
    col, row = (None, None, MODEL_AXIS), (None, MODEL_AXIS, None)
    blocks = {"ln1_g": (), "ln1_b": (), "Wq": col, "Wk": col, "Wv": col,
              "Wo": row, "ln2_g": (), "ln2_b": ()}
    if cfg.moe_experts:
        blocks.update({
            "Wg": (),
            "W1": (None, EXPERT_AXIS, None, MODEL_AXIS),
            "b1": (None, EXPERT_AXIS, MODEL_AXIS),
            "W2": (None, EXPERT_AXIS, MODEL_AXIS, None),
            "b2": (None, EXPERT_AXIS, None),
        })
    else:
        blocks.update({"W1": col, "b1": (None, MODEL_AXIS), "W2": row,
                       "b2": ()})
    return {"embed": (None, MODEL_AXIS), "pos": (), "lnf_g": (),
            "lnf_b": (), "blocks": blocks}


def pipeline_param_specs(cfg: TransformerConfig) -> Params:
    """The pipeline layout (``pipeline_param_shardings`` :1025): every
    block leaf split over ``'pipe'`` on its layer dim (stage s holds
    layers [s L/S, (s+1) L/S)), the rest whole."""
    keys = MOE_BLOCK_KEYS if cfg.moe_experts else BLOCK_KEYS
    return {"embed": (), "pos": (), "lnf_g": (), "lnf_b": (),
            "blocks": {k: (PIPELINE_AXIS,) for k in keys}}


def param_specs_for_mesh(cfg: TransformerConfig, mesh) -> Params:
    """THE rule for which slice of each leaf a rank holds
    (``param_shardings_for_mesh`` :211): the pipeline layout when the
    mesh has ``'pipe'``, Megatron when it has ``'model'`` or
    ``'expert'``, every leaf whole otherwise (``'data'`` and ``'seq'``
    meshes). Training, :func:`shard_params`, the sharded checkpoint's
    save and restore all read it."""
    if mesh is not None and mesh.has(PIPELINE_AXIS):
        return pipeline_param_specs(cfg)
    if mesh is not None and (mesh.has(MODEL_AXIS) or mesh.has(EXPERT_AXIS)):
        return param_specs(cfg)
    return {k: ({kk: () for kk in v} if isinstance(v, dict) else ())
            for k, v in pipeline_param_specs(cfg).items()}


def _spec_map(fn, tree, specs):
    return {k: _spec_map(fn, v, specs[k]) if isinstance(v, dict)
            else fn(v, specs[k]) for k, v in tree.items()}


def shard_params(params: Params, cfg: TransformerConfig, mesh) -> Params:
    """This rank's slice of every leaf of a whole params (or Adam moment)
    tree under :func:`param_specs_for_mesh`."""
    sizes = {a: mesh.size(a) for a in mesh.axis_names}
    return _spec_map(lambda a, sp: ep.shard(a, sp, sizes, mesh.indices),
                     params, param_specs_for_mesh(cfg, mesh))


def gather_params(local: Params, cfg: TransformerConfig, mesh) -> Params:
    """The whole tree from every rank's :func:`shard_params` slices (an
    all-gather over each split dim's group; every rank must call)."""
    import torch.distributed as tdist

    def whole(a, spec):
        for dim, axis in enumerate(spec):
            g = mesh.group(axis) if axis is not None else None
            if group_size(g) == 1:
                continue
            parts = [torch.empty_like(a) for _ in range(group_size(g))]
            tdist.all_gather(parts, a.contiguous(), group=g)
            a = torch.cat(parts, dim=dim)
        return a

    return _spec_map(whole, local, param_specs_for_mesh(cfg, mesh))


def mesh_shards(mesh) -> Shards:
    """The :class:`Shards` of this rank on a ``data`` x ``model`` x
    ``expert`` mesh: the MoE routing spans ``'data'``."""
    data = mesh.group(DATA_AXIS)
    return Shards(
        model=mesh.group(MODEL_AXIS),
        experts=ep.ExpertGroups(expert=mesh.group(EXPERT_AXIS),
                                expert_index=mesh.index(EXPERT_AXIS),
                                model=mesh.group(MODEL_AXIS)),
        route=(None if group_size(data) == 1 else ep.RouteGroups(
            data=data, data_index=mesh.index(DATA_AXIS))))


def _data_rows(batch, mesh):
    """This rank's rows of ``batch`` [N, ...] (``P('data')``)."""
    if mesh is None:
        return batch
    d, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    n = batch.shape[0]
    if n % d:
        raise ValueError(f"batch {n} not divisible by the data axis {d}")
    return batch[i * (n // d):(i + 1) * (n // d)]


# ---------------------------------------------------------------------------
# sequence-parallel training
# ---------------------------------------------------------------------------


def _reject_lowprec(path: str) -> None:
    """bf16 loss scaling is refused on the sequence-parallel and pipelined
    steps, as the JAX package refuses it there."""
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
    d, s = mesh.size(DATA_AXIS), mesh.size(SEQUENCE_AXIS)
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
    None or a world of 1 passes them through). The collectives are the
    ``train.allreduce`` span, on the device too (``leaves``, ``bytes``)."""
    world = group_size(group)
    if world == 1:
        return loss, grads
    parts = [loss] + tree_leaves(grads)
    with obs_trace.span("train.allreduce", device=True) as sp:
        if sp is not obs_trace.NULL_SPAN:
            sp.set_attr("leaves", len(parts))
            sp.set_attr("bytes", sum(x.numel() * x.element_size()
                                     for x in parts))
        for x in parts:
            dist.all_reduce(x, group=group)
    return loss / world, tree_map(lambda g: g / world, grads)


def _build_ring_step(cfg: TransformerConfig, group, strategy: str):
    """The optimizer step of :func:`make_ring_train_step`; every
    sequence-parallel factory validates here."""
    refuse_extended(cfg, "the sequence-parallel step")
    if cfg.accum_steps != 1:
        raise ValueError("cfg.accum_steps must be 1 under sequence-parallel "
                         "training (shard 'data' for more batch instead)")
    _reject_lowprec("sequence-parallel")
    _validate_schedule(cfg)
    _validate_moe(cfg)
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    mesh = as_mesh(group)
    route = ep.RouteGroups(data=mesh.data, data_index=mesh.data_index,
                           seq=mesh.seq, seq_index=mesh.seq_index)

    def sp_loss(p, x, y):
        logits, aux = ring_forward(p, x, cfg, mesh.seq, strategy,
                                   return_aux=True, route=route)
        return nll_loss(logits, y) + cfg.moe_aux_coef * aux

    def step(params, opt, tokens, targets):
        x, y = ring_step_block(tokens, mesh), ring_step_block(targets, mesh)
        loss, grads = value_and_grad(lambda p: sp_loss(p, x, y), params)
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
    rank passes and every rank gets back, plus the MoE load-balance term
    over the whole batch), with attention sequence-parallel over the
    ``'seq'`` group (``strategy="ring"``: K5 each ring step forward, K7
    backward with the lse cotangent; ``"ulysses"``: all-to-alls around
    ``FlashFn``, K4 and K7) and, for a ``MeshGroups``, the batch split
    over ``'data'``. Params stay replicated, bit-equal on every rank.
    Refuses ``accum_steps != 1``, ``DL4J_TPU_BF16`` and a bad
    schedule."""
    return _build_ring_step(cfg, group, strategy)


def make_ring_train_multi_step(cfg: TransformerConfig, group=None, *,
                               strategy: str = "ring"):
    """K sequence-parallel steps over global batches stacked [K, N, T]:
    the same results as K calls of :func:`make_ring_train_step`'s step."""
    return _multi_from_step(_build_ring_step(cfg, group, strategy))


# ---------------------------------------------------------------------------
# pipeline-parallel forward and training (transformer.py:941-1130)
# ---------------------------------------------------------------------------


def _micro_rows(batch, n_micro: int, mesh):
    """[n_micro * mb, ...] -> this rank's rows of every microbatch
    [n_micro, mb / data, ...] (JAX's ``P(None, 'data')`` on the
    microbatch stack)."""
    b = batch.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    d = 1 if mesh is None else mesh.size(DATA_AXIS)
    if mb % d != 0:
        raise ValueError(
            f"microbatch width {mb} not divisible by data-axis size {d} "
            f"(global batch {b} / n_micro {n_micro})")
    xm = batch.reshape((n_micro, mb) + tuple(batch.shape[1:]))
    if d == 1:
        return xm
    i = mesh.index(DATA_AXIS)
    return xm[:, i * (mb // d):(i + 1) * (mb // d)]


def pipeline_forward(params: Params, tokens, cfg: TransformerConfig, mesh,
                     *, n_micro: int, return_aux: bool = False,
                     split_data: bool = True):
    """The forward with the layer stack split over the mesh's ``'pipe'``
    group (``transformer.py:941``, ``parallel/pipeline_parallel``'s GPipe
    schedule): ``params["blocks"]`` holds this stage's layers, the
    embedding and the tied head run on every rank. ``tokens`` is the
    GLOBAL batch; with ``split_data`` each rank takes its ``'data'`` rows
    of every microbatch (PP x DP). Returns this rank's logits [M * mb_l,
    T, V] f32 in microbatch order (and the grouped MoE aux: every group
    routes on its own, the mean over layers and groups)."""
    from deeplearning4j_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply_local,
    )

    refuse_extended(cfg, "pipeline_forward")
    s_count = mesh.size(PIPELINE_AXIS)
    if cfg.n_layers % s_count != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{s_count} stages")
    pipe = mesh.group(PIPELINE_AXIS)
    xm = _micro_rows(tokens, n_micro, mesh if split_data else None)
    m, mbl = xm.shape[:2]
    h = copy_to(_embed(params, xm.reshape((m * mbl,) + tuple(xm.shape[2:])),
                       cfg), pipe)
    attend = lambda q, k, v: _attention(q, k, v, cfg.n_heads,
                                        use_flash=cfg.use_flash)
    moe = bool(cfg.moe_experts)

    def stage_fn(sp, x):
        aux = None
        for bp in _layers(sp):
            if moe:
                x, a = _moe_block(bp, x, cfg, attend)
                aux = a if aux is None else aux + a
            else:
                x = _block(bp, x, cfg, attend)
        return x, aux

    out, aux = pipeline_apply_local(
        params["blocks"], h.reshape((m, mbl) + tuple(h.shape[1:])), pipe,
        stage_fn=stage_fn, stage=mesh.index(PIPELINE_AXIS),
        n_stages=s_count, with_aux=moe)
    h = out.reshape((m * mbl,) + tuple(out.shape[2:]))
    logits = _at_least_f32(_head(params, _final_ln(params, h)))
    if not return_aux:
        return logits
    if moe:
        aux = aux / (cfg.n_layers * n_micro)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


def _build_pipeline_step(cfg: TransformerConfig, mesh, n_micro: int):
    refuse_extended(cfg, "the pipeline step")
    _reject_lowprec("pipelined")
    _validate_schedule(cfg)
    _validate_moe(cfg)
    norm_of = sharded_global_norm(cfg, mesh)
    if cfg.accum_steps != 1:
        raise ValueError(
            "cfg.accum_steps must be 1 under pipelined training — n_micro "
            "IS the microbatch/accumulation count (the GPipe schedule)")
    if mesh.has(MODEL_AXIS) or mesh.has(EXPERT_AXIS) or mesh.has(
            SEQUENCE_AXIS):
        raise ValueError("the pipeline step's mesh is 'pipe' x 'data'")
    data = mesh.group(DATA_AXIS)

    def pp_loss(p, tokens, targets):
        logits, aux = pipeline_forward(p, tokens, cfg, mesh, n_micro=n_micro,
                                       return_aux=True)
        y = _micro_rows(targets, n_micro, mesh)
        return (nll_loss(logits, y.reshape((-1,) + tuple(y.shape[2:])))
                + cfg.moe_aux_coef * aux)

    def step(params, opt, tokens, targets):
        loss, grads = value_and_grad(lambda p: pp_loss(p, tokens, targets),
                                     params)
        loss, grads = _mean_over(data, loss, grads)
        lr = _scheduled_lr(cfg, opt["t"] + 1)
        params, opt = _adam_update(params, grads, opt, lr,
                                   weight_decay=cfg.weight_decay,
                                   clip_grad_norm=cfg.clip_grad_norm,
                                   norm_of=norm_of)
        return params, opt, loss

    step.loss_scaled = False
    return step


def make_pipeline_train_step(cfg: TransformerConfig, mesh, *, n_micro: int):
    """The pipelined training step (``transformer.py:1054``):
    ``step(params, opt, tokens, targets)`` on the GLOBAL batch and this
    rank's :func:`shard_params` (its stage's layers); GPipe forward, the
    backward pipeline from autograd (one ``ring_shift`` a tick, in
    reverse), Adam. The loss and gradients are averaged over ``'data'``
    (PP x DP). For dense configs the serial step; for MoE the grouped
    objective (group = microbatch x data slice), which is the serial one
    at ``n_micro = 1`` and the ``accum_steps = n_micro`` one otherwise."""
    return _build_pipeline_step(cfg, mesh, n_micro)


def make_pipeline_train_multi_step(cfg: TransformerConfig, mesh, *,
                                   n_micro: int):
    """K pipelined steps over global batches stacked [K, N, T]."""
    return _multi_from_step(_build_pipeline_step(cfg, mesh, n_micro))


# ---------------------------------------------------------------------------
# the model object
# ---------------------------------------------------------------------------


def _mode_of(group) -> str:
    """``dense`` (no group), ``pipe``, ``seq`` (a plain group too) or
    ``megatron``: the JAX package's dispatch order (:1188-1207)."""
    if group is None:
        return "dense"
    if not isinstance(group, MeshGroups):
        return "seq"
    if group.has(PIPELINE_AXIS):
        return "pipe"
    if group.has(SEQUENCE_AXIS):
        return "seq"
    return "megatron"


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

    With ``group`` it trains across ranks; every rank builds the same
    model and passes the same GLOBAL batch to :meth:`fit` and
    :meth:`fit_batches`, and only the mesh's rank 0 writes in
    :meth:`save`. The mode follows the group, in the JAX package's order
    (``_make_step`` :1201): a ``MeshGroups`` with ``'pipe'`` is the
    pipeline mode (:func:`make_pipeline_train_step`,
    ``cfg.pipeline_microbatches`` microbatches, PP x DP with
    ``'data'``); one with ``'seq'``, or a plain process group, the
    sequence mode (:func:`make_ring_train_step`); any other mesh
    (``'data'``, ``'model'``, ``'expert'``) the Megatron mode
    (:func:`make_train_step` with the mesh). In the pipeline and
    Megatron modes ``params`` holds this rank's shards
    (:func:`shard_params`: a whole tree passed in is sharded here, unless
    ``sharded``); attention stays on ``FlashFn`` on each rank's heads."""

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 params: Optional[Params] = None,
                 opt: Optional[Params] = None, group=None,
                 sharded: bool = False) -> None:
        _validate_moe(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.group = group
        self.mode = _mode_of(group)
        if params is None:
            params = init_params(cfg, device=self.device)
            sharded = False
        if self.mode in ("pipe", "megatron") and not sharded:
            params = shard_params(params, cfg, group)
            if opt is not None:
                opt = dict(opt, m=shard_params(opt["m"], cfg, group),
                           v=shard_params(opt["v"], cfg, group))
        self.params = params
        self._opt = opt
        self.iteration = 0 if opt is None else int(opt["t"])
        if self.mode == "pipe":
            self._step = make_pipeline_train_step(
                cfg, group, n_micro=cfg.pipeline_microbatches)
        elif self.mode == "seq":
            self._step = make_ring_train_step(cfg, group)
        else:
            self._step = make_train_step(
                cfg, group if self.mode == "megatron" else None)
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

    def _world(self):
        return as_mesh(self.group).world

    def _infer(self, params: Params, tokens) -> torch.Tensor:
        """Logits of a whole batch on every rank, in any mode: the
        Megatron mode's shards summed over their groups, the pipeline as
        one microbatch."""
        if self.mode == "megatron":
            sh = mesh_shards(self.group)
            return forward(params, tokens, self.cfg,
                           Shards(model=sh.model, experts=sh.experts))[0]
        if self.mode == "pipe":
            return pipeline_forward(params, tokens, self.cfg, self.group,
                                    n_micro=1, split_data=False)
        return forward(params, tokens, self.cfg)[0]

    @classmethod
    def from_state(cls, cfg: TransformerConfig, params: Params,
                   opt: Optional[Params] = None, *,
                   device=None, group=None,
                   sharded: bool = False) -> "TransformerLM":
        """An LM around existing state, with no random init; the
        iteration is ``opt["t"]``. ``sharded``: the state is already this
        rank's shards (the sharded checkpoint's restore)."""
        return cls(cfg, device=device, params=params, opt=opt, group=group,
                   sharded=sharded)

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
            opt = _tree_like(init_opt_state(params, lm._step.loss_scaled),
                             npz_bytes_to_tree(upd), params["embed"].device)
            if lm.mode in ("pipe", "megatron"):
                opt = dict(opt, m=shard_params(opt["m"], cfg, group),
                           v=shard_params(opt["v"], cfg, group))
            lm.opt = opt
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

        params, opt = self.params, self.opt
        if self.mode in ("pipe", "megatron"):  # every rank gathers
            params = gather_params(params, self.cfg, self.group)
            opt = dict(opt, m=gather_params(opt["m"], self.cfg, self.group),
                       v=gather_params(opt["v"], self.cfg, self.group))
        if self.group is not None and dist.get_rank(self._world()) != 0:
            return
        write_flagship_zip(path, "TransformerLM", self.cfg, params, opt)

    # -- training -----------------------------------------------------------
    def fit(self, tokens, targets) -> torch.Tensor:
        """One optimizer step on tokens/targets [N, T]; the loss (a 0-d
        device tensor: reading it waits for the card). In the sequence
        mode the global batch: this rank trains on its block, and the
        loss is the global batch's. The ``train.step`` span, on the
        device too."""
        with obs_trace.span("train.step", device=True, steps=1) as sp:
            with obs_trace.span("train.prepare"):
                tokens, targets = self._tokens(tokens), self._tokens(targets)
            sp.set_attr("rows", int(tokens.shape[0]))
            sp.set_attr("tokens", int(tokens.numel()))
            params, opt, loss = self._step(self.params, self.opt, tokens,
                                           targets)
            self._set_state(params, opt)
            self.iteration += 1
        return loss

    def fit_batches(self, tokens_k, targets_k) -> torch.Tensor:
        """K optimizer steps on tokens/targets stacked [K, N, T]; the K
        losses. The same as K :meth:`fit` calls, under one ``train.step``
        span of ``steps`` K."""
        with obs_trace.span("train.step", device=True) as sp:
            with obs_trace.span("train.prepare"):
                tokens_k = self._tokens(tokens_k)
                targets_k = self._tokens(targets_k)
            k = int(tokens_k.shape[0])
            sp.set_attr("steps", k)
            sp.set_attr("rows", k * int(tokens_k.shape[1]))
            sp.set_attr("tokens", int(tokens_k.numel()))
            params, opt, losses = self._multi_step(self.params, self.opt,
                                                   tokens_k, targets_k)
            self._set_state(params, opt)
            self.iteration += k
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
                losses.append(nll_loss(self._infer(self.compute_params, x),
                                       y, m_arr))
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
            return self._infer(self.compute_params, self._tokens(tokens))

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

    def _sample_fn(self, params, buf, pos0: int, n_new: int, gen,
                   temperature, top_k, top_p):
        """The full-forward sampler: each token from a forward over the
        whole right-padded window (causal masking hides the padding)."""
        out = []
        for i in range(n_new):
            logits, _ = forward(params, buf, self.cfg)
            pos = pos0 + i  # next write index; condition on pos - 1
            tempered = logits[:, pos - 1] / max(float(temperature), 1e-6)
            nxt = _categorical(self._filter_logits(tempered, top_k, top_p),
                               gen)
            buf[:, pos] = nxt
            out.append(nxt)
        return torch.stack(out, dim=1)

    def _sample_kv_fn(self, params, buf, pos0: int, n_new: int, gen,
                      temperature, top_k, top_p):
        """The KV-cache sampler: prefill the window once, then one
        :func:`decode_step` per token (O(max_len) each)."""
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
        default for dense models with no group): prefill +
        :func:`decode_step`; otherwise a full forward per token. The
        uniforms come from a ``torch.Generator`` seeded with ``seed`` on
        the model's device. In the Megatron and pipeline modes every rank
        must call: each gathers the whole tree (:func:`gather_params`) and
        samples from it as one device would, so every rank returns the
        same tokens."""
        cfg = self.cfg
        refuse_extended(cfg, "generate")
        if n_new >= cfg.max_len:
            raise ValueError(f"n_new {n_new} must be < max_len {cfg.max_len}")
        if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k {top_k} must be in [1, vocab_size]")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p {top_p} must be in (0, 1]")
        if use_cache is None:  # the full-forward sampler on a group
            use_cache = self.group is None and not cfg.moe_experts
        params = self.compute_params
        if self.mode in ("pipe", "megatron"):  # every rank gathers
            params = compute_params(
                gather_params(self.params, cfg, self.group), cfg)
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
            return fn(params, buf, keep, int(n_new), gen, temperature, top_k,
                      top_p)
