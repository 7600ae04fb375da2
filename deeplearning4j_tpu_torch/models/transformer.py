"""Transformer language model, inference side (counterpart:
``deeplearning4j_tpu/models/transformer.py``).

Ported: ``TransformerConfig`` (same fields and defaults), ``init_params``
(same distributions, a ``torch.Generator`` in place of ``jax.random``),
``_ln``, ``_attention``, ``forward``, ``prefill_cache`` (:756) and
``TransformerLM`` (``load`` of a JAX zip, ``.params``, ``.cfg``), plus
:func:`params_from_numpy` for a JAX parameter tree handed over as numpy.
Training, Adam, accumulation, remat, ring/pipeline modes, MoE and
``lm.generate`` wait for later slices; an MoE config raises.

Parameters are a dict in the JAX layout: ``embed`` [V, d], ``pos``
[max_len, d], ``lnf_g``/``lnf_b`` [d], and ``blocks`` whose leaves are
stacked per layer as [L, ...]. Under ``dtype_policy="performance"`` the
JAX package casts each f32 weight to bf16 at each use; the port keeps one
compute-dtype copy of the block weights, made once
(:func:`compute_params`) — the cast gives the same values. ``embed``,
``pos`` and the final LN stay f32: the tied head is ``h.float() @
embed.T`` after an f32 final LN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention

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
    # flash attention in prefill: the hand-written kernel on the card,
    # its plain version on the CPU; False keeps the dense masked softmax
    # of the JAX package's _attention
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
    """q, k, v [N, T, d] -> [N, T, d], causal. ``use_flash``: the flash
    wrapper (the kernel on the card, its plain version on the CPU);
    otherwise the JAX package's dense masked softmax."""
    n, t, d = q.shape
    hd = d // n_heads
    q = q.reshape(n, t, n_heads, hd)
    k = k.reshape(n, t, n_heads, hd)
    v = v.reshape(n, t, n_heads, hd)
    if use_flash:
        return flash_attention(q, k, v, causal=True)[0].reshape(n, t, d)
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -1e9)
    p = torch.softmax(s.to(softmax_dtype(s.dtype)), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p, v).reshape(n, t, d)


def _layer(blocks: Params, layer: int) -> Params:
    return {k: v[layer] for k, v in blocks.items()}


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


def _embed(params: Params, tokens, cfg: TransformerConfig):
    t = tokens.shape[1]
    h = params["embed"][tokens.long()] + params["pos"][:t][None]
    return h.to(cfg.compute_dtype)


def forward(params: Params, tokens, cfg: TransformerConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [N, T] int -> (logits [N, T, V] f32, aux_loss 0): the JAX
    ``forward`` for dense models (aux is the MoE load-balance loss)."""
    check_dense(cfg)
    h = _embed(params, tokens, cfg)
    attend = lambda q, k, v: _attention(q, k, v, cfg.n_heads,
                                        use_flash=cfg.use_flash)
    for layer in range(cfg.n_layers):
        h = _block(_layer(params["blocks"], layer), h, cfg, attend)
    h = _ln(h.float(), params["lnf_g"], params["lnf_b"])
    logits = h @ params["embed"].T  # tied head
    return logits.float(), torch.zeros((), dtype=torch.float32,
                                       device=logits.device)


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
    h = _ln(h.float(), params["lnf_g"], params["lnf_b"])
    return {"k": ks, "v": vs}, h


# ---------------------------------------------------------------------------
# the model object
# ---------------------------------------------------------------------------


class TransformerLM:
    """The flagship LM's inference surface: ``cfg``, the f32 master
    ``params``, and ``compute_params`` (one compute-dtype copy of the
    block weights). Lives on ``device`` — the card unless the caller
    passes ``device="cpu"``."""

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 params: Optional[Params] = None) -> None:
        check_dense(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = (params if params is not None
                       else init_params(cfg, device=self.device))
        self.compute_params = compute_params(self.params, cfg)

    @classmethod
    def load(cls, path: str, *, device=None) -> "TransformerLM":
        """Read a zip written by the JAX package's ``TransformerLM.save``
        (``transformer.py:1347``) through the port's own zip and npz
        reader. The updater section is not read: the port serves."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_flagship_zip,
        )

        cfg_dict, coeff, _upd, _meta = read_flagship_zip(path,
                                                         "TransformerLM")
        cfg = TransformerConfig(**cfg_dict)
        params = params_from_numpy(npz_bytes_to_tree(coeff), device=device)
        return cls(cfg, device=device, params=params)

    def logits(self, tokens) -> torch.Tensor:
        """tokens [N, T] -> logits [N, T, V] f32."""
        with torch.inference_mode():
            tokens = torch.as_tensor(tokens, device=self.device)
            return forward(self.compute_params, tokens, self.cfg)[0]
