"""The low-precision plane: bf16 loss-scaled training and the serving
helpers (counterpart: ``deeplearning4j_tpu/ops/lowprec.py`` :57-205 —
``train_policy``, ``loss_scale_config``, ``init_scale_state``,
``cast_array``, ``cast_tree``, ``finite_tree``, ``unscale``,
``select_trees``, ``advance_scale``, ``scale_snapshot``,
``scale_from_snapshot``, ``OPT_SCALE_KEYS``, ``opt_scale_entries``,
``opt_scale_state`` and ``opt_with_scale``; and ``quantize_weight``
:238, ``spec_mode`` :384, ``_DRAFT_WEIGHT_KEYS`` and
``_fake_quant_matrix`` :396-408, ``draft_lm`` :411, ``kv_dtype`` :472,
``precision_of`` :484).

Mixed precision with master weights and dynamic loss scaling
(Micikevicius et al., ICLR 2018): f32 master params and optimizer state
stay the source of truth; the step casts the params to bf16, computes the
loss scaled by a power of two, unscales the f32 gradients and skips the
update (halving the scale) when any gradient is not finite. The scale
doubles after ``growth_interval`` clean steps. The state is three 0-d
device tensors, so the step never reads it back to the host.

Serving: the paged arena's dtype (``DL4J_TPU_SERVE_KV_DTYPE``) and the
self-drafts of speculative decoding (``DL4J_TPU_SERVE_SPEC``), derived
from the target's own weights. The int8 ``/predict`` wrapper
(``QuantizedNet``, ``int8_dense``) waits for a later slice.

Trees are nests of dicts (and lists) of tensors.

Knobs (``ops/env.py``): ``DL4J_TPU_BF16``, ``DL4J_TPU_LOSS_SCALE``,
``DL4J_TPU_SERVE_KV_DTYPE``, ``DL4J_TPU_SERVE_SPEC``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import env

_DEFAULT_SCALE = 32768.0  # 2^15, the Micikevicius et al. starting point
_DEFAULT_GROWTH = 2000    # clean steps before the scale doubles

OPT_SCALE_KEYS = ("loss_scale", "ls_good", "ls_skipped")


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure nests of dicts, lists and
    tuples."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a nest of dicts, lists and tuples, in insertion
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def train_policy() -> bool:
    """True when bf16 loss-scaled training is on (``DL4J_TPU_BF16``),
    read when a step is built."""
    return env.get_bool("DL4J_TPU_BF16")


def loss_scale_config() -> Tuple[float, int]:
    """(initial_scale, growth_interval) from ``DL4J_TPU_LOSS_SCALE``:
    'init' or 'init:growth_interval'; garbage falls back to the defaults."""
    spec = env.raw("DL4J_TPU_LOSS_SCALE")
    init, growth = _DEFAULT_SCALE, _DEFAULT_GROWTH
    if spec:
        head, _, tail = spec.partition(":")
        try:
            init = float(head)
        except ValueError:
            init = _DEFAULT_SCALE
        if tail:
            try:
                growth = int(tail)
            except ValueError:
                growth = _DEFAULT_GROWTH
    return max(init, 1.0), max(growth, 1)


def init_scale_state(device=None) -> dict:
    """A fresh loss-scale state on ``device``: the scale (f32) and the
    clean-step and skip counters (int32)."""
    init, _ = loss_scale_config()
    return {
        "scale": torch.tensor(init, dtype=torch.float32, device=device),
        "good": torch.zeros((), dtype=torch.int32, device=device),
        "skipped": torch.zeros((), dtype=torch.int32, device=device),
    }


def cast_array(x):
    """bf16 for a floating tensor; anything else (token ids) passes."""
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16)
    return x


def cast_tree(tree, dtype=torch.bfloat16):
    """Every floating leaf cast to ``dtype`` (the master-weight boundary:
    gradients flow back in f32 through the cast)."""
    return tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def finite_tree(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf all finite."""
    ok = None
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point():
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else ok & f
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def unscale(grads, scale):
    """grads / scale in f32 (exact for the power-of-two scales)."""
    inv = (1.0 / scale).to(torch.float32)
    return tree_map(lambda g: g.to(torch.float32) * inv, grads)


def select_trees(pred, new, old):
    """``new`` where ``pred`` (the gradients were finite), else ``old``:
    a skipped step never lets a NaN reach the masters."""
    return tree_map(lambda n, o: torch.where(pred, n.to(o.dtype), o),
                    new, old)


def advance_scale(ls: dict, finite) -> dict:
    """One transition: a clean step bumps the good counter (doubling the
    scale every ``growth_interval``); a non-finite step halves the scale
    (floor 1) and bumps the skip counter."""
    _, growth = loss_scale_config()
    good = torch.where(finite, ls["good"] + 1, torch.zeros_like(ls["good"]))
    grow = good >= growth
    scale = torch.where(
        finite, torch.where(grow, ls["scale"] * 2.0, ls["scale"]),
        torch.clamp(ls["scale"] * 0.5, min=1.0))
    return {
        "scale": scale.to(torch.float32),
        "good": torch.where(grow, torch.zeros_like(good), good).to(
            torch.int32),
        "skipped": (ls["skipped"] + (~finite).to(torch.int32)).to(
            torch.int32),
    }


def scale_snapshot(ls: Optional[dict]) -> Optional[dict]:
    """A JSON-able host view (one readback: a sync point)."""
    if ls is None:
        return None
    return {"scale": float(ls["scale"]), "good": int(ls["good"]),
            "skipped": int(ls["skipped"])}


def scale_from_snapshot(st: dict, device=None) -> dict:
    return {
        "scale": torch.tensor(float(st["scale"]), dtype=torch.float32,
                              device=device),
        "good": torch.tensor(int(st["good"]), dtype=torch.int32,
                             device=device),
        "skipped": torch.tensor(int(st["skipped"]), dtype=torch.int32,
                                device=device),
    }


# -- the flagship rides the loss-scale state inside its opt dict ----------


def opt_scale_entries(device=None) -> dict:
    ls = init_scale_state(device)
    return {"loss_scale": ls["scale"], "ls_good": ls["good"],
            "ls_skipped": ls["skipped"]}


def opt_scale_state(opt: dict) -> dict:
    return {"scale": opt["loss_scale"], "good": opt["ls_good"],
            "skipped": opt["ls_skipped"]}


def opt_with_scale(opt: dict, ls: dict) -> dict:
    out = dict(opt)
    out.update({"loss_scale": ls["scale"], "ls_good": ls["good"],
                "ls_skipped": ls["skipped"]})
    return out


# ---------------------------------------------------------------------------
# serving: int8 weights, self-drafts, the arena dtype
# ---------------------------------------------------------------------------


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of an [in, out]
    matrix (or a stack [..., in, out]): scale[j] = max|W[:, j]| / 127,
    W_q = round(W / scale), rounded half to even as the JAX package
    rounds, so the int8 values are bit-equal to its."""
    w = w.float()
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.squeeze(-2)


def spec_mode() -> str:
    """The draft of self-speculative decoding (``DL4J_TPU_SERVE_SPEC``):
    '' off, 'int8' the weight-quantized self-draft, 'layers' /
    'layers:m' the truncated-layer self-draft."""
    v = (env.raw("DL4J_TPU_SERVE_SPEC") or "").strip().lower()
    if v in ("", "0", "off", "false", "no"):
        return ""
    if v in ("1", "on", "true", "yes"):
        return "int8"  # a bare enable is the default self-draft
    return v


# the block matrices the int8 self-draft fake-quantizes; LN gains and
# biases and the embedding (also the tied head) stay as they are
_DRAFT_WEIGHT_KEYS = ("Wq", "Wk", "Wv", "Wo", "W1", "W2")


def _fake_quant_matrix(w):
    """Quantize then dequantize [..., in, out]: int8-rounded values in
    w's dtype, so the draft runs the target's own programs."""
    wq, scale = quantize_weight(w)
    return (wq.float() * scale.unsqueeze(-2)).to(w.dtype)


def draft_lm(lm, mode: str = "int8", *, device=None):
    """The self-draft a ``SpeculativeDecoder`` proposes with, made from
    the target's own weights on ``device`` (the card unless the caller
    passes ``device="cpu"``), which must be the target's:

    * ``int8``: every block matrix fake-quantized per output channel
      (:func:`quantize_weight`), the same depth and programs;
    * ``layers`` / ``layers:m``: the first m blocks (default half, at
      least 1) under the target's final LN and tied head.

    The draft shares the target's embedding, LN and (``layers``) block
    tensors read-only and carries no optimizer state."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.ops.device import resolve_device

    dev = resolve_device(device)
    if dev != lm.device:
        raise ValueError(f"the target lives on {lm.device}, the draft was "
                         f"asked for on {dev}")
    cfg = lm.cfg
    mode = (mode or "int8").strip().lower()
    params = dict(lm.params)
    if mode == "int8":
        blocks = dict(lm.params["blocks"])
        for k in _DRAFT_WEIGHT_KEYS:
            blocks[k] = _fake_quant_matrix(blocks[k])
        params["blocks"] = blocks
        dcfg = cfg
        draft = TransformerLM.from_state(dcfg, params, device=dev)
    elif mode.startswith("layers"):
        _, _, tail = mode.partition(":")
        m = int(tail) if tail else max(1, cfg.n_layers // 2)
        if not 1 <= m <= cfg.n_layers:
            raise ValueError(
                f"draft depth {m} out of range [1, {cfg.n_layers}]")
        params["blocks"] = {k: v[:m] for k, v in lm.params["blocks"].items()}
        dcfg = dataclasses.replace(cfg, n_layers=m)
        draft = TransformerLM.from_state(dcfg, params, device=dev)
        # the target's compute copy, sliced: no second bf16 copy
        target = lm.compute_params
        draft._compute = dict(target)
        draft._compute["blocks"] = {k: v[:m] for k, v in
                                    target["blocks"].items()}
    else:
        raise ValueError(
            f"unknown draft mode {mode!r} (want 'int8' or 'layers[:m]')")
    draft.draft_mode = mode
    return draft


def kv_dtype(cfg) -> torch.dtype:
    """The paged arena's dtype: ``DL4J_TPU_SERVE_KV_DTYPE`` bf16 or f32,
    else the model's compute dtype. bf16 halves a block's bytes, so the
    same budget holds ~2x the tokens."""
    v = (env.raw("DL4J_TPU_SERVE_KV_DTYPE") or "").strip().lower()
    if v == "bf16":
        return torch.bfloat16
    if v == "f32":
        return torch.float32
    return getattr(cfg, "compute_dtype", torch.float32)


def precision_of(model) -> str:
    """Serving precision label for ``/models``: 'int8' for an int8
    model, 'bf16' when the model computes in bf16, else 'f32'."""
    if getattr(model, "precision", None) == "int8":
        return "int8"
    cd = getattr(getattr(model, "cfg", None), "compute_dtype", None)
    return "bf16" if cd == torch.bfloat16 else "f32"
