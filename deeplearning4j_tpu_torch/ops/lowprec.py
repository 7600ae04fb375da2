"""The low-precision plane: bf16 loss-scaled training and the serving
helpers (counterpart: ``deeplearning4j_tpu/ops/lowprec.py`` :57-205 —
``train_policy``, ``loss_scale_config``, ``init_scale_state``,
``cast_array``, ``cast_tree``, ``finite_tree``, ``unscale``,
``select_trees``, ``advance_scale``, ``scale_snapshot``,
``scale_from_snapshot``, ``OPT_SCALE_KEYS``, ``opt_scale_entries``,
``opt_scale_state`` and ``opt_with_scale``; the int8 ``/predict`` path
:217-376 — ``QuantGateError``, ``quant_mode``, ``quant_max_delta``,
``quantize_weight``, ``int8_dense`` and ``QuantizedNet``; and
``spec_mode`` :384, ``_DRAFT_WEIGHT_KEYS`` and
``_fake_quant_matrix`` :396-408, ``draft_lm`` :411, ``kv_dtype`` :472,
``precision_of`` :484).

Mixed precision with master weights and dynamic loss scaling
(Micikevicius et al., ICLR 2018): f32 master params and optimizer state
stay the source of truth; the step casts the params to bf16, computes the
loss scaled by a power of two, unscales the f32 gradients and skips the
update (halving the scale) when any gradient is not finite. The scale
doubles after ``growth_interval`` clean steps. The state is three 0-d
device tensors, so the step never reads it back to the host.

Serving: calibrated int8 inference (Jacob et al., CVPR 2018):
per-output-channel weight scales from max|W|, per-tensor activation
scales from a calibration pass (``etl/calibrate.QuantCalibrator``), an
int8 x int8 product accumulated in int32 and dequantized to f32 for the
bias and the activation. :class:`QuantizedNet` routes a
MultiLayerNetwork's dense-family layers through :func:`int8_dense` and
runs every other layer (the char-RNN's GravesLSTMs: K1 on the card) in
f32. The JAX package computes the product with XLA's ``dot_general``
outside any Pallas kernel, so the port uses PyTorch's int8 GEMM,
``torch._int_mm``, on the card. Also the paged arena's dtype
(``DL4J_TPU_SERVE_KV_DTYPE``) and the self-drafts of speculative decoding
(``DL4J_TPU_SERVE_SPEC``), derived from the target's own weights.

Trees are nests of dicts (and lists) of tensors.

Knobs (``ops/env.py``): ``DL4J_TPU_BF16``, ``DL4J_TPU_LOSS_SCALE``,
``DL4J_TPU_QUANT``, ``DL4J_TPU_QUANT_MAX_DELTA``,
``DL4J_TPU_SERVE_KV_DTYPE``, ``DL4J_TPU_SERVE_SPEC``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


class QuantGateError(RuntimeError):
    """The measured int8 accuracy delta exceeded
    ``DL4J_TPU_QUANT_MAX_DELTA``: raised inside ``ModelRegistry.load``, so
    the record lands broken and the serving default never moves."""


def quant_mode() -> str:
    """'off' | 'auto' | 'force' from ``DL4J_TPU_QUANT`` ('' = auto:
    quantize when the zip carries quant.json and the gate passes)."""
    v = (env.raw("DL4J_TPU_QUANT") or "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v == "force":
        return "force"
    return "auto"


def quant_max_delta() -> float:
    return float(env.get_float("DL4J_TPU_QUANT_MAX_DELTA") or 0.05)


# torch._int_mm's shape rules on CUDA (aten _int_mm_out_cuda): more than
# 16 rows, K and N positive multiples of 8, int8 operands, an int32
# result. The H100 machine's build (torch 2.11.0+cu128) agrees, as
# chip_smoke.py's serving planes probe shows: M = 16, K = 10 and N = 10
# are refused, M = 17 and the padded shapes run. int8_matmul pads M, K
# and N with zero rows and columns, which add nothing to an integer sum,
# and slices the answer.
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _ceil(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exactly (int64 sums:
    K x 127^2 stays far below 2^31 for every layer width)."""
    int8_matmul_plain.launches += 1
    return (xq.to(torch.int64) @ wq.to(torch.int64)).to(torch.int32)


int8_matmul_plain.launches = 0


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """CPU tensors: :func:`int8_matmul_plain`. CUDA tensors: PyTorch's
    int8 GEMM (``torch._int_mm``, int32 accumulation) on the operands
    zero-padded to its shape rules, or an exception: a shape it refuses
    raises, nothing moves to a float product."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {xq.device}")
    m, k = xq.shape
    n = wq.shape[1]
    mp = max(_ceil(m, _INT_MM_ALIGN), _ceil(_INT_MM_MIN_ROWS, _INT_MM_ALIGN))
    kp, np_ = _ceil(k, _INT_MM_ALIGN), _ceil(n, _INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        padded = xq.new_zeros((mp, kp))
        padded[:m, :k] = xq
        xq = padded
    if (kp, np_) != (k, n):
        padded = wq.new_zeros((kp, np_))
        padded[:k, :n] = wq
        wq = padded
    acc = torch._int_mm(xq.contiguous(), wq.contiguous())
    int8_matmul.launches += 1
    return acc[:m, :n]


int8_matmul.launches = 0


def int8_quantize_rows(x: torch.Tensor, x_scale) -> torch.Tensor:
    """[..., in] f32 -> [rows, in] int8 codes: x / x_scale in f32, rounded
    half to even, clipped to +-127 (the JAX package's order)."""
    x2 = x.reshape((-1, x.shape[-1])).to(torch.float32)
    return torch.clamp(torch.round(x2 / x_scale), -127, 127).to(torch.int8)


def int8_dense(x, wq, w_scale, x_scale, b=None):
    """Quantized dense: the int8 codes of ``x`` times ``wq`` with int32
    accumulation, dequantized to f32 by ``x_scale * w_scale``, the bias
    added in f32. Takes [..., in] (the RnnOutput head's [N, T, in]
    reshapes through the same product)."""
    lead = tuple(x.shape[:-1])
    xq = int8_quantize_rows(x, x_scale)
    acc = int8_matmul(xq, wq)
    y = acc.to(torch.float32) * (x_scale * w_scale)
    if b is not None:
        y = y + b
    return y.reshape(lead + (y.shape[-1],))


def _supported_dense(layer) -> bool:
    """Dense-family layers the int8 path covers: Dense and the Output and
    RnnOutput heads (x @ W + b, then an elementwise activation). Every
    other layer runs its f32 apply."""
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayerImpl,
    )

    return type(layer).__name__ in (
        "DenseLayerImpl", "OutputLayerImpl", "RnnOutputLayerImpl",
    ) and isinstance(layer, DenseLayerImpl)


class QuantizedNet:
    """int8 inference wrapper of a MultiLayerNetwork: the net's inference
    forward (preprocessors included) with every supported dense-family
    layer through :func:`int8_dense` at its calibrated activation scale
    and every other layer through its f32 apply. It offers the serving
    surface (``output``, ``params``, ``states``, ``layers``,
    ``device``), so the registry, warm-up and batcher treat it as the
    net it wraps."""

    precision = "int8"

    def __init__(self, net, spec):
        self.base = net
        self.spec = spec
        self.device = net.device
        self.layers = net.layers
        scales = list(spec.act_scales)
        if len(scales) < len(net.layers):
            scales += [None] * (len(net.layers) - len(scales))
        quant: List[Optional[dict]] = []
        for i, layer in enumerate(net.layers):
            sc = scales[i]
            p = net.params[i] if net.params is not None else None
            if (sc is None or not sc or p is None or "W" not in p
                    or not _supported_dense(layer)):
                quant.append(None)
                continue
            wq, w_scale = quantize_weight(p["W"])
            quant.append({
                "wq": wq, "w_scale": w_scale,
                "x_scale": torch.tensor(float(sc), dtype=torch.float32,
                                        device=self.device),
                "b": p["b"].float() if "b" in p else None,
            })
        # every tensor this wrapper reaches, so an unload drops them all
        self.params = {"base": net.params, "quant": quant}
        self.states = net.states
        # its ledgers join the metrics registry (JAX ops/lowprec.py
        # :327-329); it has none of its own yet
        from deeplearning4j_tpu_torch.obs.registry import register_net

        register_net(self)

    @property
    def _input_shape(self):
        return self.base._input_shape

    def quantized_layers(self) -> List[int]:
        return [i for i, q in enumerate(self.params["quant"])
                if q is not None]

    def _forward_quant(self, base_params, quant, states, x):
        net = self.base
        batch_n = x.shape[0]
        for i, layer in enumerate(net.layers):
            x = net._apply_preprocessor(i, x, batch_n)
            q = quant[i]
            if q is None:
                x, _ = layer.apply(base_params[i], states[i], x,
                                   train=False)
            else:
                z = int8_dense(x, q["wq"], q["w_scale"], q["x_scale"],
                               q["b"])
                x = layer.act(z)
        return x

    def output(self, x) -> torch.Tensor:
        """Quantized batch inference with the net's bucket padding: a
        ragged batch is zero-padded to its bucket and the answer sliced
        back (every layer is row-independent)."""
        from deeplearning4j_tpu_torch.ops import dispatch

        with torch.inference_mode():
            x = self.base._as_input(x)
            n = x.shape[0]
            target = dispatch.inference_bucket(n)
            if target is not None:
                x = dispatch.pad_axis0(x, target)
            return self._forward_quant(self.params["base"],
                                       self.params["quant"], self.states,
                                       x)[:n]


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
