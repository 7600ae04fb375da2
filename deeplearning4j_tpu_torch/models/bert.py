"""BERT-style bidirectional encoder with masked-LM pretraining and
sequence-classification fine-tuning (counterpart:
``deeplearning4j_tpu/models/bert.py``).

Ported: ``BertConfig`` (:44, same fields and defaults, the ``mask_id``
warning), ``init_params`` (:89, the same distributions drawn from a
``torch.Generator`` seeded with ``cfg.seed``; the bits differ from
``jax.random``), ``_bi_attention`` (:115), ``encode`` (:136),
``mlm_logits`` (:163), ``mlm_loss`` (:168), ``mask_tokens`` (:183, numpy:
the same draws from the same ``np.random.Generator``), ``_build_mlm_step``
(:214, with the bf16 loss-scaled branch of ``ops/lowprec.py``),
``make_train_step`` (:255), ``make_train_multi_step`` (:263),
``init_classifier_head`` (:276), ``classify_logits`` (:289),
``make_finetune_step`` (:304), ``BertClassifier`` (:367) and ``BertMLM``
(:433: ``fit``, ``fit_batches``, ``masked_accuracy``, ``predict_logits``,
``save``/``load``, ``embed_tokens``), plus :func:`params_from_numpy` for a
JAX parameter tree handed over as numpy. Zips are the JAX package's
flagship layout (``utils/serialization.write_flagship_zip``, model classes
``"BertMLM"`` and ``"BertClassifier"``): each package reads the other's.
Not ported: ``measure_memory`` (an XLA AOT ledger;
``torch.cuda.max_memory_allocated`` stands in on the card).

The encoder is the TransformerLM's pre-LN block attending in both
directions with a key-padding mask, in the params' dtype (f32; bf16 under
``DL4J_TPU_BF16``; f64 in the gradient checks). Its attention goes through
``ops/flash_attention.attention_auto`` with the key mask: K5 at offset T
forward and K7 backward on the card, their plain versions on the CPU. The
JAX package fills masked scores with -1e9, so a query of an all-pad
sequence attends uniformly to every position and gets the mean of V; K5
gives 0 there, and :func:`_bi_attention` puts the mean of V back on those
rows (its gradient reaches V as JAX's does; q and k get none, as in JAX).
Elsewhere -1e9 and K5's -inf give the same softmax.

Steps are plain functions over the params dict returning ``(params, opt,
loss)`` with the TransformerLM's Adam (``models/transformer.py``); the
multi step is a loop over K. Every entry point runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.transformer import (
    Params,
    _adam_update,
    _ln,
    _multi_from_step,
    _scheduled_lr,
    _tree_like,
    _validate_schedule,
    init_opt_state,
    params_from_numpy,  # noqa: F401 (the same tree layout as the LM's)
    value_and_grad,
)
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.dtypes import softmax_dtype
from deeplearning4j_tpu_torch.ops.f32_gemm import tied_head
from deeplearning4j_tpu_torch.ops.flash_attention import (
    attention_auto,
    key_keep,
)
from deeplearning4j_tpu_torch.ops.lowprec import tree_map
from deeplearning4j_tpu_torch.ops.remat import remat_wrap

@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 1000
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_len: int = 64
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    clip_grad_norm: float = 0.0
    warmup_steps: int = 0
    lr_schedule: str = "none"
    total_steps: int = 0
    mlm_prob: float = 0.15
    pad_token_id: int = 0
    # [MASK]; None claims the top id, vocab_size - 1, with a warning
    mask_token_id: Optional[int] = None
    seed: int = 0
    # the remat ladder of ops/remat.py for each encoder block ("auto"
    # defers to DL4J_TPU_REMAT)
    remat: str = "auto"

    @property
    def mask_id(self) -> int:
        if self.mask_token_id is None:
            warnings.warn(
                "BertConfig.mask_token_id not set: defaulting [MASK] to "
                f"vocab_size-1 = {self.vocab_size - 1}. Make sure the "
                "vocab reserves that slot (examples/bert_mlm.py does), "
                "or pass the real mask id.", stacklevel=2)
            return self.vocab_size - 1
        return self.mask_token_id


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: BertConfig, *, device=None) -> Params:
    """Random f32 params with the JAX package's distributions: N(0, 0.02)
    embeddings and weight matrices, unit LN scales, zero biases; block
    leaves stacked [L, ...]. Drawn from a ``torch.Generator`` seeded with
    ``cfg.seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def nrm(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "embed": nrm((cfg.vocab_size, d)),
        "pos": nrm((cfg.max_len, d)),
        "blocks": {
            "ln1_g": full((L, d), 1.0), "ln1_b": full((L, d), 0.0),
            "Wq": nrm((L, d, d)), "Wk": nrm((L, d, d)),
            "Wv": nrm((L, d, d)), "Wo": nrm((L, d, d)),
            "ln2_g": full((L, d), 1.0), "ln2_b": full((L, d), 0.0),
            "W1": nrm((L, d, f)), "b1": full((L, f), 0.0),
            "W2": nrm((L, f, d)), "b2": full((L, d), 0.0),
        },
        "lnf_g": full((d,), 1.0), "lnf_b": full((d,), 0.0),
    }


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


def _bi_attention(q, k, v, n_heads: int, key_mask):
    """q, k, v [N, T, d] -> [N, T, d]: full bidirectional attention with a
    key-padding mask (``key_mask`` [N, T] bool, False keys hidden from
    every query) through ``attention_auto`` (K5 at offset T, K7 backward
    on the card). A sequence with no visible key gets the mean of V on
    every row, the JAX package's uniform softmax over its -1e9 scores."""
    n, t, d = q.shape
    hd = d // n_heads
    qh, kh, vh = (a.reshape(n, t, n_heads, hd) for a in (q, k, v))
    o = attention_auto(qh, kh, vh, causal=False, key_mask=key_mask)
    if key_mask is not None:
        dead = ~key_keep(key_mask).any(-1)[:, None, None, None]
        mean_v = vh.to(softmax_dtype(vh.dtype)).mean(1, keepdim=True)
        o = torch.where(dead, mean_v.to(o.dtype), o)
    return o.reshape(n, t, d)


def _block(bp: Params, h, n_heads: int, key_mask):
    x = _ln(h, bp["ln1_g"], bp["ln1_b"])
    att = _bi_attention(x @ bp["Wq"], x @ bp["Wk"], x @ bp["Wv"], n_heads,
                        key_mask)
    h = h + att @ bp["Wo"]
    x = _ln(h, bp["ln2_g"], bp["ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation
    return h + F.gelu(x @ bp["W1"] + bp["b1"],
                      approximate="tanh") @ bp["W2"] + bp["b2"]


def encode(params: Params, tokens, cfg: BertConfig, key_mask=None):
    """tokens [N, T] -> hidden states [N, T, d] after the final LN, in the
    params' dtype. ``key_mask`` defaults to ``tokens != pad_token_id``.
    While gradients are recorded each block runs under the remat policy
    (``cfg.remat``)."""
    tokens = tokens.long()
    t = tokens.shape[1]
    if key_mask is None:
        key_mask = tokens != cfg.pad_token_id
    h = params["embed"][tokens] + params["pos"][:t][None]
    block = (remat_wrap(_block, cfg.remat) if torch.is_grad_enabled()
             else _block)
    blocks = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(params["blocks"]["Wq"].shape[0]):
        h = block({k: v[i] for k, v in blocks.items()}, h, cfg.n_heads,
                  key_mask)
    return _ln(h, params["lnf_g"], params["lnf_b"])


def mlm_logits(params: Params, tokens, cfg: BertConfig, key_mask=None):
    """[N, T, V] through the tied embedding head (``ops/f32_gemm
    .tied_head``: K8 on the card for f32 and enough rows)."""
    return tied_head(encode(params, tokens, cfg, key_mask), params["embed"])


def mlm_loss(params: Params, tokens, targets, weights, cfg: BertConfig):
    """Cross-entropy over the selected (weight > 0) positions only, in at
    least f32."""
    logits = mlm_logits(params, tokens, cfg)
    dt = softmax_dtype(logits.dtype)
    logp = torch.log_softmax(logits.to(dt), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    w = weights.to(dt)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def mask_tokens(tokens: np.ndarray, cfg: BertConfig,
                rng: np.random.Generator
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 80/10/10 recipe on the host, the JAX package's draws in its
    order: (inputs with the corruptions, the original ids as targets,
    weights 1.0 at the predicted positions). Pad positions are never
    selected; at least one position is, where any can be; random
    replacements avoid the pad id."""
    tokens = np.asarray(tokens)
    selectable = tokens != cfg.pad_token_id
    sel = (rng.random(tokens.shape) < cfg.mlm_prob) & selectable
    if not sel.any():
        i = np.argwhere(selectable)
        if len(i):
            r, c = i[rng.integers(0, len(i))]
            sel[r, c] = True
    roll = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[sel & (roll < 0.8)] = cfg.mask_id
    rand_pos = sel & (roll >= 0.8) & (roll < 0.9)
    r = rng.integers(0, cfg.vocab_size - 1, int(rand_pos.sum()))
    r[r >= cfg.pad_token_id] += 1
    inputs[rand_pos] = r
    weights = sel.astype(np.float32)
    return inputs, tokens, weights


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _loss_scaled_update(cfg, params, opt, grad_loss, finish=None):
    """The bf16 loss-scaled branch shared by the MLM and fine-tune steps
    (the TransformerLM's ``_build_step``): the loss of the bf16-cast
    params scaled, the f32 gradients unscaled, Adam, then ``finish(new,
    old)`` on the new params, and the update skipped (the scale halved)
    when a gradient is not finite."""
    ls = lowprec.opt_scale_state(opt)
    base = {"m": opt["m"], "v": opt["v"], "t": opt["t"]}
    scale = ls["scale"]
    loss, grads = value_and_grad(
        lambda p: grad_loss(lowprec.cast_tree(p)).to(torch.float32) * scale,
        params)
    loss = loss / scale
    grads = lowprec.unscale(grads, scale)
    finite = lowprec.finite_tree(grads)
    lr = _scheduled_lr(cfg, base["t"] + 1)
    new, new_base = _adam_update(params, grads, base, lr,
                                 weight_decay=cfg.weight_decay,
                                 clip_grad_norm=cfg.clip_grad_norm)
    if finish is not None:
        new = finish(new, params)
    new = lowprec.select_trees(finite, new, params)
    base = lowprec.select_trees(finite, new_base, base)
    ls = lowprec.advance_scale(ls, finite)
    return new, lowprec.opt_with_scale(base, ls), loss


def _build_mlm_step(cfg: BertConfig):
    """``step(params, opt, inputs, targets, weights)``: the masked loss,
    its gradients and Adam; ``DL4J_TPU_BF16`` (read here, kept as
    ``step.loss_scaled``) takes the loss-scaled branch."""
    _validate_schedule(cfg)
    lp = lowprec.train_policy()

    def step(params, opt, inputs, targets, weights):
        grad_loss = lambda p: mlm_loss(p, inputs, targets, weights, cfg)
        if lp:
            return _loss_scaled_update(cfg, params, opt, grad_loss)
        loss, grads = value_and_grad(grad_loss, params)
        lr = _scheduled_lr(cfg, opt["t"] + 1)
        params, opt = _adam_update(params, grads, opt, lr,
                                   weight_decay=cfg.weight_decay,
                                   clip_grad_norm=cfg.clip_grad_norm)
        return params, opt, loss

    step.loss_scaled = lp
    return step


def make_train_step(cfg: BertConfig):
    """One MLM optimizer step: ``step(params, opt, inputs, targets,
    weights) -> (params, opt, loss)``."""
    return _build_mlm_step(cfg)


def make_train_multi_step(cfg: BertConfig):
    """K MLM steps over pre-masked batches stacked [K, N, T]: the same
    results as K calls of :func:`make_train_step`'s step."""
    return _multi_from_step(_build_mlm_step(cfg))


def init_classifier_head(cfg: BertConfig, n_classes: int, seed: int = 0,
                         *, device=None) -> Params:
    """A fresh linear head: ``Wc`` [d, C] ~ N(0, 0.02) from a
    ``torch.Generator`` seeded with ``seed``, ``bc`` zeros."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return {"Wc": torch.randn((cfg.d_model, n_classes), generator=gen,
                              device=dev, dtype=torch.float32) * 0.02,
            "bc": torch.zeros((n_classes,), dtype=torch.float32,
                              device=dev)}


def classify_logits(params: Params, head: Params, tokens,
                    cfg: BertConfig):
    """[N, C]: the encoder's hidden states mean-pooled over the non-pad
    positions, then the linear head."""
    tokens = tokens.long()
    key_mask = tokens != cfg.pad_token_id
    h = encode(params, tokens, cfg, key_mask)
    w = key_mask.to(h.dtype)[..., None]
    pooled = (h * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    return pooled @ head["Wc"] + head["bc"]


def make_finetune_step(cfg: BertConfig, n_classes: int,
                       encoder_lr_scale: float = 1.0):
    """``step(both, opt, tokens, labels) -> (both, opt, loss)`` over
    ``{"encoder", "head"}``: the pooled classifier's cross-entropy (in at
    least f32; f32 except in the f64 gradient checks) and Adam.
    ``encoder_lr_scale`` scales the encoder's UPDATE (new = old + scale *
    (adam - old)), not its gradient, which Adam would normalise away; 0
    freezes the encoder, decay included."""
    _validate_schedule(cfg)
    lp = lowprec.train_policy()

    def loss_fn(both, tokens, labels):
        logits = classify_logits(both["encoder"], both["head"], tokens, cfg)
        logp = torch.log_softmax(logits.to(softmax_dtype(logits.dtype)),
                                 dim=-1)
        return -torch.gather(logp, -1, labels.long()[:, None]).mean()

    def scale_encoder(new, old):
        if encoder_lr_scale != 1.0:
            new = dict(new, encoder=tree_map(
                lambda o, n: o + encoder_lr_scale * (n - o),
                old["encoder"], new["encoder"]))
        return new

    def step(both, opt, tokens, labels):
        grad_loss = lambda b: loss_fn(b, tokens, labels)
        if lp:
            return _loss_scaled_update(cfg, both, opt, grad_loss,
                                       scale_encoder)
        loss, grads = value_and_grad(grad_loss, both)
        lr = _scheduled_lr(cfg, opt["t"] + 1)
        new, opt = _adam_update(both, grads, opt, lr,
                                weight_decay=cfg.weight_decay,
                                clip_grad_norm=cfg.clip_grad_norm)
        return scale_encoder(new, both), opt, loss

    step.loss_scaled = lp
    return step


# ---------------------------------------------------------------------------
# the model objects
# ---------------------------------------------------------------------------


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).long()


class BertClassifier:
    """Fine-tune a (pretrained) :class:`BertMLM` encoder for sequence
    classification: ``state`` = {"encoder": the MLM's params, "head": a
    fresh head seeded with ``cfg.seed + 1``}, Adam over both."""

    def __init__(self, mlm: "BertMLM", n_classes: int,
                 encoder_lr_scale: float = 1.0) -> None:
        self.cfg = mlm.cfg
        self.device = mlm.device
        self.n_classes = n_classes
        self._encoder_lr_scale = encoder_lr_scale
        self.state = {"encoder": mlm.params,
                      "head": init_classifier_head(
                          mlm.cfg, n_classes, seed=mlm.cfg.seed + 1,
                          device=self.device)}
        self._step = make_finetune_step(mlm.cfg, n_classes,
                                        encoder_lr_scale)
        self.opt = init_opt_state(self.state, self._step.loss_scaled)

    def fit(self, tokens, labels) -> float:
        """One fine-tune step on tokens [N, T] and labels [N]; the loss."""
        self.state, self.opt, loss = self._step(
            self.state, self.opt, _ids(tokens, self.device),
            _ids(labels, self.device))
        return float(loss)

    def logits(self, tokens) -> torch.Tensor:
        with torch.inference_mode():
            return classify_logits(self.state["encoder"], self.state["head"],
                                   _ids(tokens, self.device), self.cfg)

    def predict(self, tokens) -> np.ndarray:
        return self.logits(tokens).argmax(-1).cpu().numpy()

    def accuracy(self, tokens, labels) -> float:
        return float((self.predict(tokens) == np.asarray(labels)).mean())

    def save(self, path: str) -> None:
        """The flagship zip (coefficients: the {"encoder", "head"} state;
        ``n_classes`` and ``encoder_lr_scale`` in the metadata), which the
        JAX ``BertClassifier.load`` reads."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            write_flagship_zip,
        )

        write_flagship_zip(
            path, "BertClassifier", self.cfg, self.state, self.opt,
            extra_meta={"n_classes": self.n_classes,
                        "encoder_lr_scale": self._encoder_lr_scale})

    @classmethod
    def load(cls, path: str, *, device=None,
             load_updater: bool = True) -> "BertClassifier":
        """Read a zip written by :meth:`save` or by the JAX package's
        ``BertClassifier.save``."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_flagship_zip,
        )

        cfg_dict, coeff, upd, meta = read_flagship_zip(path,
                                                       "BertClassifier")
        mlm = BertMLM(BertConfig(**cfg_dict), device=device)
        clf = cls(mlm, n_classes=int(meta["n_classes"]),
                  encoder_lr_scale=float(meta.get("encoder_lr_scale", 1.0)))
        clf.state = _tree_like(clf.state, npz_bytes_to_tree(coeff),
                               clf.device)
        if load_updater and upd is not None:
            clf.opt = _tree_like(clf.opt, npz_bytes_to_tree(upd), clf.device)
        return clf


class BertMLM:
    """Masked-LM pretraining and evaluation: ``cfg``, the f32 ``params``,
    Adam's ``opt`` and the masking generator (``np.random.default_rng(
    cfg.seed)``, drawn in the JAX package's order by :meth:`fit` and
    :meth:`fit_batches`). Lives on ``device`` — the card unless the
    caller passes ``device="cpu"``."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 params: Optional[Params] = None) -> None:
        if cfg.d_model % cfg.n_heads:
            raise ValueError("n_heads must divide d_model")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = (params if params is not None
                       else init_params(cfg, device=self.device))
        self._step = make_train_step(cfg)
        self._multi = _multi_from_step(self._step)
        self.opt = init_opt_state(self.params, self._step.loss_scaled)
        self._rng = np.random.default_rng(cfg.seed)

    def _masked(self, tokens):
        inputs, targets, weights = mask_tokens(tokens, self.cfg, self._rng)
        return (_ids(inputs, self.device), _ids(targets, self.device),
                torch.as_tensor(weights, device=self.device))

    def fit(self, tokens) -> float:
        """One masked-LM step on a [N, T] batch, the masking drawn anew
        (dynamic masking); the loss. The ``train.step`` span, on the
        device too."""
        with obs_trace.span("train.step", device=True, steps=1) as sp:
            with obs_trace.span("train.prepare"):
                batch = self._masked(tokens)
            sp.set_attr("rows", int(batch[0].shape[0]))
            sp.set_attr("tokens", int(batch[0].numel()))
            self.params, self.opt, loss = self._step(self.params, self.opt,
                                                     *batch)
            with obs_trace.span("train.readback"):
                return float(loss)

    def fit_batches(self, tokens_k) -> float:
        """K masked-LM steps on stacked batches [K, N, T], each masked from
        the stream :meth:`fit` draws from (K ``fit`` calls on the same
        batches take the same steps); the last step's loss. One
        ``train.step`` span of ``steps`` K."""
        with obs_trace.span("train.step", device=True) as sp:
            with obs_trace.span("train.prepare"):
                tokens_k = np.asarray(tokens_k.cpu()
                                      if torch.is_tensor(tokens_k)
                                      else tokens_k)
                if tokens_k.ndim != 3 or tokens_k.shape[0] == 0:
                    raise ValueError(
                        f"fit_batches expects stacked batches [K, N, T] "
                        f"with K >= 1, got shape {tokens_k.shape} (a "
                        "single [N, T] batch belongs in fit())")
                drawn = [self._masked(b) for b in tokens_k]
                stacks = [torch.stack([d[i] for d in drawn])
                          for i in range(3)]
            sp.set_attr("steps", int(tokens_k.shape[0]))
            sp.set_attr("rows", int(tokens_k.shape[0] * tokens_k.shape[1]))
            sp.set_attr("tokens", int(tokens_k.size))
            self.params, self.opt, losses = self._multi(self.params,
                                                        self.opt, *stacks)
            with obs_trace.span("train.readback"):
                return float(losses[-1])

    def logits(self, tokens) -> torch.Tensor:
        """MLM logits [N, T, V] on the device."""
        with torch.inference_mode():
            return mlm_logits(self.params, _ids(tokens, self.device),
                              self.cfg)

    def masked_accuracy(self, tokens, n_draws: int = 1) -> float:
        """The share of masked positions whose argmax is the original
        token, over masks from a dedicated generator re-seeded per call
        (``(cfg.seed, 0xE7A1)``), so evaluating moves no training draw."""
        eval_rng = np.random.default_rng((self.cfg.seed, 0xE7A1))
        hits = total = 0
        for _ in range(n_draws):
            inputs, targets, weights = mask_tokens(tokens, self.cfg,
                                                   eval_rng)
            pred = self.logits(inputs).argmax(-1).cpu().numpy()
            m = weights > 0
            hits += int((pred[m] == np.asarray(targets)[m]).sum())
            total += int(m.sum())
        return hits / max(total, 1)

    def predict_logits(self, tokens) -> np.ndarray:
        """MLM logits [N, T, V] as numpy."""
        return self.logits(tokens).cpu().numpy()

    def embed_tokens(self, tokens) -> np.ndarray:
        """Contextual embeddings [N, T, d] as numpy."""
        with torch.inference_mode():
            return encode(self.params, _ids(tokens, self.device),
                          self.cfg).cpu().numpy()

    def save(self, path: str) -> None:
        """The flagship zip (configuration, coefficients, updater), which
        the JAX ``BertMLM.load`` and ``ModelSerializer.restore`` read."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            write_flagship_zip,
        )

        write_flagship_zip(path, "BertMLM", self.cfg, self.params, self.opt)

    @classmethod
    def load(cls, path: str, *, device=None,
             load_updater: bool = True) -> "BertMLM":
        """Read a zip written by :meth:`save` or by the JAX package's
        ``BertMLM.save``."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            npz_bytes_to_tree,
            read_flagship_zip,
        )

        cfg_dict, coeff, upd, _ = read_flagship_zip(path, "BertMLM")
        lm = cls(BertConfig(**cfg_dict), device=device)
        lm.params = _tree_like(lm.params, npz_bytes_to_tree(coeff),
                               lm.device)
        if load_updater and upd is not None:
            lm.opt = _tree_like(lm.opt, npz_bytes_to_tree(upd), lm.device)
        return lm
