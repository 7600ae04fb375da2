"""Updaters, learning-rate policies and gradient normalization (counterpart:
``deeplearning4j_tpu/optimize/updaters.py``).

The seven update rules of the reference (sgd, none, nesterovs, adagrad,
rmsprop, adadelta, adam), the seven LR policies, the five gradient
normalizations, the separate bias learning rate (``BIAS_PARAM_NAMES``) and
the ``score`` policy's ``lr_scale``. ``update`` returns the updates that
:func:`apply_updates` subtracts from the params (added when maximizing).

State keeps the JAX layout, one dict per layer such as
``{"cache": {"W": ..., "U": ..., "p": ..., "b": ...}}`` (plus ``lr_scale``
under the ``score`` policy), so a checkpoint's ``updater.npz`` maps leaf
for leaf. Unlike the JAX package's pure transforms, the port updates the
state and the params in place (``torch._foreach_*`` over a layer's
leaves, under ``torch.no_grad()``): they have one owner, so no copy is
needed. The schedule scalars (learning rate, momentum, Adam's bias
correction) are computed on the host in f32, as the JAX package computes
them on the device in f32; the tensor math runs in the gradients' dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map

BIAS_PARAM_NAMES = ("b", "vb", "beta")

_F = np.float32

Path = Tuple[str, ...]


def flatten_paths(tree, prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    """The leaves of a nest of dicts keyed by their paths, in order."""
    out: Dict[Path, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_paths(flat: Dict[Path, torch.Tensor]) -> Dict[str, object]:
    """Inverse of :func:`flatten_paths`."""
    tree: Dict[str, object] = {}
    for path, v in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return tree


def at_path(tree, path: Path):
    for part in path:
        tree = tree[part]
    return tree


def lr_at(conf, base_lr: float, iteration) -> np.float32:
    """Learning rate at ``iteration`` under the conf's LR policy (f32).
    conf carries lr_policy, lr_policy_decay_rate, lr_policy_steps,
    lr_policy_power and lr_schedule (iteration -> lr)."""
    it = _F(iteration)
    policy = getattr(conf, "lr_policy", "none") or "none"
    decay = getattr(conf, "lr_policy_decay_rate", None)
    steps = getattr(conf, "lr_policy_steps", None)
    power = getattr(conf, "lr_policy_power", None)
    lr = _F(base_lr)
    if policy in ("none", "score"):
        return lr
    if policy == "exponential":
        return lr * np.power(_F(decay), it)
    if policy == "inverse":
        return lr / np.power(_F(1.0) + _F(decay) * it, _F(power))
    if policy == "poly":
        frac = np.clip(it / _F(steps), _F(0.0), _F(1.0))
        return lr * np.power(_F(1.0) - frac, _F(power))
    if policy == "sigmoid":
        return lr / (_F(1.0) + np.exp(-_F(decay) * (it - _F(steps))))
    if policy == "step":
        return lr * np.power(_F(decay), np.floor(it / _F(steps)))
    if policy == "schedule":
        for k in sorted((conf.lr_schedule or {}).keys()):
            if it >= k:
                lr = _F(conf.lr_schedule[k])
        return lr
    raise ValueError(f"unknown lr policy {policy}")


def momentum_at(layer_conf, net_conf, iteration) -> np.float32:
    m = _F(layer_conf.momentum)
    sched = getattr(net_conf, "momentum_schedule", None) if net_conf else None
    for k in sorted((sched or {}).keys()):
        if _F(iteration) >= k:
            m = _F(sched[k])
    return m


def _global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def normalize_gradients(grads: Dict[str, torch.Tensor],
                        scheme: Optional[str],
                        threshold: float) -> Dict[str, torch.Tensor]:
    """One layer's gradient normalization scheme applied to its grads."""
    if not scheme:
        return grads
    s = scheme.lower()
    if s == "renormalize_l2_per_layer":
        norm = torch.clamp(_global_norm(grads), min=1e-12)
        return {k: g / norm for k, g in grads.items()}
    if s == "renormalize_l2_per_param_type":
        return {k: g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
                for k, g in grads.items()}
    if s == "clip_elementwise_absolute_value":
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if s == "clip_l2_per_layer":
        norm = _global_norm(grads)
        scale = torch.where(norm > threshold, threshold / (norm + 1e-12),
                            torch.ones_like(norm))
        return {k: g * scale for k, g in grads.items()}
    if s == "clip_l2_per_param_type":
        out = {}
        for k, g in grads.items():
            norm = torch.linalg.vector_norm(g)
            out[k] = g * torch.where(norm > threshold,
                                     threshold / (norm + 1e-12),
                                     torch.ones_like(norm))
        return out
    raise ValueError(f"unknown gradient normalization {scheme}")


class LayerUpdater:
    """One layer's update rule over its params dict."""

    def __init__(self, layer_conf, net_conf=None):
        self.conf = layer_conf
        self.net_conf = net_conf
        self.kind = (layer_conf.updater or "sgd").lower()

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, object]:
        zeros = lambda: tree_map(torch.zeros_like, params)
        k = self.kind
        if k in ("sgd", "none"):
            state = {}
        elif k == "nesterovs":
            state = {"v": zeros()}
        elif k == "adagrad":
            state = {"hist": zeros()}
        elif k == "rmsprop":
            state = {"cache": zeros()}
        elif k == "adadelta":
            state = {"msg": zeros(), "msdx": zeros()}
        elif k == "adam":
            state = {"m": zeros(), "v": zeros()}
        else:
            raise ValueError(f"unknown updater {self.kind}")
        if (getattr(self.net_conf, "lr_policy", None) or "none") == "score":
            # the event-driven 'score' policy's cumulative decay
            # (apply_lr_score_decay multiplies it)
            leaves = tree_leaves(params)
            dev = leaves[0].device if leaves else None
            state["lr_scale"] = torch.ones((), dtype=torch.float32,
                                           device=dev)
        return state

    def _lrs(self, names: List[Path], iteration, scale) -> List[float]:
        """Per-leaf learning rates (bias leaves, by the last name of their
        path, get bias_learning_rate)."""
        lr = lr_at(self.net_conf, self.conf.learning_rate, iteration)
        bias_lr = lr_at(self.net_conf,
                        self.conf.bias_learning_rate
                        or self.conf.learning_rate, iteration)
        if scale is not None:
            lr, bias_lr = lr * scale, bias_lr * scale
        return [float(bias_lr if k[-1] in BIAS_PARAM_NAMES else lr)
                for k in names]

    @torch.no_grad()
    def update(self, grads, state, params, iteration
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
        """(updates, state): ``state`` is advanced in place and returned.
        A layer's params may nest (the bidirectional LSTM's ``fwd`` and
        ``bwd``): the rule runs over the leaves by path."""
        scale = _F(float(state["lr_scale"])) if "lr_scale" in state else None
        flat = flatten_paths(grads)
        flat = normalize_gradients(
            flat, self.conf.gradient_normalization,
            self.conf.gradient_normalization_threshold or 1.0)
        names = list(flat)
        g = [flat[k] for k in names]
        lrs = self._lrs(names, iteration, scale)
        leaves = lambda key: [at_path(state[key], k) for k in names]
        eps = self.conf.epsilon or 1e-8
        k = self.kind
        if k == "sgd":
            upd = torch._foreach_mul(g, lrs)
        elif k == "none":
            upd = g
        elif k == "nesterovs":
            # v <- mu v - lr g; update = mu v_prev - (1 + mu) v
            mu = momentum_at(self.conf, self.net_conf, iteration)
            v = leaves("v")
            upd = torch._foreach_mul(v, float(mu))
            torch._foreach_mul_(v, float(mu))
            torch._foreach_sub_(v, torch._foreach_mul(g, lrs))
            torch._foreach_sub_(
                upd, torch._foreach_mul(v, float(_F(1.0) + mu)))
        elif k == "adagrad":
            hist = leaves("hist")
            torch._foreach_addcmul_(hist, g, g)
            denom = torch._foreach_sqrt(hist)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_mul(g, lrs)
            torch._foreach_div_(upd, denom)
        elif k == "rmsprop":
            d = self.conf.rms_decay
            cache = leaves("cache")
            torch._foreach_mul_(cache, d)
            torch._foreach_addcmul_(cache, g, g, value=1.0 - d)
            denom = torch._foreach_add(cache, eps)
            torch._foreach_sqrt_(denom)
            upd = torch._foreach_mul(g, lrs)
            torch._foreach_div_(upd, denom)
        elif k == "adadelta":
            rho = self.conf.rho
            msg, msdx = leaves("msg"), leaves("msdx")
            torch._foreach_mul_(msg, rho)
            torch._foreach_addcmul_(msg, g, g, value=1 - rho)
            upd = torch._foreach_add(msdx, eps)
            torch._foreach_sqrt_(upd)
            torch._foreach_mul_(upd, g)
            denom = torch._foreach_add(msg, eps)
            torch._foreach_sqrt_(denom)
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(msdx, rho)
            torch._foreach_addcmul_(msdx, upd, upd, value=1 - rho)
        elif k == "adam":
            b1 = self.conf.adam_mean_decay
            b2 = self.conf.adam_var_decay
            t = _F(iteration) + _F(1.0)
            m, v = leaves("m"), leaves("v")
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            alpha = (np.sqrt(_F(1.0) - np.power(_F(b2), t))
                     / (_F(1.0) - np.power(_F(b1), t)))
            upd = torch._foreach_mul(m, [float(_F(lr) * alpha)
                                         for lr in lrs])
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(upd, denom)
        else:
            raise ValueError(f"unknown updater {self.kind}")
        return unflatten_paths(dict(zip(names, upd))), state


class MultiLayerUpdater:
    """Per-layer updaters over the network's list of param dicts."""

    def __init__(self, layer_confs, net_conf=None):
        self.updaters = [LayerUpdater(lc, net_conf) for lc in layer_confs]

    def init(self, params_list):
        return [u.init(p) for u, p in zip(self.updaters, params_list)]

    def update(self, grads_list, state_list, params_list, iteration):
        updates, states = [], []
        for u, g, s, p in zip(self.updaters, grads_list, state_list,
                              params_list):
            if not g:  # parameterless layer
                updates.append(g)
                states.append(s)
                continue
            upd, s = u.update(g, s, p, iteration)
            updates.append(upd)
            states.append(s)
        return updates, states


@torch.no_grad()
def apply_updates(params_list, updates_list, minimize: bool = True):
    """params <- params - updates (+ when maximizing), in place. Lists of
    per-layer dicts, or dicts of them keyed by vertex name."""
    if isinstance(params_list, dict):
        updates_list = [updates_list[k] for k in params_list]
        params_list = list(params_list.values())
    for p, u in zip(params_list, updates_list):
        if not u:
            continue
        src = flatten_paths(u)
        dst = [at_path(p, k) for k in src]
        src = list(src.values())
        if minimize:
            torch._foreach_sub_(dst, src)
        else:
            torch._foreach_add_(dst, src)
    return params_list
