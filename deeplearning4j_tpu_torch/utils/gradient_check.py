"""Numerical gradient checks (counterpart:
``deeplearning4j_tpu/utils/gradient_check.py`` — ``check_gradients`` :23,
``check_network_gradients`` :85 and ``check_graph_gradients`` :117-157).

Central differences against autograd, per parameter entry, with a
relative-error threshold, in f64.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map


def check_gradients(loss_fn: Callable, params, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3,
                    abs_error_floor: float = 1e-8,
                    max_params_per_leaf: Optional[int] = None,
                    seed: int = 0, verbose: bool = False
                    ) -> Tuple[bool, float]:
    """Autograd gradients of ``loss_fn(params)`` (a nest of dicts and
    lists of tensors) against central differences, in f64.
    ``max_params_per_leaf`` checks a seeded random subset of each larger
    leaf. Returns (passed, max relative error)."""
    params64 = tree_map(
        lambda a: a.detach().to(torch.float64).requires_grad_(True), params)
    leaves = tree_leaves(params64)
    with torch.enable_grad():
        analytic = torch.autograd.grad(loss_fn(params64), leaves,
                                       materialize_grads=True)
    rng = np.random.default_rng(seed)
    max_rel = 0.0
    ok = True
    with torch.no_grad():
        for li, (leaf, gleaf) in enumerate(zip(leaves, analytic)):
            flat = leaf.view(-1)
            gflat = gleaf.reshape(-1).cpu().numpy()
            idxs = np.arange(flat.numel())
            if max_params_per_leaf is not None \
                    and flat.numel() > max_params_per_leaf:
                idxs = rng.choice(flat.numel(), size=max_params_per_leaf,
                                  replace=False)
            for j in idxs:
                orig = float(flat[j])

                def eval_at(v):
                    flat[j] = v
                    return float(loss_fn(params64))

                num = (eval_at(orig + epsilon)
                       - eval_at(orig - epsilon)) / (2 * epsilon)
                flat[j] = orig
                ana = float(gflat[j])
                denom = abs(num) + abs(ana)
                if denom < abs_error_floor:
                    continue
                rel = abs(num - ana) / denom
                max_rel = max(max_rel, rel)
                if rel > max_rel_error:
                    ok = False
                    if verbose:
                        print(f"grad check FAIL leaf {li} idx {j}: "
                              f"numerical={num:.8g} analytic={ana:.8g} "
                              f"rel={rel:.3g}")
    return ok, max_rel


def check_network_gradients(net, features, labels, mask=None,
                            label_mask=None, epsilon: float = 1e-6,
                            max_rel_error: float = 1e-3,
                            max_params_per_leaf: Optional[int] = None
                            ) -> Tuple[bool, float]:
    """Gradient-check a MultiLayerNetwork's whole loss (with the l1/l2
    penalty) in inference mode, in f64."""
    if net.params is None:
        net.init()
    as64 = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a, np.float64), device=net.device)
    x, y = as64(features), as64(labels)
    mask, label_mask = as64(mask), as64(label_mask)
    states = tree_map(lambda a: a.to(torch.float64)
                      if a.is_floating_point() else a, net.states)

    def loss(p):
        val, _ = net._loss(p, states, x, y, train=False, mask=mask,
                           label_mask=label_mask)
        return val

    return check_gradients(loss, net.params, epsilon=epsilon,
                           max_rel_error=max_rel_error,
                           max_params_per_leaf=max_params_per_leaf)


def check_graph_gradients(net, features_list, labels_list, masks=None,
                          label_masks=None, epsilon: float = 1e-6,
                          max_rel_error: float = 1e-3,
                          max_params_per_leaf: Optional[int] = None
                          ) -> Tuple[bool, float]:
    """Gradient-check a ComputationGraph's summed multi-output loss (with
    the l1/l2 penalty) in inference mode, in f64."""
    if net.params is None:
        net.init()
    as64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                     device=net.device)
    inputs = {n: as64(f) for n, f in zip(net.conf.inputs, features_list)}
    labels = [as64(l) for l in labels_list]
    masks = {k: as64(m) for k, m in net._as_masks(masks).items()} or None
    label_masks = (None if label_masks is None else
                   [None if m is None else as64(m) for m in label_masks])
    states = tree_map(lambda a: a.to(torch.float64)
                      if a.is_floating_point() else a, net.states)

    def loss(p):
        val, _ = net._loss(p, states, inputs, labels, train=False,
                           masks=masks, label_masks=label_masks)
        return val

    return check_gradients(loss, net.params, epsilon=epsilon,
                           max_rel_error=max_rel_error,
                           max_params_per_leaf=max_params_per_leaf)
