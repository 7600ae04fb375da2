"""Full-batch optimizers and the Solver (counterpart:
``deeplearning4j_tpu/optimize/solvers.py`` — ``negative_gradient_step``,
the terminations ``EpsTermination``, ``Norm2Termination`` and
``ZeroDirection``, ``backtrack_line_search`` :90,
``line_gradient_descent`` :145, ``conjugate_gradient`` :173, ``lbfgs``
:211 and ``Solver`` :286 with the MultiLayerNetwork oracle and the
ComputationGraph's, ``_oracles_graph`` / ``optimize_graph`` :337-414).

The optimizers are functions over one flat parameter vector and an
oracle ``vg_fn(x) -> (score, grad)`` (with an optional ``value_only``
attribute for the line search's probes), the same control flow as the
JAX package's. The Solver flattens a network's params in the JAX
package's ``ravel_pytree`` order (layers in order, a graph's vertices
and each dict's keys sorted), evaluates the loss in inference mode (no dropout) on the
minibatch, and takes the gradient with ``torch.autograd.grad``. Scores
cross to the host as Python floats: every line-search decision is a host
branch, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.lowprec import tree_map

# ---------------------------------------------------------------------------
# step function and termination conditions
# ---------------------------------------------------------------------------


def negative_gradient_step(params: torch.Tensor, direction: torch.Tensor,
                           step: float) -> torch.Tensor:
    """params + step * direction, the direction already a descent one."""
    return params + step * direction


class EpsTermination:
    """|new - old| <= eps * |old| + tolerance."""

    def __init__(self, eps: float = 1e-10, tolerance: float = 1e-6):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, new_score: float, old_score: float,
                  direction=None) -> bool:
        return abs(new_score - old_score) <= (self.eps * abs(old_score)
                                              + self.tolerance)


class Norm2Termination:
    """The gradient's L2 norm below a threshold."""

    def __init__(self, gradient_norm_threshold: float = 1e-8):
        self.threshold = gradient_norm_threshold

    def terminate(self, new_score, old_score, direction=None) -> bool:
        if direction is None:
            return False
        return float(torch.linalg.vector_norm(direction)) < self.threshold


class ZeroDirection:
    """The search direction vanished."""

    def terminate(self, new_score, old_score, direction=None) -> bool:
        if direction is None:
            return False
        return float(direction.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# backtracking line search
# ---------------------------------------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def backtrack_line_search(value_fn: Callable[[torch.Tensor], float],
                          x: torch.Tensor, score0: float, grad0: torch.Tensor,
                          direction: torch.Tensor, *,
                          initial_step: float = 1.0,
                          max_iterations: int = 5, min_step: float = 1e-12,
                          wolfe_c1: float = 1e-4) -> Tuple[float, float]:
    """Armijo backtracking: halve the step from ``initial_step`` until
    f(x + step * d) <= f(x) + c1 * step * g.d. Returns (step, new score);
    step 0 means no improving step (or not a descent direction)."""
    gd = _dot(grad0, direction)
    if gd >= 0:
        return 0.0, score0
    step = float(initial_step)
    for _ in range(max_iterations):
        new_score = float(value_fn(x + step * direction))
        if new_score <= score0 + wolfe_c1 * step * gd \
                and math.isfinite(new_score):
            return step, new_score
        step *= 0.5
        if step < min_step:
            break
    return 0.0, score0


# ---------------------------------------------------------------------------
# optimizers over a flat vector oracle
# ---------------------------------------------------------------------------


def _value_oracle(vg_fn):
    """The line search's probe: ``vg_fn.value_only`` when given, else the
    score of ``vg_fn``."""
    v = getattr(vg_fn, "value_only", None)
    return v if v is not None else (lambda p: vg_fn(p)[0])


class OptimResult(NamedTuple):
    params: torch.Tensor
    score: float
    iterations: int
    converged: bool


def line_gradient_descent(vg_fn, x0: torch.Tensor, *, max_iterations: int,
                          line_search_iterations: int = 5,
                          termination: Optional[EpsTermination] = None
                          ) -> OptimResult:
    """Steepest descent with the backtracking line search."""
    termination = termination or EpsTermination()
    x = x0
    score, grad = vg_fn(x)
    score = float(score)
    it = 0
    for it in range(1, max_iterations + 1):
        direction = -grad
        step, _ = backtrack_line_search(
            _value_oracle(vg_fn), x, score, grad, direction,
            max_iterations=line_search_iterations)
        if step == 0.0:
            return OptimResult(x, score, it, True)
        x = x + step * direction
        old = score
        score, grad = vg_fn(x)
        score = float(score)
        if termination.terminate(score, old, grad):
            return OptimResult(x, score, it, True)
    return OptimResult(x, score, it, False)


def conjugate_gradient(vg_fn, x0: torch.Tensor, *, max_iterations: int,
                       line_search_iterations: int = 5,
                       termination: Optional[EpsTermination] = None
                       ) -> OptimResult:
    """Nonlinear CG, Polak-Ribiere (beta clipped at 0), restarted along
    the steepest descent when the line search finds no step."""
    termination = termination or EpsTermination()
    x = x0
    score, grad = vg_fn(x)
    score = float(score)
    direction = -grad
    it = 0
    for it in range(1, max_iterations + 1):
        step, _ = backtrack_line_search(
            _value_oracle(vg_fn), x, score, grad, direction,
            max_iterations=line_search_iterations)
        if step == 0.0:
            # restart along steepest descent once; if still stuck, converged
            if bool(torch.allclose(direction, -grad)):
                return OptimResult(x, score, it, True)
            direction = -grad
            continue
        x = x + step * direction
        old_grad, old_score = grad, score
        score, grad = vg_fn(x)
        score = float(score)
        denom = _dot(old_grad, old_grad)
        beta = max(0.0, _dot(grad, grad - old_grad) / max(denom, 1e-30))
        direction = -grad + beta * direction
        if termination.terminate(score, old_score, grad):
            return OptimResult(x, score, it, True)
    return OptimResult(x, score, it, False)


def lbfgs(vg_fn, x0: torch.Tensor, *, max_iterations: int, memory: int = 10,
          line_search_iterations: int = 5,
          termination: Optional[EpsTermination] = None) -> OptimResult:
    """Limited-memory BFGS, two-loop recursion over the last ``memory``
    (s, y) pairs; a failed line search retries along the steepest descent
    and clears the history."""
    termination = termination or EpsTermination()
    x = x0
    score, grad = vg_fn(x)
    score = float(score)
    s_hist: List[torch.Tensor] = []
    y_hist: List[torch.Tensor] = []
    it = 0
    for it in range(1, max_iterations + 1):
        q = grad
        alphas = []
        for s, y in zip(reversed(s_hist), reversed(y_hist)):
            ys = _dot(y, s)
            if abs(ys) < 1e-20:
                continue  # a degenerate curvature pair (flat region)
            rho = 1.0 / ys
            a = rho * _dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if y_hist:
            s, y = s_hist[-1], y_hist[-1]
            q = q * (_dot(s, y) / max(_dot(y, y), 1e-30))
        for a, rho, s, y in reversed(alphas):
            b = rho * _dot(y, q)
            q = q + (a - b) * s
        direction = -q
        step, _ = backtrack_line_search(
            _value_oracle(vg_fn), x, score, grad, direction,
            max_iterations=line_search_iterations)
        if step == 0.0:
            direction = -grad
            step, _ = backtrack_line_search(
                _value_oracle(vg_fn), x, score, grad, direction,
                max_iterations=line_search_iterations)
            if step == 0.0:
                return OptimResult(x, score, it, True)
            s_hist.clear()
            y_hist.clear()
        x_new = x + step * direction
        old_score = score
        new_score, new_grad = vg_fn(x_new)
        new_score = float(new_score)
        s_hist.append(x_new - x)
        y_hist.append(new_grad - grad)
        if len(s_hist) > memory:
            s_hist.pop(0)
            y_hist.pop(0)
        x, score, grad = x_new, new_score, new_grad
        if termination.terminate(score, old_score, grad):
            return OptimResult(x, score, it, True)
    return OptimResult(x, score, it, False)


OPTIMIZERS = {
    "line_gradient_descent": line_gradient_descent,
    "conjugate_gradient": conjugate_gradient,
    "lbfgs": lbfgs,
}


# ---------------------------------------------------------------------------
# the flat parameter vector of a network
# ---------------------------------------------------------------------------


def _sorted_leaves(tree, path=()):
    """(path, tensor) of a nest of lists and dicts in ``ravel_pytree``
    order: list items in order, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sorted_leaves(v, path + (i,))
    else:
        yield path, tree


def ravel(tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], list]]:
    """(flat vector, unravel): ``unravel(v)`` rebuilds the nest with views
    of ``v`` in the leaves' shapes."""
    leaves = list(_sorted_leaves(tree))
    flat = torch.cat([t.reshape(-1) for _, t in leaves])
    shapes = [(p, tuple(t.shape), t.numel()) for p, t in leaves]

    def unravel(v: torch.Tensor):
        # a graph's params are a dict keyed by vertex name
        out = ({k: {} for k in tree} if isinstance(tree, dict)
               else [dict() for _ in tree])
        offset = 0
        for path, shape, n in shapes:
            node = out[path[0]]
            for part in path[1:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = v[offset:offset + n].view(shape)
            offset += n
        return out

    return flat, unravel


# ---------------------------------------------------------------------------
# Solver — an optimizer on a network's loss over one minibatch
# ---------------------------------------------------------------------------


class Solver:
    """A full-batch optimizer on a MultiLayerNetwork's loss over one
    minibatch; ``conf.optimization_algo`` names it (SGD runs in the
    network's own train step, not here)."""

    def __init__(self, net, algo: Optional[str] = None):
        self.net = net
        self.algo = algo or net.conf.optimization_algo
        if self.algo not in OPTIMIZERS:
            raise ValueError(
                f"Solver handles {sorted(OPTIMIZERS)}; got '{self.algo}' "
                "(stochastic_gradient_descent runs in the container's "
                "train step)")

    def _run(self, vg_fn, flat0, unravel, max_iterations) -> float:
        net = self.net
        res = OPTIMIZERS[self.algo](
            vg_fn, flat0,
            max_iterations=max_iterations or max(1, net.conf.iterations),
            line_search_iterations=net.conf.max_num_line_search_iterations)
        # copies in the old nest's key order, not views of the vector
        net.params = tree_map(lambda _, new: new.clone(), net.params,
                              unravel(res.params.detach()))
        net._score = torch.tensor(res.score, dtype=flat0.dtype,
                                  device=flat0.device)
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration, res.score)
        net.iteration += res.iterations
        if res.converged and (getattr(net.conf, "lr_policy", "none")
                              or "none") == "score":
            # an eps plateau under the 'score' policy decays the LR
            net.apply_lr_score_decay()
        return res.score

    def optimize(self, features, labels, mask=None, label_mask=None,
                 max_iterations: Optional[int] = None) -> float:
        """Run the optimizer from the network's params on this minibatch;
        the network takes the result's params. Returns the final score."""
        net = self.net
        if net.params is None:
            net.init()
        x, y = net._as_input(features), net._as_input(labels)
        mask, label_mask = net._as_optional(mask), net._as_optional(
            label_mask)
        flat0, unravel = ravel(net.params)

        def value(p):
            with torch.no_grad():
                val, _ = net._loss(unravel(p), net.states, x, y, train=False,
                                   mask=mask, label_mask=label_mask)
            return float(val)

        def vg(p):
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                val, _ = net._loss(unravel(p), net.states, x, y, train=False,
                                   mask=mask, label_mask=label_mask)
                (grad,) = torch.autograd.grad(val, p)
            return float(val.detach()), grad

        vg.value_only = value
        return self._run(vg, flat0.detach(), unravel, max_iterations)

    def optimize_graph(self, inputs, labels, masks=None, label_masks=None,
                       max_iterations: Optional[int] = None) -> float:
        """The ComputationGraph path (``_oracles_graph`` and
        ``optimize_graph``, :337-414): ``inputs`` a name-keyed dict of
        tensors, ``labels`` a list; the graph takes the result's
        params."""
        net = self.net
        if net.params is None:
            net.init()
        flat0, unravel = ravel(net.params)
        masks = masks or {}

        def value(p):
            with torch.no_grad():
                val, _ = net._loss(unravel(p), net.states, inputs, labels,
                                   train=False, masks=masks,
                                   label_masks=label_masks)
            return float(val)

        def vg(p):
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                val, _ = net._loss(unravel(p), net.states, inputs, labels,
                                   train=False, masks=masks,
                                   label_masks=label_masks)
                (grad,) = torch.autograd.grad(val, p)
            return float(val.detach()), grad

        vg.value_only = value
        return self._run(vg, flat0.detach(), unravel, max_iterations)

