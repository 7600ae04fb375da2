"""t-SNE of the port, exact and Barnes-Hut (counterpart:
``deeplearning4j_tpu/plot/tsne.py`` — ``_binary_search_betas``,
``_tsne_step``, ``Tsne`` and ``BarnesHutTsne``).

The input affinities are host numpy in f64, as in the JAX package: a
per-row binary search for the precision whose entropy is log(perplexity)
(:func:`_binary_search_betas`), symmetrised into P. The exact variant's
gradient step is :func:`tsne_step`, in place on Y, the velocity and the
gains on P's device: the N x N Student-t kernel with its diagonal
zeroed, Q clamped at 1e-12, the gradient 4 (diag(rowsum PQ) - PQ) Y, the
gains rule keyed on the signs, momentum, and Y recentred (an XLA program
in the JAX package, no Pallas kernel; PyTorch ops here). The KL
divergence is computed only on the steps it is recorded (every 50th and
the last), stays on the device, and is read once at the end.

Barnes-Hut stays host numpy, as in the JAX package: VPTree neighbours
for a sparse P and an SPTree walk per point for the repulsion. It takes
no device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.sptree import SPTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.ops.device import resolve_device

KL_EVERY = 50  # kl_history: every KL_EVERY steps and the last


def _binary_search_betas(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
                         max_iter: int = 50) -> np.ndarray:
    """Each row's precision beta such that its conditional distribution
    exp(-d2 beta) / sum has entropy log(perplexity), all rows at once; the
    row-normalised P. The caller excludes self entries from ``d2``."""
    n = d2.shape[0]
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    log_u = np.log(perplexity)
    P = np.zeros_like(d2)
    for _ in range(max_iter):
        P = np.exp(-d2 * beta[:, None])
        sum_p = np.maximum(P.sum(axis=1), 1e-12)
        h = np.log(sum_p) + beta * (d2 * P).sum(axis=1) / sum_p
        diff = h - log_u
        done = np.abs(diff) < tol
        if done.all():
            break
        too_high = diff > 0
        upd = ~done & too_high
        beta_min[upd] = beta[upd]
        beta[upd] = np.where(np.isinf(beta_max[upd]), beta[upd] * 2,
                             (beta[upd] + beta_max[upd]) / 2)
        upd = ~done & ~too_high
        beta_max[upd] = beta[upd]
        beta[upd] = np.where(np.isinf(beta_min[upd]), beta[upd] / 2,
                             (beta[upd] + beta_min[upd]) / 2)
    return P / np.maximum(P.sum(axis=1, keepdims=True), 1e-12)


def tsne_step(P, Y, velocity, gains, momentum, lr, kl: bool = False):
    """One exact t-SNE step in place on Y [N, c], ``velocity`` and
    ``gains``, from the affinities P [N, N]. Returns the KL divergence of
    P from this step's Q (a 0-d tensor) when ``kl``, else None."""
    sum_y = torch.sum(Y * Y, dim=1)
    num = 1.0 / (1.0 + sum_y[:, None] - 2.0 * Y @ Y.T + sum_y[None, :])
    num.fill_diagonal_(0.0)
    Q = torch.clamp_min(num / torch.sum(num), 1e-12)
    PQ = (P - Q) * num
    lap = PQ.neg()  # diag(rowsum PQ) - PQ; PQ's diagonal is 0
    lap.diagonal().add_(PQ.sum(dim=1))
    grad = 4.0 * (lap @ Y)
    flip = torch.sign(grad) != torch.sign(velocity)
    gains.copy_(torch.clamp_min(
        torch.where(flip, gains + 0.2, gains * 0.8), 0.01))
    velocity.mul_(momentum).sub_(lr * gains * grad)
    Y.add_(velocity)
    Y.sub_(torch.mean(Y, dim=0, keepdim=True))
    if kl:
        return torch.sum(P * torch.log(torch.clamp_min(P, 1e-12) / Q))
    return None


class Tsne:
    """Exact t-SNE with DL4J's options: n_components, perplexity,
    max_iter, learning_rate, early exaggeration (factor and steps),
    momentum (initial, final, the step it switches), seed. The steps run
    on ``cuda`` unless ``device="cpu"``."""

    def __init__(
        self,
        n_components: int = 2,
        perplexity: float = 30.0,
        max_iter: int = 1000,
        learning_rate: float = 200.0,
        early_exaggeration: float = 4.0,
        exaggeration_iters: int = 100,
        initial_momentum: float = 0.5,
        final_momentum: float = 0.8,
        momentum_switch: int = 250,
        seed: int = 42,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.kl_history: list = []
        self.Y_: Optional[np.ndarray] = None

    def _input_p(self, x: np.ndarray) -> np.ndarray:
        """The symmetrised affinities of the rows of ``x`` (f64)."""
        d2 = (np.sum(x * x, 1)[:, None] - 2.0 * x @ x.T
              + np.sum(x * x, 1)[None, :])
        np.fill_diagonal(d2, 1e12)  # exclude self
        p_cond = _binary_search_betas(np.maximum(d2, 0.0), self.perplexity)
        P = (p_cond + p_cond.T) / (2.0 * p_cond.shape[0])
        return np.maximum(P, 1e-12)

    def _momentum(self, it: int) -> float:
        return (self.initial_momentum if it < self.momentum_switch
                else self.final_momentum)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        P = self._input_p(x)
        rng = np.random.default_rng(self.seed)
        up = lambda a: torch.from_numpy(a.astype(np.float32)).to(self.device)
        Y = up(rng.normal(0, 1e-4, (n, self.n_components)))
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        P_ex = up(P * self.early_exaggeration)
        P_d = up(P)
        del P
        f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
        lr = f32(self.learning_rate)
        kls = []
        for it in range(self.max_iter):
            record = it % KL_EVERY == 0 or it == self.max_iter - 1
            kl = tsne_step(P_ex if it < self.exaggeration_iters else P_d,
                           Y, vel, gains, f32(self._momentum(it)), lr,
                           kl=record)
            if record:
                kls.append(kl)
        self.kl_history = torch.stack(kls).tolist() if kls else []
        self.Y_ = Y.cpu().numpy()
        return self.Y_

    def plot(self, x) -> np.ndarray:
        return self.fit_transform(x)


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE on the host: P over each point's 3 x perplexity
    nearest neighbours (a VPTree), the repulsion from an SPTree at
    ``theta``. Takes no device."""

    def __init__(self, theta: float = 0.5, **kwargs):
        kwargs.setdefault("early_exaggeration", 12.0)
        super().__init__(device="cpu", **kwargs)
        self.theta = theta

    def _sparse_input_p(self, x: np.ndarray):
        """(pairs [m, 2], P values [m]): row-conditional affinities over
        the exact neighbours, symmetrised over the union of the supports
        and normalised."""
        n = x.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(x)
        rows = np.zeros((n, k), np.int64)
        d2 = np.zeros((n, k))
        for i in range(n):
            res = [r for r in tree.knn(x[i], k + 1) if r[1] != i][:k]
            rows[i] = [r[1] for r in res]
            d2[i] = [r[0] ** 2 for r in res]
        p_cond = _binary_search_betas(d2, min(self.perplexity, k / 3.0))
        P = {}
        for i in range(n):
            for jj in range(k):
                j = int(rows[i, jj])
                v = p_cond[i, jj] / (2.0 * n)
                P[(i, j)] = P.get((i, j), 0.0) + v
                P[(j, i)] = P.get((j, i), 0.0) + v
        idx = np.array(list(P.keys()), np.int64)
        vals = np.array(list(P.values()))
        vals /= max(vals.sum(), 1e-12)
        return idx, np.maximum(vals, 1e-12)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        idx, pvals = self._sparse_input_p(x)
        rng = np.random.default_rng(self.seed)
        Y = rng.normal(0, 1e-4, (n, self.n_components))
        vel = np.zeros_like(Y)
        gains = np.ones_like(Y)
        self.kl_history = []
        for it in range(self.max_iter):
            exaggeration = (self.early_exaggeration
                            if it < self.exaggeration_iters else 1.0)
            # attraction over the sparse P
            diff = Y[idx[:, 0]] - Y[idx[:, 1]]
            qu = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            pos_f = np.zeros_like(Y)
            np.add.at(pos_f, idx[:, 0], (exaggeration * pvals * qu)[:, None]
                      * diff)
            # repulsion through the tree
            tree = SPTree.build(Y)
            neg_f = np.zeros_like(Y)
            sum_q = 0.0
            for i in range(n):
                f = np.zeros(self.n_components)
                sum_q += tree.compute_non_edge_forces(Y[i], self.theta, f)
                neg_f[i] = f
            # the exact step's factor 4, so learning_rate means the same
            grad = 4.0 * (pos_f - neg_f / max(sum_q, 1e-12))
            gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2,
                             gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = self._momentum(it) * vel - self.learning_rate * gains * grad
            Y = Y + vel
            Y = Y - Y.mean(axis=0, keepdims=True)
            if it % KL_EVERY == 0 or it == self.max_iter - 1:
                diffq = Y[idx[:, 0]] - Y[idx[:, 1]]
                qn = (1.0 / (1.0 + np.sum(diffq ** 2, 1))) / max(sum_q, 1e-12)
                self.kl_history.append(float(np.sum(
                    pvals * np.log(pvals / np.maximum(qn, 1e-12)))))
        self.Y_ = Y
        return self.Y_
