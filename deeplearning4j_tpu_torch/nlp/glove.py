"""GloVe of the port (counterpart: ``deeplearning4j_tpu/nlp/glove.py`` —
``_glove_step`` and ``Glove``): distance-weighted co-occurrence counts,
then AdaGrad on the weighted least squares w_i . w_j + b_i + b_j -
log X_ij, weighted by min(1, (X_ij / x_max)^alpha).

The counts are made on the host, vectorised: every (position, distance)
pair in scan order, keys ordered by first appearance (the insertion order
of the JAX package's dict) and X summed with ``np.bincount`` in scan
order, so keys, order and X are the JAX package's bit for bit. A
minibatch is :func:`glove_step`, in place on W, b and their AdaGrad
accumulators (an XLA program in the JAX package, no Pallas kernel;
PyTorch ops here). The pairs, X and each epoch's permutation go to the
device once; the batch losses are summed there in f64, in batch order
(the sum of the JAX package's ``float(loss)`` adds), and read once an
epoch.

Data parallelism (JAX: the pair batch sharded over a ``'data'`` mesh
axis, GSPMD summing the scatters): every rank runs the same fit, takes
its rows of each batch, and one all-reduce of the touched rows' sums
after each half of the step (the accumulators, then W and b) makes every
rank's tables the whole batch's update (:func:`glove_step_shards`).
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.text import (
    DefaultTokenizerFactory,
    common_preprocessor,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.nlp.word2vec import DataShards, Word2Vec
from deeplearning4j_tpu_torch.ops.device import resolve_device

_EPS = 1e-8


def _gradients(W, b, wi, wj, logx, fdiff, live):
    """(diff, f diff, dL/dw_i, dL/dw_j) of the pairs (wi, wj) at the
    stale rows."""
    vi, vj = W[wi], W[wj]
    pred = torch.einsum("bd,bd->b", vi, vj) + b[wi] + b[wj]
    diff = (pred - logx) * live
    wdiff = fdiff * diff
    return diff, wdiff, wdiff[:, None] * vj, wdiff[:, None] * vi


def glove_step(W, b, hW, hb, wi, wj, logx, fdiff, lr, live):
    """One AdaGrad minibatch of pairs (wi, wj) [B], in place on W [V, D],
    b [V] and the accumulators hW, hb: first both rows' squared gradients
    are added to the accumulators (duplicates accumulate), then W and b
    step by -lr g / (sqrt(h) + 1e-8) read from the accumulated h. Returns
    the batch's loss, 0.5 sum f (pred - log X)^2 (a 0-d tensor)."""
    diff, wdiff, gi, gj = _gradients(W, b, wi, wj, logx, fdiff, live)
    hW.index_add_(0, wi, gi * gi)
    hW.index_add_(0, wj, gj * gj)
    hb.index_add_(0, wi, wdiff * wdiff)
    hb.index_add_(0, wj, wdiff * wdiff)
    W.index_add_(0, wi, -lr * gi / (torch.sqrt(hW[wi]) + _EPS))
    W.index_add_(0, wj, -lr * gj / (torch.sqrt(hW[wj]) + _EPS))
    b.index_add_(0, wi, -lr * wdiff / (torch.sqrt(hb[wi]) + _EPS))
    b.index_add_(0, wj, -lr * wdiff / (torch.sqrt(hb[wj]) + _EPS))
    return 0.5 * torch.sum(fdiff * diff * diff)


def glove_step_shards(shards: DataShards, tables, wi, wj, logx, fdiff, lr,
                      live):
    """:func:`glove_step` of a whole minibatch over the ranks of
    ``shards``: each rank computes its rows' gradients; the touched rows'
    squared-gradient sums are all-reduced into the accumulators, then the
    rows' steps (and the loss) into W and b. Returns the batch's loss."""
    import torch.distributed as dist

    W, b, hW, hb = tables
    n = wi.shape[0]
    rows, inv = torch.unique(torch.cat([wi, wj]), return_inverse=True)
    r = shards.rows
    wi_r, wj_r, ii, jj = r(wi), r(wj), r(inv[:n]), r(inv[n:])
    diff, wdiff, gi, gj = _gradients(W, b, wi_r, wj_r, r(logx), r(fdiff),
                                     r(live))
    d = W.shape[1]

    def row_sums(pi, pj, si, sj):
        acc = torch.zeros((len(rows), d + 1), dtype=W.dtype, device=W.device)
        acc.index_add_(0, ii, torch.cat([pi, si[:, None]], dim=1))
        acc.index_add_(0, jj, torch.cat([pj, sj[:, None]], dim=1))
        return acc

    acc = row_sums(gi * gi, gj * gj, wdiff * wdiff, wdiff * wdiff)
    dist.all_reduce(acc, group=shards.group)
    hW.index_add_(0, rows, acc[:, :d])
    hb.index_add_(0, rows, acc[:, d])
    step = row_sums(-lr * gi / (torch.sqrt(hW[wi_r]) + _EPS),
                    -lr * gj / (torch.sqrt(hW[wj_r]) + _EPS),
                    -lr * wdiff / (torch.sqrt(hb[wi_r]) + _EPS),
                    -lr * wdiff / (torch.sqrt(hb[wj_r]) + _EPS))
    loss = torch.zeros((1, d + 1), dtype=W.dtype, device=W.device)
    loss[0, 0] = 0.5 * torch.sum(r(fdiff) * diff * diff)
    step = torch.cat([step, loss])
    dist.all_reduce(step, group=shards.group)
    W.index_add_(0, rows, step[:-1, :d])
    b.index_add_(0, rows, step[:-1, d])
    return step[-1, 0]


class Glove:
    """GloVe with DL4J's options: layer_size, learning_rate, x_max,
    alpha, epochs, min_word_frequency, window, symmetric, seed,
    batch_size. Runs on ``cuda`` unless ``device="cpu"``. ``mesh`` (the
    ``'data'`` process group, or a ``parallel/mesh.MeshGroups`` with that
    axis) and ``num_workers`` as in Word2Vec: every rank calls ``fit`` on
    the same corpus and ends with the same tables."""

    def __init__(
        self,
        layer_size: int = 100,
        learning_rate: float = 0.05,
        x_max: float = 100.0,
        alpha: float = 0.75,
        epochs: int = 5,
        min_word_frequency: int = 1,
        window: int = 15,
        symmetric: bool = True,
        seed: int = 123,
        batch_size: int = 4096,
        tokenizer: Optional[DefaultTokenizerFactory] = None,
        num_workers: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.epochs = epochs
        self.min_word_frequency = min_word_frequency
        self.window = window
        self.symmetric = symmetric
        self.seed = seed
        self.batch_size = batch_size
        self.tokenizer = tokenizer or DefaultTokenizerFactory(common_preprocessor)
        self.vocab: Optional[VocabCache] = None
        self.W: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None
        self.losses: List[float] = []
        self.mesh = None
        self._shards: Optional[DataShards] = None
        if mesh is not None or num_workers is not None:
            self.mesh = Word2Vec._data_group(mesh, num_workers)
            n = 1 if self.mesh is None else DataShards(self.mesh).world
            if self.batch_size % n != 0:
                raise ValueError(f"batch_size {self.batch_size} not "
                                 f"divisible by {n} data-parallel ranks")
            if n > 1:
                self._shards = DataShards(self.mesh)
        # the last fit: pairs, the count's host seconds, batches, the loop's
        # seconds up to the tables' copy back
        self.fit_stats: dict = {}

    def config(self) -> dict:
        """The constructor arguments a carried model records."""
        return {k: getattr(self, k) for k in (
            "layer_size", "learning_rate", "x_max", "alpha", "epochs",
            "min_word_frequency", "window", "symmetric", "seed",
            "batch_size")}

    @classmethod
    def from_arrays(cls, conf: dict, vocab_rows, arrays, device=None
                    ) -> "Glove":
        """A model from ``config()``'s keys, vocabulary rows (``{"word",
        "count"}`` in index order) and numpy ``W`` and ``bias``: how
        trained weights cross from the JAX package."""
        model = cls(**conf, device=device)
        vocab = VocabCache()
        for row in vocab_rows:
            vocab.add_token(row["word"], row["count"])
        vocab.finalize_vocab(1)
        vocab.set_order([r["word"] for r in vocab_rows])
        model.vocab = vocab
        model.W = np.asarray(arrays["W"])
        model.bias = np.asarray(arrays["bias"])
        return model

    # -- co-occurrences ---------------------------------------------------
    def _count_cooccurrences(self, seqs: List[np.ndarray]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [n, 2] int32, X [n] f64): every pair of distinct words at
        distance d <= window within a sequence adds 1/d to its key ((min,
        max) when symmetric); keys in order of first appearance."""
        w = self.window
        if not seqs:
            return np.zeros((0, 2), np.int32), np.zeros((0,), np.float64)
        flat = np.concatenate(seqs).astype(np.int64)
        lens = np.array([len(s) for s in seqs])
        ends = np.repeat(np.cumsum(lens), lens)
        dist = np.arange(1, w + 1)
        j = np.arange(len(flat))[:, None] + dist[None, :]
        valid = j < ends[:, None]
        a = np.broadcast_to(flat[:, None], j.shape)[valid]
        c = flat[j[valid]]
        d = np.broadcast_to(dist, j.shape)[valid]
        keep = a != c
        a, c, d = a[keep], c[keep], d[keep]
        if self.symmetric:
            a, c = np.minimum(a, c), np.maximum(a, c)
        v = max(1, int(flat.max()) + 1)
        keys, first, inv = np.unique(a * v + c, return_index=True,
                                     return_inverse=True)
        x = np.bincount(inv.reshape(-1), weights=1.0 / d,
                        minlength=len(keys))
        order = np.argsort(first, kind="stable")
        keys = keys[order]
        return (np.stack([keys // v, keys % v], axis=1).astype(np.int32),
                x[order])

    # -- training ---------------------------------------------------------
    def fit(self, sentences: Iterable[str]) -> "Glove":
        token_seqs = [t for t in (self.tokenizer.tokenize(s)
                                  for s in sentences) if t]
        self.vocab = VocabConstructor(
            self.min_word_frequency, build_huffman_tree=False
        ).build(token_seqs)
        index_of = self.vocab.index_of
        seqs = []
        for toks in token_seqs:
            idx = np.fromiter((index_of(t) for t in toks), np.int32,
                              len(toks))
            idx = idx[idx >= 0]
            if idx.size:
                seqs.append(idx)
        t0 = time.perf_counter()
        pairs, xs = self._count_cooccurrences(seqs)
        count_s = time.perf_counter() - t0
        if not len(pairs):
            raise ValueError("empty co-occurrence matrix — corpus too small")
        logx = np.log(xs).astype(np.float32)
        fdiff = np.minimum(1.0, (xs / self.x_max) ** self.alpha).astype(
            np.float32)

        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        tables = (up(((rng.random((V, D)) - 0.5) / D).astype(np.float32)),
                  up(np.zeros((V,), np.float32)),
                  up(np.full((V, D), 1e-8, np.float32)),
                  up(np.full((V,), 1e-8, np.float32)))
        pairs_d, logx_d, fdiff_d = up(pairs.astype(np.int64)), up(logx), \
            up(fdiff)
        lr = float(torch.tensor(self.learning_rate, dtype=torch.float32))
        B, n = self.batch_size, len(pairs)
        nb = -(-n // B)
        live = up((np.arange(nb * B) < n).astype(np.float32))
        self.losses = []
        t1 = time.perf_counter()
        for _epoch in range(self.epochs):
            order = rng.permutation(n)
            # the last batch padded with its first pair (live 0)
            sel = up(np.concatenate([order, np.repeat(
                order[(nb - 1) * B:][:1], nb * B - n)]).astype(np.int64))
            total = torch.zeros((), dtype=torch.float64, device=dev)
            for bi in range(nb):
                s = sel[bi * B:(bi + 1) * B]
                args = (pairs_d[s, 0], pairs_d[s, 1], logx_d[s], fdiff_d[s],
                        lr, live[bi * B:(bi + 1) * B])
                if self._shards is not None:
                    loss = glove_step_shards(self._shards, tables, *args)
                else:
                    loss = glove_step(*tables, *args)
                total += loss.double()
            self.losses.append(total.item() / n)
        self.W = tables[0].cpu().numpy()
        self.bias = tables[1].cpu().numpy()
        self.fit_stats = {"pairs": n, "count_s": count_s,
                          "batches": nb * self.epochs,
                          "loop_s": time.perf_counter() - t1}
        return self

    # -- queries ----------------------------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word) if self.vocab else -1
        return None if idx < 0 else self.W[idx]

    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.vector(w1), self.vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = float(np.linalg.norm(v1) * np.linalg.norm(v2)) or 1.0
        return float(np.dot(v1, v2) / denom)

    def words_nearest(self, word: str, top_n: int = 10) -> List[str]:
        v = self.vector(word)
        if v is None:
            return []
        norms = np.linalg.norm(self.W, axis=1)
        norms = np.where(norms == 0, 1.0, norms)
        sims = self.W @ v / (norms * (np.linalg.norm(v) or 1.0))
        out = []
        for i in np.argsort(-sims):
            cand = self.vocab.word_at_index(int(i))
            if cand != word:
                out.append(cand)
            if len(out) >= top_n:
                break
        return out
