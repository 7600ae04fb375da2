"""ParagraphVectors (doc2vec), DBOW and DM, of the port (counterpart:
``deeplearning4j_tpu/nlp/paragraph_vectors.py`` — ``_dbow_step``,
``_dm_step``, ``_infer_dbow_step`` and ``ParagraphVectors``).

* DBOW: a document's vector is the input row that predicts each of its
  words along the word's Huffman path (:func:`dbow_step`).
* DM: the mean of a context window's word rows and the document's row
  predicts the centre word; the step goes back to both
  (:func:`dm_step`).
* ``infer_vector``: steps on one fresh document vector against a frozen
  syn1 (:func:`infer_dbow_step`).

The steps are XLA programs in the JAX package (no Pallas kernel); here
they are PyTorch ops in place on the tables (``index_select``,
``einsum``, ``index_add_``), over Word2Vec's ``_hs_path`` and
``ops/sgns.mean_scale``. ``fit_documents`` first co-trains the words
with ``Word2Vec.fit_tokens``, whose negative-sampling half runs K3
(``ops/sgns.sgns_step``) when ``negative > 0``. The document vectors, the
examples, their permutation and the learning rates come from the JAX
package's numpy stream in its order (the document vectors, then the word
co-training's own stream, then each phase's examples), so both packages
train on the same minibatches. Each phase's examples go to the device in
one copy; the batches are slices of it.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.text import (
    BasicLabelAwareIterator,
    LabelledDocument,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (
    MAX_EXP,
    Draw,
    Word2Vec,
    _hs_path,
    _pad_batch,
    mean_scale,
    packed_windows,
)


def dbow_step(docvecs, syn1, doc_ids, points, codes, mask, alpha):
    """One DBOW minibatch in place: the rows ``doc_ids`` [B] of
    ``docvecs`` predict the centre words whose paths are points/codes/mask
    [B, L]; syn1 learns along the paths, each document row moves by its
    neu1e over sqrt(its hits)."""
    neu1e = _hs_path(syn1, docvecs[doc_ids], points, codes, mask, alpha)
    d_live = (mask.sum(dim=1) > 0).float()  # f32, as in the JAX package
    d_scale = mean_scale(docvecs.shape[0], doc_ids, d_live)
    docvecs.index_add_(0, doc_ids, d_scale[:, None] * neu1e)
    return docvecs, syn1


def dm_step(syn0, syn1, docvecs, doc_ids, ctx_idx, ctx_mask, points, codes,
            mask, alpha):
    """One DM minibatch in place: (the live context rows ``ctx_idx`` [B, C]
    summed, plus the document row) / (live count + 1) predicts the centre
    word; neu1e goes to every live context row and to the document row."""
    cvecs = syn0[ctx_idx]                                 # [B, C, D]
    dvec = docvecs[doc_ids]                               # [B, D]
    denom = ctx_mask.sum(dim=1, keepdim=True) + 1.0
    l1 = ((cvecs * ctx_mask[..., None]).sum(dim=1) + dvec) / denom
    neu1e = _hs_path(syn1, l1, points, codes, mask, alpha)
    ctx_scale = mean_scale(syn0.shape[0], ctx_idx, ctx_mask)
    syn0.index_add_(0, ctx_idx.reshape(-1),
                    (neu1e[:, None, :] * ctx_scale[..., None])
                    .reshape(-1, l1.shape[1]))
    d_live = (mask.sum(dim=1) > 0).float()
    d_scale = mean_scale(docvecs.shape[0], doc_ids, d_live)
    docvecs.index_add_(0, doc_ids, d_scale[:, None] * neu1e)
    return syn0, syn1, docvecs


def infer_dbow_step(docvec, syn1, points, codes, mask, alpha):
    """One DBOW step of a single document vector ``docvec`` [1, D] in place
    against a frozen ``syn1`` (read, never written): every row of the
    padded sequence shares the vector, so its step is the rows' summed
    neu1e over sqrt(live rows)."""
    l1 = docvec[0]
    s1 = syn1[points]                                     # [B, L, D]
    dot = torch.einsum("d,bld->bl", l1, s1)
    live = mask * (dot.abs() < MAX_EXP)
    f = torch.sigmoid(dot)
    g = (1.0 - codes - f) * alpha * live
    n_live = torch.clamp_min((mask.sum(dim=1) > 0).sum(), 1)
    neu1e = torch.einsum("bl,bld->d", g, s1) / torch.sqrt(
        n_live.to(g.dtype))
    docvec[0] += neu1e
    return docvec


class ParagraphVectors(Word2Vec):
    """Word2Vec's options plus ``dm`` (False: DBOW). Documents are
    :class:`LabelledDocument` s; every distinct label gets a row of
    ``doc_vectors`` (numpy between fits). Runs on ``cuda`` unless
    ``device="cpu"``."""

    _INFER_PAD = 64  # infer_vector's sequence: padded or cut to this length

    def __init__(self, dm: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.dm = dm
        self.labels: List[str] = []
        self.doc_vectors: Optional[np.ndarray] = None
        self._frozen = None  # (the host syn1, its device tables)

    def config(self) -> dict:
        return dict(super().config(), dm=self.dm)

    @classmethod
    def from_arrays(cls, conf: dict, vocab_rows, arrays, device=None,
                    labels: Sequence[str] = ()) -> "ParagraphVectors":
        """Word2Vec.from_arrays plus the labels (in row order) and
        ``arrays["doc_vectors"]``: how a trained model crosses from the
        JAX package."""
        model = super().from_arrays(conf, vocab_rows, arrays, device=device)
        model.labels = list(labels)
        model.doc_vectors = np.array(arrays["doc_vectors"])
        return model

    # -- fitting ----------------------------------------------------------
    def fit_documents(self, documents: Iterable[LabelledDocument],
                      draw: Optional[Draw] = None) -> "ParagraphVectors":
        """Co-train the words (``fit_tokens``, ``draw`` passed through),
        then ``epochs * iterations`` phases of DBOW or DM over the
        documents. ``fit_stats`` holds the co-training's stats under
        ``"words"`` and the document phases' under ``"docs"``."""
        docs = list(documents)
        per_doc = [self._tokenize_corpus([d.content]) for d in docs]
        token_sequences = [t[0] for t in per_doc if t]
        if self.vocab is None:
            self.build_vocab(token_sequences)
        self._counts = np.array(
            [wd.count for wd in self.vocab.vocab_words()], np.float64)
        self.labels = list(dict.fromkeys(l for d in docs for l in d.labels))
        label_to_id = {l: i for i, l in enumerate(self.labels)}
        rng = np.random.default_rng(self.seed)
        self.doc_vectors = (
            (rng.random((len(self.labels), self.layer_size)) - 0.5)
            / self.layer_size).astype(np.float32)

        super().fit_tokens(token_sequences, draw=draw)
        words = self.fit_stats
        lt = self.lookup_table
        doc_seqs = [(self._sequences_as_indices(t),
                     [label_to_id[l] for l in d.labels])
                    for t, d in zip(per_doc, docs)]
        doc_seqs = [(s[0], ids) for s, ids in doc_seqs if s]

        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        P, C, M = lt.huffman_tensors()
        P, C, M = up(P.astype(np.int64)), up(C), up(M)
        docvecs, syn0, syn1 = (up(a) for a in (self.doc_vectors, lt.syn0,
                                               lt.syn1))
        B = self.batch_size
        n_phases = max(1, self.epochs * self.iterations)
        stats = {"examples": 0, "batches": 0, "assembly_s": 0.0,
                 "loop_s": 0.0}
        for phase in range(n_phases):
            t0 = time.perf_counter()
            cols = (self._dm_examples(doc_seqs, rng) if self.dm
                    else self._dbow_pairs(doc_seqs, rng))
            n = len(cols[0])
            nb = max(1, -(-n // B))
            t1 = time.perf_counter()
            stats["assembly_s"] += t1 - t0
            stats["examples"] += n
            if n == 0:
                continue
            stats["batches"] += nb
            # the last batch padded with its first example (mask 0)
            cols = [np.concatenate([c[:(nb - 1) * B],
                                    _pad_batch(c[(nb - 1) * B:], B)])
                    for c in cols]
            d_ids, cen = up(cols[0].astype(np.int64)), up(
                cols[1].astype(np.int64))
            plive = up((np.arange(nb * B) < n).astype(np.float32))
            alphas = torch.tensor([self._alpha(phase, bi, n_phases, nb)
                                   for bi in range(nb)],
                                  dtype=torch.float32).to(dev)
            if self.dm:
                ctx, cmask = up(cols[2].astype(np.int64)), up(cols[3])
            for bi in range(nb):
                sl = slice(bi * B, (bi + 1) * B)
                c, pl = cen[sl], plive[sl, None]
                if self.dm:
                    dm_step(syn0, syn1, docvecs, d_ids[sl], ctx[sl],
                            cmask[sl] * pl, P[c], C[c], M[c] * pl,
                            alphas[bi])
                else:
                    dbow_step(docvecs, syn1, d_ids[sl], P[c], C[c],
                              M[c] * pl, alphas[bi])
            stats["loop_s"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        self.doc_vectors = docvecs.cpu().numpy()
        lt.syn0 = syn0.cpu().numpy()
        lt.syn1 = syn1.cpu().numpy()
        stats["loop_s"] += time.perf_counter() - t1
        self._frozen = None
        self.fit_stats = {"words": words, "docs": stats}
        return self

    def fit_labelled(self, sentences: Sequence[str],
                     labels: Optional[Sequence[str]] = None):
        return self.fit_documents(BasicLabelAwareIterator(sentences, labels))

    def _dbow_pairs(self, doc_seqs, rng):
        """(label id, word) of every word of every document (after
        subsampling), document by document, label by label, permuted."""
        d_ids, centers = [], []
        for idx, ids in doc_seqs:
            seq = self._subsample(idx, rng)
            for li in ids:
                d_ids.append(np.full(len(seq), li, np.int32))
                centers.append(seq)
        if not centers:
            return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
        d_ids, centers = np.concatenate(d_ids), np.concatenate(centers)
        order = rng.permutation(len(centers))
        return d_ids[order], centers[order].astype(np.int32)

    def _dm_examples(self, doc_seqs, rng):
        """(label id, centre, context window padded to 2w, its mask) of
        every position of every document, with the random shrink b ~ U[0,
        w) drawn per position (one draw even for an empty document),
        document by document, label by label, permuted."""
        w = self.window
        width = 2 * w
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
        d_ids, centers, ctx, cmask = [], [], [], []
        for idx, ids in doc_seqs:
            seq = self._subsample(idx, rng)
            n = len(seq)
            bs = rng.integers(0, w, size=max(1, n))[:n]
            pos = np.arange(n)[:, None] + offs[None, :]
            live = ((np.abs(offs)[None, :] <= (w - bs)[:, None])
                    & (pos >= 0) & (pos < n))
            row, m = packed_windows(seq, pos, live, width)
            for li in ids:
                d_ids.append(np.full(n, li, np.int32))
                centers.append(seq)
                ctx.append(row)
                cmask.append(m)
        if not centers:
            z = np.zeros((0, width), np.int32)
            return (np.zeros((0,), np.int32), np.zeros((0,), np.int32), z,
                    z.astype(np.float32))
        cols = [np.concatenate(a) for a in (d_ids, centers, ctx, cmask)]
        order = rng.permutation(len(cols[1]))
        return tuple(a[order] for a in cols)

    # -- queries ----------------------------------------------------------
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        try:
            return self.doc_vectors[self.labels.index(label)]
        except ValueError:
            return None

    def similarity_to_label(self, label1: str, label2: str) -> float:
        v1, v2 = self.doc_vector(label1), self.doc_vector(label2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = float(np.linalg.norm(v1) * np.linalg.norm(v2)) or 1.0
        return float(np.dot(v1, v2) / denom)

    def _frozen_tables(self):
        """syn1 and the Huffman tensors on the device, made once per
        trained syn1."""
        lt = self.lookup_table
        if self._frozen is None or self._frozen[0] is not lt.syn1:
            up = lambda a: torch.tensor(a, device=self.device)  # a copy
            P, C, M = lt.huffman_tensors()
            self._frozen = (lt.syn1, (up(lt.syn1), up(P.astype(np.int64)),
                                      up(C), up(M)))
        return self._frozen[1]

    def infer_vector(self, text: str, steps: int = 10) -> np.ndarray:
        """Train one fresh document vector ([D] numpy) against the frozen
        syn1; the text's first ``_INFER_PAD`` words, padded to that
        length."""
        idx = self._sequences_as_indices(self._tokenize_corpus([text]))
        rng = np.random.default_rng(self.seed)
        vec = ((rng.random((1, self.layer_size)) - 0.5)
               / self.layer_size).astype(np.float32)
        if not idx or not len(idx[0]):
            return vec[0]
        syn1, P, C, M = self._frozen_tables()
        seq = idx[0][:self._INFER_PAD]
        n = len(seq)
        seq = torch.from_numpy(
            _pad_batch(seq, self._INFER_PAD).astype(np.int64)).to(self.device)
        live = (torch.arange(self._INFER_PAD, device=self.device) < n).to(
            M.dtype)
        points, codes, mask = P[seq], C[seq], M[seq] * live[:, None]
        docvec = torch.from_numpy(vec).to(self.device)
        for step in range(steps):
            alpha = max(self.min_learning_rate,
                        self.learning_rate * (1.0 - step / max(1, steps)))
            infer_dbow_step(docvec, syn1, points, codes, mask,
                            float(torch.tensor(alpha, dtype=torch.float32)))
        return docvec.cpu().numpy()[0]

    def nearest_labels(self, text_or_vec, top_n: int = 5) -> List[str]:
        v = (self.infer_vector(text_or_vec) if isinstance(text_or_vec, str)
             else np.asarray(text_or_vec, np.float32))
        norms = np.linalg.norm(self.doc_vectors, axis=1)
        norms = np.where(norms == 0, 1.0, norms)
        sims = self.doc_vectors @ v / (norms * (np.linalg.norm(v) or 1.0))
        order = np.argsort(-sims)[:top_n]
        return [self.labels[int(i)] for i in order]
