"""Word2Vec skip-gram and CBOW training of the port (counterpart:
``deeplearning4j_tpu/nlp/word2vec.py`` — ``MAX_EXP``, ``_hs_body``,
``_cbow_body``, ``_skipgram_epoch``, ``_cbow_epoch`` and ``Word2Vec``).

One skip-gram minibatch is :func:`skipgram_step`, in place on syn0, syn1
and syn1neg:

* hierarchical softmax on every batch (:func:`hs_body`: ``index_select``,
  ``einsum`` and ``index_add_``, XLA work in the JAX package as here);
* then, when ``negative > 0``, negative sampling on the syn0 that HS left,
  through ``ops/sgns.sgns_step``: the hand-written kernel K3 on the card,
  its plain version on the CPU;
* CBOW runs HS only (:func:`cbow_body`).

The JAX package runs each chunk of minibatches as one jitted
``lax.scan``. On the CPU the port loops over :func:`skipgram_step` in
Python (:func:`skipgram_batches`). On the card a Python loop of ~30 eager
launches a batch is bound by the host, so ``fit_tokens`` runs each chunk
as one CUDA graph replay (:class:`SkipgramGraphs`), the counterpart of the
scan; CBOW stays an eager loop.

The vocabulary, Huffman tree, pairs, their permutation, the padding of the
last batch (``pair_live = 0``) and the learning rate of each batch are the
JAX package's, drawn from the same numpy stream, so both packages train on
the same minibatches in the same order. Negatives are drawn on the device:
the JAX package with ``jax.random``, the port with a ``torch.Generator``
seeded from ``seed``. ``fit_tokens`` takes a ``draw`` callable instead,
which is how a test replays the JAX draws (:func:`replay_draw` replays
fixed negatives on the card). The tables, the Huffman tensors and the
unigram table stay on the device for the whole fit; only the pairs go up,
one chunk of batches per copy.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.text import (
    DefaultTokenizerFactory,
    common_preprocessor,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.sgns import (
    MAX_EXP,
    mean_scale,
    reserve,
    sgns_step,
)

CHUNK_BATCHES = 128  # minibatches per host -> device copy, and per graph

# draw(global batch index) -> [B, K] int64 negatives on the tables' device;
# the index is an int in an eager loop and a 0-d int64 tensor on the card
# inside a captured chunk
Draw = Callable[[Union[int, torch.Tensor]], torch.Tensor]


def _hs_path(syn1, l1, points, codes, mask, alpha):
    """The HS update of syn1 along each example's Huffman path, in place,
    from the inputs ``l1`` [B, D]; points/codes/mask [B, L] (mask 0 pads
    the path and dead examples). Dots with |dot| >= MAX_EXP update
    nothing. Returns neu1e [B, D], the step for the input rows."""
    s1 = syn1[points]                                     # [B, L, D]
    dot = torch.einsum("bd,bld->bl", l1, s1)
    live = mask * (dot.abs() < MAX_EXP)
    f = torch.sigmoid(dot)
    g = (1.0 - codes - f) * alpha * live                  # [B, L]
    neu1e = torch.einsum("bl,bld->bd", g, s1)
    s1_scale = mean_scale(syn1.shape[0], points, live)
    syn1.index_add_(0, points.reshape(-1),
                    ((g * s1_scale)[..., None] * l1[:, None, :])
                    .reshape(-1, l1.shape[1]))
    return neu1e


def hs_body(syn0, syn1, contexts, points, codes, mask, alpha):
    """One minibatch of hierarchical-softmax skip-gram pairs, in place:
    ``contexts`` [B] are the syn0 rows updated, points/codes/mask [B, L]
    the Huffman paths of the center words."""
    neu1e = _hs_path(syn1, syn0[contexts], points, codes, mask, alpha)
    ctx_live = (mask.sum(dim=1) > 0).float()  # f32, as in the JAX package
    ctx_scale = mean_scale(syn0.shape[0], contexts, ctx_live)
    syn0.index_add_(0, contexts, ctx_scale[:, None] * neu1e)
    return syn0, syn1


def cbow_body(syn0, syn1, ctx_idx, ctx_mask, points, codes, mask, alpha):
    """One minibatch of HS CBOW examples, in place: the input is the mean
    of the live context rows ``ctx_idx`` [B, C], the path the center
    word's; neu1e goes to every live context row."""
    cvecs = syn0[ctx_idx]                                 # [B, C, D]
    denom = torch.clamp_min(ctx_mask.sum(dim=1, keepdim=True), 1.0)
    l1 = (cvecs * ctx_mask[..., None]).sum(dim=1) / denom
    neu1e = _hs_path(syn1, l1, points, codes, mask, alpha)
    ctx_scale = mean_scale(syn0.shape[0], ctx_idx, ctx_mask)
    upd = neu1e[:, None, :] * ctx_scale[..., None]        # [B, C, D]
    syn0.index_add_(0, ctx_idx.reshape(-1), upd.reshape(-1, l1.shape[1]))
    return syn0, syn1


def ns_constants(batch: int, negative: int, dtype, device):
    """The NS step's labels [B, K+1] (1 in column 0, the centre word) and
    the centre's liveness column [B, 1] of ones."""
    labels = torch.zeros((batch, negative + 1), dtype=dtype, device=device)
    labels[:, 0] = 1.0
    return labels, torch.ones((batch, 1), dtype=dtype, device=device)


def skipgram_step(tables, huffman, cen, cx, pl, alpha, negatives=None,
                  labels=None, ones=None, ns_step=sgns_step) -> None:
    """One skip-gram minibatch, in place (the body of ``_skipgram_epoch``'s
    scan): HS along the Huffman paths of the centre words ``cen`` [B] for
    the syn0 rows ``cx`` [B]; then, with ``negatives`` [B, K], the NS step
    ``ns_step`` (``sgns_step``, or a plain version to compare against) on
    the targets [cen, negatives], a negative equal to its centre dead.
    ``pl`` [B] is the pairs' liveness, ``alpha`` the batch's rate (a 0-d
    tensor or a float), ``labels`` and ``ones`` from :func:`ns_constants`."""
    syn0, syn1, syn1neg = tables
    P, C, M = huffman
    hs_body(syn0, syn1, cx, P[cen], C[cen], M[cen] * pl[:, None], alpha)
    if negatives is not None:
        tgt = torch.cat([cen[:, None], negatives], dim=1)
        live = torch.cat([ones, (negatives != cen[:, None]).to(syn0.dtype)],
                         dim=1) * pl[:, None]
        ns_step(syn0, syn1neg, cx, tgt, labels, live, alpha)


def skipgram_batches(tables, huffman, cens, cxs, plive, alphas, *,
                     negative: int = 0, draw: Optional[Draw] = None,
                     first_index: int = 0, ns_step=sgns_step) -> None:
    """Train on stacked skip-gram minibatches, in place, in an eager loop
    of :func:`skipgram_step` (the body of ``_skipgram_epoch``; the CPU's
    path, and on the card the reference a graph replay is held to).
    ``tables`` = (syn0, syn1, syn1neg), ``huffman`` = (P, C, M) [V, L];
    cens/cxs [NB, B] int64, plive [NB, B] and alphas [NB], all on the
    tables' device. Batch j draws its negatives with ``draw(first_index +
    j)`` -> [B, negative] words."""
    syn0 = tables[0]
    consts = (ns_constants(cens.shape[1], negative, syn0.dtype, syn0.device)
              if negative > 0 else (None, None))
    for j in range(cens.shape[0]):
        negatives = draw(first_index + j) if negative > 0 else None
        skipgram_step(tables, huffman, cens[j], cxs[j], plive[j], alphas[j],
                      negatives, *consts, ns_step=ns_step)


class SkipgramGraphs:
    """The card's skip-gram loop, the counterpart of ``_skipgram_epoch``'s
    one ``lax.scan`` per chunk: a chunk of n batches runs as one CUDA graph
    replay of n :func:`skipgram_step` calls. Each chunk length is captured
    once, the first time it comes (``CHUNK_BATCHES``, and the shorter last
    chunk of a phase), into graphs that share one memory pool; :meth:`run`
    copies a chunk's pairs, liveness, rates and global batch indices into
    the graph's static buffers and replays it.

    The draw is captured as it is. It is called with the batch index as a
    0-d int64 tensor on the card (:func:`replay_draw` reads fixed negatives
    by it); a generator it carries as ``draw.generator``
    (:func:`unigram_draw`) is registered with every graph, so each replay
    advances it as the eager loop would and draws the same negatives.
    Replays run K3's kernels without its Python wrapper, so :meth:`run`
    adds the K3 calls captured in the chunk to ``sgns_step.launches``. No
    fallback: a failed capture raises."""

    def __init__(self, tables, huffman, batch: int, negative: int = 0,
                 draw: Optional[Draw] = None):
        self.tables, self.huffman = tables, huffman
        self.device = tables[0].device
        self.batch, self.negative, self.draw = batch, negative, draw
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: dict = {}
        self._pool = None
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def run(self, cens, cxs, plive, alphas, first_index: int = 0) -> None:
        """Train on one chunk: cens/cxs [n, B] int64, plive [n, B], alphas
        [n] (host or device tensors), batch j the global batch
        ``first_index + j``."""
        n = cens.shape[0]
        if n not in self._graphs:
            self._graphs[n] = self._capture(n)
        graph, bufs, k3_calls = self._graphs[n]
        index = torch.arange(first_index, first_index + n)
        for buf, src in zip(bufs, (cens, cxs, plive, alphas, index)):
            buf.copy_(src)
        graph.replay()
        self.replays += 1
        sgns_step.launches += k3_calls

    def _capture(self, n: int):
        t0 = time.perf_counter()
        dev, dtype = self.device, self.tables[0].dtype
        bufs = (torch.zeros((n, self.batch), dtype=torch.int64, device=dev),
                torch.zeros((n, self.batch), dtype=torch.int64, device=dev),
                torch.zeros((n, self.batch), dtype=dtype, device=dev),
                torch.zeros((n,), dtype=dtype, device=dev),
                torch.zeros((n,), dtype=torch.int64, device=dev))
        if not self._graphs:
            self._warm_up()
        graph = torch.cuda.CUDAGraph()
        gen = getattr(self.draw, "generator", None)
        if gen is not None:
            graph.register_generator_state(gen)
        captured = sgns_step.captured
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
            self._chunk(*bufs)
        self._pool = graph.pool()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, bufs, sgns_step.captured - captured

    def _chunk(self, cens, cxs, plive, alphas, index) -> None:
        syn0 = self.tables[0]
        consts = (ns_constants(self.batch, self.negative, syn0.dtype,
                               self.device)
                  if self.negative else (None, None))
        for j in range(cens.shape[0]):
            negatives = self.draw(index[j]) if self.negative else None
            skipgram_step(self.tables, self.huffman, cens[j], cxs[j],
                          plive[j], alphas[j], negatives, *consts)

    def _warm_up(self) -> None:
        """Before the first capture, on the capture stream: K3 readied
        there (``ops.sgns.reserve``: its scratch, its kernels loaded), and
        the PyTorch ops of one batch of the same shapes run on one-row
        scratch tables with every pair dead, so every kernel and library
        handle a capture meets exists already. K3 itself does not run (its
        launch counter counts the fit's batches only), and no table, draw
        or generator of the fit is touched."""
        dev, b = self.device, self.batch
        syn0, (P, C, M) = self.tables[0], self.huffman
        d, width = syn0.shape[1], P.shape[1]
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            tables = tuple(torch.zeros((1, d), dtype=syn0.dtype, device=dev)
                           for _ in range(3))
            huffman = tuple(torch.zeros((1, width), dtype=x.dtype, device=dev)
                            for x in (P, C, M))
            rows = torch.zeros((b,), dtype=torch.int64, device=dev)
            dead = torch.zeros((b,), dtype=syn0.dtype, device=dev)
            negatives, consts = None, (None, None)
            if self.negative:
                reserve(dev, syn0.shape[0], d, b, self.negative + 1)
                negatives = torch.zeros((b, self.negative), dtype=torch.int64,
                                        device=dev)
                consts = ns_constants(b, self.negative, syn0.dtype, dev)
            skipgram_step(tables, huffman, rows, rows, dead, dead[0],
                          negatives, *consts, ns_step=lambda *args: None)
        torch.cuda.current_stream(dev).wait_stream(self.stream)


def cbow_batches(tables, huffman, cens, ctxs, cmasks, plive, alphas) -> None:
    """Train on stacked CBOW minibatches, in place (the body of
    ``_cbow_epoch``); ctxs/cmasks are [NB, B, 2w]."""
    syn0, syn1 = tables
    P, C, M = huffman
    for j in range(cens.shape[0]):
        cen, pl = cens[j], plive[j]
        cbow_body(syn0, syn1, ctxs[j], cmasks[j] * pl[:, None], P[cen],
                  C[cen], M[cen] * pl[:, None], alphas[j])


def unigram_draw(table: torch.Tensor, negative: int, batch: int,
                 gen: torch.Generator) -> Draw:
    """Negatives from the device-resident unigram table: ``randint(0,
    table_size)`` with ``gen`` on the table's device, then a lookup."""
    def draw(_batch_index) -> torch.Tensor:
        idx = torch.randint(0, table.shape[0], (batch, negative),
                            generator=gen, device=table.device)
        return table[idx]
    draw.generator = gen  # registered with the graphs that capture it
    return draw


def replay_draw(negatives: torch.Tensor) -> Draw:
    """A draw of fixed negatives [N, B, K] by global batch index: an int
    in an eager loop, a 0-d int64 tensor on the card in a captured chunk
    (read on the device, so each replay takes its own batches')."""
    def draw(index) -> torch.Tensor:
        if isinstance(index, torch.Tensor):
            return negatives.index_select(0, index.reshape(1))[0]
        return negatives[index]
    return draw


class Word2Vec:
    """Word2Vec with DL4J's options: layer_size, window,
    min_word_frequency, learning_rate / min_learning_rate, epochs,
    iterations, negative, sampling, seed, batch_size, use_cbow. Runs on
    ``cuda`` unless ``device="cpu"``; ``mesh`` / ``num_workers`` (data
    parallel training) are not ported yet."""

    def __init__(
        self,
        layer_size: int = 100,
        window: int = 5,
        min_word_frequency: int = 1,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        epochs: int = 1,
        iterations: int = 1,
        negative: int = 0,
        sampling: float = 0.0,
        seed: int = 123,
        batch_size: int = 2048,
        use_cbow: bool = False,
        tokenizer: Optional[DefaultTokenizerFactory] = None,
        stop_words: Sequence[str] = (),
        num_workers: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        if mesh is not None or num_workers is not None:
            raise NotImplementedError(
                "Word2Vec: data-parallel training (mesh / num_workers) is "
                "not ported yet")
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.iterations = iterations
        self.negative = negative
        self.sampling = sampling
        self.seed = seed
        self.batch_size = batch_size
        self.use_cbow = use_cbow
        self.tokenizer = tokenizer or DefaultTokenizerFactory(common_preprocessor)
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        # the last fit: examples (pairs, or CBOW windows) and minibatches
        # over all phases, host seconds of their assembly, and seconds of
        # the batch loop up to the tables' copy back (which waits for the
        # device); on the card also the skip-gram graphs captured, their
        # capture seconds (in the loop's) and their replays
        self.fit_stats: dict = {}

    def config(self) -> dict:
        """The constructor arguments a saved model records."""
        return {k: getattr(self, k) for k in (
            "layer_size", "window", "min_word_frequency", "learning_rate",
            "min_learning_rate", "epochs", "iterations", "negative",
            "sampling", "seed", "use_cbow")}

    @classmethod
    def from_arrays(cls, conf: dict, vocab_rows, arrays, device=None
                    ) -> "Word2Vec":
        """A model from a configuration (``config()``'s keys), vocabulary
        rows (``{"word", "count", "codes", "points"}`` in index order) and
        numpy tables (``syn0``, ``syn1``, and ``syn1neg`` when trained with
        negatives): how weights cross from the JAX package."""
        model = cls(**conf, device=device)
        vocab = VocabCache()
        for row in vocab_rows:
            vocab.add_token(row["word"], row["count"])
        vocab.finalize_vocab(1)
        vocab.set_order([r["word"] for r in vocab_rows])
        for r in vocab_rows:
            vw = vocab.word_for(r["word"])
            vw.codes = list(r["codes"])
            vw.points = list(r["points"])
        model.vocab = vocab
        lt = InMemoryLookupTable(vocab, conf["layer_size"], seed=conf["seed"],
                                 negative=conf["negative"])
        lt.syn0 = np.asarray(arrays["syn0"])
        lt.syn1 = np.asarray(arrays["syn1"])
        if "syn1neg" in arrays:
            lt.syn1neg = np.asarray(arrays["syn1neg"])
        model.lookup_table = lt
        return model

    # -- vocab ------------------------------------------------------------
    def _tokenize_corpus(self, sentences: Iterable[str]) -> List[List[str]]:
        out = []
        for s in sentences:
            toks = [t for t in self.tokenizer.tokenize(s) if t not in self.stop_words]
            if toks:
                out.append(toks)
        return out

    def build_vocab(self, token_sequences: Sequence[Sequence[str]]) -> VocabCache:
        self.vocab = VocabConstructor(self.min_word_frequency).build(token_sequences)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            negative=self.negative)
        return self.vocab

    # -- pair assembly (host side) ---------------------------------------
    def _sequences_as_indices(self, token_sequences) -> List[np.ndarray]:
        index_of = self.vocab.index_of
        seqs = []
        for toks in token_sequences:
            idx = np.fromiter((index_of(t) for t in toks), np.int32,
                              len(toks))
            idx = idx[idx >= 0]
            if idx.size:
                seqs.append(idx)
        return seqs

    def _subsample(self, seq: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Frequent-word subsampling: keep with probability
        (sqrt(f / (s N)) + 1) s N / f."""
        if self.sampling <= 0:
            return seq
        counts = self._counts[seq]
        total = self.vocab.total_word_occurrences
        s = self.sampling
        ran = (np.sqrt(counts / (s * total)) + 1.0) * (s * total) / counts
        keep = ran >= rng.random(seq.shape)
        return seq[keep]

    def _windows(self, seqs, rng):
        """Per sequence (subsampled, at least 2 words): the sequence and a
        [n, 2w] mask of its live context offsets -w..-1, 1..w after the
        random window shrink b ~ U[0, w)."""
        w = self.window
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
        for seq in seqs:
            seq = self._subsample(seq, rng)
            n = len(seq)
            if n < 2:
                continue
            bs = rng.integers(0, w, size=n)
            pos = np.arange(n)[:, None] + offs[None, :]
            live = ((np.abs(offs)[None, :] <= (w - bs)[:, None])
                    & (pos >= 0) & (pos < n))
            yield seq, pos, live

    def _make_pairs(self, seqs: List[np.ndarray], rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """All (center, context) skip-gram pairs, center by center, each
        center's contexts left to right (the JAX package's order)."""
        centers, contexts = [], []
        for seq, pos, live in self._windows(seqs, rng):
            rows = np.nonzero(live)
            centers.append(seq[rows[0]])
            contexts.append(seq[pos[rows]])
        if not centers:
            return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
        return (np.concatenate(centers).astype(np.int32),
                np.concatenate(contexts).astype(np.int32))

    def _make_cbow_batches(self, seqs, rng):
        """(center, context window padded to 2w, its mask) examples."""
        width = 2 * self.window
        centers, ctx, cmask = [], [], []
        for seq, pos, live in self._windows(seqs, rng):
            keep = live.any(axis=1)
            live, pos = live[keep], pos[keep]
            slot = np.cumsum(live, axis=1) - 1
            row = np.zeros((len(live), width), np.int32)
            r, c = np.nonzero(live)
            row[r, slot[r, c]] = seq[pos[r, c]]
            centers.append(seq[keep])
            ctx.append(row)
            cmask.append((np.arange(width)[None, :]
                          < live.sum(axis=1)[:, None]).astype(np.float32))
        if not centers:
            z = np.zeros((0, width), np.int32)
            return np.zeros((0,), np.int32), z, z.astype(np.float32)
        return (np.concatenate(centers).astype(np.int32),
                np.concatenate(ctx), np.concatenate(cmask))

    # -- training ---------------------------------------------------------
    def fit(self, sentences: Iterable[str]) -> "Word2Vec":
        return self.fit_tokens(self._tokenize_corpus(sentences))

    def fit_tokens(self, token_sequences: Sequence[Sequence[str]],
                   draw: Optional[Draw] = None) -> "Word2Vec":
        """Train on tokenized sentences. ``draw(global_batch_index)`` ->
        int64 [batch_size, negative] words on the device replaces the
        generator's negatives (the global index counts batches across
        epochs: phase * batches_per_phase + batch; on the card a 0-d int64
        tensor, see :func:`replay_draw`). On the card the skip-gram chunks
        run as CUDA graph replays (:class:`SkipgramGraphs`)."""
        if self.vocab is None:
            self.build_vocab(token_sequences)
        lt = self.lookup_table
        dev = self.device
        self._counts = np.array(
            [wd.count for wd in self.vocab.vocab_words()], np.float64)
        seqs = self._sequences_as_indices(token_sequences)
        rng = np.random.default_rng(self.seed)

        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        P, C, M = lt.huffman_tensors()
        huffman = (up(P.astype(np.int64)), up(C), up(M))
        syn0, syn1 = up(lt.syn0), up(lt.syn1)
        use_neg = self.negative > 0 and lt.syn1neg is not None
        syn1neg = up(lt.syn1neg) if use_neg else None
        B = self.batch_size
        if use_neg and draw is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            draw = unigram_draw(up(lt.table.astype(np.int64)), self.negative,
                                B, gen)
        graphs = None
        if dev.type == "cuda" and not self.use_cbow:
            graphs = SkipgramGraphs((syn0, syn1, syn1neg), huffman, B,
                                    self.negative if use_neg else 0, draw)
        n_phases = max(1, self.epochs * self.iterations)
        stats = {"examples": 0, "batches": 0, "assembly_s": 0.0,
                 "loop_s": 0.0}
        for phase in range(n_phases):
            t0 = time.perf_counter()
            if self.use_cbow:
                centers, ctx, cmask = self._make_cbow_batches(seqs, rng)
                order = rng.permutation(len(centers))
                cols = (centers[order], ctx[order], cmask[order])
            else:
                centers, contexts = self._make_pairs(seqs, rng)
                order = rng.permutation(len(centers))
                cols = (centers[order], contexts[order])
            n_ex = len(centers)
            nb = max(1, -(-n_ex // B))
            t1 = time.perf_counter()
            stats["assembly_s"] += t1 - t0
            stats["examples"] += n_ex
            stats["batches"] += nb
            alphas = torch.from_numpy(np.array(
                [self._alpha(phase, bi, n_phases, nb) for bi in range(nb)],
                np.float32))
            for s0 in range(0, nb, CHUNK_BATCHES):
                s1 = min(s0 + CHUNK_BATCHES, nb)
                chunk = s1 - s0
                sl = slice(s0 * B, s1 * B)
                ex = [_pad_rows(c[sl], chunk * B) for c in cols]
                plive = (np.arange(s0 * B, s1 * B) < n_ex).astype(np.float32)
                cen = torch.from_numpy(
                    ex[0].astype(np.int64).reshape(chunk, B))
                pl = torch.from_numpy(plive.reshape(chunk, B))
                if self.use_cbow:
                    cbow_batches(
                        (syn0, syn1), huffman, cen.to(dev),
                        up(ex[1].astype(np.int64).reshape(chunk, B, -1)),
                        up(ex[2].reshape(chunk, B, -1)), pl.to(dev),
                        alphas[s0:s1].to(dev))
                    continue
                cx = torch.from_numpy(
                    ex[1].astype(np.int64).reshape(chunk, B))
                if graphs is not None:  # copied into the graph's buffers
                    graphs.run(cen, cx, pl, alphas[s0:s1], phase * nb + s0)
                else:
                    skipgram_batches(
                        (syn0, syn1, syn1neg), huffman, cen.to(dev),
                        cx.to(dev), pl.to(dev), alphas[s0:s1].to(dev),
                        negative=self.negative if use_neg else 0, draw=draw,
                        first_index=phase * nb + s0)
            stats["loop_s"] += time.perf_counter() - t1

        t1 = time.perf_counter()
        lt.syn0 = syn0.cpu().numpy()
        lt.syn1 = syn1.cpu().numpy()
        if use_neg:
            lt.syn1neg = syn1neg.cpu().numpy()
        stats["loop_s"] += time.perf_counter() - t1
        if graphs is not None:
            stats.update(graph_captures=graphs.captures,
                         graph_capture_s=graphs.capture_s,
                         graph_replays=graphs.replays)
        self.fit_stats = stats
        return self

    def _alpha(self, phase, bi, n_phases, nb) -> float:
        progress = (phase * nb + bi) / max(1, n_phases * nb)
        return max(self.min_learning_rate,
                   self.learning_rate * (1.0 - progress))

    # -- queries ----------------------------------------------------------
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word)

    def similarity(self, w1: str, w2: str) -> float:
        return self.lookup_table.similarity(w1, w2)

    def words_nearest(self, word, top_n: int = 10) -> List[str]:
        return self.lookup_table.words_nearest(word, top_n)

    def words_nearest_sum(self, positive, negative, top_n: int = 10) -> List[str]:
        return self.lookup_table.words_nearest_sum(positive, negative, top_n)

    def vocab_size(self) -> int:
        return 0 if self.vocab is None else self.vocab.num_words()


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis to n with zeros (dead rows: pair_live 0)."""
    if len(arr) == n:
        return arr
    pad = np.zeros((n - len(arr),) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)
