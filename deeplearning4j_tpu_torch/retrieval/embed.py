"""Embedding adapters: one ``rows -> [N, dim] float32`` surface for
``/embed`` (counterpart: ``deeplearning4j_tpu/retrieval/embed.py`` —
``FeedForwardEmbedding``, ``BertEmbedding``, ``LookupEmbedding`` and
``resolve_adapter``).

Three adapter families, resolved by duck type (``resolve_adapter``):

- ``FeedForwardEmbedding``: a MultiLayerNetwork's or ComputationGraph's
  hidden activation through ``feed_forward``. ``layer`` is an int index
  into the MLN's activations (the input is 0; the default -2 is the last
  hidden layer, or ``DL4J_TPU_EMBED_LAYER``) or a vertex NAME of a graph
  (default: the vertex feeding the first output). Rows come back
  flattened to [N, -1].
- ``BertEmbedding``: ``BertMLM.embed_tokens`` (K5 on the card) pooled
  over the sequence axis by ``mean``, ``cls`` or ``max``
  (``DL4J_TPU_EMBED_POOL``).
- ``LookupEmbedding``: word2vec ``InMemoryLookupTable.vectors`` rows by
  token id.

``dim`` never runs the model. The JAX package abstract-evaluates the
MLN's forward (``jax.eval_shape``, :84-100) for the last axis of the
picked activation when the record has an input shape, and leaves a
graph's dim unknown until the first call; the port reads that last axis
from the activation shapes ``MultiLayerNetwork.init`` propagated (shape
arithmetic, no forward: K1's wrapper has no meta-device kernel), and a
graph's dim likewise waits for the first call. BERT's is ``d_model``,
the table's its vector length.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import env as envknob

_POOLS = ("mean", "cls", "max")


def _env_layer() -> Optional[int]:
    try:
        return int(envknob.raw("DL4J_TPU_EMBED_LAYER").strip())
    except ValueError:  # unset ('' default) or garbage: the adapter's
        return None


def _env_pool() -> str:
    pool = envknob.raw("DL4J_TPU_EMBED_POOL").strip()
    return pool if pool in _POOLS else "mean"


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


class FeedForwardEmbedding:
    """Hidden-layer encoder over MLN/CG ``feed_forward`` activations."""

    kind = "feedforward"

    def __init__(self, net: Any, layer=None,
                 input_shape: Optional[Sequence[int]] = None) -> None:
        self.net = net
        self._graph = hasattr(getattr(net, "conf", None), "vertex_inputs")
        if layer is None and not self._graph:
            layer = _env_layer()
        self.layer = self._default_layer() if layer is None else layer
        self._input_shape = tuple(input_shape) if input_shape else None
        self._dim: Optional[int] = self._aot_dim()

    def _default_layer(self):
        if self._graph:
            conf = self.net.conf
            return conf.vertex_inputs[conf.outputs[0]][0]
        return -2

    def _pick(self, acts):
        if self._graph:
            return acts[self.layer]
        idx = int(self.layer)
        if not (-len(acts) <= idx < len(acts)):
            raise ValueError(
                f"embed layer {idx} out of range for {len(acts)} activations")
        return acts[idx]

    def _aot_dim(self) -> Optional[int]:
        """The picked activation's last axis from the MLN's propagated
        shapes; None for a graph or without an input shape (as the JAX
        adapter answers)."""
        if self._input_shape is None or self._graph:
            return None
        shapes = getattr(self.net, "_act_shapes", None)
        try:
            return int(self._pick(shapes)[-1])
        except (TypeError, ValueError, IndexError):
            return None

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    def __call__(self, rows) -> np.ndarray:
        x = np.asarray(rows, np.float32)
        if self._graph:
            acts = self.net.feed_forward(x)
        else:
            acts = self.net.feed_forward(x, train=False)
        out = _host(self._pick(acts))
        out = out.reshape(out.shape[0], -1)
        if self._dim is None:
            self._dim = int(out.shape[-1])
        return out


class BertEmbedding:
    """Pooled contextual embeddings over ``BertMLM.embed_tokens``."""

    kind = "bert"

    def __init__(self, lm: Any, pool: Optional[str] = None) -> None:
        if pool is None:
            pool = _env_pool()
        if pool not in _POOLS:
            raise ValueError(f"pool must be one of {_POOLS}, got {pool!r}")
        self.lm = lm
        self.pool = pool
        self._dim = int(lm.cfg.d_model)

    @property
    def dim(self) -> int:
        return self._dim

    def __call__(self, rows) -> np.ndarray:
        tokens = np.asarray(rows)
        if tokens.dtype.kind == "f":
            tokens = np.rint(tokens)
        tokens = tokens.astype(np.int32)
        emb = np.asarray(self.lm.embed_tokens(tokens), np.float32)  # [N,T,d]
        if self.pool == "cls":
            return emb[:, 0, :]
        if self.pool == "max":
            return emb.max(axis=1)
        return emb.mean(axis=1)


class LookupEmbedding:
    """Word2vec table rows by token id (the lookup is the encoder)."""

    kind = "lookup"

    def __init__(self, table: Any) -> None:
        # a Word2Vec model or the bare lookup table
        if getattr(table, "lookup_table", None) is not None:
            table = table.lookup_table
        if not hasattr(table, "syn0"):
            raise TypeError("LookupEmbedding needs an InMemoryLookupTable "
                            "(or a fitted Word2Vec)")
        self.table = table
        self._dim = int(table.vector_length)

    @property
    def dim(self) -> int:
        return self._dim

    def __call__(self, rows) -> np.ndarray:
        ids = np.asarray(rows)
        if ids.dtype.kind == "f":
            ids = np.rint(ids)
        return self.table.vectors(
            ids.astype(np.int64).reshape(ids.shape[0], -1)[:, 0])


def resolve_adapter(model: Any, layer=None, pool: Optional[str] = None,
                    input_shape: Optional[Sequence[int]] = None):
    """The adapter of any registrable model, by duck type: BertMLM
    (``embed_tokens``), a word2vec table (``syn0``/``lookup_table``), a
    MultiLayerNetwork or ComputationGraph (``feed_forward``)."""
    if hasattr(model, "embed_tokens"):
        return BertEmbedding(model, pool=pool)
    if hasattr(model, "syn0") or getattr(model, "lookup_table",
                                         None) is not None:
        return LookupEmbedding(model)
    if hasattr(model, "feed_forward"):
        return FeedForwardEmbedding(model, layer=layer,
                                    input_shape=input_shape)
    raise TypeError(
        f"no embedding surface on {type(model).__name__}: expected "
        "embed_tokens (BERT), lookup_table/syn0 (word2vec), or "
        "feed_forward (MLN/CG)")
