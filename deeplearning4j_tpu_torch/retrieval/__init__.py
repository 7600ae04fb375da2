"""Embedding serving (counterpart: ``deeplearning4j_tpu/retrieval/``):
the ``/embed`` adapters and the retrieval ledger. The vector store and
its indexes behind ``/search`` (``index.py``, ``store.py``) wait for a
later slice."""

from deeplearning4j_tpu_torch.retrieval.embed import (
    BertEmbedding,
    FeedForwardEmbedding,
    LookupEmbedding,
    resolve_adapter,
)
from deeplearning4j_tpu_torch.retrieval.stats import RetrievalStats

__all__ = [
    "BertEmbedding",
    "FeedForwardEmbedding",
    "LookupEmbedding",
    "RetrievalStats",
    "resolve_adapter",
]
