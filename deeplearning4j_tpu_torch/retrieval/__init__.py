"""Embedding and retrieval serving (counterpart:
``deeplearning4j_tpu/retrieval/``): the ``/embed`` adapters, the vector
store with its exact and IVF indexes behind ``/search``, and the
retrieval ledger."""

from deeplearning4j_tpu_torch.retrieval.embed import (
    BertEmbedding,
    FeedForwardEmbedding,
    LookupEmbedding,
    resolve_adapter,
)
from deeplearning4j_tpu_torch.retrieval.index import (
    ExactIndex,
    IndexSnapshot,
    IVFIndex,
    measure_recall,
)
from deeplearning4j_tpu_torch.retrieval.stats import RetrievalStats
from deeplearning4j_tpu_torch.retrieval.store import (
    IndexFullError,
    PublishVetoed,
    VectorStore,
)

__all__ = [
    "BertEmbedding",
    "ExactIndex",
    "FeedForwardEmbedding",
    "IndexFullError",
    "IndexSnapshot",
    "IVFIndex",
    "LookupEmbedding",
    "PublishVetoed",
    "RetrievalStats",
    "VectorStore",
    "measure_recall",
    "resolve_adapter",
]
