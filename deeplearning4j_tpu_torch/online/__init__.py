"""The online feed (counterpart: ``deeplearning4j_tpu/online/``):
``StreamSource`` (a live feed with monotone offsets and backpressure),
``DriftMonitor`` (live moments against the training-time statistics,
whose latched alarm vetoes a ``VectorStore`` publish) and the
``online_stats`` ledger. ``ContinuousTrainer`` and the shadow promotion
(``trainer.py``, ``promote.py``) wait for the online training slice."""

from deeplearning4j_tpu_torch.online.drift import DriftMonitor
from deeplearning4j_tpu_torch.online.stats import OnlineStats
from deeplearning4j_tpu_torch.online.stream import (
    StreamBackpressure,
    StreamClosed,
    StreamSource,
)

__all__ = [
    "DriftMonitor",
    "OnlineStats",
    "StreamBackpressure",
    "StreamClosed",
    "StreamSource",
]
