"""The online loop (counterpart: ``deeplearning4j_tpu/online/``):
``StreamSource`` (a live feed with monotone offsets and backpressure),
``DriftMonitor`` (live moments against the training-time statistics,
whose latched alarm vetoes a ``VectorStore`` publish and a promotion),
``ContinuousTrainer`` (round-based incremental fit under the
``ResilientTrainer`` fault plane), ``ShadowPromoter`` (shadow mirroring,
promotion gates, the swap and its rollback) and the ``online_stats``
ledger."""

from deeplearning4j_tpu_torch.online.drift import DriftMonitor
from deeplearning4j_tpu_torch.online.promote import (
    PromotionRefused,
    ShadowMirror,
    ShadowPromoter,
)
from deeplearning4j_tpu_torch.online.stats import OnlineStats
from deeplearning4j_tpu_torch.online.stream import (
    StreamBackpressure,
    StreamClosed,
    StreamSource,
)
from deeplearning4j_tpu_torch.online.trainer import ContinuousTrainer

__all__ = [
    "ContinuousTrainer",
    "DriftMonitor",
    "OnlineStats",
    "PromotionRefused",
    "ShadowMirror",
    "ShadowPromoter",
    "StreamBackpressure",
    "StreamClosed",
    "StreamSource",
]
