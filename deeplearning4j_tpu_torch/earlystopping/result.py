"""EarlyStoppingResult (counterpart:
``deeplearning4j_tpu/earlystopping/result.py``; reference
earlystopping/EarlyStoppingResult.java)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class EarlyStoppingResult:
    termination_reason: str  # epoch | iteration | error
    termination_details: str
    score_vs_epoch: Dict[int, float] = field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = float("inf")
    total_epochs: int = 0
    best_model: Optional[Any] = None
