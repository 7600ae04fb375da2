"""Speculative-decode chaos (counterpart:
``deeplearning4j_tpu/resilience/chaos.py`` ``SpecChaosConfig`` :529 and
``SpecChaos`` :545). The training, serving, low-precision and autoscale
chaos of that module wait for a later slice.

``SpecChaos`` forces all-reject speculative rounds deterministically: at
acceptance-comparison time, after the verify ran on the true proposals,
each proposal of a chosen round becomes (target greedy + 1) % vocab,
which can never match. An all-reject round commits only the target's own
first token, a function of the last committed token alone, so the stream
stays byte-equal to target-only greedy decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SpecChaosConfig:
    """Corrupt the proposals of rounds ``reject_at_round`` ..
    ``reject_at_round + count - 1`` (the decoder's round counter)."""

    reject_at_round: Optional[int] = None
    count: int = 1     # consecutive corrupted rounds from reject_at_round

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("count must be >= 1")


class SpecChaos:
    """Stateful executor of a :class:`SpecChaosConfig`; ``log`` keeps
    (round, fault) for tests."""

    def __init__(self, config: SpecChaosConfig):
        if isinstance(config, dict):
            config = SpecChaosConfig(**config)
        self.config = config
        self.log: list = []

    def corrupt(self, round_idx: int, proposed, target_greedy,
                vocab_size: int):
        """The proposals to compare for round ``round_idx``: a corrupted
        copy on fault rounds (the caller's array is never changed), else
        ``proposed`` itself."""
        c = self.config
        if (c.reject_at_round is None
                or not (c.reject_at_round <= round_idx
                        < c.reject_at_round + c.count)):
            return proposed
        bad = np.array(proposed, dtype=np.int32, copy=True)
        g = np.asarray(target_greedy, np.int32).reshape(-1)[:bad.size]
        bad[:] = (g + 1) % int(vocab_size)
        self.log.append((round_idx, "reject_all"))
        return bad
