"""MovingWindowMatrix, patch extraction with optional rotations
(counterpart: ``deeplearning4j_tpu/utils/moving_window.py``).

Consume a matrix in row-major order in ``window_rows * window_cols``
chunks, reshape each chunk to a window, and optionally add its three
90-degree rotations before it. Host numpy, as in the JAX package."""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    def __init__(
        self,
        to_slice: np.ndarray,
        window_rows: int,
        window_cols: int,
        add_rotate: bool = False,
    ):
        self.to_slice = np.asarray(to_slice)
        self.window_rows = int(window_rows)
        self.window_cols = int(window_cols)
        self.add_rotate = bool(add_rotate)

    def windows(self, flattened: bool = False) -> List[np.ndarray]:
        flat = self.to_slice.reshape(-1)
        step = self.window_rows * self.window_cols
        n = len(flat) // step
        out: List[np.ndarray] = []
        for w in range(n):
            chunk = flat[w * step : (w + 1) * step]
            win = (
                chunk.copy()
                if flattened
                else chunk.reshape(self.window_rows, self.window_cols)
            )
            if self.add_rotate and not flattened:
                # reference adds the 3 remaining orientations BEFORE the
                # original (:107-115 appends rotations first)
                rot = win
                for _ in range(3):
                    rot = np.rot90(rot)
                    out.append(rot.copy())
            out.append(win)
        return out
