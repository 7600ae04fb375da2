"""DiskBasedQueue, a FIFO queue that spills its elements to disk
(counterpart: ``deeplearning4j_tpu/utils/disk_queue.py``).

Each element is pickled to its own file under a spill directory; an
in-memory deque holds only the file paths, so a long queue costs O(1)
memory. Thread-safe. Host-side Python, the JAX package's code with the
port's imports."""

from __future__ import annotations

import pickle
import tempfile
import threading
import uuid
from collections import deque
from pathlib import Path
from typing import Any, Optional


class DiskBasedQueue:
    def __init__(self, directory: Optional[str] = None):
        self._dir = Path(directory) if directory else Path(tempfile.mkdtemp(prefix="dl4j_q_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self._paths: deque = deque()
        self._lock = threading.Lock()

    def add(self, item: Any) -> None:
        path = self._dir / f"{uuid.uuid4().hex}.pkl"
        with open(path, "wb") as f:
            pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._paths.append(path)

    put = add  # queue.Queue-style alias

    def poll(self) -> Optional[Any]:
        """Remove and return the head, or None when empty (Queue.poll)."""
        with self._lock:
            if not self._paths:
                return None
            path = self._paths.popleft()
        with open(path, "rb") as f:
            item = pickle.load(f)  # noqa: S301 — our own spill files
        path.unlink(missing_ok=True)
        return item

    def peek(self) -> Optional[Any]:
        # read under the lock: a concurrent poll() unlinks the head file
        # right after releasing it, so reading outside would race
        with self._lock:
            if not self._paths:
                return None
            with open(self._paths[0], "rb") as f:
                return pickle.load(f)  # noqa: S301

    def __len__(self) -> int:
        with self._lock:
            return len(self._paths)

    def is_empty(self) -> bool:
        return len(self) == 0

    def clear(self) -> None:
        with self._lock:
            paths = list(self._paths)
            self._paths.clear()
        for p in paths:
            Path(p).unlink(missing_ok=True)
