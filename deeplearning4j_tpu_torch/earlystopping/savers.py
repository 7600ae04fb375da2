"""Model savers (counterpart: ``deeplearning4j_tpu/earlystopping/savers.py``
— ``InMemoryModelSaver``, ``LocalFileModelSaver`` and
``CheckpointManagerSaver`` :94; reference earlystopping/saver/).

``InMemoryModelSaver`` keeps clones; ``LocalFileModelSaver`` writes
``bestModel.zip`` and ``latestModel.zip`` (the ModelSerializer zip) with
a crash-safe tmp + fsync + rename; ``CheckpointManagerSaver`` makes the
latest saves managed checkpoints (async, digested, retained, with the
corrupt-checkpoint fallback) and keeps the best one a pinned zip that
retention never prunes. A saved model is read back onto ``device``, or
onto the device of the net that was saved when none was given.
"""

from __future__ import annotations

import os
from typing import Optional


class InMemoryModelSaver:
    """Best and latest model clones in memory (reference
    InMemoryModelSaver.java)."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score: float) -> None:
        self.best = net.clone()

    def save_latest_model(self, net, score: float) -> None:
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver:
    """Best and latest to ``<dir>/bestModel.zip`` and ``latestModel.zip``
    (reference LocalFileModelSaver.java; the ModelSerializer zip with the
    updater and training state)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.zip")

    @staticmethod
    def _atomic_write(net, path: str) -> None:
        """Serialize to a tmp file, fsync, rename: the previous file
        survives a death mid-save."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import fsync_file
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer,
        )

        tmp = f"{path}.tmp-{os.getpid()}"
        ModelSerializer.write_model(net, tmp)
        fsync_file(tmp)
        os.replace(tmp, path)

    def _remember(self, net) -> None:
        if self.device is None:
            self.device = getattr(net, "device", None)

    def _read(self, path: str):
        from deeplearning4j_tpu_torch.utils.serialization import restore

        if not os.path.exists(path):
            return None
        return restore(path, device=self.device)

    def save_best_model(self, net, score: float) -> None:
        self._remember(net)
        self._atomic_write(net, self.best_path)

    def save_latest_model(self, net, score: float) -> None:
        self._remember(net)
        self._atomic_write(net, self.latest_path)

    def get_best_model(self):
        return self._read(self.best_path)

    def get_latest_model(self):
        return self._read(self.latest_path)


class CheckpointManagerSaver(LocalFileModelSaver):
    """Latest saves as managed checkpoints of a ``CheckpointManager``
    under ``<dir>/latest`` (async write, sha256 manifest, keep-last-k,
    the corrupt-checkpoint fallback when read); the best model a pinned
    atomic zip beside them."""

    def __init__(self, directory: str, manager: Optional[object] = None,
                 keep_last: int = 3, device=None):
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            CheckpointManager,
        )

        super().__init__(directory, device=device)
        self.manager = manager or CheckpointManager(
            os.path.join(directory, "latest"), keep_last=keep_last)
        if getattr(self.manager, "backend", "zip") != "zip":
            raise ValueError("CheckpointManagerSaver requires a zip-backend "
                             "CheckpointManager")
        # the step chain continues across process restarts: starting at 0
        # would hand retention a step older than the ones it keeps
        self._saves = max(
            (s for s, _ in self.manager.checkpoints()), default=0)

    def save_latest_model(self, net, score: float) -> None:
        self._remember(net)
        self._saves += 1
        self.manager.save(net, step=self._saves)

    def get_latest_model(self):
        self.manager.flush()
        found = self.manager.latest_intact()
        if found is None:
            return None
        path, _ = found
        return self._read(os.path.join(path, "model.zip"))
