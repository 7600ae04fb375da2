"""Model registry: named, versioned load -> warmup -> serve (counterpart:
``deeplearning4j_tpu/serving/registry.py`` — ``bucket_ladder``,
``ModelRecord`` with ``draft_net`` :96, and ``ModelRegistry`` ``load`` /
``warmup`` / ``serve`` / ``get`` / ``default`` / ``describe``, :49-460).

  load    adopt a live model or restore a checkpoint zip (dispatching on
          its recorded model class) under (name, auto-assigned version);
  warmup  run ``output`` once at every bucket size a batcher can dispatch
          (``bucket_ladder``), before the record takes traffic, so the
          first real request pays no first-call costs (CUDA module loads,
          GEMM heuristics, the kernels' build); a failure lands the record
          ``broken`` and re-raises;
  serve   make (name, version) the default traffic target; a broken
          record is refused, and the prior default keeps its state.

A record hands out the self-drafts of speculative decoding
(``draft_net``), one per mode however many decoders are built around it.
Unload, the broken-record isolation of a failed load, quantization,
embed adapters, version lineage and chaos hooks wait for a later slice.
"""

from __future__ import annotations

import json
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.ops import dispatch, lowprec


def bucket_ladder(max_batch: int) -> List[int]:
    """The distinct bucket sizes a batcher can dispatch for batches of
    1..max_batch rows — the set warmup must cover."""
    return sorted({dispatch.bucket_size(n) for n in range(1, max_batch + 1)})


def restore(path: str, *, device=None):
    """The model a JAX-written checkpoint zip holds, by its recorded
    ``model_class``: a TransformerLM or a MultiLayerNetwork (a zip with no
    recorded class is a MultiLayerNetwork, as in the JAX package)."""
    with zipfile.ZipFile(path, "r") as z:
        got = json.loads(z.read("metadata.json").decode()).get("model_class")
    if got == "TransformerLM":
        from deeplearning4j_tpu_torch.models.transformer import TransformerLM

        return TransformerLM.load(path, device=device)
    if got in (None, "MultiLayerNetwork"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork.load(path, device=device)
    raise ValueError(f"checkpoint model_class {got!r} at {path} is not "
                     "ported yet")


class ModelRecord:
    """One (name, version) entry. ``state`` walks loaded -> warm ->
    serving, or lands ``broken``; the registry is the only writer."""

    def __init__(self, name: str, version: int, model, *,
                 input_shape: Optional[Tuple[int, ...]] = None) -> None:
        self.name = name
        self.version = int(version)
        self.model = model
        self.input_shape = tuple(input_shape) if input_shape else None
        # the serving precision /models reports ('f32' or 'bf16')
        self.precision = lowprec.precision_of(model)
        self.state = "loaded"
        self.error: Optional[str] = None
        self.loaded_ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.warmed_buckets: List[int] = []
        self._drafts: Dict[str, Any] = {}  # self-drafts, per mode

    @property
    def key(self) -> str:
        return f"{self.name}@v{self.version}"

    def draft_net(self, mode: str = "int8"):
        """The self-draft a ``SpeculativeDecoder`` proposes with
        (``ops/lowprec.draft_lm`` of this record's model), made once per
        mode."""
        mode = (mode or "int8").strip().lower()
        draft = self._drafts.get(mode)
        if draft is None:
            draft = self._drafts[mode] = lowprec.draft_lm(
                self.model, mode, device=self.model.device)
        return draft

    def describe(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "version": self.version,
            "state": self.state,
            "model_type": type(self.model).__name__,
            "precision": self.precision,
            "loaded_ts": self.loaded_ts,
            "warmed_buckets": list(self.warmed_buckets),
        }
        if self.error is not None:
            out["error"] = self.error
        if self.input_shape:
            out["input_shape"] = list(self.input_shape)
        return out


class ModelRegistry:
    def __init__(self, *, device=None) -> None:
        self.device = device  # where a restored checkpoint lands
        self._lock = threading.RLock()
        self._records: Dict[str, Dict[int, ModelRecord]] = {}
        self._default: Optional[Tuple[str, int]] = None

    def load(self, name: str, model=None, model_path: Optional[str] = None,
             input_shape=None) -> ModelRecord:
        """Register a live model or restore a checkpoint zip; the version
        is monotonic per name, from 1. Not promoted to the default: only
        serve() moves traffic."""
        if model is None and model_path is None:
            raise ValueError("need model or model_path")
        if model is None:
            model = restore(model_path, device=self.device)
        with self._lock:
            versions = self._records.setdefault(name, {})
            version = max(versions) + 1 if versions else 1
            rec = ModelRecord(name, version, model, input_shape=input_shape)
            versions[version] = rec
            return rec

    def warmup(self, name: Optional[str] = None,
               version: Optional[int] = None, *, max_batch: int = 64,
               sample_row: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Run the model's ``output`` at every bucket size of the ladder.
        The sample row defaults to zeros of the record's input_shape."""
        rec = self.get(name, version)
        if sample_row is not None:
            row = np.asarray(sample_row, np.float32)
        elif rec.input_shape is not None:
            row = np.zeros(rec.input_shape, np.float32)
        else:
            raise ValueError(
                f"{rec.key}: warmup needs input_shape or sample_row")
        t0 = time.perf_counter()
        ladder = bucket_ladder(max_batch)
        try:
            for b in ladder:
                out = rec.model.output(np.broadcast_to(row, (b,) + row.shape))
                out.cpu()  # the answer reaches the host, as a request's does
        except Exception as e:
            with self._lock:
                rec.state = "broken"
                rec.error = f"{type(e).__name__}: {e}"
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            rec.warmed_buckets = ladder
            if rec.state in ("loaded", "broken"):
                rec.state = "warm"
                rec.error = None
        return {"model": rec.key, "buckets": ladder, "seconds": round(dt, 3)}

    def serve(self, name: Optional[str] = None,
              version: Optional[int] = None) -> ModelRecord:
        """Make (name, version) the default traffic target."""
        rec = self.get(name, version)
        if rec.state == "broken":
            raise ValueError(
                f"{rec.key} is broken ({rec.error}); refusing to serve")
        with self._lock:
            prev = self._default
            self._default = (rec.name, rec.version)
            rec.state = "serving"
            if prev is not None and prev != self._default:
                old = self._records[prev[0]][prev[1]]
                if old.state == "serving":
                    old.state = "warm"
        return rec

    def get(self, name: Optional[str] = None,
            version: Optional[int] = None) -> ModelRecord:
        with self._lock:
            if name is None:
                if self._default is None:
                    raise KeyError("no model is serving")
                name, default_version = self._default
                if version is None:
                    version = default_version
            versions = self._records.get(name)
            if not versions:
                raise KeyError(f"unknown model {name!r}")
            if version is None:
                # the serving version of the name, else its newest
                if self._default and self._default[0] == name:
                    version = self._default[1]
                else:
                    version = max(versions)
            rec = versions.get(int(version))
            if rec is None:
                raise KeyError(f"unknown version {name}@v{version}")
            return rec

    def default(self) -> Optional[ModelRecord]:
        with self._lock:
            if self._default is None:
                return None
            return self._records[self._default[0]][self._default[1]]

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            recs = [r for vs in self._records.values() for r in vs.values()]
        return [r.describe() for r in
                sorted(recs, key=lambda r: (r.name, r.version))]
