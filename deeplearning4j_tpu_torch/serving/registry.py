"""Model registry: named, versioned load -> warmup -> serve -> unload
(counterpart: ``deeplearning4j_tpu/serving/registry.py`` —
``bucket_ladder``, ``ModelRecord`` :55-163 with ``embed_adapter``
:118-135, and ``ModelRegistry``,
``_maybe_quantize`` and ``_delete_device_buffers`` :166-534).

  load    adopt a live model or restore a checkpoint zip (dispatching on
          its recorded model class) under (name, auto-assigned version),
          with the zip's ``normalizer.json`` and ``quant.json`` unless the
          caller passes its own; under ``DL4J_TPU_QUANT`` a MultiLayerNetwork
          with a quant spec is wrapped in ``ops/lowprec.QuantizedNet``
          behind the accuracy gate (``_maybe_quantize``: verdicts ``ok``,
          ``ungated``, ``forced``, ``forced-ungated``, or
          ``QuantGateError``);
  warmup  run ``output`` once at every bucket size a batcher can dispatch
          (``bucket_ladder``), and ``generate`` for ``gen_tokens`` on an
          LM, before the record takes traffic, so the first request pays
          no first-call costs (CUDA module loads, GEMM heuristics, the
          kernels' build); a broken-at-warmup record that warms clean is
          rehabilitated;
  serve   make (name, version) the default traffic target, recording the
          swap in the lineage (``prior_default`` is the rollback target);
  unload  drop every reference the record holds to the model's tensors,
          so the device memory is freed now (the engine's ``retire``
          first stops the batcher and decoder that hold the model too).

Isolation: a load or warmup that raises lands the record ``broken`` with
its error kept for ``/models``, re-raises, and never moves the default;
``serve`` refuses a broken or unloaded record; ``seal`` (the engine's
drain) refuses load, warmup and serve from then on. Faults are injected
by ``resilience/chaos.ServingChaos`` (``on_load``, ``on_warmup``). A
record also hands out the self-drafts of speculative decoding
(``draft_net``) and the ``/embed`` adapters (``embed_adapter``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.ops import dispatch, lowprec
from deeplearning4j_tpu_torch.ops.memory import MODEL_BUFFER_ATTRS
from deeplearning4j_tpu_torch.serving.resilience import DrainingError


def bucket_ladder(max_batch: int) -> List[int]:
    """The distinct bucket sizes a batcher can dispatch for batches of
    1..max_batch rows — the set warmup must cover."""
    return sorted({dispatch.bucket_size(n) for n in range(1, max_batch + 1)})


def restore(path: str, *, device=None):
    """The model a checkpoint zip holds, by its recorded ``model_class``
    (``utils/serialization.restore``: a TransformerLM, BertMLM,
    BertClassifier, ComputationGraph or MultiLayerNetwork; a zip with no
    recorded class is a MultiLayerNetwork, as in the JAX package)."""
    from deeplearning4j_tpu_torch.utils.serialization import restore as _r

    return _r(path, device=device)


class ModelRecord:
    """One (name, version) entry. ``state`` walks loaded -> warm ->
    serving -> unloaded, or lands ``broken``; the registry is the only
    writer."""

    def __init__(self, name: str, version: int, model, *,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 path: Optional[str] = None, normalizer=None) -> None:
        self.name = name
        self.version = int(version)
        self.model = model
        self.input_shape = tuple(input_shape) if input_shape else None
        self.path = path
        # the fitted normalizer every /predict row goes through
        self.normalizer = normalizer
        # the serving precision ('f32', 'bf16' or 'int8') and the int8
        # gate's evidence measured at load
        self.precision = lowprec.precision_of(model)
        self.quant: Optional[Dict[str, Any]] = None
        self.state = "loaded"
        self.error: Optional[str] = None
        self.loaded_ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.warmed_buckets: List[int] = []
        # the default this record replaced when serve() promoted it
        self.prior_default: Optional[str] = None
        self._drafts: Dict[str, Any] = {}  # self-drafts, per mode
        self._embedders: Dict[Tuple[Any, Any], Any] = {}  # per (layer, pool)

    @property
    def key(self) -> str:
        return f"{self.name}@v{self.version}"

    def draft_net(self, mode: str = "int8"):
        """The self-draft a ``SpeculativeDecoder`` proposes with
        (``ops/lowprec.draft_lm`` of this record's model), made once per
        mode."""
        mode = (mode or "int8").strip().lower()
        if self.model is None:
            raise ValueError(
                f"record {self.key} has no model (state={self.state})")
        draft = self._drafts.get(mode)
        if draft is None:
            draft = self._drafts[mode] = lowprec.draft_lm(
                self.model, mode, device=self.model.device)
        return draft

    def embed_adapter(self, layer=None, pool: Optional[str] = None):
        """The embedding encoder over this record's model
        (``retrieval/embed.resolve_adapter``: an MLN's or graph's hidden
        layer, BERT's pooled ``embed_tokens``, a word2vec table), made
        once per (layer, pool). Making it never runs the model."""
        if self.model is None:
            raise ValueError(
                f"record {self.key} has no model (state={self.state})")
        key = (layer, pool)
        adapter = self._embedders.get(key)
        if adapter is None:
            from deeplearning4j_tpu_torch.retrieval.embed import (
                resolve_adapter,
            )

            adapter = self._embedders[key] = resolve_adapter(
                self.model, layer=layer, pool=pool,
                input_shape=self.input_shape)
        return adapter

    def describe(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "version": self.version,
            "state": self.state,
            "model_type": (type(self.model).__name__
                           if self.model is not None else None),
            "loaded_ts": self.loaded_ts,
            "warmed_buckets": list(self.warmed_buckets),
            "precision": self.precision,
        }
        if self.quant is not None:
            out["quant"] = dict(self.quant)
        if self.error is not None:
            out["error"] = self.error
        if self.input_shape:
            out["input_shape"] = list(self.input_shape)
        if self.normalizer is not None:
            out["normalizer"] = type(self.normalizer).__name__
        if self.prior_default is not None:
            out["prior_default"] = self.prior_default
        return out


class ModelRegistry:
    def __init__(self, *, device=None, chaos=None, stats=None) -> None:
        self.device = device  # where a restored checkpoint lands
        self._lock = threading.RLock()
        self._records: Dict[str, Dict[int, ModelRecord]] = {}
        self._default: Optional[Tuple[str, int]] = None
        self.chaos = chaos  # resilience/chaos.ServingChaos, never ambient
        self.stats = stats  # serving/telemetry.ServingStats
        self._sealed = False
        self._lineage: List[Dict[str, Any]] = []  # every serve() swap

    def seal(self) -> None:
        """Freeze the lifecycle for shutdown: from now on load, warmup and
        serve raise DrainingError (HTTP 503), so a rollout racing a drain
        cannot promote a half-warmed record; unload stays legal."""
        with self._lock:
            self._sealed = True

    def _check_sealed(self) -> None:
        if self._sealed:
            raise DrainingError(
                "registry is sealed (engine draining); lifecycle "
                "mutations refused")

    def load(self, name: str, model=None, model_path: Optional[str] = None,
             input_shape=None, normalizer=None, quant=None) -> ModelRecord:
        """Register a live model or restore a checkpoint zip; the version
        is monotonic per name, from 1. A zip's normalizer and quant
        sections are read unless given. Not promoted: only serve() moves
        traffic. A failure (the restore, the chaos hook, the int8 gate)
        lands a broken record and re-raises; the default never moves."""
        if model is None and model_path is None:
            raise ValueError("need model or model_path")
        self._check_sealed()
        quant_info = None
        try:
            if self.chaos is not None:
                self.chaos.on_load(name)
            if model is None:
                model = restore(model_path, device=self.device)
            if model_path is not None:
                from deeplearning4j_tpu_torch.utils.serialization import (
                    read_normalizer,
                    read_quant,
                )

                if normalizer is None:
                    normalizer = read_normalizer(model_path)
                if quant is None:
                    quant = read_quant(model_path)
            model, quant_info = _maybe_quantize(model, quant)
        except Exception as e:
            self._record_broken(name, e, input_shape=input_shape,
                                path=model_path)
            if self.stats is not None:
                self.stats.record_load_failure()
            raise
        with self._lock:
            versions = self._records.setdefault(name, {})
            version = max(versions) + 1 if versions else 1
            rec = ModelRecord(name, version, model,
                              input_shape=input_shape, path=model_path,
                              normalizer=normalizer)
            rec.quant = quant_info
            versions[version] = rec
            return rec

    def _record_broken(self, name: str, exc: Exception, *,
                       input_shape=None, path=None) -> ModelRecord:
        """A broken record for a failed load, auditable at /models. Never
        touches the serving default."""
        with self._lock:
            versions = self._records.setdefault(name, {})
            version = max(versions) + 1 if versions else 1
            rec = ModelRecord(name, version, None,
                              input_shape=input_shape, path=path)
            rec.state = "broken"
            rec.error = f"{type(exc).__name__}: {exc}"
            versions[version] = rec
            return rec

    def warmup(self, name: Optional[str] = None,
               version: Optional[int] = None, *, max_batch: int = 64,
               sample_row: Optional[np.ndarray] = None,
               gen_tokens: int = 0) -> Dict[str, Any]:
        """Run the model's ``output`` at every bucket size of the ladder
        (each answer read back to the host, as a request's is). The sample
        row defaults to zeros of input_shape; a token model (no
        input_shape, a ``generate``) warms with [b, 2] ids, and
        ``gen_tokens > 0`` also runs ``generate`` for that many tokens."""
        self._check_sealed()
        rec = self.get(name, version)
        model = rec.model
        if model is None:
            raise ValueError(f"{rec.key} is unloaded")
        if sample_row is not None:
            row = np.asarray(sample_row)
        elif rec.input_shape is not None:
            row = np.zeros(rec.input_shape, np.float32)
        elif hasattr(model, "generate"):  # a token-id model (the LM)
            row = np.zeros((2,), np.int64)
        else:
            raise ValueError(
                f"{rec.key}: warmup needs input_shape or sample_row")
        t0 = time.perf_counter()
        ladder = bucket_ladder(max_batch)
        try:
            if self.chaos is not None:
                self.chaos.on_warmup(rec.name)
            for b in ladder:
                out = model.output(
                    np.broadcast_to(row, (b,) + row.shape).copy())
                # a graph answers a list, its outputs in order
                for o in (out if isinstance(out, (list, tuple)) else [out]):
                    o.cpu()
            if gen_tokens and hasattr(model, "generate"):
                model.generate(np.zeros((1, 2), np.int32),
                               int(gen_tokens)).cpu()
        except Exception as e:
            with self._lock:
                rec.state = "broken"
                rec.error = f"{type(e).__name__}: {e}"
            if self.stats is not None:
                self.stats.record_warmup_failure()
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            rec.warmed_buckets = ladder
            if rec.state in ("loaded", "broken"):
                # a re-warm that runs clean is the operator's probe
                rec.state = "warm"
                rec.error = None
        return {"model": rec.key, "buckets": ladder,
                "gen_tokens": int(gen_tokens), "seconds": round(dt, 3)}

    def serve(self, name: Optional[str] = None,
              version: Optional[int] = None) -> ModelRecord:
        """Make (name, version) the default traffic target. Refuses a
        broken or unloaded record and a sealed registry."""
        self._check_sealed()
        rec = self.get(name, version)
        if rec.state == "broken":
            raise ValueError(
                f"{rec.key} is broken ({rec.error}); refusing to serve")
        if rec.model is None:
            raise ValueError(f"{rec.key} is unloaded")
        with self._lock:
            prev = self._default
            self._default = (rec.name, rec.version)
            rec.state = "serving"
            if prev is not None and prev != self._default:
                old = self._records.get(prev[0], {}).get(prev[1])
                if old is not None and old.state == "serving":
                    old.state = "warm"
            if prev != self._default:
                prev_key = f"{prev[0]}@v{prev[1]}" if prev else None
                rec.prior_default = prev_key
                self._lineage.append({
                    "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "from": prev_key, "to": rec.key})
        return rec

    def mark_broken(self, name: str, version: Optional[int] = None, *,
                    error: str = "promotion gate failed") -> ModelRecord:
        """Land a record broken after the fact; refuses the serving
        default (traffic never moves through this door)."""
        rec = self.get(name, version)
        with self._lock:
            if self._default == (rec.name, rec.version):
                raise ValueError(
                    f"{rec.key} is the serving default; mark_broken would "
                    "break live traffic — demote it first")
            rec.state = "broken"
            rec.error = str(error)
        return rec

    def lineage(self) -> List[Dict[str, Any]]:
        """The serve() swaps, oldest first."""
        with self._lock:
            return [dict(e) for e in self._lineage]

    def rollback_target(self) -> Optional[Tuple[str, int]]:
        """(name, version) the current default replaced, while that record
        can still be promoted."""
        with self._lock:
            if self._default is None:
                return None
            rec = self._records[self._default[0]][self._default[1]]
            prior = rec.prior_default
            if prior is None:
                return None
            pname, _, pver = prior.rpartition("@v")
            old = self._records.get(pname, {}).get(int(pver))
            if old is None or old.model is None or old.state == "broken":
                return None
            return pname, int(pver)

    def unload(self, name: str, version: Optional[int] = None) -> ModelRecord:
        """Drop the record's model and its tensors now."""
        rec = self.get(name, version)
        with self._lock:
            if self._default == (rec.name, rec.version):
                self._default = None
            model, rec.model, rec.state = rec.model, None, "unloaded"
            drafts, rec._drafts = rec._drafts, {}
            rec._embedders = {}
        for m in [model, *drafts.values()]:
            if m is not None:
                _delete_device_buffers(m)
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


def _maybe_quantize(model, spec):
    """The calibrated int8 path (``ops/lowprec.QuantizedNet``) under the
    ``DL4J_TPU_QUANT`` policy, and its accuracy gate:

    * 'off', no spec, or a model without a layer stack: f32 as it is;
    * 'auto' (default): quantize when the spec carries a gate sample and
      the measured int8-vs-f32 max abs output delta is within
      ``DL4J_TPU_QUANT_MAX_DELTA``; past it raise QuantGateError (the
      caller lands the record broken). A spec with no sample serves f32,
      verdict 'ungated';
    * 'force': quantize even past the bar, the delta still measured and
      reported ('forced', or 'forced-ungated' with no sample).

    Returns (model or QuantizedNet, the gate's info dict or None)."""
    mode = lowprec.quant_mode()
    if spec is None or mode == "off" or not hasattr(model, "layers"):
        return model, None
    qnet = lowprec.QuantizedNet(model, spec)
    layers = qnet.quantized_layers()
    if not layers:
        return model, None
    info: Dict[str, Any] = {
        "mode": mode,
        "layers": layers,
        "max_delta": lowprec.quant_max_delta(),
    }
    sample = getattr(spec, "sample", None)
    if sample is None or getattr(sample, "size", 0) == 0:
        if mode != "force":
            info["verdict"] = "ungated"
            info["delta"] = None
            return model, info
        info["verdict"] = "forced-ungated"
        info["delta"] = None
        return qnet, info
    f32_out = model.output(sample).float().cpu().numpy()
    int8_out = qnet.output(sample).float().cpu().numpy()
    delta = float(np.max(np.abs(f32_out - int8_out)))
    info["delta"] = delta
    if delta <= info["max_delta"]:
        info["verdict"] = "ok"
        return qnet, info
    if mode == "force":
        info["verdict"] = "forced"
        return qnet, info
    raise lowprec.QuantGateError(
        f"int8 accuracy gate failed: measured delta {delta:.6g} > "
        f"DL4J_TPU_QUANT_MAX_DELTA {info['max_delta']:.6g} on the "
        f"{sample.shape[0]}-row calibration gate sample")


def _delete_device_buffers(model) -> None:
    """Drop every reference ``model`` (and a wrapper's ``base``) holds to
    its tensors, so the device memory is freed as soon as nothing else
    holds them: PyTorch frees a tensor with its last reference."""
    for attr in MODEL_BUFFER_ATTRS:
        if getattr(model, attr, None) is not None:
            try:
                setattr(model, attr, None)
            except Exception:  # noqa: BLE001 — read-only attrs stay
                pass
    base = getattr(model, "base", None)
    if base is not None:
        _delete_device_buffers(base)
