"""ServingEngine: the HTTP front door over the registry's records, their
``/predict`` batchers, ``/generate`` decoders and circuit breakers
(counterpart: ``deeplearning4j_tpu/serving/engine.py``).

It takes ``model=`` (a TransformerLM, a MultiLayerNetwork, a
ComputationGraph or a ``QuantizedNet``) or ``model_path=`` (a checkpoint
zip the JAX package or the port wrote, restored by its model class, with
its
``normalizer.json`` and ``quant.json``) as the record "default", or
nothing: records are then loaded at run time through ``POST /models``.
Every record gets its own batcher, decoder and breaker, keyed by
``rec.key``, so ``"model"``/``"version"`` reach any loaded record.

Routes (stdlib HTTP, JSON — the contracts of the JAX engine):

  POST /generate  (a TransformerLM; ``engine.py:1067-1102``)
                  {"tokens": [[ids]] | [ids], "n_new": K, "temperature"?,
                  "seed"?, "slo"?, "model"?, "version"?} -> {"tokens":
                  [[ids]]}. With "stream": true (one prompt) the response
                  is chunked application/x-ndjson: one {"token": t} line
                  per token as it is sampled, then {"done": true,
                  "tokens": [...]} (or {"error": ...}). "top_k"/"top_p"
                  sample through ``lm.generate`` (400 with "stream").
                  The decoder, as the JAX engine picks it (``_decoder_for``
                  :774-850): the paged pool, the speculative one under
                  ``DL4J_TPU_SERVE_SPEC``, or the fixed-slot pool under
                  ``DL4J_TPU_SERVE_KV_BLOCK=0``; a ValueError while
                  building it (or ``DL4J_TPU_SERVE_CONTINUOUS=0``) leaves
                  the record without one, and ``/generate`` samples
                  through ``lm.generate``.
  POST /prefill   (the paged pools; :1104-1120) {"tokens": [ids],
                  "n_new"?} -> {"digests", "k", "v": base64 of the raw
                  blocks, "shape", "dtype": "float32" | "bfloat16",
                  "block_tokens"}; bf16 blocks travel as raw 16-bit words.
  POST /prime     (:1122-1135) that payload -> {"adopted": n}.
  POST /predict   (a MultiLayerNetwork, or a ComputationGraph's first
                  output; :995-1020) {"record": [...]} |
                  {"record_base64": "<le float32 bytes>"} -> {"output"},
                  {"batch": [[...], ...]} -> {"outputs"}; optional
                  "model", "version", "timeout_s". Rows are reshaped to
                  the record's input_shape, checked and normalized by its
                  fitted normalizer (``_shape_rows``: a bad payload is a
                  400 and no breaker vote), then go through the record's
                  dynamic batcher, or one locked ``output`` call under
                  ``DL4J_TPU_SERVE_BATCH=0``.
  POST /embed     (:1022-1047; ``embed_for`` :332-468) {"record": [...]}
                  -> {"embedding", "dim"}; {"batch": [[...], ...]} or
                  {"tokens": [[ids]] | [ids]} -> {"embeddings", "dim"};
                  optional "layer" (an MLN activation index or a graph
                  vertex name), "pool" (BERT: mean | cls | max), "model",
                  "version", "timeout_s". Rows go through the record's
                  adapter (``retrieval/embed.resolve_adapter``: a
                  MultiLayerNetwork's or ComputationGraph's hidden
                  activation, BERT's pooled ``embed_tokens`` through K5,
                  a word2vec table's rows), padded up the bucket ladder
                  with the pad rows sliced off, through the record's embed
                  batcher (one per record, the first request's layer and
                  pool, with the watchdog and breaker hooks) or one locked
                  call under ``DL4J_TPU_SERVE_BATCH=0``; 400 with no
                  record, batch or tokens.
  POST /search    (:1049-1065; ``search`` :425-443) {"query": [...]} |
                  {"queries": [[...], ...]}, "index"? ("default"), "k"?
                  (10), "nprobe"? -> {"ids": [[...]], "scores": [[...]]}
                  over a registered ``retrieval/store.VectorStore``'s
                  current generation (``register_index``); ids -1 with
                  scores -Infinity past the live rows; 400 without a
                  query or for an unknown index, 503 while draining.
  POST /models    {"action": "load", "name", "path", "input_shape"?} |
                  {"action": "warmup" | "serve" | "unload", "name",
                  "version"?, "max_batch"?, "gen_tokens"?} (:1172-1197).
  GET  /health    {"ok", "draining", "model", "models", "health": per-
                  record breaker or lifecycle state, "device"}; 503 while
                  draining or when every loaded record is broken.
                  ``/health?ready=1`` adds "live": true and "ready"
                  (:1341-1355).
  GET  /models    {"models", "default", "kv": per-record decoder
                  capacity, "lineage": the serve() swaps, "embed": each
                  record's adapter kind and dim, "indexes": each
                  registered store's ``report()``}
  GET  /metrics   {"serving", "models", "health", "draining", "hbm":
                  resident bytes per record and each index's arena
                  against the device's memory,
                  "kernels": launch counts of each kernel of the served
                  paths and of its plain version, and for the default LM
                  "decode" and "dispatch"}; with ``Accept: text/plain`` or
                  ``?format=prometheus`` the process registry's text
                  exposition (``obs/registry.py``), the engine's
                  ``retrieval_stats`` ledger among them.

Statuses (``do_POST`` :962-993): 429 queue full; 503 with an integer
Retry-After (ceil, at least 1) for an open breaker, a broken record or a
drain; 503 "Wedged" for a dispatch the watchdog expired; 503 for a dead
worker; 504 past the deadline; 400 otherwise.

Resilience (``serving/resilience.py``): a breaker per record fed by
every dispatch's outcome (payload errors and deadlines do not vote), the
batcher's watchdog (``DL4J_TPU_SERVE_WATCHDOG_S``), whose verdict trips
the breaker, ``drain`` (seal the registry, close admission, wait up to
``DL4J_TPU_SERVE_DRAIN_S``) and the SIGTERM handlers. ``chaos``
(``resilience/chaos.ServingChaos``) injects faults per dispatch, load,
warmup and admission.

Constructor arguments take precedence; unset ones read the JAX engine's
knobs through the port's copy of the table (``ops/env.py``):
``DL4J_TPU_SERVE_QUEUE_CAP``, ``_TIMEOUT_S``, ``_MAX_BATCH``,
``_MAX_WAIT_MS``, ``_BATCH``, ``_SLOTS``, ``_KV_BLOCK``, ``_KV_BLOCKS``,
``_SPEC``, ``_CONTINUOUS``, ``_MESH``, ``_ROLE``, ``_SLO_CLASSES``
(parsed at construction: a malformed spec raises ValueError there),
``_BREAKER_FAILS``,
``_WATCHDOG_S`` and ``_DRAIN_S``, and through the decoders
``DL4J_TPU_SERVE_TICK_K``, ``_SPEC_K`` and ``_KV_DTYPE``.

Observability (``obs/``, under ``DL4J_TPU_OBS``): every entry point
(``predict_for``, ``embed_for``, ``search``, ``generate``,
``generate_stream``, ``prefill_for``) opens a ``serve.request`` span with
its request id ``rid``; the batchers' ``serve.batch`` spans list their
members' rids, and each decode tick opens one too. The journal records
``serve.health`` (breaker transitions), ``serve.wedged`` (flushed with
fsync), ``serve.drain``, ``serve.drain_complete`` (flushed with fsync)
and ``serve.preempt`` (a SIGTERM).

The serving fleet's hooks: ``role`` (``DL4J_TPU_SERVE_ROLE``: '',
``prefill`` or ``decode``; a tagged replica's ``/health`` carries it and
the router dispatches ``/generate`` by it), ``mesh_devices``
(``DL4J_TPU_SERVE_MESH``: >= 2 builds the paged pool as
``serving/mesh.MeshPagedDecoder``, whose build raises on a knob it cannot
honour) and the shadow mirror (``attach_shadow``, ``detach_shadow``: the
answered ``/predict`` rows and outputs offered to
``online/promote.ShadowMirror``, JAX :302-330).
"""

from __future__ import annotations

import base64
import gc
import itertools
import json
import math
import queue as stdqueue
import signal
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import journal as obs_journal
from deeplearning4j_tpu_torch.obs import registry as obs_registry
from deeplearning4j_tpu_torch.obs import trace as obs_trace
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops import memory as opsmem
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops import dispatch
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_block,
    flash_attention_block_plain,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops.lstm_scan import lstm_scan, lstm_scan_plain
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)
from deeplearning4j_tpu_torch.serving.batcher import (
    DynamicBatcher,
    QueueFullError,
    RequestTimeoutError,
)
from deeplearning4j_tpu_torch.serving.decode import ContinuousDecoder
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder, dtype_name
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.resilience import (
    BreakerOpenError,
    CircuitBreaker,
    ClientRequestError,
    DrainingError,
    ModelWedgedError,
    WorkerDeadError,
    breaker_fails_default,
    drain_s_default,
    watchdog_s_default,
)
from deeplearning4j_tpu_torch.serving.slo import SLOClass, parse_slo_classes
from deeplearning4j_tpu_torch.serving.speculate import SpeculativeDecoder
from deeplearning4j_tpu_torch.retrieval.stats import RetrievalStats
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats

# the kernels of each served path: (wrapper, plain version)
GENERATE_KERNELS = {"flash_attention": (flash_attention,
                                        flash_attention_plain),
                    "paged_attention": (paged_attention,
                                        paged_attention_plain)}
PREDICT_KERNELS = {"lstm_scan": (lstm_scan, lstm_scan_plain)}
EMBED_KERNELS = {"flash_attention_block": (flash_attention_block,
                                           flash_attention_block_plain)}
SERVED_TYPES = (TransformerLM, MultiLayerNetwork, ComputationGraph,
                lowprec.QuantizedNet)
_OFF = ("0", "off", "false", "no")


def kernel_counts(kernels) -> Dict[str, Dict[str, int]]:
    """Launch counts of each kernel wrapper and of its plain version."""
    return {name: {"launches": fn.launches, "plain_launches": plain.launches}
            for name, (fn, plain) in kernels.items()}


def _first_output(out) -> np.ndarray:
    """A model's ``output`` on the host: a graph's first output (its list
    in ``conf.outputs`` order), a network's only one."""
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out.float().cpu().numpy()


# the handoff's wire dtypes: (numpy word to carry the raw bytes, tensor
# dtype); numpy has no bfloat16, so bf16 blocks travel as 16-bit words
_WIRE_DTYPES = {"float32": (np.float32, torch.float32),
                "bfloat16": (np.int16, torch.bfloat16)}


def blocks_to_wire(t: torch.Tensor) -> str:
    """base64 of a CPU tensor's raw bytes (C order)."""
    raw = t.contiguous().view(torch.uint8).numpy().tobytes()
    return base64.b64encode(raw).decode()


def blocks_from_wire(data: str, shape, dtype: str) -> torch.Tensor:
    """The inverse of :func:`blocks_to_wire` for the wire's dtype names
    ("float32" as the JAX engine writes f32 blocks, "bfloat16" as it
    writes bf16 ones)."""
    if dtype not in _WIRE_DTYPES:
        raise ClientRequestError(
            f"prefix blocks dtype {dtype!r} is not one of "
            f"{sorted(_WIRE_DTYPES)}")
    word, tdt = _WIRE_DTYPES[dtype]
    a = np.frombuffer(base64.b64decode(data), word).reshape(
        tuple(int(s) for s in shape))
    return torch.from_numpy(a.copy()).view(tdt)


class ServingEngine:
    """``/generate`` and ``/predict`` over the registry's records on
    ``device`` (the card unless the caller passes ``device="cpu"``; a
    live model given must live there)."""

    def __init__(self, model=None, *, model_path: Optional[str] = None,
                 port: int = 0, input_shape=None, normalizer=None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 slots: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 mesh_devices: Optional[int] = None,
                 role: Optional[str] = None,
                 slo_classes: Union[str, List[SLOClass], None] = None,
                 breaker_fails: Optional[int] = None,
                 breaker_cooldown_s: float = 2.0,
                 watchdog_s: Optional[float] = None,
                 drain_s: Optional[float] = None,
                 chaos=None, handle_signals: bool = False,
                 device=None) -> None:
        self.device = resolve_device(device)
        if model is not None:
            if not isinstance(model, SERVED_TYPES):
                raise TypeError(
                    "the port's engine serves a TransformerLM, a "
                    "MultiLayerNetwork, a ComputationGraph or a "
                    "QuantizedNet; got "
                    f"{type(model).__name__}")
            if model.device != self.device:
                raise ValueError(f"the model lives on {model.device}, the "
                                 f"engine on {self.device}")
        self.queue_capacity = int(
            queue_capacity if queue_capacity is not None
            else envknob.get_int("DL4J_TPU_SERVE_QUEUE_CAP"))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else envknob.get_float("DL4J_TPU_SERVE_TIMEOUT_S"))
        self.max_batch = int(max_batch if max_batch is not None
                             else envknob.get_int("DL4J_TPU_SERVE_MAX_BATCH"))
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None
            else envknob.get_float("DL4J_TPU_SERVE_MAX_WAIT_MS"))
        self.slots = int(slots if slots is not None
                         else envknob.get_int("DL4J_TPU_SERVE_SLOTS"))
        self.kv_block = int(kv_block if kv_block is not None
                            else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCK"))
        self.kv_blocks = int(
            kv_blocks if kv_blocks is not None
            else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCKS"))
        # the serving mesh (serving/mesh.py): >= 2 shards the paged
        # decode tick's heads over that many shards; the decoder build
        # gates incompatible knobs loudly (JAX engine.py:150-157)
        self.mesh_devices = int(
            mesh_devices if mesh_devices is not None
            else envknob.get_int("DL4J_TPU_SERVE_MESH"))
        # prefill/decode disaggregation role: routing metadata published
        # with the replica's address (serving/fleet.py); the router
        # enforces the split, the role declares intent (:158-167)
        self.role = (role if role is not None
                     else envknob.raw("DL4J_TPU_SERVE_ROLE")).strip().lower()
        if self.role not in ("", "prefill", "decode"):
            raise ValueError(
                f"DL4J_TPU_SERVE_ROLE {self.role!r} must be '', "
                "'prefill' or 'decode'")
        # a typo'd operator spec fails HERE, for every model kind, not
        # later as FIFO (JAX engine.py:169-172)
        if slo_classes is None:
            slo_classes = envknob.raw("DL4J_TPU_SERVE_SLO_CLASSES")
        self.slo_classes = (parse_slo_classes(slo_classes)
                            if isinstance(slo_classes, str)
                            else list(slo_classes))
        self.batching_enabled = (
            envknob.raw("DL4J_TPU_SERVE_BATCH").strip().lower() not in _OFF)
        self.continuous_enabled = (
            envknob.raw("DL4J_TPU_SERVE_CONTINUOUS").strip().lower()
            not in _OFF)
        self.stats = ServingStats()
        # the serving ledger joins the process's metrics registry: one
        # Prometheus scrape covers it, with a latency histogram
        metrics = obs_registry.default_registry()
        metrics.register_ledger(self, "serving_stats", self.stats)
        self.retrieval_stats = RetrievalStats()
        metrics.register_ledger(self, "retrieval_stats",
                                self.retrieval_stats)
        self.stats.on_latency = lambda s: metrics.histogram(
            "dl4j_serving_latency_seconds", s)
        self.breaker_fails = int(breaker_fails if breaker_fails is not None
                                 else breaker_fails_default())
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.watchdog_s = float(watchdog_s if watchdog_s is not None
                                else watchdog_s_default())
        self.drain_s = float(drain_s if drain_s is not None
                             else drain_s_default())
        self.chaos = chaos
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._embed_batchers: Dict[str, DynamicBatcher] = {}
        self._decoders: Dict[str, Any] = {}
        self._no_decoder: set = set()  # records probed and found ineligible
        self._indexes: Dict[str, Any] = {}  # name -> VectorStore
        self._rid = itertools.count(1)  # observability request ids
        self._draining = False   # the admission gate
        self._drained = False    # a full drain() ran
        self._old_handlers: Dict[int, Any] = {}
        self._lock = threading.Lock()  # direct /predict, lm.generate
        self._engine_lock = threading.Lock()  # batcher/decoder creation
        # the shadow mirror (online/promote.ShadowMirror): when attached,
        # a fraction of answered /predict traffic is offered to the
        # candidate off-thread; offer() never raises, never blocks and
        # never votes a breaker (JAX engine.py:219-223)
        self._shadow = None
        self.registry = ModelRegistry(device=self.device, chaos=chaos,
                                      stats=self.stats)
        if model is not None or model_path is not None:
            rec = self.registry.load("default", model=model,
                                     model_path=model_path,
                                     input_shape=input_shape,
                                     normalizer=normalizer)
            self.registry.serve(rec.name, rec.version)
            if isinstance(rec.model, TransformerLM):
                self._decoder_for(rec)  # the pool is there before traffic
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        if handle_signals:
            self.install_signal_handlers()

    # -- the default record -----------------------------------------------
    @property
    def model(self):
        rec = self.registry.default()
        return rec.model if rec is not None else None

    @property
    def decoder(self):
        """The default record's decode pool (None when it has none)."""
        rec = self.registry.default()
        if rec is None or not isinstance(rec.model, TransformerLM):
            return None
        return self._decoder_for(rec)

    # -- admission ----------------------------------------------------------
    def _admit(self, rec) -> CircuitBreaker:
        """The per-request gate, before the request costs a queue slot: a
        draining engine and a broken or open record fast-fail (503). Returns
        the record's breaker (a half-open probe rides through)."""
        if self._draining:
            self.stats.record_fast_fail()
            raise DrainingError("engine is draining; admission closed")
        if rec.state == "broken":
            self.stats.record_fast_fail()
            raise BreakerOpenError(
                f"model {rec.key} is broken ({rec.error}); reload or "
                "re-warm it", retry_after_s=5.0)
        breaker = self._breaker_for(rec)
        breaker.check()
        return breaker

    def predict(self, x, timeout_s: Optional[float] = None) -> np.ndarray:
        """Rows through the default model."""
        return self.predict_for(None, None, x, timeout_s=timeout_s)

    def predict_for(self, name, version, x,
                    timeout_s: Optional[float] = None) -> np.ndarray:
        """[k, ...] rows -> [k, ...] outputs of the (name, version) record
        (the default record when both are None)."""
        rec = self.registry.get(name, version)
        # admission before the unloaded check: a broken record answers
        # 503 with Retry-After, not a 400
        breaker = self._admit(rec)
        if rec.model is None:
            raise KeyError(f"{rec.key} is unloaded")
        if isinstance(rec.model, TransformerLM):
            raise ClientRequestError(
                f"POST /predict needs a MultiLayerNetwork; {rec.key} is a "
                "TransformerLM (POST /generate)")
        raw = np.asarray(x, np.float32)  # what a shadow record reshapes
        x = self._shape_rows(rec, raw)
        rid = next(self._rid)
        with obs_trace.span("serve.request", rid=rid, model=rec.key,
                            rows=int(x.shape[0])):
            if not self.batching_enabled:
                try:
                    out = self._direct_output(rec, x)
                except Exception as e:  # noqa: BLE001 — serving boundary
                    breaker.record_failure(f"{type(e).__name__}: {e}")
                    raise
                breaker.record_success()
                self._offer_shadow(raw, out)
                return out
            # the rid rides the batcher: the serve.batch span on its
            # worker lists it, joining this request to its dispatch
            out = self._batcher_for(rec).predict(x, timeout_s=timeout_s,
                                                 rid=rid)
            self._offer_shadow(raw, out)
            return out

    def attach_shadow(self, mirror) -> None:
        """Install a shadow mirror on the /predict answer path (one at a
        time: promotion is a serialized operator action)."""
        self._shadow = mirror

    def detach_shadow(self, mirror=None) -> None:
        """Remove the mirror (idempotent; a given ``mirror`` detaches only
        itself, so a stale promoter cannot evict its successor)."""
        if mirror is None or self._shadow is mirror:
            self._shadow = None

    def _offer_shadow(self, x, out) -> None:
        shadow = self._shadow
        if shadow is not None:
            shadow.offer(x, out)

    @staticmethod
    def _shape_rows(rec, x: np.ndarray) -> np.ndarray:
        """Reshape to the record's input_shape, hold the rows to the
        model's input rank and feature width (a sequence row may have any
        length) and apply the fitted normalizer (per final-axis column,
        after the reshape; the pure form, as a coalesced batch shares
        buffers). A failure is the client's payload (400, no breaker
        vote), refused before it can share a batch."""
        try:
            if rec.input_shape is not None:
                x = x.reshape((x.shape[0],) + rec.input_shape)
        except ValueError as e:
            raise ClientRequestError(f"bad rows for {rec.key}: {e}") from e
        want = getattr(rec.model, "_input_shape", None)
        if want is not None and (x.ndim != len(want) + 1 or x.shape[0] < 1
                                 or x.shape[-1] != want[-1]):
            raise ClientRequestError(
                f"bad rows for {rec.key}: got {list(x.shape)}, each row "
                f"must have rank {len(want)} and {want[-1]} features")
        if rec.normalizer is None:
            return x
        try:
            return rec.normalizer.transform_array(x)
        except Exception as e:  # noqa: BLE001 — input boundary
            raise ClientRequestError(
                f"bad request rows for {rec.key}: "
                f"{type(e).__name__}: {e}") from e

    def _direct_output(self, rec, x: np.ndarray) -> np.ndarray:
        """The naive per-request path the batcher replaces: one locked
        ``output`` call per request."""
        with self._lock:
            return _first_output(rec.model.output(x))

    def _breaker_for(self, rec) -> CircuitBreaker:
        with self._engine_lock:
            breaker = self._breakers.get(rec.key)
            if breaker is None:

                def on_transition(old, new, reason, _key=rec.key):
                    # the health timeline rides the journal: when each
                    # record broke or recovered, and why
                    obs_journal.event("serve.health", model=_key,
                                      old=old, new=new, reason=reason)

                breaker = self._breakers[rec.key] = CircuitBreaker(
                    fails=self.breaker_fails,
                    cooldown_s=self.breaker_cooldown_s,
                    key=rec.key, stats=self.stats,
                    on_transition=on_transition)
            return breaker

    def _batcher_for(self, rec) -> DynamicBatcher:
        with self._engine_lock:
            batcher = self._batchers.get(rec.key)
            if batcher is None:
                model, chaos = rec.model, self.chaos

                def infer(batch, _model=model):
                    if chaos is not None:
                        # per dispatch; an injected hang blocks here
                        chaos.on_infer()
                    return _first_output(_model.output(batch))

                batcher = DynamicBatcher(
                    infer, max_batch=self.max_batch,
                    max_wait_ms=self.max_wait_ms,
                    queue_capacity=self.queue_capacity,
                    default_timeout_s=self.request_timeout_s,
                    stats=self.stats, watchdog_s=self.watchdog_s,
                    on_outcome=self._outcome_hook(rec),
                    on_wedged=self._wedged_hook(rec))
                self._batchers[rec.key] = batcher
            return batcher

    # -- /embed (retrieval/embed.py adapters) -------------------------------
    def embed_for(self, name, version, x, timeout_s: Optional[float] = None,
                  layer=None, pool: Optional[str] = None) -> np.ndarray:
        """Rows -> embeddings [N, dim] through the (name, version)
        record's adapter (``ModelRecord.embed_adapter``), behind the same
        admission gate, dynamic batcher and bucket ladder as /predict."""
        rec = self.registry.get(name, version)
        breaker = self._admit(rec)
        if rec.model is None:
            raise KeyError(f"{rec.key} is unloaded")
        x = np.asarray(x)
        rid = next(self._rid)
        with obs_trace.span("serve.request", rid=rid, model=rec.key,
                            rows=int(x.shape[0]), kind="embed"):
            if not self.batching_enabled:
                try:
                    out = self._direct_embed(rec, x, layer, pool)
                except ClientRequestError:
                    raise  # the client's payload: no vote either way
                except Exception as e:  # noqa: BLE001 — serving boundary
                    breaker.record_failure(f"{type(e).__name__}: {e}")
                    raise
                breaker.record_success()
            else:
                out = self._embed_batcher_for(rec, layer, pool).predict(
                    x, timeout_s=timeout_s, rid=rid)
        self.retrieval_stats.bump("embed_requests")
        self.retrieval_stats.bump("embed_rows", int(x.shape[0]))
        return out

    def embed(self, x, timeout_s: Optional[float] = None) -> np.ndarray:
        """The default record's :meth:`embed_for`."""
        return self.embed_for(None, None, x, timeout_s=timeout_s)

    def _embed_rows(self, rec, x: np.ndarray, layer, pool) -> np.ndarray:
        """The one compute path of the direct call and the batcher's
        dispatch: shape and normalize as /predict does, zero-pad up the
        bucket ladder, encode, slice the pad rows off (every encoder is
        row-independent)."""
        adapter = rec.embed_adapter(layer=layer, pool=pool)
        batch = self._shape_rows(rec, x)
        n = int(batch.shape[0])
        bucket = dispatch.bucket_size(n)
        if bucket > n:
            pad = np.zeros((bucket - n,) + batch.shape[1:], batch.dtype)
            batch = np.concatenate([batch, pad])
        return np.asarray(adapter(batch))[:n]

    def _direct_embed(self, rec, x: np.ndarray, layer, pool) -> np.ndarray:
        with self._lock:
            return self._embed_rows(rec, x, layer, pool)

    def _embed_batcher_for(self, rec, layer=None,
                           pool: Optional[str] = None) -> DynamicBatcher:
        """The record's embed batcher, made on its first request with that
        request's layer and pool (the JAX engine keys it by record)."""
        with self._engine_lock:
            batcher = self._embed_batchers.get(rec.key)
            if batcher is None:
                chaos = self.chaos

                def infer(batch, _rec=rec, _layer=layer, _pool=pool):
                    if chaos is not None:
                        chaos.on_infer()
                    return self._embed_rows(_rec, np.asarray(batch),
                                            _layer, _pool)

                batcher = DynamicBatcher(
                    infer, max_batch=self.max_batch,
                    max_wait_ms=self.max_wait_ms,
                    queue_capacity=self.queue_capacity,
                    default_timeout_s=self.request_timeout_s,
                    stats=self.stats, watchdog_s=self.watchdog_s,
                    on_outcome=self._outcome_hook(rec),
                    on_wedged=self._wedged_hook(rec))
                self._embed_batchers[rec.key] = batcher
            return batcher

    def embed_report(self) -> Dict[str, Any]:
        """/models: each live record's adapter kind and dim (no model
        call: config fields and propagated shapes)."""
        out: Dict[str, Any] = {}
        for rec in self._live_records():
            try:
                adapter = rec.embed_adapter()
            except TypeError:
                continue  # no embedding surface on this model family
            out[rec.key] = {"kind": adapter.kind, "dim": adapter.dim}
        return out

    # -- /search (retrieval/store.py) ---------------------------------------
    def register_index(self, name: str, store) -> None:
        """Attach a ``retrieval/store.VectorStore`` behind /search."""
        with self._engine_lock:
            self._indexes[str(name)] = store

    def unregister_index(self, name: str):
        with self._engine_lock:
            return self._indexes.pop(str(name), None)

    def index(self, name: str):
        store = self._indexes.get(str(name))
        if store is None:
            raise ClientRequestError(f"no index named {name!r}")
        return store

    def search(self, index_name, queries, k: int = 10,
               nprobe: Optional[int] = None):
        """Top-k (ids, scores) over a registered index's CURRENT published
        generation, lock-free against publishes: a concurrent generation
        swap fails no admitted search (the store's snapshot rule). A
        draining engine refuses (503)."""
        if self._draining:
            self.stats.record_fast_fail()
            raise DrainingError("engine is draining; admission closed")
        store = self.index(index_name)
        rid = next(self._rid)
        q = np.asarray(queries, np.float32)
        with obs_trace.span("serve.request", rid=rid, index=str(index_name),
                            rows=int(q.shape[0]) if q.ndim > 1 else 1,
                            kind="search"):
            return store.search(q, k=k, nprobe=nprobe)

    def index_report(self) -> Dict[str, Any]:
        """/models: each index's capacity, rows and generation (the
        stores' own host-side accounting)."""
        with self._engine_lock:
            stores = dict(self._indexes)
        return {name: store.report() for name, store in stores.items()}

    def _outcome_hook(self, rec):
        """A record's breaker, fed per dispatch by its batcher."""
        def on_outcome(ok: bool, exc, _rec=rec):
            breaker = self._breaker_for(_rec)
            if ok:
                breaker.record_success()
            elif isinstance(exc, ClientRequestError):
                pass  # the client's payload: no vote either way
            elif isinstance(exc, WorkerDeadError):
                breaker.trip(f"{exc}")  # categorical: nothing dispatches
            else:
                breaker.record_failure(f"{type(exc).__name__}: {exc}")
        return on_outcome

    def _wedged_hook(self, rec):
        """The watchdog's verdict trips the record's breaker and journals
        the wedge, flushed with fsync: a hung device leaves a readable
        timeline even if the process dies next."""
        def on_wedged(info, _rec=rec):
            self._breaker_for(_rec).trip(f"watchdog: {info['error']}")
            obs_journal.event(
                "serve.wedged", model=_rec.key, rows=int(info["rows"]),
                failed_requests=int(info["failed_requests"]),
                watchdog_s=float(info["watchdog_s"]))
            obs_journal.flush(fsync=True)
        return on_wedged

    def _decoder_for(self, rec):
        """The record's decode pool, built on first use as the JAX engine
        builds it: paged (speculative under ``DL4J_TPU_SERVE_SPEC``) for
        kv_block > 0, fixed-slot for kv_block = 0; None for a record that
        is not a TransformerLM, under ``DL4J_TPU_SERVE_CONTINUOUS=0``, or
        when building it raises a ValueError."""
        if not self.continuous_enabled:
            return None
        with self._engine_lock:
            if rec.key in self._no_decoder:
                return None
            decoder = self._decoders.get(rec.key)
            if decoder is not None:
                return decoder
            if not isinstance(rec.model, TransformerLM):
                self._no_decoder.add(rec.key)
                return None
            timeout = max(self.request_timeout_s, 300.0)
            paged_kw = dict(
                block_tokens=self.kv_block, n_blocks=self.kv_blocks or None,
                min_lanes=self.slots, stats=self.stats,
                default_timeout_s=timeout,
                slo_classes=self.slo_classes or None,
                queue_cap=self.queue_capacity, chaos=self.chaos,
                device=self.device)
            if self.mesh_devices >= 2:
                # DL4J_TPU_SERVE_MESH: an incompatibility raises OUT of
                # here (JAX :796-815): a caller who asked for the sharded
                # tick is never served by the dense one
                if self.kv_block <= 0:
                    raise ValueError(
                        "DL4J_TPU_SERVE_MESH requires the paged KV pool "
                        "(DL4J_TPU_SERVE_KV_BLOCK > 0); the fixed-slot pool "
                        "has no sharded arena")
                from deeplearning4j_tpu_torch.serving.mesh import (
                    MeshPagedDecoder,
                )

                decoder = MeshPagedDecoder(
                    rec.model, devices=self.mesh_devices, **paged_kw)
                self._decoders[rec.key] = decoder
                return decoder
            try:
                if self.kv_block <= 0:
                    decoder = ContinuousDecoder(
                        rec.model, slots=self.slots, stats=self.stats,
                        default_timeout_s=timeout, chaos=self.chaos,
                        device=self.device)
                else:
                    spec = lowprec.spec_mode()
                    if spec:
                        decoder = SpeculativeDecoder(
                            rec.model, draft=rec.draft_net(spec),
                            **paged_kw)
                    else:
                        decoder = PagedDecoder(rec.model, **paged_kw)
            except ValueError:
                self._no_decoder.add(rec.key)
                return None
            self._decoders[rec.key] = decoder
            return decoder

    # -- /generate ---------------------------------------------------------
    def generate(self, tokens, n_new: int, *, temperature: float = 1.0,
                 seed: int = 0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 slo: Optional[str] = None, name=None,
                 version=None) -> np.ndarray:
        """[N, T] (or [T]) prompts -> [N, n_new] sampled continuations of
        the (name, version) record. Plain sampling goes through its
        decoder (row i draws from seed + i; ``slo`` where the pool has
        classes); ``top_k``/``top_p``, or a record without a decoder,
        through ``lm.generate``, one call at a time."""
        rec = self.registry.get(name, version)
        breaker = self._admit(rec)
        model = rec.model
        if model is None:
            raise KeyError(f"{rec.key} is unloaded")
        if not isinstance(model, TransformerLM):
            # addressing a non-LM record is the client's mistake: no vote
            raise ClientRequestError(
                f"POST /generate needs a TransformerLM; {rec.key} is a "
                f"{type(model).__name__}")
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        rid = next(self._rid)
        with obs_trace.span("serve.request", rid=rid, model=rec.key,
                            rows=int(tokens.shape[0]), kind="generate"):
            try:
                out = self._generate_inner(rec, model, tokens, n_new,
                                           temperature, seed, top_k, top_p,
                                           slo)
            except (RequestTimeoutError, FutureTimeoutError,
                    ClientRequestError):
                raise  # deadlines and payloads are no evidence of health
            except Exception as e:  # noqa: BLE001 — serving boundary
                breaker.record_failure(f"{type(e).__name__}: {e}")
                raise
            breaker.record_success()
        return out

    def _generate_inner(self, rec, model, tokens, n_new, temperature,
                        seed, top_k, top_p, slo) -> np.ndarray:
        decoder = (self._decoder_for(rec)
                   if top_k is None and top_p is None else None)
        if decoder is not None:
            kwargs = {}
            if slo is not None and decoder.supports_streaming:
                kwargs["slo"] = slo
            return np.asarray(decoder.generate(
                tokens, int(n_new), temperature=float(temperature),
                seed=int(seed), **kwargs))
        with self._lock:
            out = model.generate(
                tokens, int(n_new), temperature=float(temperature),
                seed=int(seed), top_k=top_k, top_p=top_p).cpu().numpy()
        self.stats.record_tokens(int(out.size))
        return out

    def generate_stream(self, tokens, n_new: int, *,
                        temperature: float = 1.0, seed: int = 0,
                        slo: Optional[str] = None, name=None, version=None):
        """Streaming ``/generate`` for ONE prompt: an iterator of token ids,
        each yielded as the decode tick produces it (the fixed-slot pool,
        or no decoder: the same ids after the whole generation).
        Admission errors raise HERE, before a caller commits response
        headers; mid-generation failures raise from the iterator."""
        rec = self.registry.get(name, version)
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        decoder = (self._decoder_for(rec)
                   if isinstance(rec.model, TransformerLM) else None)
        if decoder is None or not decoder.supports_streaming:
            # generate() admits itself: admitting here too would spend a
            # half-open probe twice
            out = self.generate(prompt, n_new, temperature=temperature,
                                seed=seed, slo=slo, name=name,
                                version=version)
            return iter(np.asarray(out).reshape(-1).tolist())
        breaker = self._admit(rec)
        rid = next(self._rid)
        q: stdqueue.Queue = stdqueue.Queue()
        with obs_trace.span("serve.request", rid=rid, model=rec.key,
                            rows=1, kind="generate_stream"):
            fut = decoder.submit(prompt, int(n_new),
                                 temperature=float(temperature),
                                 seed=int(seed), slo=slo, on_token=q.put)

        def stream():
            while True:
                try:
                    yield int(q.get(timeout=0.2))
                    continue
                except stdqueue.Empty:
                    pass
                if not fut.done():
                    continue
                # on_token callbacks run BEFORE the future resolves, so a
                # done future means every token is already queued
                try:
                    fut.result(timeout=0)
                except (RequestTimeoutError, FutureTimeoutError,
                        ClientRequestError):
                    raise
                except Exception as e:  # noqa: BLE001 — serving boundary
                    breaker.record_failure(f"{type(e).__name__}: {e}")
                    raise
                breaker.record_success()
                while True:
                    try:
                        yield int(q.get_nowait())
                    except stdqueue.Empty:
                        return

        return stream()

    def _paged_decoder(self, rec, verb: str):
        decoder = self._decoder_for(rec)
        if not isinstance(decoder, PagedDecoder):
            raise ClientRequestError(
                f"model {rec.key} has no paged decoder to {verb}")
        return decoder

    def prefill_for(self, name, version, tokens, n_new: int):
        """The prefill half of the handoff: (digests, k_blocks, v_blocks,
        block_tokens) of the prompt's full blocks below its write block
        (``PagedDecoder.export_prefix``), for a decode replica's
        :meth:`prime_for`."""
        rec = self.registry.get(name, version)
        breaker = self._admit(rec)
        decoder = self._paged_decoder(rec, "prefill")
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        rid = next(self._rid)
        with obs_trace.span("serve.request", rid=rid, model=rec.key,
                            rows=1, kind="prefill"):
            try:
                digests, kb, vb = decoder.export_prefix(prompt, int(n_new))
            except ClientRequestError:
                raise
            except Exception as e:  # noqa: BLE001 — serving boundary
                breaker.record_failure(f"{type(e).__name__}: {e}")
                raise
            breaker.record_success()
        return digests, kb, vb, int(decoder.block_tokens)

    def prime_for(self, name, version, digests, k_blocks,
                  v_blocks) -> int:
        """The decode half: adopt exported blocks into the arena and the
        prefix cache; returns the blocks adopted (a partial adoption is
        fine: the next admission recomputes the rest)."""
        rec = self.registry.get(name, version)
        breaker = self._admit(rec)
        decoder = self._paged_decoder(rec, "prime")
        try:
            adopted = decoder.import_prefix(digests, k_blocks, v_blocks)
        except ClientRequestError:
            raise
        except Exception as e:  # noqa: BLE001 — serving boundary
            breaker.record_failure(f"{type(e).__name__}: {e}")
            raise
        breaker.record_success()
        return int(adopted)

    # -- reports -----------------------------------------------------------
    def _live_records(self):
        out = []
        for d in self.registry.describe():
            if d["state"] in ("broken", "unloaded"):
                continue
            rec = self.registry.get(d["name"], d["version"])
            if rec.model is not None:
                out.append(rec)
        return out

    def kv_report(self) -> Dict[str, Any]:
        """/models KV capacity per record with a decode pool (eligible
        decoders are built on first ask: capacity is a property of the
        configuration)."""
        out: Dict[str, Any] = {}
        for rec in self._live_records():
            decoder = self._decoder_for(rec)
            if decoder is not None:
                out[rec.key] = decoder.kv_capacity()
        return out

    def hbm_report(self) -> Dict[str, Any]:
        """Resident device bytes: every live record's tensors
        (``ops/memory.model_resident_bytes``) and every live decoder's KV
        arena (paged: n_blocks + the trash block; fixed slots: one max_len
        stripe a slot), summed per record name against the device's
        memory, and every registered index's arena (``arena_bytes``: the
        staging rows) under ``indexes``. Shape arithmetic, no device
        read."""
        budget = opsmem.device_memory_bytes(self.device)
        models: Dict[str, Any] = {}
        used = 0
        with self._engine_lock:
            decoders = dict(self._decoders)
            stores = dict(self._indexes)
        for rec in self._live_records():
            entry = {"param_bytes": opsmem.model_resident_bytes(rec.model),
                     "kv_bytes": 0}
            decoder = decoders.get(rec.key)
            if isinstance(decoder, PagedDecoder):
                # a mesh whose shards sit one a card holds 1/d of each
                entry["kv_bytes"] = (decoder.n_blocks + 1) * \
                    opsmem.kv_block_bytes(decoder.cfg, decoder.block_tokens,
                                          decoder.kv_dtype,
                                          decoder.arena_devices)
            elif isinstance(decoder, ContinuousDecoder):
                entry["kv_bytes"] = decoder.slots * opsmem.kv_block_bytes(
                    decoder.cfg, decoder.cfg.max_len,
                    decoder.cfg.compute_dtype)
            used += entry["param_bytes"] + entry["kv_bytes"]
            agg = models.setdefault(rec.name,
                                    {"param_bytes": 0, "kv_bytes": 0})
            agg["param_bytes"] += entry["param_bytes"]
            agg["kv_bytes"] += entry["kv_bytes"]
        indexes = {name: int(store.report()["arena_bytes"])
                   for name, store in stores.items()}
        used += sum(indexes.values())
        return {"budget_bytes": budget, "used_bytes": used,
                "utilization": used / budget if budget else None,
                "models": models, "indexes": indexes}

    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"serving": self.stats.snapshot(),
                               "models": self.registry.describe(),
                               "health": self.model_health(),
                               "draining": self._draining,
                               "hbm": self.hbm_report()}
        rec = self.registry.default()
        with self._engine_lock:
            d = self._decoders.get(rec.key) if rec is not None else None
        if d is not None:
            paged = isinstance(d, PagedDecoder)
            dec = {"scheme": "paged" if paged else "fixed-slot",
                   "tick_k": d.tick_k,
                   "decode_ticks": d.decode_ticks,
                   "tick_seconds": d.tick_seconds,
                   "admissions": d.admissions,
                   "admit_seconds": d.admit_seconds,
                   "peak_active": d.peak_active}
            if paged:
                dec.update(lanes=d.lanes, n_blocks=d.n_blocks,
                           block_tokens=d.block_tokens,
                           kv_dtype=dtype_name(d.kv_dtype))
            else:
                dec.update(slots=d.slots)
            if isinstance(d, SpeculativeDecoder):
                dec.update(spec_k=d.spec_k, spec_rounds=d.spec_rounds,
                           spec_seconds=d.spec_seconds,
                           draft=d._draft.draft_mode)
            out["decode"] = dec
            out["dispatch"] = d.dispatch_stats.snapshot()
        kernels: Dict[str, Any] = {}
        for r in self._live_records():
            if isinstance(r.model, TransformerLM):
                kernels.update(GENERATE_KERNELS)
            elif hasattr(r.model, "embed_tokens"):  # BERT
                kernels.update(EMBED_KERNELS)
            elif hasattr(r.model, "output"):
                kernels.update(PREDICT_KERNELS)
        out["kernels"] = kernel_counts(kernels)
        return out

    def model_health(self) -> Dict[str, str]:
        """Per record: the breaker's state once it has taken traffic, the
        lifecycle state otherwise (broken and unloaded read as such)."""
        out: Dict[str, str] = {}
        with self._engine_lock:
            breakers = dict(self._breakers)
        for d in self.registry.describe():
            key = f"{d['name']}@v{d['version']}"
            if d["state"] in ("broken", "unloaded"):
                out[key] = d["state"]
                continue
            breaker = breakers.get(key)
            out[key] = breaker.state if breaker is not None else d["state"]
        return out

    def health(self):
        """(http_code, body) for /health: 503 while draining or when every
        loaded record is broken; 200 otherwise (an engine with no records
        is healthy and empty)."""
        health = self.model_health()
        live = [k for k, v in health.items()
                if v not in ("broken", "unloaded")]
        loaded = [k for k, v in health.items() if v != "unloaded"]
        ok = not self._draining and (bool(live) or not loaded)
        rec = self.registry.default()
        body = {
            "ok": ok,
            "draining": self._draining,
            "model": (type(rec.model).__name__
                      if rec is not None and rec.model is not None
                      else None),
            "models": [r["name"] + "@v" + str(r["version"])
                       for r in self.registry.describe()],
            "health": health,
            "device": str(self.device),
        }
        if self.role:
            # only a role-tagged replica adds the key (JAX :1334-1338)
            body["role"] = self.role
        return (200 if ok else 503), body

    def readiness(self):
        """(http_code, body) for /health?ready=1: "live" is true in every
        answer this process sends; "ready" is plain /health's ok (false
        while draining), so a router stops new traffic without reading a
        drain as death."""
        code, body = self.health()
        body = dict(body)
        body["live"] = True
        body["ready"] = body["ok"]
        return code, body

    def retire(self, name, version=None) -> None:
        """Unload a record after stopping and dropping its batcher,
        decoder and breaker (they hold the model too), so its device
        memory is freed now."""
        rec = self.registry.get(name, version)
        with self._engine_lock:
            batcher = self._batchers.pop(rec.key, None)
            embed_batcher = self._embed_batchers.pop(rec.key, None)
            decoder = self._decoders.pop(rec.key, None)
            self._no_decoder.discard(rec.key)
            self._breakers.pop(rec.key, None)
        for b in (batcher, embed_batcher, decoder):
            if b is not None:
                b.stop()
        del batcher, embed_batcher, decoder
        self.registry.unload(rec.name, rec.version)
        gc.collect()  # cycles through thread targets and closures

    # -- HTTP -------------------------------------------------------------
    def _make_handler(self):
        engine = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer (the streaming contract) is HTTP/1.1; every
            # non-streamed response carries a Content-Length
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n))

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/health":
                    if "ready=1" in query.split("&"):
                        self._send(*engine.readiness())
                    else:
                        self._send(*engine.health())
                elif path == "/metrics":
                    accept = self.headers.get("Accept", "")
                    if ("format=prometheus" in query
                            or "text/plain" in accept
                            or "openmetrics" in accept):
                        body = (obs_registry.default_registry()
                                .render_prometheus().encode())
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            obs_registry.PROMETHEUS_CONTENT_TYPE)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._send(200, engine.metrics())
                elif path == "/models":
                    default = engine.registry.default()
                    self._send(200, {
                        "models": engine.registry.describe(),
                        "default": default.key if default else None,
                        "kv": engine.kv_report(),
                        "lineage": engine.registry.lineage(),
                        "embed": engine.embed_report(),
                        "indexes": engine.index_report()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/generate":
                        self._do_generate()
                    elif self.path == "/predict":
                        self._do_predict()
                    elif self.path == "/embed":
                        self._do_embed()
                    elif self.path == "/search":
                        self._do_search()
                    elif self.path == "/prefill":
                        self._do_prefill()
                    elif self.path == "/prime":
                        self._do_prime()
                    elif self.path == "/models":
                        self._do_models()
                    else:
                        self._send(404, {"error": "not found"})
                except QueueFullError as e:
                    self._send(429, {"error": f"QueueFull: {e}"})
                except (BreakerOpenError, DrainingError) as e:
                    # RFC 9110 delta-seconds is an integer: round a
                    # sub-second cooldown up to 1
                    self._send(503, {"error": f"Unavailable: {e}"},
                               headers={"Retry-After": str(max(
                                   1, math.ceil(e.retry_after_s)))})
                except ModelWedgedError as e:
                    self._send(503, {"error": f"Wedged: {e}"},
                               headers={"Retry-After": "1"})
                except WorkerDeadError as e:
                    self._send(503, {"error": f"WorkerDead: {e}"},
                               headers={"Retry-After": "1"})
                except RequestTimeoutError as e:
                    self._send(504, {"error": f"Timeout: {e}"})
                except FutureTimeoutError as e:
                    engine.stats.record_timeout()
                    self._send(504, {"error": f"Timeout: {e}"})
                except Exception as e:  # noqa: BLE001 — serving boundary
                    engine.stats.record_error()
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

            def _do_prefill(self):
                payload = self._read_json()
                toks = np.asarray(payload["tokens"], np.int32).reshape(-1)
                digests, kb, vb, bt = engine.prefill_for(
                    payload.get("model"), payload.get("version"), toks,
                    int(payload.get("n_new", 16)))
                self._send(200, {
                    "digests": [d.hex() for d in digests],
                    "k": blocks_to_wire(kb), "v": blocks_to_wire(vb),
                    "shape": list(kb.shape), "dtype": dtype_name(kb.dtype),
                    "block_tokens": int(bt)})

            def _do_prime(self):
                payload = self._read_json()
                shape, dtype = payload["shape"], str(payload["dtype"])
                kb = blocks_from_wire(payload["k"], shape, dtype)
                vb = blocks_from_wire(payload["v"], shape, dtype)
                digests = [bytes.fromhex(d) for d in payload["digests"]]
                adopted = engine.prime_for(payload.get("model"),
                                           payload.get("version"), digests,
                                           kb, vb)
                self._send(200, {"adopted": int(adopted)})

            def _do_predict(self):
                payload = self._read_json()
                if "record_base64" in payload:
                    # imported here: streaming/ subclasses this engine
                    from deeplearning4j_tpu_torch.streaming.conversion \
                        import decode_record_base64

                    x = decode_record_base64(payload["record_base64"])[None]
                elif "record" in payload:
                    x = np.asarray(payload["record"], np.float32)[None]
                elif "batch" in payload:
                    x = np.asarray(payload["batch"], np.float32)
                else:
                    self._send(400,
                               {"error": "need record|record_base64|batch"})
                    return
                timeout = payload.get("timeout_s")
                out = engine.predict_for(
                    payload.get("model"), payload.get("version"), x,
                    # an explicit 0 means no wait, not the default
                    timeout_s=(float(timeout) if timeout is not None
                               else None))
                if "batch" in payload:
                    self._send(200, {"outputs": out.tolist()})
                else:
                    self._send(200, {"output": out[0].tolist()})

            def _do_embed(self):
                payload = self._read_json()
                if "record" in payload:
                    x = np.asarray(payload["record"], np.float32)[None]
                elif "batch" in payload:
                    x = np.asarray(payload["batch"], np.float32)
                elif "tokens" in payload:
                    # token-id rows (BERT, a word2vec table) stay integral
                    x = np.asarray(payload["tokens"])
                    if x.ndim == 1:
                        x = x[None]
                else:
                    self._send(400, {"error": "need record|batch|tokens"})
                    return
                timeout = payload.get("timeout_s")
                out = engine.embed_for(
                    payload.get("model"), payload.get("version"), x,
                    timeout_s=(float(timeout) if timeout is not None
                               else None),
                    layer=payload.get("layer"), pool=payload.get("pool"))
                many = "batch" in payload or "tokens" in payload
                self._send(200, {
                    "embeddings" if many else "embedding":
                        out.tolist() if many else out[0].tolist(),
                    "dim": int(out.shape[-1])})

            def _do_search(self):
                payload = self._read_json()
                if "queries" in payload:
                    q = np.asarray(payload["queries"], np.float32)
                elif "query" in payload:
                    q = np.asarray(payload["query"], np.float32)[None]
                else:
                    self._send(400, {"error": "need query|queries"})
                    return
                nprobe = payload.get("nprobe")
                ids, scores = engine.search(
                    payload.get("index", "default"), q,
                    k=int(payload.get("k", 10)),
                    nprobe=int(nprobe) if nprobe is not None else None)
                # -inf scores (fewer live rows than k) travel as
                # -Infinity, as json.dumps writes them
                self._send(200, {"ids": ids.tolist(),
                                 "scores": scores.tolist()})

            def _do_generate(self):
                payload = self._read_json()
                toks = np.asarray(payload["tokens"], np.int32)
                # JSON numbers may arrive as floats: top_k is an int
                tk, tp = payload.get("top_k"), payload.get("top_p")
                kwargs = dict(temperature=float(payload.get("temperature",
                                                            1.0)),
                              seed=int(payload.get("seed", 0)),
                              slo=payload.get("slo"),
                              name=payload.get("model"),
                              version=payload.get("version"))
                n_new = int(payload.get("n_new", 16))
                if payload.get("stream"):
                    if tk is not None or tp is not None:
                        self._send(400, {"error": "stream does not "
                                         "support top_k/top_p"})
                        return
                    if toks.ndim > 1 and toks.shape[0] != 1:
                        self._send(400, {"error": "stream takes ONE "
                                         "prompt per request"})
                        return
                    gen = engine.generate_stream(toks.reshape(-1), n_new,
                                                 **kwargs)
                    self._stream_tokens(gen)
                    return
                out = engine.generate(
                    toks, n_new, top_k=int(tk) if tk is not None else None,
                    top_p=float(tp) if tp is not None else None, **kwargs)
                self._send(200, {"tokens": out.tolist()})

            def _stream_tokens(self, gen):
                # manual chunked framing: one NDJSON object per token,
                # flushed as sampled; failures after the headers can only
                # ride the stream
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                    self.wfile.flush()

                out = []
                try:
                    for t in gen:
                        out.append(int(t))
                        chunk({"token": int(t)})
                    chunk({"done": True, "tokens": out})
                except (RequestTimeoutError, FutureTimeoutError) as e:
                    chunk({"error": f"Timeout: {e}"})
                except Exception as e:  # noqa: BLE001 — serving boundary
                    engine.stats.record_error()
                    chunk({"error": f"{type(e).__name__}: {e}"})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            def _do_models(self):
                payload = self._read_json()
                action = payload.get("action")
                name = payload.get("name")
                version = payload.get("version")
                if action == "load":
                    rec = engine.registry.load(
                        name, model_path=payload.get("path"),
                        input_shape=payload.get("input_shape"))
                    self._send(200, rec.describe())
                elif action == "warmup":
                    self._send(200, engine.registry.warmup(
                        name, version,
                        max_batch=int(payload.get("max_batch",
                                                  engine.max_batch)),
                        gen_tokens=int(payload.get("gen_tokens", 0))))
                elif action == "serve":
                    rec = engine.registry.serve(name, version)
                    self._send(200, rec.describe())
                elif action == "unload":
                    engine.retire(name, version)
                    self._send(200, engine.registry.get(
                        name, version).describe())
                else:
                    self._send(400, {"error": "action must be "
                                     "load|warmup|serve|unload"})

        return Handler

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Close admission (503), seal the registry first (a rollout
        racing the drain cannot promote a half-warmed record), then wait
        up to ``DL4J_TPU_SERVE_DRAIN_S`` for every admitted request: the
        batchers' queues and in-flight batches and the decoders' pending
        prompts and lanes. True when everything admitted was answered in
        time."""
        budget = float(timeout_s if timeout_s is not None else self.drain_s)
        self._draining = True
        self.registry.seal()
        obs_journal.event("serve.drain", drain_s=budget)
        deadline = time.monotonic() + budget
        with self._engine_lock:
            batchers = (list(self._batchers.values())
                        + list(self._embed_batchers.values()))
            decoders = list(self._decoders.values())
        ok = True
        for b in batchers:
            ok = b.drain(max(0.0, deadline - time.monotonic())) and ok
        for d in decoders:
            ok = d.drain(max(0.0, deadline - time.monotonic())) and ok
        self.stats.record_drain(ok)
        obs_journal.event("serve.drain_complete", completed=ok)
        obs_journal.flush(fsync=True)
        self._drained = True
        return ok

    def stop(self, drain: bool = True,
             drain_timeout_s: Optional[float] = None) -> None:
        """Shutdown: by default answer everything already admitted (a
        drain, unless one already ran), then stop the HTTP server, the
        batchers and the decoders."""
        if drain and not self._drained:
            self.drain(drain_timeout_s)
        self._draining = True
        self.restore_signal_handlers()
        if self._thread is not None:
            # shutdown() handshakes with a running serve_forever loop
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._engine_lock:
            batchers = (list(self._batchers.values())
                        + list(self._embed_batchers.values()))
            decoders = list(self._decoders.values())
            self._batchers.clear()
            self._embed_batchers.clear()
            self._decoders.clear()
        for b in batchers:
            b.stop()
        for d in decoders:
            d.stop()

    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """A preemption signal drains and stops the engine. Main thread
        only (the signal module's rule); raises ValueError elsewhere."""
        for sig in signals:
            self._old_handlers[sig] = signal.signal(sig, self._on_signal)

    def restore_signal_handlers(self) -> None:
        for sig in list(self._old_handlers):
            try:
                signal.signal(sig, self._old_handlers[sig])
            except ValueError:
                continue  # not the main thread: a later stop restores
            del self._old_handlers[sig]

    def _on_signal(self, signum, frame) -> None:
        # close admission in the handler (one flag write); the journal
        # and the drain run on their own thread (the journal's lock may
        # be held by the very frame this handler interrupted)
        self._draining = True
        threading.Thread(target=self._preempt_stop, args=(int(signum),),
                         daemon=True, name="serve-drain").start()

    def _preempt_stop(self, signum: int) -> None:
        obs_journal.event("serve.preempt", signum=signum)
        self.stop(drain=True)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        return self._drained

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
