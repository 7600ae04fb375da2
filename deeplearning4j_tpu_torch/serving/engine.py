"""ServingEngine: the HTTP front door over the decode pools and the
``/predict`` batcher (counterpart: ``deeplearning4j_tpu/serving/engine.py``).

It takes ``model=`` (a TransformerLM or a MultiLayerNetwork) or
``model_path=`` (a checkpoint zip the JAX package wrote, restored by its
model class) like the JAX engine (``engine.py:224-232``).

Routes (stdlib HTTP, JSON — the contracts of the JAX engine):

  POST /generate  (a TransformerLM; ``engine.py:1067-1102``)
                  {"tokens": [[ids]] | [ids], "n_new": K, "temperature"?,
                  "seed"?, "slo"?} -> {"tokens": [[ids]]}. With
                  "stream": true (one prompt) the response is chunked
                  application/x-ndjson: one {"token": t} line per token as
                  it is sampled, then {"done": true, "tokens": [...]} (or
                  {"error": ...} if generation failed mid-stream).
                  "top_k"/"top_p" sample through ``lm.generate`` (one
                  generator seeded with "seed" for the batch, calls
                  serialized), as the JAX engine does (:509-529); with
                  "stream" they answer 400.
                  429 when the decode queue is full, 503 when the decode
                  worker is dead or the engine is draining, 504 past the
                  request's deadline, 400 for a malformed request.
                  The decoder, as the JAX engine picks it
                  (``_decoder_for`` :774-850): the paged pool, the
                  speculative one under ``DL4J_TPU_SERVE_SPEC`` (its
                  draft from ``ModelRecord.draft_net``), or the fixed-slot
                  pool under ``DL4J_TPU_SERVE_KV_BLOCK=0`` (no streaming
                  there: a stream answers after the whole generation). A
                  ValueError while building it leaves the engine without
                  a decoder, and ``/generate`` samples through
                  ``lm.generate``, as in the JAX engine.
  POST /prefill   (the paged pools; ``engine.py:1104-1120``) {"tokens":
                  [ids], "n_new"?} -> {"digests": [hex], "k", "v": base64
                  of the raw blocks, "shape", "dtype": "float32" |
                  "bfloat16", "block_tokens"}: a prompt's full blocks
                  below its write block (``PagedDecoder.export_prefix``).
  POST /prime     (``engine.py:1122-1135``) that payload -> {"adopted":
                  n}: the blocks adopted into the arena and the prefix
                  cache (``import_prefix``); a dtype or shape that does not
                  match the arena answers 400. bf16 blocks travel as raw
                  16-bit words, both ways, so the JAX engine's payloads
                  are the port's.
  POST /predict   (a MultiLayerNetwork; ``engine.py:995-1020``)
                  {"record": [...]} -> {"output": [...]},
                  {"batch": [[...], ...]} -> {"outputs": [[...], ...]},
                  optional "model", "version", "timeout_s". Rows go
                  through the dynamic batcher, or one locked ``output``
                  call per request under ``DL4J_TPU_SERVE_BATCH=0``.
                  "record_base64" answers 400: not ported yet. 429 when
                  the batcher queue is full, 504 past the deadline, 503
                  when draining, 400 for malformed rows.
  GET  /health    {"ok", "draining", "model", "device"}; 503 when the
                  engine cannot take traffic.
  GET  /models    {"models": <registry listing>, "default": key, "kv":
                  {key: <the decoder's kv_capacity: scheme "paged" or
                  "fixed-slot", capacity_tokens, ...>}}
  GET  /metrics   {"serving": <ServingStats incl. batch fill, draft
                  acceptance and the handoff>, "models": <registry
                  listing>, "decode": <pool shape, ticks, speculative
                  rounds> and "dispatch": <ticks, tokens, tokens per
                  dispatch> (a TransformerLM engine), "kernels": <launch
                  counts of each kernel of the served paths and of its
                  plain version>}

Constructor arguments take precedence; unset ones read the JAX engine's
env knobs through the port's copy of the table (``ops/env.py``):
``DL4J_TPU_SERVE_QUEUE_CAP``, ``DL4J_TPU_SERVE_TIMEOUT_S``,
``DL4J_TPU_SERVE_MAX_BATCH``, ``DL4J_TPU_SERVE_MAX_WAIT_MS``,
``DL4J_TPU_SERVE_BATCH``, ``DL4J_TPU_SERVE_SLOTS``,
``DL4J_TPU_SERVE_KV_BLOCK``, ``DL4J_TPU_SERVE_KV_BLOCKS``,
``DL4J_TPU_SERVE_SPEC`` (read here), and through the decoders
``DL4J_TPU_SERVE_TICK_K``, ``DL4J_TPU_SERVE_SPEC_K`` and
``DL4J_TPU_SERVE_KV_DTYPE``.

Not ported yet: /embed, /search, the POST /models lifecycle, shadow
traffic, the serving mesh and the disaggregation roles, the circuit
breaker and the watchdog, record_base64 and Prometheus exposition.
"""

from __future__ import annotations

import base64
import json
import queue as stdqueue
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
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
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry, restore
from deeplearning4j_tpu_torch.serving.resilience import (
    ClientRequestError,
    DrainingError,
    WorkerDeadError,
)
from deeplearning4j_tpu_torch.serving.slo import SLOClass, parse_slo_classes
from deeplearning4j_tpu_torch.serving.speculate import SpeculativeDecoder
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats

# the kernels of each served path: (wrapper, plain version)
GENERATE_KERNELS = {"flash_attention": (flash_attention,
                                        flash_attention_plain),
                    "paged_attention": (paged_attention,
                                        paged_attention_plain)}
PREDICT_KERNELS = {"lstm_scan": (lstm_scan, lstm_scan_plain)}


def kernel_counts(kernels) -> Dict[str, Dict[str, int]]:
    """Launch counts of each kernel wrapper and of its plain version."""
    return {name: {"launches": fn.launches, "plain_launches": plain.launches}
            for name, (fn, plain) in kernels.items()}


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
    """``/generate`` over a TransformerLM, or ``/predict`` over the
    registry's MultiLayerNetworks, on ``device`` (the card unless the
    caller passes ``device="cpu"``; it must be the model's)."""

    def __init__(self, model=None, *, model_path: Optional[str] = None,
                 port: int = 0, input_shape=None,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 slots: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 slo_classes: Union[str, List[SLOClass], None] = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if model is None and model_path is not None:
            model = restore(model_path, device=self.device)
        if not isinstance(model, (TransformerLM, MultiLayerNetwork)):
            raise TypeError("the port's engine serves a TransformerLM or a "
                            f"MultiLayerNetwork; got {type(model).__name__}")
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine on {self.device}")
        self.model = model
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
        self.batching_enabled = (
            envknob.raw("DL4J_TPU_SERVE_BATCH").strip().lower()
            not in ("0", "off", "false", "no"))
        self.stats = ServingStats()
        self.registry = ModelRegistry(device=self.device)
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._lock = threading.Lock()  # direct /predict, filtered /generate
        self._engine_lock = threading.Lock()  # batcher creation
        self.decoder = None
        if isinstance(model, TransformerLM):
            self.slots = int(slots if slots is not None
                             else envknob.get_int("DL4J_TPU_SERVE_SLOTS"))
            self.kv_block = int(
                kv_block if kv_block is not None
                else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCK"))
            self.kv_blocks = int(
                kv_blocks if kv_blocks is not None
                else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCKS"))
            if isinstance(slo_classes, str):
                slo_classes = parse_slo_classes(slo_classes)
            rec = self.registry.load("default", model=model)
            self.registry.serve(rec.name, rec.version)
            self.decoder = self._decoder_for(rec, slo_classes)
        else:
            rec = self.registry.load("default", model=model,
                                     input_shape=input_shape)
            self.registry.serve(rec.name, rec.version)
        self._draining = False
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _decoder_for(self, rec, slo_classes):
        """The record's decode pool, chosen as the JAX engine chooses it:
        paged (speculative under ``DL4J_TPU_SERVE_SPEC``) for kv_block >
        0, fixed-slot for kv_block = 0; None when building it raises a
        ValueError (``/generate`` then samples through ``lm.generate``)."""
        timeout = max(self.request_timeout_s, 300.0)
        try:
            if self.kv_block <= 0:
                return ContinuousDecoder(
                    rec.model, slots=self.slots, stats=self.stats,
                    default_timeout_s=timeout, device=self.device)
            paged_kw = dict(
                block_tokens=self.kv_block, n_blocks=self.kv_blocks or None,
                min_lanes=self.slots, stats=self.stats,
                default_timeout_s=timeout, slo_classes=slo_classes or None,
                queue_cap=self.queue_capacity, device=self.device)
            spec = lowprec.spec_mode()
            if spec:
                return SpeculativeDecoder(rec.model,
                                          draft=rec.draft_net(spec),
                                          **paged_kw)
            return PagedDecoder(rec.model, **paged_kw)
        except ValueError:
            return None

    # -- in-process surface -----------------------------------------------
    def _admit(self) -> None:
        if self._draining:
            raise DrainingError("engine is draining; admission closed")
        if not isinstance(self.model, TransformerLM):
            raise ClientRequestError(
                "POST /generate needs a TransformerLM; this engine serves "
                f"a {type(self.model).__name__}")

    def generate(self, tokens, n_new: int, *, temperature: float = 1.0,
                 seed: int = 0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 slo: Optional[str] = None) -> np.ndarray:
        """[N, T] (or [T]) prompts -> [N, n_new] sampled continuations.
        Plain sampling goes through the decoder (row i draws from seed +
        i; ``slo`` where the pool has classes); ``top_k``/``top_p``, or
        an engine without a decoder, through ``lm.generate``, one call at
        a time."""
        self._admit()
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        if top_k is not None or top_p is not None or self.decoder is None:
            with self._lock:
                out = self.model.generate(
                    tokens, int(n_new), temperature=float(temperature),
                    seed=int(seed), top_k=top_k, top_p=top_p)
                out = out.cpu().numpy()
            self.stats.record_tokens(int(out.size))
            return out
        kwargs = {}
        if slo is not None and self.decoder.supports_streaming:
            kwargs["slo"] = slo
        return np.asarray(self.decoder.generate(
            tokens, int(n_new), temperature=float(temperature),
            seed=int(seed), **kwargs))

    def generate_stream(self, tokens, n_new: int, *,
                        temperature: float = 1.0, seed: int = 0,
                        slo: Optional[str] = None):
        """Streaming ``/generate`` for ONE prompt: an iterator of token ids,
        each yielded as the decode tick produces it (the fixed-slot pool,
        or no decoder: the same ids after the whole generation).
        Admission errors raise HERE, before a caller commits response
        headers; mid-generation failures raise from the iterator."""
        self._admit()
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        if self.decoder is None or not self.decoder.supports_streaming:
            out = self.generate(prompt, n_new, temperature=temperature,
                                seed=seed, slo=slo)
            return iter(np.asarray(out).reshape(-1).tolist())
        q: stdqueue.Queue = stdqueue.Queue()
        fut = self.decoder.submit(prompt, int(n_new),
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
                fut.result(timeout=0)
                while True:
                    try:
                        yield int(q.get_nowait())
                    except stdqueue.Empty:
                        return

        return stream()

    def _paged_decoder(self, name, version, verb: str):
        """The paged pool of record (name, version), for the handoff."""
        if self._draining:
            raise DrainingError("engine is draining; admission closed")
        rec = self.registry.get(name, version)
        if not isinstance(rec.model, TransformerLM) or \
                not isinstance(self.decoder, PagedDecoder):
            raise ClientRequestError(
                f"model {rec.key} has no paged decoder to {verb}")
        return self.decoder

    def prefill_for(self, name, version, tokens, n_new: int):
        """The prefill half of the handoff: (digests, k_blocks, v_blocks,
        block_tokens) of the prompt's full blocks below its write block
        (``PagedDecoder.export_prefix``), for a decode replica's
        :meth:`prime_for`."""
        decoder = self._paged_decoder(name, version, "prefill")
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        digests, kb, vb = decoder.export_prefix(prompt, int(n_new))
        return digests, kb, vb, int(decoder.block_tokens)

    def prime_for(self, name, version, digests, k_blocks,
                  v_blocks) -> int:
        """The decode half: adopt exported blocks into the arena and the
        prefix cache; returns the blocks adopted (a partial adoption is
        fine: the next admission recomputes the rest)."""
        decoder = self._paged_decoder(name, version, "prime")
        return int(decoder.import_prefix(digests, k_blocks, v_blocks))

    def kv_report(self) -> Dict[str, Any]:
        """/models KV capacity per record with a decode pool."""
        rec = self.registry.default()
        if rec is None or self.decoder is None:
            return {}
        return {rec.key: self.decoder.kv_capacity()}

    def predict(self, x, timeout_s: Optional[float] = None) -> np.ndarray:
        """Rows through the default model (dynamic batcher when enabled,
        the locked direct path otherwise)."""
        return self.predict_for(None, None, x, timeout_s=timeout_s)

    def predict_for(self, name, version, x,
                    timeout_s: Optional[float] = None) -> np.ndarray:
        """[k, ...] rows -> [k, ...] outputs of the (name, version) record
        (the default record when both are None)."""
        if self._draining:
            raise DrainingError("engine is draining; admission closed")
        rec = self.registry.get(name, version)
        if isinstance(rec.model, TransformerLM):
            raise ClientRequestError(
                f"POST /predict needs a MultiLayerNetwork; {rec.key} is a "
                "TransformerLM (POST /generate)")
        x = self._check_rows(rec, np.asarray(x, np.float32))
        if not self.batching_enabled:
            return self._direct_output(rec, x)
        return self._batcher_for(rec).predict(x, timeout_s=timeout_s)

    @staticmethod
    def _check_rows(rec, x: np.ndarray) -> np.ndarray:
        """Reshape to the record's input_shape, when it has one, and hold
        the rows to the model's input rank and feature width (a sequence
        row may have any length): a malformed request is the client's
        error (400), refused before it can share a batch."""
        try:
            if rec.input_shape is not None:
                x = x.reshape((x.shape[0],) + rec.input_shape)
        except ValueError as e:
            raise ClientRequestError(f"bad rows for {rec.key}: {e}") from e
        want = rec.model._input_shape
        if want is not None and (x.ndim != len(want) + 1 or x.shape[0] < 1
                                 or x.shape[-1] != want[-1]):
            raise ClientRequestError(
                f"bad rows for {rec.key}: got {list(x.shape)}, each row "
                f"must have rank {len(want)} and {want[-1]} features")
        return x

    def _direct_output(self, rec, x: np.ndarray) -> np.ndarray:
        """The naive per-request path the batcher replaces: one locked
        ``output`` call per request."""
        with self._lock:
            return rec.model.output(x).float().cpu().numpy()

    def _batcher_for(self, rec) -> DynamicBatcher:
        with self._engine_lock:
            batcher = self._batchers.get(rec.key)
            if batcher is None:
                model = rec.model
                batcher = DynamicBatcher(
                    lambda batch: model.output(batch).float().cpu().numpy(),
                    max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
                    queue_capacity=self.queue_capacity,
                    default_timeout_s=self.request_timeout_s,
                    stats=self.stats)
                self._batchers[rec.key] = batcher
            return batcher

    def metrics(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"serving": self.stats.snapshot(),
                               "models": self.registry.describe()}
        kernels: Dict[str, Any] = {}
        d = self.decoder
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
        if isinstance(self.model, TransformerLM):
            kernels.update(GENERATE_KERNELS)
        else:
            kernels.update(PREDICT_KERNELS)
        out["kernels"] = kernel_counts(kernels)
        return out

    def health(self):
        """(http_code, body): 503 when draining or a worker (the decode
        loop, a batcher) died."""
        dead = ((self.decoder is not None and self.decoder._dead is not None)
                or any(b._dead is not None for b in self._batchers.values()))
        ok = not self._draining and not dead
        body = {"ok": ok, "draining": self._draining,
                "model": type(self.model).__name__,
                "device": str(self.device)}
        return (200 if ok else 503), body

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

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/health":
                    self._send(*engine.health())
                elif path == "/metrics":
                    self._send(200, engine.metrics())
                elif path == "/models":
                    default = engine.registry.default()
                    self._send(200, {
                        "models": engine.registry.describe(),
                        "default": default.key if default else None,
                        "kv": engine.kv_report()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/generate":
                        self._do_generate()
                    elif self.path == "/predict":
                        self._do_predict()
                    elif self.path == "/prefill":
                        self._do_prefill()
                    elif self.path == "/prime":
                        self._do_prime()
                    else:
                        self._send(404, {"error": "not found"})
                except QueueFullError as e:
                    self._send(429, {"error": f"QueueFull: {e}"})
                except (WorkerDeadError, DrainingError) as e:
                    self._send(503, {"error": f"Unavailable: {e}"},
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
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
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
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                shape, dtype = payload["shape"], str(payload["dtype"])
                kb = blocks_from_wire(payload["k"], shape, dtype)
                vb = blocks_from_wire(payload["v"], shape, dtype)
                digests = [bytes.fromhex(d) for d in payload["digests"]]
                adopted = engine.prime_for(payload.get("model"),
                                           payload.get("version"), digests,
                                           kb, vb)
                self._send(200, {"adopted": int(adopted)})

            def _do_predict(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                if "record_base64" in payload:
                    raise ClientRequestError(
                        "record_base64 is not ported yet; send record or "
                        "batch")
                if "record" in payload:
                    x = np.asarray(payload["record"], np.float32)[None]
                elif "batch" in payload:
                    x = np.asarray(payload["batch"], np.float32)
                else:
                    raise ClientRequestError("need record|batch")
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

            def _do_generate(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                toks = np.asarray(payload["tokens"], np.int32)
                # JSON numbers may arrive as floats: top_k is an int
                tk, tp = payload.get("top_k"), payload.get("top_p")
                kwargs = dict(temperature=float(payload.get("temperature",
                                                            1.0)),
                              seed=int(payload.get("seed", 0)),
                              slo=payload.get("slo"))
                n_new = int(payload.get("n_new", 16))
                if payload.get("stream"):
                    if tk is not None or tp is not None:
                        self._send(400, {"error": "stream does not "
                                         "support top_k/top_p"})
                        return
                    engine._admit()
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

        return Handler

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Close admission (503) and wait for every admitted request (the
        decode queue and every batcher's queue and in-flight batch)."""
        self._draining = True
        budget = self.request_timeout_s if timeout_s is None else timeout_s
        with self._engine_lock:
            batchers = list(self._batchers.values())
        ok = all([b.drain(budget) for b in batchers])
        if self.decoder is not None:
            ok = self.decoder.drain(budget) and ok
        return ok

    def stop(self, drain: bool = True,
             drain_timeout_s: Optional[float] = None) -> None:
        """Shutdown: by default answer everything already admitted, then
        stop the HTTP server, the batchers and the decode worker."""
        if drain:
            self.drain(drain_timeout_s)
        self._draining = True
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._engine_lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop()
        if self.decoder is not None:
            self.decoder.stop()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

