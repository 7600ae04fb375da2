"""ServingEngine: the HTTP front door over the paged decoder (counterpart:
``deeplearning4j_tpu/serving/engine.py``).

Routes (stdlib HTTP, JSON — the ``/generate`` contract of the JAX engine,
``engine.py:1067-1102``):

  POST /generate  {"tokens": [[ids]] | [ids], "n_new": K, "temperature"?,
                  "seed"?, "slo"?} -> {"tokens": [[ids]]}. With
                  "stream": true (one prompt) the response is chunked
                  application/x-ndjson: one {"token": t} line per token as
                  it is sampled, then {"done": true, "tokens": [...]} (or
                  {"error": ...} if generation failed mid-stream).
                  "top_k"/"top_p" answer 400: not ported yet.
                  429 when the decode queue is full, 503 when the decode
                  worker is dead or the engine is draining, 504 past the
                  request's deadline, 400 for a malformed request.
  GET  /health    {"ok", "draining", "model", "device"}; 503 when the
                  engine cannot take traffic.
  GET  /metrics   {"serving": <ServingStats>, "decode": <pool shape and
                  ticks>, "kernels": <launch counts of each kernel and of
                  its plain version>}

Constructor arguments take precedence; unset ones read the JAX engine's
env knobs through the port's copy of the table (``ops/env.py``):
``DL4J_TPU_SERVE_QUEUE_CAP``, ``DL4J_TPU_SERVE_TIMEOUT_S``,
``DL4J_TPU_SERVE_SLOTS``, ``DL4J_TPU_SERVE_KV_BLOCK``,
``DL4J_TPU_SERVE_KV_BLOCKS``.

Not ported yet: /predict, /embed, /search, the /models lifecycle and
registry, shadow traffic, /prefill and /prime, the serving mesh, the
circuit breaker, the fixed-slot pool (``DL4J_TPU_SERVE_KV_BLOCK=0``),
top-k / top-p sampling and Prometheus exposition.
"""

from __future__ import annotations

import json
import queue as stdqueue
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.ops import env as envknob
from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)
from deeplearning4j_tpu_torch.serving.batcher import (
    QueueFullError,
    RequestTimeoutError,
)
from deeplearning4j_tpu_torch.serving.paged import PagedDecoder
from deeplearning4j_tpu_torch.serving.resilience import (
    ClientRequestError,
    DrainingError,
    WorkerDeadError,
)
from deeplearning4j_tpu_torch.serving.slo import SLOClass, parse_slo_classes
from deeplearning4j_tpu_torch.serving.telemetry import ServingStats


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """Launch counts of each kernel wrapper and of its plain version."""
    return {
        "flash_attention": {"launches": flash_attention.launches,
                            "plain_launches": flash_attention_plain.launches},
        "paged_attention": {"launches": paged_attention.launches,
                            "plain_launches": paged_attention_plain.launches},
    }


class ServingEngine:
    """``/generate`` over one TransformerLM on ``device`` (the card unless
    the caller passes ``device="cpu"``; it must be the model's)."""

    def __init__(self, model: TransformerLM, *, port: int = 0,
                 queue_capacity: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 slots: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 slo_classes: Union[str, List[SLOClass], None] = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if not isinstance(model, TransformerLM):
            raise TypeError("the port's engine serves a TransformerLM; "
                            f"got {type(model).__name__}")
        self.model = model
        self.queue_capacity = int(
            queue_capacity if queue_capacity is not None
            else envknob.get_int("DL4J_TPU_SERVE_QUEUE_CAP"))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else envknob.get_float("DL4J_TPU_SERVE_TIMEOUT_S"))
        self.slots = int(slots if slots is not None
                         else envknob.get_int("DL4J_TPU_SERVE_SLOTS"))
        self.kv_block = int(kv_block if kv_block is not None
                            else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCK"))
        self.kv_blocks = int(kv_blocks if kv_blocks is not None
                             else envknob.get_int("DL4J_TPU_SERVE_KV_BLOCKS"))
        if self.kv_block <= 0:
            raise ValueError("kv_block must be > 0: the fixed-slot pool "
                             "(DL4J_TPU_SERVE_KV_BLOCK=0) is not ported")
        if isinstance(slo_classes, str):
            slo_classes = parse_slo_classes(slo_classes)
        self.stats = ServingStats()
        self.decoder = PagedDecoder(
            model, block_tokens=self.kv_block,
            n_blocks=self.kv_blocks or None, min_lanes=self.slots,
            stats=self.stats,
            default_timeout_s=max(self.request_timeout_s, 300.0),
            slo_classes=slo_classes or None,
            queue_cap=self.queue_capacity, device=self.device)
        self._draining = False
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- in-process surface -----------------------------------------------
    def _admit(self, top_k=None, top_p=None) -> None:
        if self._draining:
            raise DrainingError("engine is draining; admission closed")
        if top_k is not None or top_p is not None:
            raise ClientRequestError("top_k/top_p sampling is not ported "
                                     "yet; send plain temperature sampling")

    def generate(self, tokens, n_new: int, *, temperature: float = 1.0,
                 seed: int = 0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 slo: Optional[str] = None) -> np.ndarray:
        """[N, T] (or [T]) prompts -> [N, n_new] sampled continuations;
        row i draws from seed + i."""
        self._admit(top_k, top_p)
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        return np.asarray(self.decoder.generate(
            tokens, int(n_new), temperature=float(temperature),
            seed=int(seed), slo=slo))

    def generate_stream(self, tokens, n_new: int, *,
                        temperature: float = 1.0, seed: int = 0,
                        slo: Optional[str] = None):
        """Streaming ``/generate`` for ONE prompt: an iterator of token ids,
        each yielded as the decode tick produces it. Admission errors
        raise HERE, before a caller commits response headers;
        mid-generation failures raise from the iterator."""
        self._admit()
        prompt = np.asarray(tokens, np.int32).reshape(-1)
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

    def metrics(self) -> Dict[str, Any]:
        d = self.decoder
        return {"serving": self.stats.snapshot(),
                "decode": {"lanes": d.lanes, "n_blocks": d.n_blocks,
                           "block_tokens": d.block_tokens,
                           "decode_ticks": d.decode_ticks,
                           "tick_seconds": d.tick_seconds,
                           "admissions": d.admissions,
                           "admit_seconds": d.admit_seconds,
                           "peak_active": d.peak_active},
                "kernels": kernel_counts()}

    def health(self):
        """(http_code, body): 503 when draining or the decode worker died."""
        ok = not self._draining and self.decoder._dead is None
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
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/generate":
                        self._do_generate()
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

            def _do_generate(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                toks = np.asarray(payload["tokens"], np.int32)
                tk, tp = payload.get("top_k"), payload.get("top_p")
                kwargs = dict(temperature=float(payload.get("temperature",
                                                            1.0)),
                              seed=int(payload.get("seed", 0)),
                              slo=payload.get("slo"))
                n_new = int(payload.get("n_new", 16))
                if payload.get("stream"):
                    engine._admit(tk, tp)
                    if toks.ndim > 1 and toks.shape[0] != 1:
                        self._send(400, {"error": "stream takes ONE "
                                         "prompt per request"})
                        return
                    gen = engine.generate_stream(toks.reshape(-1), n_new,
                                                 **kwargs)
                    self._stream_tokens(gen)
                    return
                out = engine.generate(toks, n_new, top_k=tk, top_p=tp,
                                      **kwargs)
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
        """Close admission (503) and wait for every admitted request."""
        self._draining = True
        return self.decoder.drain(self.request_timeout_s
                                  if timeout_s is None else timeout_s)

    def stop(self, drain: bool = True,
             drain_timeout_s: Optional[float] = None) -> None:
        """Shutdown: by default answer everything already admitted, then
        stop the HTTP server and the decode worker."""
        if drain:
            self.drain(drain_timeout_s)
        self._draining = True
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.decoder.stop()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

