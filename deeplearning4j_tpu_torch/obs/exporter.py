"""Standalone metrics exporter over stdlib HTTP (counterpart:
``deeplearning4j_tpu/obs/exporter.py``, all of it).

The serving engine has its own ``/metrics``; a process without an engine
(a training run, a feed beside a store) has none. This exporter serves
the process-wide registry and journal from a daemon thread, each GET
rendered from ONE snapshot taken at request time:

  GET /metrics        Prometheus text exposition (format 0.0.4) of the
                      default MetricsRegistry — first-class metrics plus
                      every registered ledger view in one scrape
  GET /metrics.json   the same registry as a JSON dump
  GET /journal        the flight-recorder ring as JSONL (live view; the
                      on-disk file is for post-mortem)
  GET /health         liveness

Knob: ``DL4J_TPU_OBS_PORT`` (default 0 = an OS-assigned port, read back
from ``exporter.port``; a production run pins it).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.obs.registry import PROMETHEUS_CONTENT_TYPE
from deeplearning4j_tpu_torch.ops import env as envknob

ENV_PORT = "DL4J_TPU_OBS_PORT"


def _env_port() -> int:
    return envknob.get_int(ENV_PORT)


class MetricsExporter:
    """See module docstring. ``registry``/``journal`` default to the
    process-wide singletons so `MetricsExporter().start()` beside any
    loop exports everything the process registered."""

    def __init__(self, registry=None, journal=None,
                 port: Optional[int] = None):
        if registry is None:
            from deeplearning4j_tpu_torch.obs.registry import default_registry

            registry = default_registry()
        if journal is None:
            from deeplearning4j_tpu_torch.obs.journal import default_journal

            journal = default_journal()
        self.registry = registry
        self.journal = journal
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.split("?")[0] == "/metrics":
                        self._send(200,
                                   exporter.registry.render_prometheus()
                                   .encode(),
                                   PROMETHEUS_CONTENT_TYPE)
                    elif self.path == "/metrics.json":
                        self._send(200,
                                   json.dumps(exporter.registry.snapshot(),
                                              default=str).encode(),
                                   "application/json")
                    elif self.path == "/journal":
                        body = "".join(
                            json.dumps(e, default=str) + "\n"
                            for e in exporter.journal.events())
                        self._send(200, body.encode(),
                                   "application/x-ndjson")
                    elif self.path == "/health":
                        self._send(200, b'{"ok": true}',
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # noqa: BLE001 — export boundary
                    self._send(500, f"{type(e).__name__}: {e}".encode(),
                               "text/plain")

        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", _env_port() if port is None else int(port)),
            Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-exporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"
