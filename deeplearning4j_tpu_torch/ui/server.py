"""The training UI's server and its history storage (counterpart:
``deeplearning4j_tpu/ui/server.py`` — ``HistoryStorage`` :28 and
``UiServer`` :56 with every route of :59-72).

Standard-library only: ``http.server`` on a daemon thread. Listeners
POST JSON updates to ``/train/update``; ``GET /`` renders the dashboard
on the server from the stored history (the score line, the latest
per-parameter histograms, the topology table). The explorer routes run
t-SNE over uploaded vectors (``/tsne/upload``: the port's exact
``plot/tsne.Tsne`` on the server's ``device``, the card unless the caller
passes ``device="cpu"``) and nearest-neighbour queries over a
``clustering/vptree.VPTree`` built on the host (``/word2vec/upload`` and
``/word2vec/nearest``), as the JAX package does. Every route answers
with the JAX server's JSON for the same requests, but for the t-SNE
coordinates, which are the port's t-SNE: f32 sums in another order.

The handler threads call ``Tsne`` on the card's default stream while a
fit may run on the same stream in another thread: the stream orders the
two, and the t-SNE result is read back before the answer is sent.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ComponentTable,
    ComponentText,
    render_page,
)


class HistoryStorage:
    """Keyed, bounded history of listener updates (HistoryStorage.java)."""

    def __init__(self, max_items_per_key: int = 2048):
        self._data: Dict[str, List[Any]] = {}
        self._lock = threading.Lock()
        self.max_items = max_items_per_key

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            items = self._data.setdefault(key, [])
            items.append(value)
            if len(items) > self.max_items:
                del items[: len(items) - self.max_items]

    def get(self, key: str) -> List[Any]:
        with self._lock:
            return list(self._data.get(key, []))

    def latest(self, key: str) -> Optional[Any]:
        with self._lock:
            items = self._data.get(key)
            return items[-1] if items else None

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._data)


class UiServer:
    """POST /train/update      {type: score|histogram|flow, ...}
    GET  /train/summary        JSON dump of latest state
    GET  /                     server-rendered dashboard

    Explorer resources (reference ui/tsne/TsneResource.java and
    ui/nearestneighbors/word2vec/NearestNeighborsResource.java):
    POST /tsne/upload          {words:[...], vectors:[[...]]} -> run t-SNE
    POST /tsne/update          {words:[...], coords:[[x,y]...]} (precomputed)
    GET  /tsne/coords          stored 2-d coordinates as JSON
    GET  /tsne                 server-rendered scatter page
    POST /word2vec/upload      {words:[...], vectors:[[...]]} -> build VPTree
    GET  /word2vec/words       vocab list (reference /vocab)
    POST /word2vec/nearest     {word: w, k: n} | {vector: [...], k: n}"""

    def __init__(self, port: int = 0, storage: Optional[HistoryStorage] = None,
                 device=None):
        self.device = resolve_device(device)
        self.storage = storage or HistoryStorage()
        # explorer state (uploaded embeddings / computed coordinates)
        # explorer state published as single atomic tuples — handler
        # threads snapshot once so words/coords (and words/vectors/tree)
        # can never be observed mid-replacement
        self._tsne_state: tuple = ([], [])  # (words, coords)
        self._nn_state = None  # (words, vectors, VPTree) | None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n))
                    if self.path == "/train/update":
                        key = payload.get("type", "unknown")
                        server.storage.put(key, payload)
                        self._send_json(200, {"ok": True})
                    elif self.path == "/tsne/upload":
                        count = server.tsne_upload(
                            payload["words"], payload["vectors"],
                            **{
                                k: payload[k]
                                for k in ("perplexity", "iterations")
                                if k in payload
                            },
                        )
                        self._send_json(200, {"ok": True, "points": count})
                    elif self.path == "/tsne/update":
                        server.tsne_update(payload["words"], payload["coords"])
                        self._send_json(200, {"ok": True})
                    elif self.path == "/word2vec/upload":
                        count = server.nn_upload(
                            payload["words"], payload["vectors"]
                        )
                        self._send_json(200, {"ok": True, "words": count})
                    elif self.path == "/word2vec/nearest":
                        self._send_json(200, server.nn_query(payload))
                    else:
                        self._send(404, b"not found", "text/plain")
                except (ValueError, KeyError, TypeError) as e:
                    self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                if self.path == "/train/summary":
                    out = {
                        k: server.storage.latest(k) for k in server.storage.keys()
                    }
                    self._send_json(200, out)
                elif self.path == "/tsne/coords":
                    words, coords = server._tsne_state
                    self._send_json(200, {"words": words, "coords": coords})
                elif self.path == "/tsne":
                    self._send(
                        200, server.render_tsne().encode(), "text/html"
                    )
                elif self.path == "/word2vec/words":
                    state = server._nn_state
                    self._send_json(
                        200, {"words": state[0] if state else []}
                    )
                elif self.path == "/":
                    self._send(
                        200, server.render_dashboard().encode(), "text/html"
                    )
                else:
                    self._send(404, b"not found", "text/plain")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- explorer backends -------------------------------------------------
    def tsne_upload(self, words, vectors, perplexity: float = 30.0,
                    iterations: int = 300) -> int:
        """Run t-SNE on uploaded embeddings and store the scatter coords
        (reference TsneResource.handleUpload -> Tsne pipeline)."""
        import numpy as np

        from deeplearning4j_tpu_torch.plot.tsne import Tsne

        x = np.asarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != len(words):
            raise ValueError("vectors must be [len(words), dim]")
        perplexity = min(perplexity, max(2.0, (x.shape[0] - 1) / 3.0))
        coords = Tsne(
            n_components=2, perplexity=perplexity, max_iter=int(iterations),
            device=self.device,
        ).fit_transform(x)
        self.tsne_update(list(words), np.asarray(coords).tolist())
        return len(self._tsne_state[0])

    def tsne_update(self, words, coords) -> None:
        """Store precomputed coordinates (reference postCoordinates :72)."""
        if len(words) != len(coords):
            raise ValueError("words/coords length mismatch")
        # single atomic swap: handler threads read (words, coords) as a pair
        coords = [[float(c[0]), float(c[1])] for c in coords]
        self._tsne_state = (list(words), coords)

    def nn_upload(self, words, vectors) -> int:
        """Build the VPTree over uploaded word vectors (reference
        NearestNeighborsResource upload -> VPTree build)."""
        import numpy as np

        from deeplearning4j_tpu_torch.clustering.vptree import VPTree

        x = np.asarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != len(words):
            raise ValueError("vectors must be [len(words), dim]")
        # build off to the side, publish as ONE tuple: concurrent nn_query
        # on the ThreadingHTTPServer must never see a new word list paired
        # with an old tree (index-out-of-range / wrong labels)
        self._nn_state = (list(words), x, VPTree(x, distance="cosine"))
        return len(words)

    def nn_query(self, payload) -> Dict[str, Any]:
        """k nearest neighbors by word or raw vector (reference
        NearestNeighborsResource.getWords)."""
        import numpy as np

        state = self._nn_state  # snapshot: words/vectors/tree stay coherent
        if state is None:
            raise ValueError("no word vectors uploaded")
        nn_words, nn_vectors, nn_tree = state
        k = int(payload.get("k", 10))
        if "word" in payload:
            word = payload["word"]
            if word not in nn_words:
                raise ValueError(f"unknown word {word!r}")
            qi = nn_words.index(word)
            q = nn_vectors[qi]
            skip = qi
        else:
            q = np.asarray(payload["vector"], np.float32)
            skip = -1
        hits = nn_tree.knn(q, k + (1 if skip >= 0 else 0))
        out = [
            {"word": nn_words[i], "distance": float(d)}
            for d, i in hits
            if i != skip
        ][:k]
        return {"neighbors": out}

    def render_tsne(self) -> str:
        from deeplearning4j_tpu_torch.ui.components import ChartScatter

        tsne_words, tsne_coords = self._tsne_state
        if not tsne_coords:
            return render_page(
                [ComponentText(text="no t-SNE coordinates uploaded yet — "
                               "POST /tsne/upload or /tsne/update")],
                title="t-SNE explorer",
            )
        chart = ChartScatter(title=f"t-SNE ({len(tsne_words)} points)")
        xs = [c[0] for c in tsne_coords]
        ys = [c[1] for c in tsne_coords]
        chart.add_series("words", xs, ys)
        return render_page([chart], title="t-SNE explorer")

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "UiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
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

    # -- rendering --------------------------------------------------------
    def render_dashboard(self) -> str:
        comps = []
        scores = self.storage.get("score")
        if scores:
            chart = ChartLine(title="Score vs iteration")
            chart.add_series(
                "score",
                [s["iteration"] for s in scores],
                [s["score"] for s in scores],
            )
            comps.append(chart)
        hist = self.storage.latest("histogram")
        if hist:
            for name, h in hist.get("params", {}).items():
                c = ChartHistogram(title=f"param {name}")
                for lo, hi, cnt in zip(h["lower"], h["upper"], h["counts"]):
                    c.add_bin(lo, hi, cnt)
                comps.append(c)
        flow = self.storage.latest("flow")
        if flow:
            table = ComponentTable(
                title="Network topology",
                header=["layer", "type", "n_params"],
                rows=[
                    [l["name"], l["layer_type"], str(l["n_params"])]
                    for l in flow.get("layers", [])
                ],
            )
            comps.append(table)
        if not comps:
            comps = [ComponentText(text="no training data posted yet")]
        return render_page(comps, title="DL4J-TPU training")
