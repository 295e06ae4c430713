"""REST surface for the encoder services, in the NIM shapes.

Port of ``generativeaiexamples_tpu/encoders/server.py`` on the standard
library's ``ThreadingHTTPServer`` (the reference's is aiohttp, which the
card's machine lacks), as the port's engine server is. Every request gets
a thread of its own, so concurrent requests reach the encoders' micro-
batchers together and coalesce into shared dispatches (the reference runs
its calls in a thread pool for the same reason).

  * ``POST /v1/embeddings``: the OpenAI embeddings shape with the NIM
    ``input_type`` extension (``query`` | ``passage``, the default);
  * ``POST /v1/ranking``: ``{query: {text}, passages: [{text}], top_n}``
    -> ``{rankings: [{index, logit}]}``, best first;
  * ``GET /health``: ``{"message": "Service is up."}``;
  * ``GET /metrics``: ``core/metrics.REGISTRY`` as JSON, or as Prometheus
    text when ``?format=prometheus`` / ``text`` or an ``Accept`` of
    OpenMetrics or ``text/plain`` without JSON asks for it
    (``server/common.metrics_body``); ``?format=openmetrics`` adds the
    exemplars.

An empty input, a missing query or passages, or a body that is not a JSON
object answers 400. Not ported (ROADMAP A.10): the ``/debug`` routes,
``init_observability`` and ``/health``'s SLO pressure.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from generativeaiexamples_tpu_torch.encoders.embedder import Embedder
from generativeaiexamples_tpu_torch.encoders.reranker import Reranker
from generativeaiexamples_tpu_torch.server.common import health, metrics_body

logger = logging.getLogger(__name__)


class BadRequest(ValueError):
    """A request the server refuses with 400."""


class EncoderServer:
    def __init__(self, embedder: Optional[Embedder] = None,
                 reranker: Optional[Reranker] = None,
                 model_name: str = "e5-base-tpu",
                 rerank_model_name: str = "rerank-tpu") -> None:
        self.embedder = embedder
        self.reranker = reranker
        self.model_name = model_name
        self.rerank_model_name = rerank_model_name

    def close(self) -> None:
        """Stop the encoders' micro-batch workers."""
        for enc in (self.embedder, self.reranker):
            if enc is not None:
                enc.close()

    def embeddings(self, body: Dict[str, Any]) -> Dict[str, Any]:
        texts = body.get("input", [])
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise BadRequest("empty input")
        fn = (self.embedder.embed_queries
              if body.get("input_type", "passage") == "query"
              else self.embedder.embed_documents)
        vecs = fn(texts)
        return {
            "object": "list",
            "model": self.model_name,
            "data": [{"object": "embedding", "index": i,
                      "embedding": v.tolist()} for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        }

    def ranking(self, body: Dict[str, Any]) -> Dict[str, Any]:
        query = (body.get("query") or {}).get("text", "")
        passages = [p.get("text", "") for p in body.get("passages", [])]
        if not query or not passages:
            raise BadRequest("query and passages required")
        top_n = int(body.get("top_n") or len(passages))
        ranked = self.reranker.rerank(query, passages, top_n=top_n)
        return {"model": self.rerank_model_name,
                "rankings": [{"index": i, "logit": s} for i, s in ranked]}

    def make_httpd(self, host: str = "0.0.0.0",
                   port: int = 9080) -> ThreadingHTTPServer:
        """A bound, not yet serving, HTTP server (port 0 picks a free
        port)."""
        httpd = ThreadingHTTPServer((host, port), _handler_class(self))
        httpd.daemon_threads = True
        return httpd


def _handler_class(server: EncoderServer):
    posts = {}      # POST path -> handler, for the encoders the server holds
    if server.embedder is not None:
        posts["/v1/embeddings"] = server.embeddings
    if server.reranker is not None:
        posts["/v1/ranking"] = server.ranking

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"   # one response per connection

        def log_message(self, fmt, *args):   # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, data: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, status: int, body: Dict[str, Any]) -> None:
            self._send(status, json.dumps(body).encode(), "application/json")

        def do_GET(self):
            url = urlsplit(self.path)
            if url.path == "/health":
                self._json(*health())
            elif url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [""])[0]
                self._send(200, *metrics_body(
                    fmt, self.headers.get("Accept", "")))
            else:
                self._json(404, {"error": f"no route {url.path}"})

        def do_POST(self):
            route = posts.get(urlsplit(self.path).path)
            if route is None:
                self._json(404, {"error": f"no route {self.path}"})
                return
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise BadRequest("the request body must be a JSON "
                                     "object")
                out = route(body)
            except (BadRequest, ValueError, TypeError,
                    AttributeError) as exc:
                self._json(400, {"error": str(exc)})
                return
            self._json(200, out)

    return Handler


def serve_in_thread(embedder: Optional[Embedder] = None,
                    reranker: Optional[Reranker] = None,
                    host: str = "127.0.0.1", port: int = 0):
    """Serve on a background thread. Returns (server, httpd, thread); stop
    with ``httpd.shutdown()``, ``httpd.server_close()`` and
    ``server.close()``."""
    server = EncoderServer(embedder, reranker)
    httpd = server.make_httpd(host, port)
    thread = threading.Thread(target=httpd.serve_forever,
                              name="encoder-http", daemon=True)
    thread.start()
    return server, httpd, thread


def run_server(embedder: Optional[Embedder] = None,
               reranker: Optional[Reranker] = None,
               host: str = "0.0.0.0", port: int = 9080,
               device=None) -> None:
    """Serve until interrupted. Without encoders, builds both from the
    configuration (``APP_EMBEDDINGS_*``, ``APP_RANKING_*``: model names and
    micro-batch windows) with seeded e5-base weights on ``device`` (``cuda``
    unless the caller asks for another)."""
    from generativeaiexamples_tpu_torch.core.config import get_config
    cfg = get_config()
    names = {}
    if embedder is None and reranker is None:
        embedder = Embedder(device=device, micro_window_s=(
            cfg.embeddings.microbatch_window_ms / 1e3))
        reranker = Reranker(device=device, micro_window_s=(
            cfg.ranking.microbatch_window_ms / 1e3))
        names = dict(model_name=cfg.embeddings.model_name,
                     rerank_model_name=cfg.ranking.model_name)
    server = EncoderServer(embedder, reranker, **names)
    httpd = server.make_httpd(host, port)
    logger.info("serving encoders on http://%s:%d", host,
                httpd.server_address[1])
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()
