"""Chain server REST + SSE API on the standard library.

Port of ``generativeaiexamples_tpu/server/api.py`` on
``http.server.ThreadingHTTPServer`` (the reference's is aiohttp, which the
card's machine lacks, as it lacks bleach): every route of the reference,
with its request and response shapes.

  * ``GET /health`` (``slo_pressure``; 503 while the process drains),
    ``GET /metrics`` (JSON, or Prometheus text as
    ``server/common.metrics_body`` negotiates), the debug surface of
    ``server/common.DEBUG_ROUTES`` and ``POST /debug/drain[?off=1]``;
  * ``POST /generate``: ``messages`` (the last one is the query, the rest
    the history; every content cleaned as ``bleach.clean(text[:131072],
    strip=True)`` cleans it, ``server/sanitize.py``), ``use_knowledge_base``
    (``rag_chain`` or ``llm_chain``), ``temperature`` / ``top_p`` /
    ``max_tokens`` (capped at 1,024) / ``stop``. It answers an SSE stream of
    ``data: {ChainResponse}`` frames (``id`` = the caller's
    ``X-Request-Id`` or a new one, echoed in the header), a finish frame
    and ``data: [DONE]``. The stop strings are enforced again on the
    outgoing stream (a partial match is held back until it resolves), a
    chain that fails yields the canned error message inside a valid
    stream, and the chain runs on a ``StreamDrain`` reader thread;
  * ``POST /search`` (``query``, ``top_k``) -> ``{"chunks": [{content,
    filename, score}]}``, 501 for an example without search;
  * ``GET /documents`` -> ``{"documents": [...]}``; ``POST /documents``
    writes the multipart field ``file`` into a folder of its own under
    ``UPLOAD_DIR`` (the system's temporary directory's
    ``gaie-tpu-uploads`` unless set), ingests it and removes it, where the
    reference keeps ``UPLOAD_DIR/<name>``, which two uploads of one name
    at once share (ROADMAP C10); ``DELETE /documents?filename=`` ->
    ``{"deleted": bool}``.

An empty ``messages`` list, an empty search query, a missing ``file``
field or ``filename`` answers 422 with ``{"error": ...}``, as the reference
does. The ``e2e_ttft_s``, ``e2e_latency_s`` and ``e2e_tpot_s`` histograms
and the ``generate_requests``, ``generate_errors`` and
``documents_uploaded`` counters go to ``core/metrics.REGISTRY``. Rails
(``server/guardrails.py``) arm from ``APP_GUARDRAILS_CONFIG`` as there.

SLO admission and the usage plane, as there: ``/generate`` reads an SLO
class (``X-Request-Class`` / ``X-Slo-Class``, else a body ``slo_class``;
an unknown class answers 422) and a remaining deadline
(``X-Request-Deadline-Ms`` / ``X-Deadline-Ms``), and runs the chain
inside ``slo.admission`` and ``usage.tenant_scope`` (``X-Tenant-Id`` or
an API key's digest), so the engine requests the chain makes carry the
class and the remaining deadline (``RemoteLLM``'s headers, or the
in-process ``LocalLLM``'s ``stamp_request``) and bill the tenant.
``run_server`` calls ``init_observability("chain")``.
"""

from __future__ import annotations

import email.message
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.core.tracing import instrumentation_wrapper
from generativeaiexamples_tpu_torch.observability import otel
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability import usage as usage_mod
from generativeaiexamples_tpu_torch.server import common
from generativeaiexamples_tpu_torch.server import guardrails as guardrails_mod
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.common import (
    MAX_TOKENS_CAP, StreamDrain, health, metrics_body, parse_stop)
from generativeaiexamples_tpu_torch.server.sanitize import clean

logger = logging.getLogger(__name__)

MAX_CONTENT_CHARS = 131072
UPLOAD_DIR = os.environ.get(
    "UPLOAD_DIR", os.path.join(tempfile.gettempdir(), "gaie-tpu-uploads"))
ERROR_MESSAGE = ("Error from chain server. Please check chain-server "
                 "logs for more details.")
JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"
# the admission headers /generate reads (the SLO and usage planes)
SLO_HEADERS = ("X-Request-Class", "X-Slo-Class", "X-Request-Deadline-Ms",
               "X-Deadline-Ms", "X-Tenant-Id")


class HTTPError(Exception):
    """A response other than 200: status, body text, content type."""

    def __init__(self, status: int, body: str,
                 content_type: str = TEXT_TYPE) -> None:
        super().__init__(body)
        self.status = status
        self.body = body
        self.content_type = content_type


def _unprocessable(message: str) -> HTTPError:
    return HTTPError(422, json.dumps({"error": message}))


def _sanitize(text: str) -> str:
    return clean(text[:MAX_CONTENT_CHARS])


def _chain_chunk(rid: str, content: str,
                 finish_reason: Optional[str] = None) -> str:
    """ChainResponse-shaped SSE chunk."""
    return json.dumps({
        "id": rid,
        "choices": [{"index": 0,
                     "message": {"role": "assistant", "content": content},
                     "finish_reason": finish_reason}],
    })


def _admission(headers, body: Dict[str, Any]):
    """(SLO class, remaining deadline in ms, tenant) of a ``/generate``:
    the class from the headers or the body's ``slo_class``, the deadline
    from the headers; an unknown class or a malformed deadline is a 422."""
    try:
        slo_class, deadline_s = slo_mod.parse_inbound(
            headers, fallback_class=str(body.get("slo_class") or ""))
    except ValueError as exc:
        raise _unprocessable(str(exc))
    deadline_ms = None if deadline_s is None else deadline_s * 1000.0
    return slo_class, deadline_ms, usage_mod.tenant_from_headers(
        headers, default="")


def _read_body(request) -> bytes:
    length = int(request.headers.get("Content-Length") or 0)
    return request.rfile.read(length) if length else b""


def _json_body(request) -> Dict[str, Any]:
    return json.loads(_read_body(request) or b"null")


def _multipart_file(content_type: str, raw: bytes):
    """(filename, bytes) of the multipart field ``file``, or None."""
    header = email.message.Message()
    header["content-type"] = content_type
    boundary = header.get_param("boundary")
    if header.get_content_type() != "multipart/form-data" or not boundary:
        return None
    for part in raw.split(b"--" + str(boundary).encode())[1:]:
        if part.startswith(b"--"):
            break
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, _, data = part.partition(b"\r\n\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        fields = email.message.Message()
        for line in head.decode("utf-8", "replace").split("\r\n"):
            name, sep, value = line.partition(":")
            if sep:
                fields[name.strip()] = value.strip()
        if fields.get_param("name", header="content-disposition") == "file":
            return fields.get_filename(), data
    return None


class ChainServer:
    def __init__(self, example: BaseExample, guardrails=None) -> None:
        self.example = example
        # opt-in colang-style rails (server/guardrails.py): built from
        # APP_GUARDRAILS_CONFIG when the caller didn't inject their own
        self.guardrails = guardrails
        if self.guardrails is None:
            rails_path = os.environ.get("APP_GUARDRAILS_CONFIG", "")
            if rails_path:
                ctx = getattr(example, "ctx", None)
                if ctx is not None:
                    scrub = os.environ.get("APP_GUARDRAILS_SCRUB", "")
                    self.guardrails = guardrails_mod.from_config(
                        rails_path, ctx.embedder, ctx.llm,
                        enable_fact_check=os.environ.get(
                            "APP_GUARDRAILS_FACT_CHECK", "").lower()
                            in ("1", "true", "yes"),
                        scrub_patterns=[p for p in scrub.split("||") if p])
                else:
                    logger.warning(
                        "APP_GUARDRAILS_CONFIG set but the example has no "
                        "ctx (embedder/llm); rails disabled")

    # ------------------------------------------------------------ generate

    @instrumentation_wrapper
    def generate(self, request) -> None:
        from generativeaiexamples_tpu_torch.engine.scheduler import _stop_scan

        t_start = time.perf_counter()
        body = _json_body(request)
        messages = body.get("messages", [])
        if not isinstance(messages, list) or not messages:
            raise _unprocessable("messages must be a non-empty list")
        history = [{"role": str(m.get("role", "user")),
                    "content": _sanitize(str(m.get("content", "")))}
                   for m in messages]
        # the last user message is the query
        query = history.pop()["content"]
        use_kb = bool(body.get("use_knowledge_base", True))

        def setting(name, default, cast):
            value = body.get(name)
            return default if value is None else cast(value)

        settings: Dict[str, Any] = {
            "temperature": setting("temperature", 0.2, float),
            "top_p": setting("top_p", 0.7, float),
            "max_tokens": min(setting("max_tokens", 256, int),
                              MAX_TOKENS_CAP),
        }
        # `stop` is forwarded to the chain AND enforced again on the
        # outgoing stream, so chains that drop unknown settings still honor
        # it (held-back partial matches never reach the client)
        stop = parse_stop(body.get("stop"))
        if stop:
            settings["stop"] = stop
        REGISTRY.counter("generate_requests").inc()
        # honor the caller's id (gateway retries, cross-log joins) or mint
        # one: the SSE chunk ids, the response header and the stage spans
        # join on it
        rid = (request.headers.get("X-Request-Id", "").strip()
               or uuid.uuid4().hex)
        # SLO admission: the deadline is stamped now, and every engine
        # request the chain makes carries what remains of it
        slo_class, deadline_ms, tenant = _admission(request.headers, body)

        def guarded():
            # runs on the StreamDrain reader thread: the request id, the
            # admission and the tenant are set there, where the chain
            # executes (context variables do not cross threads)
            token = otel.set_request_id(rid)
            try:
                with slo_mod.admission(slo_class, deadline_ms=deadline_ms), \
                        usage_mod.tenant_scope(tenant):
                    yield from self._guarded_chain(query, history, use_kb,
                                                   settings)
            finally:
                otel.reset_request_id(token)

        request.send_response(200)
        request.send_header("Content-Type", "text/event-stream")
        request.send_header("Cache-Control", "no-cache")
        request.send_header("X-Request-Id", rid)
        request.end_headers()
        first_at: Optional[float] = None
        last_at = 0.0
        chunks = 0
        held = ""
        hit = False

        def write(payload: str) -> None:
            request.wfile.write(f"data: {payload}\n\n".encode())
            request.wfile.flush()

        def emit(content: str) -> None:
            nonlocal first_at, last_at, chunks
            now = time.perf_counter()
            if first_at is None:
                first_at = now
                REGISTRY.histogram("e2e_ttft_s").observe(now - t_start)
            last_at = now
            chunks += 1
            write(_chain_chunk(rid, content))

        try:
            for item in StreamDrain(guarded()):
                if stop:
                    item, held, hit = _stop_scan(stop, held + item)
                    if item:
                        emit(item)
                    if hit:
                        break
                    continue
                emit(item)
            if held and not hit:
                # trailing holdback that never completed a stop match
                emit(held)
            write(_chain_chunk(rid, "", "stop"))
            # metrics observe BEFORE the stream closes: a client that reads
            # [DONE] and scrapes /metrics finds this request counted
            REGISTRY.histogram("e2e_latency_s").observe(
                time.perf_counter() - t_start)
            if chunks > 1 and first_at is not None:
                # chain-level time per output chunk (an SSE delta can carry
                # several tokens)
                REGISTRY.histogram("e2e_tpot_s").observe(
                    (last_at - first_at) / (chunks - 1))
            write("[DONE]")
        except OSError:
            # the client went away; the reader thread drains the chain
            logger.info("generate %s: the client closed the stream", rid)

    def _guarded_chain(self, query, history, use_kb, settings):
        """The rails-wrapped chain body ``generate`` streams (runs on the
        StreamDrain reader thread)."""
        try:
            if self.guardrails is not None:
                canned = self.guardrails.check_input(query)
                if canned is not None:
                    REGISTRY.counter("guardrails_input_blocks").inc()
                    yield canned
                    return
            chain = (self.example.rag_chain if use_kb
                     else self.example.llm_chain)
            if (self.guardrails is not None
                    and self.guardrails.has_output_rails):
                # output rails need the complete answer: buffer, check,
                # emit once
                guardrails_mod.take_context()  # clear any stale record
                answer = "".join(chain(query, history, **settings))
                context = guardrails_mod.take_context() if use_kb else ""
                if context is None:
                    context = self._rails_context(query)
                yield self.guardrails.check_output(answer, context, query)
                return
            yield from chain(query, history, **settings)
        except Exception:  # the canned error message
            logger.exception("generation failed")
            REGISTRY.counter("generate_errors").inc()
            yield ERROR_MESSAGE

    def _rails_context(self, query: str) -> str:
        """Retrieved evidence for the fact-check rail; examples without
        document_search fact-check against nothing (the rail skips)."""
        search = getattr(self.example, "document_search", None)
        if search is None or self.guardrails.fact_check is None:
            return ""
        try:
            hits = search(query)
            return "\n\n".join(str(h.get("content", "")) for h in hits)
        except Exception:
            logger.exception("rails context retrieval failed")
            return ""

    # -------------------------------------------------------------- search

    @instrumentation_wrapper
    def search(self, request) -> Dict[str, Any]:
        body = _json_body(request)
        query = _sanitize(str(body.get("query", "")))
        top_k = int(body.get("top_k", 4))
        if not query:
            raise _unprocessable("query required")
        try:
            chunks = self.example.document_search(query, top_k)
        except NotImplementedError:
            raise HTTPError(501, json.dumps(
                {"error": "example does not support search"}))
        return {"chunks": [
            {"content": c.get("content", ""), "filename": c.get("source", ""),
             "score": c.get("score", 0.0)} for c in chunks]}

    # ----------------------------------------------------------- documents

    @instrumentation_wrapper
    def get_documents(self, request) -> Dict[str, Any]:
        try:
            docs = self.example.get_documents()
        except NotImplementedError:
            docs = []
        return {"documents": docs}

    @instrumentation_wrapper
    def upload_document(self, request) -> Dict[str, Any]:
        got = _multipart_file(request.headers.get("Content-Type", ""),
                              _read_body(request))
        if got is None:
            raise _unprocessable("multipart field 'file' required")
        filename = os.path.basename(got[0] or f"upload-{uuid.uuid4().hex}")
        os.makedirs(UPLOAD_DIR, exist_ok=True)
        # a folder of the upload's own: two uploads of one name at once
        # would otherwise write one file while the other is read (C10)
        with tempfile.TemporaryDirectory(dir=UPLOAD_DIR) as folder:
            path = os.path.join(folder, filename)
            with open(path, "wb") as fh:
                fh.write(got[1])
            try:
                self.example.ingest_docs(path, filename)
            except Exception as exc:
                logger.exception("ingestion failed for %s", filename)
                raise HTTPError(500, json.dumps(
                    {"error": f"ingestion failed: {exc}"}))
        REGISTRY.counter("documents_uploaded").inc()
        return {"message": "File uploaded successfully"}

    @instrumentation_wrapper
    def delete_document(self, request) -> Dict[str, Any]:
        query = parse_qs(urlsplit(request.path).query)
        filename = query.get("filename", [""])[0]
        if not filename:
            raise _unprocessable("filename query param required")
        try:
            ok = self.example.delete_documents([filename])
        except NotImplementedError:
            ok = False
        return {"deleted": bool(ok)}

    # ---------------------------------------------------------------- http

    def make_httpd(self, host: str = "0.0.0.0",
                   port: int = 8081) -> ThreadingHTTPServer:
        """A bound, not yet serving, HTTP server (port 0 picks a free
        port)."""
        httpd = ThreadingHTTPServer((host, port), _handler_class(self))
        httpd.daemon_threads = True
        return httpd


def _handler_class(server: ChainServer):
    routes = {("POST", "/generate"): server.generate,
              ("POST", "/search"): server.search,
              ("GET", "/documents"): server.get_documents,
              ("POST", "/documents"): server.upload_document,
              ("DELETE", "/documents"): server.delete_document}

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

        def _route(self, method: str) -> None:
            url = urlsplit(self.path)
            if method == "GET" and url.path == "/health":
                status, body = health()
                self._send(status, json.dumps(body).encode(), JSON_TYPE)
                return
            if method == "GET" and url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [""])[0]
                self._send(200, *metrics_body(
                    fmt, self.headers.get("Accept", "")))
                return
            if method == "POST" and url.path == "/debug/drain":
                status, body = common.drain_post(
                    common.split_path(self.path)[1])
                self._send(status, json.dumps(body).encode(), JSON_TYPE)
                return
            if method == "GET" and url.path.startswith("/debug/"):
                got = common.debug_get(url.path,
                                       common.split_path(self.path)[1])
                if got is not None:
                    self._send(got[0], json.dumps(got[1]).encode(),
                               JSON_TYPE)
                    return
            route = routes.get((method, url.path))
            if route is None:
                known = any(p == url.path for _, p in routes)
                self._send(405 if known else 404,
                           (b"405: Method Not Allowed" if known
                            else b"404: Not Found"), TEXT_TYPE)
                return
            try:
                out = route(self)
            except HTTPError as exc:
                self._send(exc.status, exc.body.encode(), exc.content_type)
                return
            except Exception:    # a malformed body or a failed call
                logger.exception("%s %s failed", method, url.path)
                self._send(500, b"500 Internal Server Error\n\nServer got "
                           b"itself in trouble", TEXT_TYPE)
                return
            if out is not None:
                self._send(200, json.dumps(out).encode(), JSON_TYPE)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_DELETE(self):
            self._route("DELETE")

    return Handler


def serve_in_thread(example: BaseExample, host: str = "127.0.0.1",
                    port: int = 0):
    """Serve on a background thread. Returns (server, httpd, thread); stop
    with ``httpd.shutdown()`` and ``httpd.server_close()``."""
    server = ChainServer(example)
    httpd = server.make_httpd(host, port)
    thread = threading.Thread(target=httpd.serve_forever, name="chain-http",
                              daemon=True)
    thread.start()
    return server, httpd, thread


def run_server(example: BaseExample, host: str = "0.0.0.0",
               port: int = 8081) -> None:
    """Serve until interrupted."""
    from generativeaiexamples_tpu_torch.observability.bootstrap import (
        init_observability)
    init_observability("chain")
    httpd = ChainServer(example).make_httpd(host, port)
    logger.info("serving the chain server on http://%s:%d", host,
                httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
