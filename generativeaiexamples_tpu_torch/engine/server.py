"""OpenAI-compatible model server on the standard library.

Port of the serving surface of ``generativeaiexamples_tpu/engine/server.py``
(``/health``, ``/v1/models``, ``/v1/completions``, ``/v1/chat/completions``,
with and without SSE ``stream``), with the same JSON shapes as its
``_chunk``/``_finish_reason``, a final ``data: [DONE]`` and ``usage``. It
is written on ``http.server.ThreadingHTTPServer``: one thread per
connection blocks on its request's token queue, and the engine's driver
thread does the device work.

Not ported (ROADMAP A7): tools and JSON mode, ``n > 1``, logprobs, LoRA
model ids, KV handoff, drain/evacuation, metrics and debug endpoints.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler

MAX_TOKENS_CAP = 1024
logger = logging.getLogger(__name__)


def parse_stop(value) -> list:
    """OpenAI ``stop`` (string | list | null) -> at most 4 strings."""
    if isinstance(value, str):
        value = [value]
    return [str(s) for s in (value or []) if s][:4]


def _finish_reason(req, default: str = "stop") -> str:
    """OpenAI finish_reason from the scheduler's finish cause."""
    if getattr(req, "error", None):
        return "error"
    if getattr(req, "finish_reason", None) == "length":
        return "length"
    return default


def _chunk(model: str, rid: str, delta: Dict[str, Any],
           finish_reason: Optional[str] = None, index: int = 0) -> str:
    return json.dumps({
        "id": rid, "object": "chat.completion.chunk",
        "created": int(time.time()), "model": model,
        "choices": [{"index": index, "delta": delta,
                     "finish_reason": finish_reason}],
    })


class BadRequest(ValueError):
    pass


class ModelServer:
    """Routes and request handling, independent of the HTTP transport."""

    def __init__(self, scheduler: Scheduler, model_name: str) -> None:
        self.scheduler = scheduler
        self.model_name = model_name

    def health(self) -> Dict[str, Any]:
        core = self.scheduler.core
        return {"message": "Service is up.", **self.scheduler.load_stats(),
                "quant": core.quant, "weight_bytes": core.param_bytes}

    def models(self) -> Dict[str, Any]:
        return {"object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "generativeaiexamples_tpu_torch"}]}

    @staticmethod
    def _sampling(body: Dict[str, Any]) -> Dict[str, Any]:
        def get(key, default, cast):
            value = body.get(key)
            return default if value is None else cast(value)

        for key in ("tools", "response_format", "logprobs", "top_logprobs"):
            if body.get(key):
                raise BadRequest(f"{key!r} is not served by the PyTorch "
                                 f"port yet (ROADMAP A7)")
        if int(body.get("n") or 1) != 1:
            raise BadRequest("n > 1 is not served by the PyTorch port yet "
                             "(ROADMAP A7)")
        return {
            "max_tokens": min(get("max_tokens", 128, int), MAX_TOKENS_CAP),
            "temperature": get("temperature", 0.7, float),
            "top_p": get("top_p", 1.0, float),
            "top_k": get("top_k", 0, int),
            "stop": parse_stop(body.get("stop")),
            "seed": (int(body["seed"]) if body.get("seed") is not None
                     else None),
        }

    def prompt_ids(self, path: str, body: Dict[str, Any]):
        tok = self.scheduler.tokenizer
        if path == "/v1/chat/completions":
            messages = body.get("messages") or []
            if not messages:
                raise BadRequest("messages must be non-empty")
            return tok.apply_chat_template(messages)
        return tok.encode(str(body.get("prompt", "")), add_bos=True)

    def submit(self, path: str, body: Dict[str, Any]):
        ids = self.prompt_ids(path, body)
        req = Request(prompt_ids=list(ids), **self._sampling(body))
        self.scheduler.submit(req)
        return req, ids

    def complete(self, req: Request, ids, chat: bool) -> Dict[str, Any]:
        """Non-streamed response body once the request has finished."""
        text = "".join(self.scheduler.iter_text(req))
        choice: Dict[str, Any] = {"index": 0,
                                  "finish_reason": _finish_reason(req)}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        n = req.completion_tokens
        payload = {
            "id": f"chatcmpl-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": len(ids), "completion_tokens": n,
                      "total_tokens": len(ids) + n},
        }
        if req.error:
            payload["error"] = req.error
        return payload

    def stream(self, req: Request, ids, chat: bool):
        """SSE payloads (without the ``data: `` framing) of a stream."""
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        if chat:
            yield _chunk(self.model_name, rid, {"role": "assistant"})
        for delta in self.scheduler.iter_text(req):
            yield _chunk(self.model_name, rid, {"content": delta})
        final = json.loads(_chunk(self.model_name, rid, {},
                                  _finish_reason(req)))
        n = req.completion_tokens
        final["usage"] = {"prompt_tokens": len(ids), "completion_tokens": n,
                          "total_tokens": len(ids) + n}
        if req.error:
            final["error"] = req.error
        yield json.dumps(final)
        yield "[DONE]"


def _handler_class(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"   # one response per connection

        def log_message(self, fmt, *args):   # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, status: int, body: Dict[str, Any]) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, server.health())
            elif self.path == "/v1/models":
                self._json(200, server.models())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path not in ("/v1/chat/completions", "/v1/completions"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise BadRequest("the request body must be a JSON object")
                req, ids = server.submit(self.path, body)
            except (BadRequest, ValueError, NotImplementedError) as exc:
                self._json(400, {"error": str(exc)})
                return
            chat = self.path == "/v1/chat/completions"
            if not body.get("stream"):
                payload = server.complete(req, ids, chat)
                self._json(503 if req.error else 200, payload)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", req.request_id)
            self.end_headers()
            for payload in server.stream(req, ids, chat):
                self.wfile.write(f"data: {payload}\n\n".encode())
                self.wfile.flush()

    return Handler


def make_server(scheduler: Scheduler, model_name: str, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """A bound, not yet serving, HTTP server (port 0 picks a free port)."""
    httpd = ThreadingHTTPServer((host, port),
                                _handler_class(ModelServer(scheduler,
                                                           model_name)))
    httpd.daemon_threads = True
    return httpd


def serve_in_thread(scheduler: Scheduler, model_name: str,
                    host: str = "127.0.0.1", port: int = 0):
    """Start the scheduler and an HTTP server on a background thread.
    Returns (httpd, thread); stop with ``httpd.shutdown()`` and
    ``scheduler.stop()``."""
    httpd = make_server(scheduler, model_name, host, port)
    scheduler.start()
    thread = threading.Thread(target=httpd.serve_forever, name="http",
                              daemon=True)
    thread.start()
    return httpd, thread


def run_server(scheduler: Scheduler, model_name: str, host: str = "0.0.0.0",
               port: int = 8000) -> None:
    """Serve until interrupted."""
    httpd = make_server(scheduler, model_name, host, port)
    scheduler.start()
    logger.info("serving %s on http://%s:%d", model_name, host,
                httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        scheduler.stop()
