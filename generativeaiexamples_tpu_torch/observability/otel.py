"""Minimal OpenTelemetry-compatible tracing core.

A copy of ``generativeaiexamples_tpu/observability/otel.py`` (standard
library only) with its imports pointed at the port: ``stage_span`` writes
the ``stage_<name>_s`` histograms into ``core/metrics.REGISTRY`` here.

The reference wires `opentelemetry-sdk` with an OTLP gRPC exporter, a
SimpleSpanProcessor, and a W3C TraceContext propagator
(ref: RAG/src/chain_server/tracing.py:36-59), then converts LangChain /
LlamaIndex lifecycle events into spans via callback handlers
(ref: RAG/tools/observability/langchain/opentelemetry_callback.py:137-606).

This module provides the same span model in-tree with zero hard deps:

  * ``Tracer.span(name)`` context manager → ``Span`` with trace_id/span_id,
    parent linkage, attributes, events, status, wall-time;
  * W3C ``traceparent`` header inject/extract for cross-service propagation
    (ref: tracing.py:46, chat_client.py:43 carrier propagation);
  * exporters: console, in-memory (tests), JSONL file (offline analysis —
    the stand-in for the OTLP→Jaeger pipeline in
    RAG/tools/observability/configs/otel-collector-config.yaml);
  * tail-filtering of health-check spans, matching the collector's
    tail_sampling drop of ``/health`` (otel-collector-config.yaml:10-20).

Tracing is opt-in via ``ENABLE_TRACING=true`` (ref: tracing.py:38,44); when
disabled every API is a cheap no-op.
"""

from __future__ import annotations

import contextvars
import json
import os
import secrets
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "gaie_tpu_current_span", default=None
)

# The serving-layer request id (X-Request-Id) for the request being handled
# on THIS thread/task: stage_span stamps it on every pipeline-stage span so
# timelines (/debug/requests/<id>), spans, and SLO breach records join on
# one key. Set by the chain server inside its StreamDrain reader thread
# (contextvars do not cross threads, so it is established where the chain
# actually executes).
_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "gaie_tpu_request_id", default=""
)


def set_request_id(request_id: str) -> "contextvars.Token[str]":
    return _request_id.set(request_id)


def reset_request_id(token: "contextvars.Token[str]") -> None:
    _request_id.reset(token)


def current_request_id() -> str:
    return _request_id.get()


def tracing_enabled() -> bool:
    return os.environ.get("ENABLE_TRACING", "").strip().lower() in ("1", "true", "yes")


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[Mapping[str, Any]] = None) -> None:
        """Record a point-in-time event (used per-token in the stream hot loop,
        mirroring on_llm_new_token spans, ref opentelemetry_callback.py:230)."""
        self.events.append({
            "name": name,
            "time_ns": time.time_ns(),
            "attributes": dict(attributes or {}),
        })

    def record_exception(self, exc: BaseException) -> None:
        self.status = "ERROR"
        self.add_event("exception", {"type": type(exc).__name__, "message": str(exc)})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ms": (self.end_ns - self.start_ns) / 1e6,
            "attributes": self.attributes,
            "events": self.events,
            "status": self.status,
        }


class SpanExporter:
    def export(self, span: Span) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class ConsoleSpanExporter(SpanExporter):
    def export(self, span: Span) -> None:
        print(json.dumps(span.to_dict(), default=str))


class InMemorySpanExporter(SpanExporter):
    """Test exporter (the stand-in for Jaeger assertions)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


class JsonlSpanExporter(SpanExporter):
    """Append spans as JSON lines — offline replacement for OTLP→Jaeger."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), default=str)
        with self._lock:
            with open(self._path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")


class OTLPHTTPSpanExporter(SpanExporter):
    """OTLP/HTTP JSON exporter: spans land in any OTLP collector (Jaeger
    all-in-one, otel-collector, Tempo) at ``<endpoint>/v1/traces``.

    In-tree replacement for the reference's OTLP-gRPC → collector pipeline
    (ref: RAG/src/chain_server/tracing.py:36-59 exporter setup;
    RAG/tools/observability/configs/otel-collector-config.yaml) with the
    collector's PROCESSING folded in, since there is no collector sidecar
    to do it here:

      * health-probe spans never reach the wire (the Tracer's tail filter,
        = the collector's tail_sampling drop, config lines 10-20);
      * collection/document ids in ``http.target`` / ``http.url`` are
        anonymized to ``{collection_id}``/``{document_id}`` placeholders
        (= the collector's transform replace_patterns, lines 21-43).

    Spans batch on a background thread (flush every ``batch_size`` spans or
    ``flush_interval_s``); export() never blocks the traced request path.
    A dead collector drops batches with one warning, not one per span.
    """

    _ANON = [
        (r"/collections/[\w-]+/documents/[\w-]+",
         "/collections/{collection_id}/documents/{document_id}"),
        (r"/collections/[\w-]+/search", "/collections/{collection_id}/search"),
        (r"/collections/[\w-]+$", "/collections/{collection_id}"),
    ]

    def __init__(self, endpoint: str = "http://localhost:4318",
                 service_name: str = "generativeaiexamples-tpu",
                 batch_size: int = 32, flush_interval_s: float = 2.0,
                 anonymize: bool = True) -> None:
        import queue as _queue
        self._url = endpoint.rstrip("/") + "/v1/traces"
        self._service = service_name
        self._anonymize = anonymize
        self._batch_size = batch_size
        self._interval = flush_interval_s
        self._q: "_queue.Queue" = _queue.Queue()
        self._warned = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="otlp-export")
        self._thread.start()

    def export(self, span: Span) -> None:
        self._q.put(span)

    def shutdown(self) -> None:
        """Deterministic drain: every span export()ed before this call is
        flushed before the thread exits. The sentinel wakes a blocked
        ``_q.get`` immediately (no up-to-``flush_interval_s`` timeout wait),
        and the loop's stop path drains the queue completely before its
        final post — the old exit condition could observe ``_stop`` with a
        non-empty final batch mid-race and leave it unsent."""
        self._stop.set()
        self._q.put(None)    # wake the getter now
        self._thread.join(timeout=2 * self._interval + 10)

    # -- wire encoding -----------------------------------------------------

    @staticmethod
    def _value(v: Any) -> Dict[str, Any]:
        if isinstance(v, bool):
            return {"boolValue": v}
        if isinstance(v, int):
            return {"intValue": str(v)}
        if isinstance(v, float):
            return {"doubleValue": v}
        return {"stringValue": str(v)}

    @classmethod
    def _attrs(cls, mapping: Mapping[str, Any]) -> List[Dict[str, Any]]:
        return [{"key": k, "value": cls._value(v)} for k, v in mapping.items()]

    def _scrub(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        if not self._anonymize:
            return attrs
        import re
        out = dict(attrs)
        for key in ("http.target", "http.url", "http.path"):
            val = out.get(key)
            if isinstance(val, str):
                for pat, repl in self._ANON:
                    val = re.sub(pat, repl, val)
                out[key] = val
        return out

    def _encode(self, spans: List[Span]) -> bytes:
        wire = []
        for s in spans:
            enc = {
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "name": s.name,
                "kind": 1,
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns),
                "attributes": self._attrs(self._scrub(s.attributes)),
                "events": [{"timeUnixNano": str(e["time_ns"]),
                            "name": e["name"],
                            "attributes": self._attrs(e["attributes"])}
                           for e in s.events],
                "status": {"code": 2 if s.status == "ERROR" else 1},
            }
            if s.parent_id:
                enc["parentSpanId"] = s.parent_id
            wire.append(enc)
        return json.dumps({"resourceSpans": [{
            "resource": {"attributes": self._attrs(
                {"service.name": self._service})},
            "scopeSpans": [{"scope": {"name": "generativeaiexamples_tpu_torch"},
                            "spans": wire}],
        }]}).encode()

    # -- background flush --------------------------------------------------

    def _loop(self) -> None:
        import queue as _queue
        batch: List[Span] = []
        deadline = time.monotonic() + self._interval
        while True:
            timeout = max(0.05, deadline - time.monotonic())
            try:
                item = self._q.get(timeout=timeout)
                if item is not None:     # None = shutdown wake sentinel
                    batch.append(item)
            except _queue.Empty:
                pass
            if self._stop.is_set():
                # deterministic final drain: collect EVERYTHING already
                # queued, post it, exit — never returns with spans that
                # were export()ed before shutdown() still unsent. Posted in
                # _batch_size chunks: a busy process can shut down with a
                # full flush interval of backlog, and one giant request
                # would trip collector request-size limits and drop it all
                while True:
                    try:
                        item = self._q.get_nowait()
                    except _queue.Empty:
                        break
                    if item is not None:
                        batch.append(item)
                for i in range(0, len(batch), self._batch_size):
                    if not self._post(batch[i:i + self._batch_size]):
                        # a dead endpoint fails every later chunk too —
                        # stop rather than serialize a 5 s timeout per
                        # chunk past shutdown()'s join budget
                        break
                return
            if (len(batch) >= self._batch_size
                    or time.monotonic() >= deadline) and batch:
                self._post(batch)
                batch = []
            if time.monotonic() >= deadline:
                deadline = time.monotonic() + self._interval

    def _post(self, batch: List[Span]) -> bool:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self._url, data=self._encode(batch),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5):
                pass
            self._warned = False
            return True
        except (urllib.error.URLError, OSError) as exc:
            if not self._warned:   # one warning per outage, not per batch
                import logging
                logging.getLogger(__name__).warning(
                    "OTLP export to %s failed (%s); dropping spans until "
                    "the collector returns", self._url, exc)
                self._warned = True
            return False


_exporter: SpanExporter = ConsoleSpanExporter()
_drop_name_substrings = ("/health",)  # ref: otel-collector-config.yaml tail_sampling lines 10-20


def configure_from_env() -> Optional[SpanExporter]:
    """Pick the exporter from env, mirroring the reference's compose wiring
    (ref: docker-compose.yaml OTEL_EXPORTER_OTLP_ENDPOINT):

      APP_TRACING_EXPORTER = console | jsonl | otlp | memory
      APP_TRACING_OTLP_ENDPOINT (default http://localhost:4318)
      APP_TRACING_JSONL_PATH (default traces.jsonl)
    """
    kind = os.environ.get("APP_TRACING_EXPORTER", "").strip().lower()
    if not kind:
        return None
    if kind == "otlp":
        exp: SpanExporter = OTLPHTTPSpanExporter(
            endpoint=os.environ.get("APP_TRACING_OTLP_ENDPOINT",
                                    "http://localhost:4318"),
            service_name=os.environ.get("APP_TRACING_SERVICE",
                                        "generativeaiexamples-tpu"))
    elif kind == "jsonl":
        exp = JsonlSpanExporter(os.environ.get("APP_TRACING_JSONL_PATH",
                                               "traces.jsonl"))
    elif kind == "memory":
        exp = InMemorySpanExporter()
    else:
        exp = ConsoleSpanExporter()
    set_exporter(exp)
    return exp


def set_exporter(exporter: SpanExporter) -> None:
    global _exporter
    _exporter = exporter


class Tracer:
    """Factory of spans; one per instrumented component."""

    def __init__(self, name: str, enabled: Optional[bool] = None) -> None:
        self.name = name
        self._enabled = enabled

    @property
    def enabled(self) -> bool:
        return tracing_enabled() if self._enabled is None else self._enabled

    @contextmanager
    def span(self, name: str, attributes: Optional[Mapping[str, Any]] = None,
             parent: Optional[Span] = None) -> Iterator[Span]:
        if not self.enabled:
            yield _NOOP_SPAN
            return
        parent = parent or _current_span.get()
        span = Span(
            name=name,
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
            span_id=secrets.token_hex(8),
            parent_id=parent.span_id if parent else None,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
        )
        token = _current_span.set(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.end_ns = time.time_ns()
            _current_span.reset(token)
            # tail-drop health probes by name OR http.path attribute
            haystack = span.name + " " + str(span.attributes.get("http.path", ""))
            if not any(s in haystack for s in _drop_name_substrings):
                _exporter.export(span)

    @contextmanager
    def start_as_current_span(self, name: str, **kw: Any) -> Iterator[Span]:
        with self.span(name, **kw) as s:
            yield s


_NOOP_SPAN = Span(name="noop", trace_id="0" * 32, span_id="0" * 16)
_tracers: Dict[str, Tracer] = {}


def get_tracer(name: str) -> Tracer:
    if name not in _tracers:
        _tracers[name] = Tracer(name)
    return _tracers[name]


def current_span() -> Optional[Span]:
    return _current_span.get()


@contextmanager
def stage_span(name: str, tracer_name: str = "rag") -> Iterator[Span]:
    """Span + latency histogram for one RAG pipeline stage.

    The pipelined dataplane needs per-stage visibility (embed / retrieve /
    rerank / generate) on BOTH surfaces: the span lands in whatever exporter
    is configured (child of the enclosing chain span, so stage waterfalls
    show up in Jaeger), and the wall time lands in a ``stage_<name>_s``
    histogram (core/metrics.py) that /metrics and bench.py read even when
    tracing is disabled."""
    from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

    t0 = time.perf_counter()
    try:
        with get_tracer(tracer_name).span(f"{tracer_name}:{name}") as span:
            rid = _request_id.get()
            if rid and span is not _NOOP_SPAN:
                # the X-Request-Id of the request this stage serves — the
                # join key across spans, /debug/requests timelines, and
                # SLO breach records (never stamped on the shared no-op)
                span.set_attribute("request_id", rid)
            yield span
    finally:
        REGISTRY.histogram(f"stage_{name}_s").observe(
            time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# W3C TraceContext propagation (ref: tracing.py:46 TraceContextTextMapPropagator)
# ---------------------------------------------------------------------------

def inject_traceparent(headers: Dict[str, str],
                       span: Optional[Span] = None) -> Dict[str, str]:
    """Stamp the W3C ``traceparent`` for ``span`` (explicit — a manually
    managed span, see :func:`start_span`) or the ambient current span."""
    span = span if span is not None else _current_span.get()
    if span is not None and tracing_enabled():
        headers["traceparent"] = f"00-{span.trace_id}-{span.span_id}-01"
    return headers


def start_span(name: str, attributes: Optional[Mapping[str, Any]] = None,
               parent: Optional[Span] = None) -> Optional[Span]:
    """Manually-managed span for generator/streaming call sites where a
    ``with`` block cannot scope the work (the failover router's streamed
    chat lives across many ``yield``s — a context manager there would leak
    the contextvar into the consumer between resumptions). Returns None
    when tracing is disabled; close with :func:`end_span`. The span is
    NOT installed as the ambient current span — propagate it explicitly
    via ``inject_traceparent(headers, span=...)``."""
    if not tracing_enabled():
        return None
    parent = parent if parent is not None else _current_span.get()
    return Span(
        name=name,
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        parent_id=parent.span_id if parent else None,
        start_ns=time.time_ns(),
        attributes=dict(attributes or {}),
    )


def end_span(span: Optional[Span]) -> None:
    """Finish + export a :func:`start_span` span (same health-probe tail
    filter as the context-manager path). None is a no-op, so call sites
    need no tracing-enabled guard of their own."""
    if span is None:
        return
    span.end_ns = time.time_ns()
    haystack = span.name + " " + str(span.attributes.get("http.path", ""))
    if not any(s in haystack for s in _drop_name_substrings):
        _exporter.export(span)


def extract_traceparent(headers: Mapping[str, str]) -> Optional[Span]:
    """Parse an incoming ``traceparent`` into a synthetic parent span
    (ref: llamaindex_instrumentation_wrapper extracting ctx from HTTP headers,
    tracing.py:62-73)."""
    raw = headers.get("traceparent")
    if raw is None:  # HTTP header names are case-insensitive on the wire
        for key, value in headers.items():
            if key.lower() == "traceparent":
                raw = value
                break
    if not raw:
        return None
    parts = raw.split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    return Span(name="remote-parent", trace_id=trace_id, span_id=span_id)


@contextmanager
def use_parent(span: Optional[Span]) -> Iterator[None]:
    """Attach an extracted remote parent for the duration of a request."""
    if span is None:
        yield
        return
    token = _current_span.set(span)
    try:
        yield
    finally:
        _current_span.reset(token)
