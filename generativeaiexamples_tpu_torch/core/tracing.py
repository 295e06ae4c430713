"""Instrumentation decorators for the chain server's handlers and the chains.

Port of ``generativeaiexamples_tpu/core/tracing.py``: ``chain_instrumentation``
wraps a chain method (plain, generator or async generator) in a span, and
``instrumentation_wrapper`` wraps a handler in a span named after it with
the caller's W3C ``traceparent`` as its parent. The port's handlers are
methods of the standard-library chain server (``server/api.py``), called as
``handler(self, request)`` where ``request`` is the connection's
``BaseHTTPRequestHandler`` (its ``headers`` and ``path``); the wrapper reads
the request from the last positional argument. Spans ride the in-tree
tracer (``observability/otel.py``), which ``APP_TRACING_EXPORTER`` picks an
exporter for at import (console | jsonl | otlp | memory; unset: none).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable

from generativeaiexamples_tpu_torch.observability import otel

otel.configure_from_env()

tracer = otel.get_tracer("generativeaiexamples_tpu_torch")


def instrumentation_wrapper(func: Callable) -> Callable:
    """Wrap a handler ``(self, request)``: extract the remote traceparent
    and open a span named after the handler."""

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        request = args[-1] if args else None
        headers = dict(getattr(request, "headers", {}) or {})
        parent = otel.extract_traceparent(headers)
        with otel.use_parent(parent):
            with tracer.span(f"http:{func.__name__}", attributes={
                    "http.path": str(getattr(request, "path", ""))}):
                return func(*args, **kwargs)

    return wrapper


def chain_instrumentation(func: Callable) -> Callable:
    """Wrap a chain method (llm_chain / rag_chain / ingest_docs) in a span."""

    if inspect.isasyncgenfunction(func):
        @functools.wraps(func)
        async def agen_wrapper(*args: Any, **kwargs: Any) -> Any:
            with tracer.span(f"chain:{func.__qualname__}") as span:
                n = 0
                async for item in func(*args, **kwargs):
                    n += 1
                    yield item
                span.set_attribute("chunks", n)
        return agen_wrapper

    if inspect.isgeneratorfunction(func):
        @functools.wraps(func)
        def gen_wrapper(*args: Any, **kwargs: Any) -> Any:
            with tracer.span(f"chain:{func.__qualname__}") as span:
                n = 0
                for item in func(*args, **kwargs):
                    n += 1
                    yield item
                span.set_attribute("chunks", n)
        return gen_wrapper

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        with tracer.span(f"chain:{func.__qualname__}"):
            return func(*args, **kwargs)

    return wrapper
