"""Shared HTTP plumbing for the port's model, encoder and chain servers.

Port of the parts of ``generativeaiexamples_tpu/server/common.py`` that
the port's servers use, on the standard library: the generation cap
(``MAX_TOKENS_CAP``) and ``parse_stop``; the ``/health`` body;
``/metrics`` content negotiation (``metrics_body``: the JSON snapshot by
default, Prometheus text 0.0.4 to ``?format=prometheus`` / ``text`` or an
``Accept`` of OpenMetrics or of ``text/plain`` without JSON, and the
exemplar-carrying OpenMetrics form behind ``?format=openmetrics`` only);
and ``StreamDrain``, which moves a blocking delta iterator onto a reader
thread of its own.

Not ported (ROADMAP A.10): the ``/debug`` routes, the drain switch that
``POST /debug/drain`` flips (``/health`` answering 503 while draining) and
``/health``'s SLO pressure.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Dict, Iterator, Tuple

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

MAX_TOKENS_CAP = 1024

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")


def parse_stop(value) -> list:
    """Normalize an OpenAI-contract `stop` field (string | list | null)
    to at most 4 non-empty strings, one rule for every server."""
    if isinstance(value, str):
        value = [value]
    return [str(s) for s in (value or []) if s][:4]


def health() -> Tuple[int, Dict[str, Any]]:
    """(status, body) of ``GET /health``."""
    return 200, {"message": "Service is up."}


def metrics_body(fmt: str, accept: str) -> Tuple[bytes, str]:
    """The registry's exposition for a ``?format=`` value and an
    ``Accept`` header: (body, content type)."""
    fmt = fmt.lower()
    if fmt == "openmetrics":
        return (REGISTRY.render_prometheus(openmetrics=True).encode(),
                OPENMETRICS_CONTENT_TYPE)
    # a Prometheus scraper asks for openmetrics or text/plain and never for
    # JSON; generic clients list text/plain after application/json and
    # keep the JSON snapshot
    if fmt in ("prometheus", "text") or "openmetrics" in accept or (
            "text/plain" in accept and "application/json" not in accept):
        return REGISTRY.render_prometheus().encode(), PROMETHEUS_CONTENT_TYPE
    return json.dumps(REGISTRY.snapshot()).encode(), "application/json"


class StreamDrain:
    """Drain a blocking delta iterator on a reader thread of its own.

    The reader pushes deltas into a queue the request's thread iterates,
    so the chain runs to its end (its engine request finishes, a
    conversation turn is saved) even when the client stops reading.
    """

    _DONE = object()

    def __init__(self, iterator) -> None:
        self._iterator = iterator
        self._queue: "queue.Queue" = queue.Queue()
        # request-scoped: the reader exits when the iterator ends
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="stream-drain")
        self._thread.start()

    def _pump(self) -> None:
        try:
            for delta in self._iterator:
                self._queue.put(delta)
        finally:
            self._queue.put(self._DONE)

    def __iter__(self) -> Iterator[str]:
        while True:
            item = self._queue.get()
            if item is self._DONE:
                return
            yield item
