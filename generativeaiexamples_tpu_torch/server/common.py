"""Shared HTTP plumbing for the port's model, encoder and chain servers.

Port of ``generativeaiexamples_tpu/server/common.py`` on the standard
library: the generation cap (``MAX_TOKENS_CAP``) and ``parse_stop``; the
``/health`` body with its ``slo_pressure`` (503 while the process drain
switch ``DRAIN`` is on); ``/metrics`` content negotiation
(``metrics_body``: the JSON snapshot by default, Prometheus text 0.0.4 to
``?format=prometheus`` / ``text`` or an ``Accept`` of OpenMetrics or of
``text/plain`` without JSON, and the exemplar-carrying OpenMetrics form
behind ``?format=openmetrics`` only); the debug surface (``debug_get``,
one path table that the engine, encoder and chain servers all consult:
``/debug/flight``, ``/debug/requests[/<rid>]``, ``/debug/slo``,
``/debug/devtime``, ``/debug/compiles``, ``/debug/chaos``,
``/debug/deadletter``, ``/debug/usage``, ``/debug/fleet`` (this
process's local view: the failover router is ROADMAP A.17),
``/debug/trace[?rid=]``, ``/debug/locks``, the QoS plane's
``/debug/qos``, the forensics plane's ``/debug/forensics[/<rid>]``,
``/debug/alerts`` and ``/debug/doctor``) with its query caps;
``POST /debug/drain[?off=1]`` for the servers without an engine
(``drain_post``; the engine server answers it through its watchdog); and
``StreamDrain``, which moves a blocking delta iterator onto a reader
thread of its own.

Each plane's route answers ``enabled: false`` with the reference's hint
while the plane is off (``APP_QOS``, ``APP_FORENSICS``, ``APP_TRACE``,
``APP_LOCKWATCH``). A request's forensics are this process's view: the
reference's router-side join of worker legs waits for the failover
router, and ``/debug/profile`` (device traces) for ROADMAP A.17.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability.flight import (
    FLIGHT, REQUEST_LOG)

MAX_TOKENS_CAP = 1024

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")

# debug-surface caps: an incident-time poll never serializes an unbounded
# ring into one response; explicit query params widen up to the hard max
FLIGHT_WINDOW_DEFAULT_S = 600.0
FLIGHT_LIMIT_DEFAULT = 1024
FLIGHT_LIMIT_MAX = 8192
REQUESTS_LIMIT_DEFAULT = 50
REQUESTS_LIMIT_MAX = 500
TRACE_WINDOW_DEFAULT_S = 600.0
TRACE_LIMIT_DEFAULT = 2048
TRACE_LIMIT_MAX = 8192

_TRUE = ("1", "true", "on")


def parse_stop(value) -> list:
    """Normalize an OpenAI-contract `stop` field (string | list | null)
    to at most 4 non-empty strings, one rule for every server."""
    if isinstance(value, str):
        value = [value]
    return [str(s) for s in (value or []) if s][:4]


class _DrainSwitch:
    """Process-level graceful-drain flag of the servers without an engine
    watchdog (chain, encoder): while draining, ``/health`` answers 503 so
    upstream pools route new work away while in-flight requests finish."""

    def __init__(self) -> None:
        self.draining = False

    def drain(self) -> None:
        if not self.draining:
            REGISTRY.gauge("server_draining").set(1)
        self.draining = True

    def undrain(self) -> None:
        if self.draining:
            REGISTRY.gauge("server_draining").set(0)
        self.draining = False


DRAIN = _DrainSwitch()


def health() -> Tuple[int, Dict[str, Any]]:
    """(status, body) of ``GET /health``: ``slo_pressure`` rides the
    liveness probe; 503 while the process drains."""
    body = {"message": "Service is up.",
            "slo_pressure": slo_mod.SLO.pressure()}
    if DRAIN.draining:
        body["message"] = "Service is draining."
        return 503, body
    return 200, body


def drain_post(query: Mapping[str, str]) -> Tuple[int, Dict[str, Any]]:
    """``POST /debug/drain[?off=1]`` of a server without an engine: flip
    the drain switch (``/health`` 503 <-> 200). ``?evacuate=1`` answers 409:
    these servers hold no engine KV state."""
    if query.get("off", "").strip() in _TRUE:
        DRAIN.undrain()
    elif query.get("evacuate", "").strip() in _TRUE:
        return 409, {"error": "this server holds no engine KV state to "
                              "evacuate; ?evacuate=1 applies to engine "
                              "workers only"}
    else:
        DRAIN.drain()
    return 200, {"draining": DRAIN.draining}


def split_path(raw: str) -> Tuple[str, Dict[str, str]]:
    """(path, last value of each query parameter) of a request line's
    target."""
    parts = urlsplit(raw)
    query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
    return parts.path, query


class DebugError(ValueError):
    """A debug route's refusal: the server answers ``status`` with
    ``{"error": ...}``."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


def _query_number(query: Mapping[str, str], name: str, default, cast,
                  maximum=None):
    raw = query.get(name, "")
    if not raw:
        return default
    try:
        value = cast(raw)
    except ValueError:
        raise DebugError(400, f"{name} must be a number, got {raw!r}")
    if maximum is not None:
        value = min(value, maximum)
    return value


def _flight(query: Mapping[str, str]) -> Dict[str, Any]:
    """Windowed flight-recorder samples (``?window=`` seconds, default
    600; ``?limit=`` newest samples, default 1024, cap 8192) and events."""
    seconds = _query_number(query, "window", FLIGHT_WINDOW_DEFAULT_S, float)
    limit = _query_number(query, "limit", FLIGHT_LIMIT_DEFAULT, int,
                          maximum=FLIGHT_LIMIT_MAX)
    return {**FLIGHT.describe(), "window_s": seconds, "limit": limit,
            "samples": FLIGHT.window(seconds, limit=max(0, limit)),
            "events": FLIGHT.events(seconds)}


def _requests(query: Mapping[str, str]) -> Dict[str, Any]:
    n = _query_number(query, "n", REQUESTS_LIMIT_DEFAULT, int,
                      maximum=REQUESTS_LIMIT_MAX)
    return {"requests": REQUEST_LOG.recent(n), "limit": n}


def _request_timeline(rid: str) -> Dict[str, Any]:
    rec = REQUEST_LOG.get(rid)
    if rec is None:
        raise DebugError(404, f"no recent request {rid!r} (log keeps the "
                              f"last {REQUEST_LOG.capacity})")
    return rec


def _slo(query: Mapping[str, str]) -> Dict[str, Any]:
    return slo_mod.SLO.debug_payload()


def _devtime(query: Mapping[str, str]) -> Dict[str, Any]:
    """The ledger by (program, bucket). ``device_s`` is a stream span that
    starts before the host issues the dispatch, so it holds the host's
    issue time: ``engine_mfu`` is a lower bound, and device busy time
    comes from a trace."""
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    return DEVTIME.snapshot()


def _compiles(query: Mapping[str, str]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    return DEVTIME.compiles()


def _chaos(query: Mapping[str, str]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.observability.chaos import CHAOS
    return CHAOS.snapshot()


def _deadletter(query: Mapping[str, str]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.chains.event_agent import (
        dead_letter_payload)
    return dead_letter_payload()


def _usage(query: Mapping[str, str]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.observability.usage import USAGE
    return USAGE.snapshot()


def _fleet(query: Mapping[str, str]) -> Dict[str, Any]:
    """The local view a process without a routing frontend answers with
    (the reference's body when its router is absent)."""
    from generativeaiexamples_tpu_torch.observability import usage as usage_mod
    return {"workers": {},
            "note": "no routing frontend in this process; local view only",
            "tenants": usage_mod.USAGE.rollup(),
            "local_perf": usage_mod.worker_perf_card()}


def _trace(query: Mapping[str, str]) -> Dict[str, Any]:
    """The event trace's newest window (``?window=``, ``?limit=``,
    ``?kind=a,b``); off mode answers ``enabled: false`` with the hint."""
    from generativeaiexamples_tpu_torch.observability.trace import TRACE
    seconds = _query_number(query, "window", TRACE_WINDOW_DEFAULT_S, float)
    limit = _query_number(query, "limit", TRACE_LIMIT_DEFAULT, int,
                          maximum=TRACE_LIMIT_MAX)
    kinds_raw = query.get("kind", "").strip()
    kinds = ([k.strip() for k in kinds_raw.split(",") if k.strip()]
             or None)
    rid = query.get("rid", "").strip()
    if not TRACE.enabled:
        return {**TRACE.describe(),
                "hint": "set APP_TRACE=on (worker env) to record the fleet "
                        "event trace"}
    if rid:
        # one request's records, the GLOBAL dispatch emits joined by
        # their rids roster (the forensics plane's slice)
        from generativeaiexamples_tpu_torch.observability import forensics
        records = forensics.trace_slice(rid)
        if kinds is not None:
            records = [r for r in records if r.get("kind") in set(kinds)]
        if limit and len(records) > limit:
            records = records[-limit:]
        return {**TRACE.describe(), "rid": rid, "limit": limit,
                "records": records}
    return {**TRACE.describe(), "window_s": seconds, "limit": limit,
            "records": TRACE.window(seconds, limit=limit, kinds=kinds)}


def _locks(query: Mapping[str, str]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.observability import lockwatch
    if not lockwatch._env_on():
        return {"enabled": False,
                "hint": "set APP_LOCKWATCH=on (worker env, before process "
                        "start) to arm the lock-order sanitizer"}
    return lockwatch.WATCH.payload()


def _qos(query: Mapping[str, str]) -> Dict[str, Any]:
    """The QoS admission plane (engine/qos.py, ``APP_QOS``): per-tenant
    weights, virtual clocks, quota buckets, the service-time estimate's
    basis and the open admission reservations; ``enabled: false`` in off
    mode. A process that never loaded the engine package cannot hold a
    policy, so the module is looked up, never imported."""
    import os
    import sys
    qos_mod = sys.modules.get("generativeaiexamples_tpu_torch.engine.qos")
    if qos_mod is None:
        return {"enabled": False,
                "mode": (os.environ.get("APP_QOS", "").strip().lower()
                         or "off"),
                "hint": "set APP_QOS=fair (engine worker env) to enable the "
                        "admission plane; docs/scheduling.md"}
    return qos_mod.debug_payload()


def _forensics(query: Mapping[str, str]) -> Dict[str, Any]:
    """The tail-exemplar ring (observability/forensics.py,
    ``APP_FORENSICS=on``): requests that breached their SLO or landed
    above the trailing p99, captured with their trace slices."""
    from generativeaiexamples_tpu_torch.observability.forensics import (
        FORENSICS)
    if not FORENSICS.enabled:
        return {**FORENSICS.describe(),
                "hint": "set APP_FORENSICS=on (worker env) to capture tail "
                        "exemplars; docs/observability.md"}
    return {**FORENSICS.describe(), "exemplars": FORENSICS.exemplars()}


def _forensics_rid(rid: str) -> Dict[str, Any]:
    """One request's critical path: its captured exemplar, else a live
    breakdown from what the trace and the request log still hold (404
    when neither knows it)."""
    from generativeaiexamples_tpu_torch.observability.forensics import (
        FORENSICS)
    body = FORENSICS.payload(rid)
    if not body.get("captured") and not (body.get("breakdown")
                                         or {}).get("found"):
        raise DebugError(404, f"no forensics for request {rid!r} (trace "
                              "ring and request log have both aged it out)")
    return body


def _alerts(query: Mapping[str, str]) -> Dict[str, Any]:
    """Burn-rate alert state (observability/alerts.py): active alerts by
    objective and scope, the raise log, the rules in force. Verdicts feed
    the windows only where a scheduler runs with ``APP_FORENSICS=on``."""
    from generativeaiexamples_tpu_torch.observability.alerts import ALERTS
    from generativeaiexamples_tpu_torch.observability.forensics import (
        FORENSICS)
    body = ALERTS.payload()
    body["enabled"] = FORENSICS.enabled
    if not FORENSICS.enabled:
        body["hint"] = ("set APP_FORENSICS=on (worker env) to feed the "
                        "burn-rate windows; docs/observability.md")
    return body


def _doctor(query: Mapping[str, str]) -> Dict[str, Any]:
    """Symptoms to named causes, ranked by estimated device seconds lost
    (observability/forensics.doctor_payload)."""
    from generativeaiexamples_tpu_torch.observability.forensics import (
        doctor_payload)
    return doctor_payload()


# the one path table of the debug surface, consulted by every server
DEBUG_ROUTES: Dict[str, Callable[[Mapping[str, str]], Dict[str, Any]]] = {
    "/debug/flight": _flight,
    "/debug/requests": _requests,
    "/debug/slo": _slo,
    "/debug/devtime": _devtime,
    "/debug/compiles": _compiles,
    "/debug/chaos": _chaos,
    "/debug/deadletter": _deadletter,
    "/debug/usage": _usage,
    "/debug/fleet": _fleet,
    "/debug/trace": _trace,
    "/debug/locks": _locks,
    "/debug/qos": _qos,
    "/debug/forensics": _forensics,
    "/debug/alerts": _alerts,
    "/debug/doctor": _doctor,
}


def debug_get(path: str, query: Mapping[str, str]
              ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """(status, body) of a ``GET /debug/...`` route; None when ``path`` is
    not one (the server answers its own 404)."""
    try:
        if path.startswith("/debug/requests/"):
            return 200, _request_timeline(
                unquote(path[len("/debug/requests/"):]))
        if path.startswith("/debug/forensics/"):
            return 200, _forensics_rid(
                unquote(path[len("/debug/forensics/"):]))
        fn = DEBUG_ROUTES.get(path)
        if fn is None:
            return None
        return 200, fn(query)
    except DebugError as exc:
        return exc.status, {"error": str(exc)}


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
