"""Engine flight recorder + per-request timeline log.

A copy of ``generativeaiexamples_tpu/observability/flight.py`` (standard
library only) with its imports pointed at the port. The crash dump
carries the QoS plane's state (``engine/qos.debug_payload``) and the host
KV tier's occupancy when the engine package is loaded.

Post-incident "why did tok/s crater at 14:02" questions need continuous
per-step engine state, not uptime-averaged counters (RAGO's per-stage
characterization argument, PAPERS.md). Two bounded in-memory stores, both
strictly memory-capped, both free when nobody reads them:

  * ``FLIGHT`` — a ring buffer of scheduler-step samples (decode batch
    fill, waiting/prefilling/running queue depths, KV pages free/used,
    prefix-cache hit tokens, preemptions, tok/s between samples). The
    scheduler feeds it time-gated (``maybe_sample``, default every 250 ms),
    so the driver loop pays one clock read per tick when a sample is not
    due. Numeric fields are mirrored into ``flight_*`` gauges
    (core/metrics.py), so the *current* engine state also rides ``/metrics``.
    Dump surfaces: ``GET /debug/flight?window=<s>`` (server/common.py) and
    SIGUSR1 → JSON file (``install_signal_dump``).

  * ``REQUEST_LOG`` — the last N finished requests' timelines
    (queued → admitted → prefill_start → first_token → finished, plus
    preemption count, prefix-hit tokens, finish cause), looked up by
    request id via ``GET /debug/requests/<id>`` and stamped onto the engine
    server's spans. Phase stamps all come from the injected perf clock
    (core/clock.py — ``time.perf_counter`` live, virtual under the
    simulator), so phase ordering is exact; ``finished_unix`` anchors the
    timeline to the wall clock for cross-log correlation.

Env knobs: ``APP_FLIGHT_CAPACITY`` (samples, default 4096),
``APP_FLIGHT_INTERVAL_MS`` (default 250 — ~17 min of history at the
default capacity), ``APP_FLIGHT_DUMP_PATH`` (SIGUSR1 target, default
``/tmp/flight_<pid>.json``), ``APP_REQUEST_LOG_CAPACITY`` (default 512).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _policy_state() -> Dict[str, Any]:
    """Point-in-time QoS virtual-time state + KV-tier occupancy for the
    crash-dump artifact. Both planes live in the engine package, whose
    import pulls torch — a process that never loaded it (encoder, chain
    server without an engine) CANNOT have registered either object, so
    consult sys.modules (under the port's module names) instead of
    importing."""
    import sys
    out: Dict[str, Any] = {}
    qos_mod = sys.modules.get("generativeaiexamples_tpu_torch.engine.qos")
    if qos_mod is not None:
        try:
            out["qos"] = qos_mod.debug_payload()
        except Exception:
            logger.exception("flight dump: qos snapshot failed")
    tier_mod = sys.modules.get("generativeaiexamples_tpu_torch.engine.kv_tier")
    if tier_mod is not None:
        try:
            out["kv_tier"] = tier_mod.occupancy_payload()
        except Exception:
            logger.exception("flight dump: kv-tier snapshot failed")
    # the event-trace tail rides the dump too: a post-incident artifact
    # should carry the last decisions, not just the last gauges
    try:
        from generativeaiexamples_tpu_torch.observability.trace import TRACE
        out["trace"] = {**TRACE.describe(),
                        "tail": TRACE.window(600.0, limit=512)}
    except Exception:
        logger.exception("flight dump: trace tail failed")
    return out


class FlightRecorder:
    """Bounded ring of engine-state samples with time-gated capture."""

    def __init__(self, capacity: Optional[int] = None,
                 interval_s: Optional[float] = None) -> None:
        self.capacity = capacity if capacity is not None else _env_int(
            "APP_FLIGHT_CAPACITY", 4096)
        self.interval_s = interval_s if interval_s is not None else (
            _env_float("APP_FLIGHT_INTERVAL_MS", 250.0) / 1000.0)
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=max(1, self.capacity))
        # discrete incidents (recompiles, resets) keep their OWN bounded
        # ring: periodic samples share a fixed field shape that window
        # consumers (bench percentiles, dashboards) iterate uniformly, and
        # an event sample interleaved among them would break that contract
        self._events: Deque[Dict[str, Any]] = deque(maxlen=256)
        self._lock = threading.Lock()
        self._last_t = 0.0
        self._prev: Optional[Dict[str, Any]] = None

    def maybe_sample(self, fields_fn: Callable[[], Mapping[str, Any]]) -> bool:
        """Record a sample iff the interval has elapsed. ``fields_fn`` is
        only invoked when a sample is due — the fast path is one clock
        read, cheap enough for every scheduler tick."""
        now = clock.mono()
        if now - self._last_t < self.interval_s:
            return False
        with self._lock:
            if now - self._last_t < self.interval_s:
                return False
            self._last_t = now
        self.record(**dict(fields_fn()))
        return True

    def record(self, **fields: Any) -> Dict[str, Any]:
        """Unconditionally append one sample; derives ``tok_s`` from the
        ``tokens_generated`` delta against the previous sample and mirrors
        numeric fields into ``flight_*`` gauges.

        Each sample carries two stamps: ``ts`` (wall clock — what dumps,
        bench windows, and cross-log correlation key on) and ``mono``
        (monotonic — what every delta and window cutoff computes from, so
        an NTP step can never produce a negative tok/s or swallow a
        window)."""
        now = clock.mono()
        sample: Dict[str, Any] = {"ts": clock.wall(), "mono": now}
        sample.update(fields)
        with self._lock:
            prev = self._prev
            if prev is not None and "tokens_generated" in fields:
                dt = now - prev["mono"]
                if dt > 1e-6:
                    sample["tok_s"] = round(
                        (fields["tokens_generated"]
                         - prev.get("tokens_generated", 0)) / dt, 2)
            self._prev = sample
            self._ring.append(sample)
        for key, value in fields.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            REGISTRY.gauge(f"flight_{key}").set(value)
        return sample

    def event(self, name: str, **fields: Any) -> Dict[str, Any]:
        """Record a discrete incident — a mid-serving recompile, a pool
        reset — into the event ring (``/debug/flight`` serves it next to
        the sample window; SIGUSR1 dumps carry it). Events bypass the time
        gate and never touch the periodic ring or its tok/s delta chain:
        sample consumers iterate a fixed field shape that an interleaved
        event would break."""
        sample: Dict[str, Any] = {"ts": clock.wall(), "mono": clock.mono(),
                                  "event": name}
        sample.update(fields)
        with self._lock:
            self._events.append(sample)
        return sample

    def events(self, seconds: Optional[float] = None) -> List[Dict[str, Any]]:
        """Events from the last ``seconds`` (None = whole ring), oldest
        first."""
        with self._lock:
            events = list(self._events)
        if seconds is not None:
            cutoff = clock.mono() - seconds
            events = [e for e in events if e["mono"] >= cutoff]
        return events

    def window(self, seconds: Optional[float] = None,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Samples from the last ``seconds`` (None = whole ring), oldest
        first; ``limit`` keeps only the NEWEST n of them (a capped debug
        poll wants the most recent state, not the window's head)."""
        with self._lock:
            samples = list(self._ring)
        if seconds is not None:
            cutoff = clock.mono() - seconds
            samples = [s for s in samples if s["mono"] >= cutoff]
        if limit is not None and len(samples) > limit:
            samples = samples[len(samples) - limit:]
        return samples

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._events.clear()
            self._prev = None
            self._last_t = 0.0

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            n_events = len(self._events)
        return {"capacity": self.capacity,
                "interval_s": self.interval_s,
                "samples_held": len(self),
                "events_held": n_events}

    def dump(self, path: str) -> str:
        """Write the full ring as JSON (the SIGUSR1 / post-incident dump),
        plus the QoS virtual-time state, KV-tier occupancy, and the event
        trace's recent tail when those planes are loaded — the crash
        artifact answers "what was the policy state" without a second
        probe of a possibly-dead server."""
        payload = {"dumped_at_unix": clock.wall(), **self.describe(),
                   "samples": self.window(), "events": self.events(),
                   **_policy_state()}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        return path


FLIGHT = FlightRecorder()


# ---------------------------------------------------------------------------
# Per-request timelines
# ---------------------------------------------------------------------------

_PHASES = ("queued", "admitted", "prefill_start", "first_token", "finished")


def timeline(req: Any) -> Dict[str, Any]:
    """Serializable timeline of a scheduler Request. Phase values share the
    injected perf clock (monotonic ordering is exact); unreached
    phases (e.g. a request failed before admission) are omitted."""
    stamps = {
        "queued": getattr(req, "submitted_at", None),
        "admitted": getattr(req, "admitted_at", None),
        "prefill_start": getattr(req, "prefill_start_at", None),
        "first_token": getattr(req, "first_token_at", None),
        "finished": getattr(req, "finished_at", None),
    }
    phases = {k: round(v, 6) for k, v in stamps.items() if v is not None}
    out: Dict[str, Any] = {
        "request_id": getattr(req, "request_id", ""),
        "phases": phases,
        "preemptions": getattr(req, "preemptions", 0),
        # resume-mode split (live migration + host spill, engine/spill.py):
        # of the preemptions/evacuations this request survived, how many
        # recovered by TRANSFER (spill promote, snapshot resume) — the
        # rest recomputed via re-prefill. Recompute-vs-transfer recovery
        # is visible per request, not just in fleet counters.
        "spill_resumes": getattr(req, "spill_resumes", 0),
        "snapshot_resumes": getattr(req, "snapshot_resumes", 0),
        "prefix_hit_tokens": getattr(req, "prefix_hit_tokens", 0),
        # prefix-tier split (engine/kv_tier.py): how many of the prefix
        # hits were promoted from the HOST tier (vs device prefix cache)
        "tier_hit_tokens": getattr(req, "tier_hit_tokens", 0),
        "completion_tokens": getattr(req, "completion_tokens", 0),
        "prompt_tokens": len(getattr(req, "prompt_ids", []) or []),
        "finish": getattr(req, "finish_reason", None),
        "error": getattr(req, "error", None),
        # usage plane (observability/usage.py): the tenant the request
        # billed to — /debug/requests timelines join /debug/usage rows
        "tenant": getattr(req, "tenant", "") or "anon",
        # SLO plane (observability/slo.py): the scheduler judges attainment
        # BEFORE recording, so timelines, breach records, and
        # slo_requests_total agree per request
        "slo_class": getattr(req, "slo_class", None),
        "slo": getattr(req, "slo", None),
        "finished_unix": clock.wall(),
    }
    durations: Dict[str, float] = {}
    q = stamps["queued"]
    if q is not None:
        for phase, key in (("admitted", "queue_wait_s"),
                           ("first_token", "ttft_s"),
                           ("finished", "total_s")):
            if stamps[phase] is not None:
                durations[key] = round(stamps[phase] - q, 6)
    if stamps["prefill_start"] is not None and stamps["first_token"] is not None:
        durations["prefill_to_first_token_s"] = round(
            stamps["first_token"] - stamps["prefill_start"], 6)
    out["durations_s"] = durations
    return out


def timeline_attributes(req: Any) -> Dict[str, Any]:
    """Flat span attributes for a finished request (engine/server.py stamps
    these on its per-request span)."""
    rec = timeline(req)
    attrs: Dict[str, Any] = {
        "request.id": rec["request_id"],
        "request.preemptions": rec["preemptions"],
        "request.prefix_hit_tokens": rec["prefix_hit_tokens"],
        "request.tier_hit_tokens": rec["tier_hit_tokens"],
        "request.completion_tokens": rec["completion_tokens"],
        "request.finish": rec["finish"] or (rec["error"] and "error") or "",
    }
    for key, value in rec["durations_s"].items():
        attrs[f"request.{key}"] = value
    return attrs


class RequestLog:
    """Bounded id-addressable log of recent request timelines."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity if capacity is not None else _env_int(
            "APP_REQUEST_LOG_CAPACITY", 512)
        self._recs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, req: Any) -> Dict[str, Any]:
        rec = timeline(req)
        rid = rec["request_id"]
        with self._lock:
            self._recs.pop(rid, None)
            self._recs[rid] = rec
            while len(self._recs) > max(1, self.capacity):
                self._recs.popitem(last=False)
        return rec

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._recs.get(request_id)

    def recent(self, n: int = 50) -> List[Dict[str, Any]]:
        """Newest first."""
        with self._lock:
            recs = list(self._recs.values())
        return recs[::-1][:max(0, n)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()


REQUEST_LOG = RequestLog()


# ---------------------------------------------------------------------------
# SIGUSR1 → dump-to-file
# ---------------------------------------------------------------------------

_signal_installed = False


def install_signal_dump(path: Optional[str] = None) -> bool:
    """``kill -USR1 <pid>`` dumps the flight ring to a JSON file — the
    no-endpoint escape hatch for a wedged or unreachable server. Only
    installable from the main thread (signal module constraint); returns
    False (with a log line) anywhere it cannot install, so server startup
    never fails on it."""
    global _signal_installed
    if _signal_installed:
        return True
    target = (path or os.environ.get("APP_FLIGHT_DUMP_PATH", "")
              or f"/tmp/flight_{os.getpid()}.json")

    def _handler(signum: int, frame: Any) -> None:
        try:
            FLIGHT.dump(target)
            logger.info("flight recorder dumped to %s (%d samples)",
                        target, len(FLIGHT))
        except OSError as exc:
            logger.warning("flight dump to %s failed: %s", target, exc)

    try:
        import signal
        if threading.current_thread() is not threading.main_thread():
            raise ValueError("not in main thread")
        signal.signal(signal.SIGUSR1, _handler)
    except (ValueError, AttributeError, OSError) as exc:
        logger.info("SIGUSR1 flight dump not installed: %s", exc)
        return False
    _signal_installed = True
    logger.info("SIGUSR1 dumps flight recorder to %s", target)
    return True
