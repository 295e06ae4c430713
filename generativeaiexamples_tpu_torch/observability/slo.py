"""SLO & goodput plane: deadline accounting, burn-rate alerts, shed signals.

A copy of ``generativeaiexamples_tpu/observability/slo.py`` (standard
library only) with its imports pointed at the port; the classes come from
the port's ``APP_SLO_*`` section (core/config.py ``SLOConfig``).

The flight plane gives the stack raw telemetry (flight ring, timelines, Prometheus
metrics) but nothing *interprets* it. This module adds the judgment layer
RAGO (arxiv 2503.14649) argues RAG serving is actually governed by — per-
stage TTFT/TPOT budgets, not raw throughput — with NinjaLLM's (arxiv
2407.12057) headline metric, SLO attainment, measured per request:

  * **SLO classes** (``interactive`` / ``batch`` / ``best_effort``)
    declared in config (``APP_SLO_*``, core/config.py) with TTFT, TPOT and
    end-to-end budgets and a ``sheddable`` bit.
  * **Deadline accounting**: the chain server stamps a class + deadline at
    admission (:func:`admission`); outbound LLM calls propagate the
    *remaining* budget to the engine as ``X-Request-Class`` /
    ``X-Request-Deadline-Ms`` headers (:func:`outbound_headers`,
    chains/llm_client.py) — remaining-ms, not absolute time, so two
    processes never need agreeing clocks.
  * **Attainment judging** (:meth:`SloTracker.observe`): every finished
    request is judged from its timeline stamps (submitted → first
    token → finished) against its class budgets; the verdict is stamped on
    the request (so ``/debug/requests/<id>`` timelines carry it), counted
    into ``slo_requests_total{class,outcome}``, and observed into
    per-class latency histograms that carry the request's trace id as an
    OpenMetrics exemplar (core/metrics.py) — a breach on ``/debug/slo``
    links straight to its trace.
  * **Multi-window burn-rate alerts** (:meth:`SloTracker.pressure`):
    Google-SRE-style paired windows (default 5 m fast / 1 h slow) over the
    class error budget, all window math on an injected monotonic clock
    (deterministic under test).
    ``pressure() ∈ {ok, warn, critical}`` fires only when BOTH windows
    burn past the paired threshold; ``best_effort``'s own breaches are
    excluded from the signal (shedding it must not keep pressure high).
  * **Shed signal**: the engine scheduler consults ``pressure()`` each
    admission pass and sheds pending ``sheddable``-class requests under
    ``critical`` (engine/scheduler.py); server/failover.py reads the
    pressure each worker reports on ``/health``.

Everything is process-global (``SLO``) like REGISTRY/FLIGHT; servers dump
the full picture at ``GET /debug/slo`` (server/common.py).
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Iterator, List, Mapping, Optional, Tuple

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

CLASS_HEADER = "X-Request-Class"
DEADLINE_HEADER = "X-Request-Deadline-Ms"
# Client-facing aliases: direct engine clients and bench drive
# /v1/chat/completions and /v1/kv/prefill without the chain server
# fronting them — the short names are the documented public contract,
# the X-Request-* pair stays the internal propagation form (canonical
# headers win when both arrive). Both servers parse both; outbound
# propagation emits both so the router forwards deadline stamping to
# engines reading either name.
CLASS_HEADER_ALIAS = "X-Slo-Class"
DEADLINE_HEADER_ALIAS = "X-Deadline-Ms"

_PRESSURE_LEVELS = ("ok", "warn", "critical")


@dataclass(frozen=True)
class SLOClass:
    """One serving objective: latency budgets + shed policy."""

    name: str
    ttft_s: float
    tpot_s: float
    e2e_s: float
    sheddable: bool = False


def _classes_from_config() -> Tuple[Dict[str, SLOClass], Dict[str, Any]]:
    """(classes, evaluator knobs) from the APP_SLO_* config section."""
    from generativeaiexamples_tpu_torch.core.config import get_config

    slo = get_config().slo
    classes = {}
    for name in ("interactive", "batch", "best_effort"):
        c = getattr(slo, name)
        classes[name] = SLOClass(name=name, ttft_s=c.ttft_s, tpot_s=c.tpot_s,
                                 e2e_s=c.e2e_s, sheddable=c.sheddable)
    knobs = {"default_class": slo.default_class, "target": slo.target,
             "fast_window_s": slo.fast_window_s,
             "slow_window_s": slo.slow_window_s,
             "warn_burn": slo.warn_burn, "critical_burn": slo.critical_burn,
             "min_events": slo.min_events}
    return classes, knobs


class _BucketWindow:
    """Good/bad event counts bucketed on a monotonic clock.

    Fixed-width buckets (fast_window / 30) in a bounded deque covering the
    slow window; summing a window is O(buckets) — cheap enough to run on
    every (cached) pressure evaluation, and the memory bound is static.
    """

    def __init__(self, bucket_s: float, span_s: float) -> None:
        self.bucket_s = max(1e-6, bucket_s)
        self._buckets: Deque[List[float]] = deque(
            maxlen=max(2, int(span_s / self.bucket_s) + 1))

    def add(self, now: float, good: int = 0, bad: int = 0) -> None:
        start = now - (now % self.bucket_s)
        if self._buckets and self._buckets[-1][0] == start:
            self._buckets[-1][1] += good
            self._buckets[-1][2] += bad
        else:
            self._buckets.append([start, float(good), float(bad)])

    def totals(self, now: float, window_s: float) -> Tuple[float, float]:
        """(good, bad) inside the trailing ``window_s``."""
        cutoff = now - window_s
        good = bad = 0.0
        for start, g, b in reversed(self._buckets):
            if start + self.bucket_s <= cutoff:
                break
            good += g
            bad += b
        return good, bad


class SloTracker:
    """Process-wide SLO state: per-class attainment, burn rates, pressure.

    ``clock`` must be monotonic (tests inject a fake); wall time appears
    only as a reported timestamp on breach records.
    """

    BREACH_LOG = 64

    def __init__(self, classes: Optional[Mapping[str, SLOClass]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 **knobs: Any) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._configured = classes is not None
        self._classes: Dict[str, SLOClass] = dict(classes or {})
        self._knobs: Dict[str, Any] = dict(knobs)
        self._windows: Dict[str, _BucketWindow] = {}
        self._breaches: Deque[Dict[str, Any]] = deque(maxlen=self.BREACH_LOG)
        self._pressure = "ok"
        self._pressure_at: Optional[float] = None
        self._pressure_ttl = 1.0   # re-evaluate at most once per second
        # external hazards (devtime's mid-serving recompile watch): each
        # floors pressure at "warn" until its TTL — a latency cliff becomes
        # an alert BEFORE the burn windows can even see its breaches
        self._hazards: Deque[Dict[str, Any]] = deque(maxlen=32)
        self._hazard_until: Optional[float] = None

    # ------------------------------------------------------------ config

    def _ensure_config(self) -> None:
        if self._configured:
            return
        classes, knobs = _classes_from_config()
        with self._lock:
            if not self._configured:
                self._classes = classes
                knobs.update(self._knobs)   # explicit ctor knobs win
                self._knobs = knobs
                self._configured = True

    def knob(self, name: str) -> Any:
        self._ensure_config()
        return self._knobs[name]

    def classes(self) -> Dict[str, SLOClass]:
        self._ensure_config()
        return dict(self._classes)

    def default_class(self) -> str:
        return str(self.knob("default_class"))

    def resolve(self, name: Optional[str]) -> SLOClass:
        """Class by name; empty/None → the configured default. Unknown
        names raise KeyError — the serving layer maps that to a 400."""
        self._ensure_config()
        return self._classes[name or self.default_class()]

    def reset(self) -> None:
        """Drop accumulated state (tests; config is re-read lazily)."""
        with self._lock:
            self._windows.clear()
            self._breaches.clear()
            self._pressure = "ok"
            self._pressure_at = None
            self._hazards.clear()
            self._hazard_until = None

    # ------------------------------------------------------------ hazards

    def note_hazard(self, kind: str, detail: Optional[Dict[str, Any]] = None,
                    warn_for_s: float = 60.0) -> None:
        """Record an external hazard — an event that predicts imminent
        breaches before any request has actually missed its budget (the
        devtime compile-watch reports programs first seen mid-serving here).
        Pressure is floored at ``warn`` for ``warn_for_s`` so routers and
        dashboards see the cliff as it happens; ``critical`` (shedding)
        still requires real measured burn."""
        now = self._clock()
        with self._lock:
            self._hazards.append({"ts_unix": time.time(), "kind": kind,
                                  "detail": dict(detail or {})})
            until = now + max(0.0, warn_for_s)
            if self._hazard_until is None or until > self._hazard_until:
                self._hazard_until = until
            self._pressure_at = None   # next pressure() re-evaluates
        REGISTRY.counter("slo_hazards_total", labels={"kind": kind}).inc()

    # ------------------------------------------------------------ judging

    def judge(self, req: Any) -> Dict[str, Any]:
        """Attainment verdict for a finished scheduler Request (or any
        object with the timeline attributes). Pure — no counters.

        Outcomes: ``attained`` | ``breached`` (with per-dimension detail)
        | ``error`` (failed before completing) | ``shed`` (preset by the
        scheduler's load shedder). All durations difference stamps from
        one monotonic clock (Request uses perf_counter throughout).
        """
        preset = getattr(req, "slo_outcome", None)
        cls = self.resolve_or_default(getattr(req, "slo_class", None))
        verdict: Dict[str, Any] = {"class": cls.name}
        if preset == "shed":
            verdict["outcome"] = "shed"
            return verdict
        if getattr(req, "error", None):
            verdict["outcome"] = "error"
            return verdict
        submitted = getattr(req, "submitted_at", None)
        first = getattr(req, "first_token_at", None)
        finished = getattr(req, "finished_at", None)
        ntok = getattr(req, "completion_tokens", 0) or 0
        breaches: Dict[str, Dict[str, float]] = {}
        if submitted is not None and first is not None:
            ttft = first - submitted
            verdict["ttft_s"] = round(ttft, 6)
            if ttft > cls.ttft_s:
                breaches["ttft"] = {"observed_s": round(ttft, 6),
                                    "budget_s": cls.ttft_s}
        if first is not None and finished is not None and ntok > 1:
            tpot = (finished - first) / (ntok - 1)
            verdict["tpot_s"] = round(tpot, 6)
            if tpot > cls.tpot_s:
                breaches["tpot"] = {"observed_s": round(tpot, 6),
                                    "budget_s": cls.tpot_s}
        if submitted is not None and finished is not None:
            e2e = finished - submitted
            verdict["e2e_s"] = round(e2e, 6)
            budget = cls.e2e_s
            deadline = getattr(req, "deadline_s", None)
            if deadline is not None:
                budget = min(budget, deadline)
            if e2e > budget:
                breaches["e2e"] = {"observed_s": round(e2e, 6),
                                   "budget_s": round(budget, 6)}
        if breaches:
            verdict["outcome"] = "breached"
            verdict["breaches"] = breaches
        else:
            verdict["outcome"] = "attained"
        return verdict

    def resolve_or_default(self, name: Optional[str]) -> SLOClass:
        try:
            return self.resolve(name)
        except KeyError:
            return self.resolve(None)

    def observe(self, req: Any) -> Dict[str, Any]:
        """Judge a finished request and account it: stamps ``req.slo``
        (REQUEST_LOG.record then persists it into the timeline), counts
        ``slo_requests_total{class,outcome}``, feeds the burn windows, logs
        breaches, and observes per-class latency histograms carrying the
        request's trace id as an exemplar."""
        verdict = self.judge(req)
        try:
            req.slo = verdict
        except AttributeError:
            pass   # SimpleNamespace-style fakes always accept; slots won't
        cls, outcome = verdict["class"], verdict["outcome"]
        REGISTRY.counter("slo_requests_total",
                         labels={"class": cls, "outcome": outcome}).inc()
        exemplar = None
        trace_id = getattr(req, "trace_id", "") or ""
        if trace_id:
            exemplar = {"trace_id": trace_id}
        for dim in ("ttft", "tpot", "e2e"):
            value = verdict.get(f"{dim}_s")
            if value is not None:
                REGISTRY.histogram(f"slo_{dim}_s",
                                   labels={"class": cls}).observe(
                    value, exemplar=exemplar)
        now = self._clock()
        counted = outcome in ("attained", "breached", "error")
        with self._lock:
            if counted:
                self._window(cls).add(now, good=int(outcome == "attained"),
                                      bad=int(outcome != "attained"))
            if outcome == "breached":
                self._breaches.append({
                    "ts_unix": time.time(),
                    "request_id": getattr(req, "request_id", ""),
                    "trace_id": trace_id,
                    "class": cls,
                    "breaches": verdict.get("breaches", {}),
                })
        return verdict

    def _window(self, cls: str) -> _BucketWindow:
        # caller holds self._lock
        if cls not in self._windows:
            fast = float(self.knob("fast_window_s"))
            slow = float(self.knob("slow_window_s"))
            self._windows[cls] = _BucketWindow(bucket_s=fast / 30.0,
                                               span_s=slow)
        return self._windows[cls]

    # ------------------------------------------------------------ burn rate

    def burn_rates(self, cls: str) -> Dict[str, float]:
        """{fast, slow} burn rates for one class: (error rate) / (error
        budget). 1.0 = burning exactly the budget; 10 = 10x too fast."""
        self._ensure_config()
        now = self._clock()
        budget = max(1e-9, 1.0 - float(self.knob("target")))
        out = {}
        with self._lock:
            win = self._windows.get(cls)
            for key in ("fast", "slow"):
                span = float(self.knob(f"{key}_window_s"))
                good, bad = win.totals(now, span) if win else (0.0, 0.0)
                total = good + bad
                rate = (bad / total) if total else 0.0
                out[key] = round(rate / budget, 4)
                out[f"{key}_events"] = int(total)
        return out

    def pressure(self) -> str:
        """Current shed signal, re-evaluated at most once per second
        (cached on the injected clock — the scheduler consults this every
        admission pass). A level fires only when BOTH windows of some
        non-sheddable class burn past its paired threshold and the fast
        window has seen ``min_events`` requests."""
        self._ensure_config()
        now = self._clock()
        with self._lock:
            if (self._pressure_at is not None
                    and now - self._pressure_at < self._pressure_ttl):
                return self._pressure
        level = "ok"
        for name, cls in self.classes().items():
            if cls.sheddable:
                continue    # shedding best_effort must not sustain pressure
            rates = self.burn_rates(name)
            if rates["fast_events"] < int(self.knob("min_events")):
                continue
            for cand, knob in (("critical", "critical_burn"),
                               ("warn", "warn_burn")):
                threshold = float(self.knob(knob))
                if rates["fast"] >= threshold and rates["slow"] >= threshold:
                    if (_PRESSURE_LEVELS.index(cand)
                            > _PRESSURE_LEVELS.index(level)):
                        level = cand
                    break
        with self._lock:
            if (level == "ok" and self._hazard_until is not None
                    and now < self._hazard_until):
                level = "warn"   # active hazard floors pressure (note_hazard)
            self._pressure = level
            self._pressure_at = now
        REGISTRY.gauge("slo_pressure").set(_PRESSURE_LEVELS.index(level))
        return level

    # ------------------------------------------------------------ reporting

    def debug_payload(self) -> Dict[str, Any]:
        """The ``GET /debug/slo`` body: per-class budgets, window
        attainment, burn rates, pressure, recent breaches."""
        self._ensure_config()
        pressure = self.pressure()
        per_class = {}
        for name, cls in self.classes().items():
            rates = self.burn_rates(name)
            fast_events = rates.pop("fast_events")
            slow_events = rates.pop("slow_events")
            snap = REGISTRY.counter("slo_requests_total",
                                    labels={"class": name,
                                            "outcome": "attained"}).value
            total = snap
            for outcome in ("breached", "error", "shed"):
                total += REGISTRY.counter(
                    "slo_requests_total",
                    labels={"class": name, "outcome": outcome}).value
            per_class[name] = {
                "budgets": {"ttft_s": cls.ttft_s, "tpot_s": cls.tpot_s,
                            "e2e_s": cls.e2e_s},
                "sheddable": cls.sheddable,
                "burn_rate": rates,
                "window_events": {"fast": fast_events, "slow": slow_events},
                "lifetime": {"total": total, "attained": snap,
                             "attainment": (round(snap / total, 4)
                                            if total else None)},
            }
        with self._lock:
            breaches = list(self._breaches)[::-1]
            hazards = list(self._hazards)[::-1]
            hazard_active = (self._hazard_until is not None
                             and self._clock() < self._hazard_until)
        return {
            "pressure": pressure,
            "hazard_active": hazard_active,
            "recent_hazards": hazards,
            "target": float(self.knob("target")),
            "windows_s": {"fast": float(self.knob("fast_window_s")),
                          "slow": float(self.knob("slow_window_s"))},
            "thresholds": {"warn": float(self.knob("warn_burn")),
                           "critical": float(self.knob("critical_burn"))},
            "default_class": self.default_class(),
            "classes": per_class,
            "recent_breaches": breaches,
        }


SLO = SloTracker()


# ---------------------------------------------------------------------------
# Admission context + header propagation (chain → engine)
# ---------------------------------------------------------------------------

@dataclass
class _Admission:
    slo_class: str
    deadline_mono: float     # absolute on time.monotonic


_admission: contextvars.ContextVar[Optional[_Admission]] = \
    contextvars.ContextVar("gaie_tpu_slo_admission", default=None)


@contextmanager
def admission(slo_class: Optional[str] = None,
              deadline_ms: Optional[float] = None) -> Iterator[_Admission]:
    """Stamp the current request's SLO class + deadline for downstream LLM
    calls (the chain server enters this around chain execution; LocalLLM /
    RemoteLLM / FailoverLLM read it via :func:`current_admission` /
    :func:`outbound_headers`). ``deadline_ms`` is REMAINING budget — an
    inbound ``X-Request-Deadline-Ms`` rides through shrinking, never a
    wall-clock instant."""
    cls = SLO.resolve_or_default(slo_class)
    budget_s = cls.e2e_s if deadline_ms is None else deadline_ms / 1000.0
    adm = _Admission(slo_class=cls.name,
                     deadline_mono=time.monotonic() + budget_s)
    token = _admission.set(adm)
    try:
        yield adm
    finally:
        _admission.reset(token)


def current_admission() -> Optional[_Admission]:
    return _admission.get()


def remaining_s(adm: Optional[_Admission] = None) -> Optional[float]:
    adm = adm if adm is not None else _admission.get()
    if adm is None:
        return None
    return adm.deadline_mono - time.monotonic()


def outbound_headers(headers: Optional[Dict[str, str]] = None
                     ) -> Dict[str, str]:
    """Class + remaining-deadline headers for an outbound engine call,
    injected alongside the W3C traceparent (chains/llm_client.py attaches
    these to every /v1 request)."""
    from generativeaiexamples_tpu_torch.observability import otel

    headers = headers if headers is not None else {}
    otel.inject_traceparent(headers)
    adm = _admission.get()
    if adm is not None:
        headers[CLASS_HEADER] = adm.slo_class
        headers[CLASS_HEADER_ALIAS] = adm.slo_class
        rem = remaining_s(adm)
        deadline_ms = str(max(0, int(rem * 1000)))
        headers[DEADLINE_HEADER] = deadline_ms
        headers[DEADLINE_HEADER_ALIAS] = deadline_ms
    return headers


def parse_inbound(headers: Mapping[str, str],
                  fallback_class: Optional[str] = None
                  ) -> Tuple[Optional[str], Optional[float]]:
    """(slo_class, deadline_s) from propagated admission headers — the one
    parser both servers share (engine/server.py maps failures to 400,
    server/api.py to 422). An unknown class is a loud ValueError: silently
    downgrading a caller's objective would falsify every attainment number
    downstream. ``fallback_class`` lets the chain server accept a body
    field when no header is present."""
    # public aliases (X-Slo-Class / X-Deadline-Ms) parse wherever the
    # canonical internal pair does — direct engine clients and bench get
    # deadline stamping without the chain server fronting them; canonical
    # wins when both arrive
    cls = ((headers.get(CLASS_HEADER) or "").strip()
           or (headers.get(CLASS_HEADER_ALIAS) or "").strip()
           or (fallback_class or "").strip() or None)
    if cls is not None:
        try:
            SLO.resolve(cls)
        except KeyError:
            raise ValueError(f"unknown SLO class {cls!r}; declared: "
                             f"{sorted(SLO.classes())}")
    deadline_s = None
    raw = ((headers.get(DEADLINE_HEADER) or "").strip()
           or (headers.get(DEADLINE_HEADER_ALIAS) or "").strip())
    if raw:
        try:
            deadline_s = max(0.0, float(raw) / 1000.0)
        except ValueError:
            raise ValueError(f"{DEADLINE_HEADER} must be milliseconds, "
                             f"got {raw!r}")
    return cls, deadline_s


def stamp_request(req: Any, slo_class: Optional[str] = None,
                  deadline_s: Optional[float] = None) -> None:
    """Stamp class/deadline onto a scheduler Request at submission. Explicit
    args (HTTP headers, engine/server.py) win; otherwise the ambient
    admission context (LocalLLM in-process path); otherwise the default
    class with its full e2e budget."""
    adm = _admission.get()
    if slo_class is None and adm is not None:
        slo_class = adm.slo_class
        if deadline_s is None:
            deadline_s = remaining_s(adm)
    cls = SLO.resolve_or_default(slo_class)
    req.slo_class = cls.name
    req.deadline_s = cls.e2e_s if deadline_s is None else deadline_s
