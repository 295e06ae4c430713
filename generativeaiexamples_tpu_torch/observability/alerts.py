"""SLO burn-rate alerting: multi-window rules over the judge's verdicts.

A copy of ``generativeaiexamples_tpu/observability/alerts.py`` (standard
library only) with its imports pointed at the port.

Classic SRE burn-rate alerting (fast window catches cliffs, slow window
confirms sustained burn; both must exceed the threshold) applied to the
three serving objectives the SLO judge already scores on every finished
request: **goodput** (attained vs everything else), **TTFT** and **TPOT**
(per-objective budget breaches). Rules are evaluated per SLO class and
per tenant (tenant scopes fold to ``other`` past a small cap: the
metric-cardinality rule applies here too).

Burn rate = (bad / total) / error_budget where error_budget =
``1 - target``; a rate of 1.0 spends the budget exactly over the window.
Thresholds, window widths and the attainment target come from the same
``APP_SLO_*`` knobs the judge uses (``SLO.knob``): one vocabulary, no
second config surface.

Raise/clear edges publish everywhere the house already looks:
``alert_active{alert,severity}`` gauges, ``alerts_fired_total{severity}``
counters, FLIGHT events, and ``slo.note_hazard`` so QoS pressure
coupling fires before goodput craters. ``GET /debug/alerts``
(server/common.py) serves the live payload on every server.

Feeding happens inside ``FORENSICS.observe`` on scheduler finish paths,
so ``APP_FORENSICS=off`` means zero alert-plane calls (test-enforced).
Every time read goes through core/clock.py, so tests inject a clock and
hand-compute both windows.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability.flight import FLIGHT
from generativeaiexamples_tpu_torch.observability.lockwatch import (
    tracked_lock)
from generativeaiexamples_tpu_torch.observability.slo import _BucketWindow

OBJECTIVES = ("goodput", "ttft", "tpot")

_TENANT_CAP = 8           # distinct tenant scopes before folding to other
_FIRED_LOG = 128
_EVAL_TTL_S = 1.0


def _is_bad(objective: str, verdict: Dict[str, Any]) -> bool:
    outcome = verdict.get("outcome", "")
    if objective == "goodput":
        return outcome != "attained"
    if outcome in ("shed",):
        return False              # shed requests never saw a first token
    breaches = verdict.get("breaches") or {}
    return bool(breaches.get(objective)) or outcome == "error"


class AlertManager:
    """Process-global burn-rate evaluator (``ALERTS``).

    One ``_BucketWindow`` per (objective, scope); scopes are
    ``class:<slo class>`` and ``tenant:<tenant>``. Evaluation is cached
    for ``_EVAL_TTL_S`` on the injected clock so the finish path never
    pays more than a dict walk per second.
    """

    def __init__(self, clock_fn: Optional[Callable[[], float]] = None,
                 **knobs: Any) -> None:
        self._clock = clock_fn or clock.mono
        self._knobs: Dict[str, Any] = dict(knobs)
        self._lock = tracked_lock("alerts._lock")
        self._windows: Dict[Tuple[str, str], _BucketWindow] = {}
        self._active: Dict[str, Dict[str, Any]] = {}
        self._fired: Deque[Dict[str, Any]] = deque(maxlen=_FIRED_LOG)
        self._last_eval: Optional[float] = None

    def _knob(self, name: str) -> Any:
        if name in self._knobs:
            return self._knobs[name]
        return slo_mod.SLO.knob(name)

    def reset(self) -> None:
        with self._lock:
            for rec in self._active.values():
                REGISTRY.gauge("alert_active",
                               labels={"alert": rec["alert"],
                                       "severity": rec["severity"]}).set(0)
            self._windows.clear()
            self._active.clear()
            self._fired.clear()
            self._last_eval = None

    # ------------------------------------------------------------- feed

    def _scopes(self, verdict: Dict[str, Any], req: Any) -> List[str]:
        cls = str(verdict.get("class", "") or "")
        tenant = str(getattr(req, "tenant", "") or "anon")
        scopes = []
        if cls:
            scopes.append("class:" + cls)
        with self._lock:
            known = {s for (_, s) in self._windows
                     if s.startswith("tenant:")}
        tscope = "tenant:" + tenant
        if tscope not in known and len(known) >= _TENANT_CAP:
            tscope = "tenant:other"
        scopes.append(tscope)
        return scopes

    def _window(self, objective: str, scope: str) -> _BucketWindow:
        key = (objective, scope)
        win = self._windows.get(key)
        if win is None:
            fast = float(self._knob("fast_window_s"))
            slow = float(self._knob("slow_window_s"))
            win = _BucketWindow(bucket_s=fast / 30.0, span_s=slow)
            self._windows[key] = win
        return win

    def observe(self, req: Any, verdict: Dict[str, Any]) -> None:
        """Feed one finished request's verdict into every matching
        (objective, scope) window, then (TTL-cached) re-evaluate."""
        if not verdict:
            return
        now = self._clock()
        scopes = self._scopes(verdict, req)
        with self._lock:
            for objective in OBJECTIVES:
                bad = _is_bad(objective, verdict)
                for scope in scopes:
                    self._window(objective, scope).add(
                        now, good=int(not bad), bad=int(bad))
        self.evaluate()

    # ------------------------------------------------------- evaluation

    def _burn(self, win: _BucketWindow, now: float,
              window_s: float, budget: float) -> Tuple[float, float]:
        good, bad = win.totals(now, window_s)
        total = good + bad
        if total <= 0:
            return 0.0, 0.0
        return (bad / total) / budget, total

    def evaluate(self, force: bool = False) -> List[Dict[str, Any]]:
        """Walk every window pair; raise/clear edges on threshold
        crossings. Returns the active alert list."""
        now = self._clock()
        with self._lock:
            if (not force and self._last_eval is not None
                    and now - self._last_eval < _EVAL_TTL_S):
                return list(self._active.values())
            self._last_eval = now
            keys = list(self._windows)
        fast_s = float(self._knob("fast_window_s"))
        slow_s = float(self._knob("slow_window_s"))
        budget = max(1e-9, 1.0 - float(self._knob("target")))
        min_events = int(self._knob("min_events"))
        thresholds = (("critical", float(self._knob("critical_burn"))),
                      ("warn", float(self._knob("warn_burn"))))
        raised, cleared = [], []
        with self._lock:
            for objective, scope in keys:
                win = self._windows[(objective, scope)]
                fast_burn, fast_n = self._burn(win, now, fast_s, budget)
                slow_burn, _ = self._burn(win, now, slow_s, budget)
                severity = ""
                if fast_n >= min_events:
                    for cand, thr in thresholds:
                        if fast_burn >= thr and slow_burn >= thr:
                            severity = cand
                            break
                name = f"{objective}:{scope}"
                rec = self._active.get(name)
                if severity:
                    row = {"alert": name, "severity": severity,
                           "objective": objective, "scope": scope,
                           "fast_burn": round(fast_burn, 3),
                           "slow_burn": round(slow_burn, 3),
                           "since_mono": rec["since_mono"] if rec
                           else round(now, 3)}
                    if rec is None or rec["severity"] != severity:
                        raised.append((row, rec))
                    self._active[name] = row
                elif rec is not None:
                    del self._active[name]
                    cleared.append(rec)
            active = list(self._active.values())
        for row, prev in raised:
            self._publish_raise(row, prev)
        for rec in cleared:
            self._publish_clear(rec)
        return active

    def _publish_raise(self, row: Dict[str, Any],
                       prev: Optional[Dict[str, Any]]) -> None:
        if prev is not None:          # severity change: drop the old gauge
            REGISTRY.gauge("alert_active",
                           labels={"alert": prev["alert"],
                                   "severity": prev["severity"]}).set(0)
        REGISTRY.gauge("alert_active",
                       labels={"alert": row["alert"],
                               "severity": row["severity"]}).set(1)
        REGISTRY.counter("alerts_fired_total",
                         labels={"severity": row["severity"]}).inc()
        FLIGHT.event("alert_raised", alert=row["alert"],
                     severity=row["severity"], fast_burn=row["fast_burn"],
                     slow_burn=row["slow_burn"])
        with self._lock:
            self._fired.append(dict(row))
        try:
            slo_mod.SLO.note_hazard(
                "alert:" + row["objective"],
                {"alert": row["alert"], "severity": row["severity"],
                 "fast_burn": row["fast_burn"]},
                warn_for_s=float(self._knob("fast_window_s")))
        except Exception:   # best-effort: the alert itself already published
            pass

    def _publish_clear(self, rec: Dict[str, Any]) -> None:
        REGISTRY.gauge("alert_active",
                       labels={"alert": rec["alert"],
                               "severity": rec["severity"]}).set(0)
        FLIGHT.event("alert_cleared", alert=rec["alert"],
                     severity=rec["severity"])

    # ------------------------------------------------------ read surface

    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._active.values()]

    def fired(self) -> List[Dict[str, Any]]:
        """Raise-edge log, oldest-first (bench round JSON)."""
        with self._lock:
            return [dict(r) for r in self._fired]

    def payload(self) -> Dict[str, Any]:
        """GET /debug/alerts body."""
        active = self.evaluate()
        return {
            "active": active,
            "fired_total": len(self.fired()),
            "recent_fired": self.fired()[-8:],
            "objectives": list(OBJECTIVES),
            "rules": {
                "windows_s": {"fast": float(self._knob("fast_window_s")),
                              "slow": float(self._knob("slow_window_s"))},
                "thresholds": {
                    "warn": float(self._knob("warn_burn")),
                    "critical": float(self._knob("critical_burn"))},
                "target": float(self._knob("target")),
                "min_events": int(self._knob("min_events")),
            },
        }


ALERTS = AlertManager()
