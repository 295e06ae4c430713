"""Latency forensics plane: "where did the time go for THIS request".

A copy of ``generativeaiexamples_tpu/observability/forensics.py``
(standard library only) with its imports pointed at the port. On the port
a "recompile" is a program key the device-time ledger first saw while
serving (``observability/devtime.py``): eager PyTorch compiles nothing,
but a first-seen shape is the same latency hazard the reference counts
(a new kernel instance, a new allocator size, a new tensor map).

The trace plane (observability/trace.py) records every scheduling
decision; the flight recorder keeps the gauges; the SLO judge stamps a
verdict on every finished request. This module is the layer that
*interprets* those streams:

* ``FORENSICS.breakdown(rid)`` reconstructs the critical path of one
  request as an ordered, cause-tagged segment list. Segments partition
  the ``[submit, finish]`` interval on the trace mono axis exactly: a
  cursor walks the request's boundary events, so the segment durations
  sum to the end-to-end latency by construction.
* ``FORENSICS.observe(req)`` (scheduler finish paths, guarded by
  ``FORENSICS.enabled``: one attribute read when ``APP_FORENSICS=off``)
  auto-captures the FULL trace slice + breakdown for requests that
  breached their SLO or landed above the trailing p99, into a bounded
  exemplar ring. The interesting requests survive ring eviction; the
  boring ones age out.
* ``doctor_payload()`` maps active symptoms (first-seen shapes, padding
  waste, spill thrash, qos sheds, affinity overrides, retry-budget
  exhaustion, watchdog trips, lock inversions) to named causes ranked by
  estimated device-seconds lost, each naming the knob to turn.

Served at ``GET /debug/forensics[/<rid>]`` and ``GET /debug/doctor``
(server/common.py). The ``router_leg`` segments are the reference's: the
router that emits them (``server/failover.py``) is not in the port yet.
All time reads go through core/clock.py.
"""

from __future__ import annotations

import bisect
import os
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability import alerts as alerts_mod
from generativeaiexamples_tpu_torch.observability import flight as flight_mod
from generativeaiexamples_tpu_torch.observability.lockwatch import (
    tracked_lock)
from generativeaiexamples_tpu_torch.observability.trace import TRACE

# Segment cause vocabulary (docs/observability.md "Why was this request
# slow"). Bounded set — these appear as JSON fields, never metric labels.
CAUSE_QOS = "qos_throttle"
CAUSE_PREEMPT = "page_pressure_preempt"
CAUSE_SPILL_PROMOTE = "spill_promote"
CAUSE_TIER_PROMOTE = "tier_promote"
CAUSE_RECOMPILE = "recompile_hazard"
CAUSE_HEDGE_LOSER = "hedge_loser"

_DEF_CAPACITY = 64
_P99_RESERVOIR = 512
_P99_MIN_SAMPLES = 30


def _env_mode() -> str:
    return (os.environ.get("APP_FORENSICS", "").strip().lower() or "off")


def _seg(label: str, t0: float, t1: float, cause: str = "",
         **extra: Any) -> Dict[str, Any]:
    seg = {"label": label, "t0_s": round(t0, 6),
           "dur_s": round(max(0.0, t1 - t0), 6), "cause": cause}
    seg.update(extra)
    return seg


def trace_slice(rid: str, records: Optional[List[dict]] = None) -> List[dict]:
    """All trace records about one request, oldest-first.

    Joins rid-stamped events with the GLOBAL dispatch emits (one per
    device program, not per request) via their ``rids`` roster field —
    the per-request prefill/decode boundaries live there.
    """
    if not rid:
        return []
    out = []
    for rec in (TRACE.records() if records is None else records):
        if rec.get("rid") == rid:
            out.append(rec)
            continue
        roster = rec.get("rids")
        if roster and rid in str(roster).split(","):
            out.append(rec)
    out.sort(key=lambda r: (r.get("mono", 0.0), r.get("seq", 0)))
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class _Builder:
    """Cursor state machine: walks one request's boundary events and
    closes a segment at each transition, so segments partition
    ``[start, end]`` exactly."""

    def __init__(self, start: float) -> None:
        self.cursor = start
        self.segments: List[Dict[str, Any]] = []
        self.label = "queue_wait"
        self.cause = ""
        self.pending_cause = ""      # promote annotates the NEXT close
        self.prefill_chunks = 0
        self.decode = None           # aggregate decode segment, open
        self.decode_last = 0.0
        self.decode_dispatches = 0
        self.decode_max_gap = 0.0

    def close(self, t: float, **extra: Any) -> None:
        cause = self.cause or self.pending_cause
        self.pending_cause = ""
        if t > self.cursor or not self.segments:
            self.segments.append(
                _seg(self.label, self.cursor, t, cause, **extra))
            self.cursor = t
        elif extra or cause:
            # zero-width transition: fold annotations into the last seg
            last = self.segments[-1]
            if cause and not last.get("cause"):
                last["cause"] = cause
            last.update(extra)

    def open(self, label: str, cause: str = "") -> None:
        self.label, self.cause = label, cause

    def close_decode(self, t: float) -> None:
        if self.decode is None:
            return
        self.segments.append(_seg(
            "decode", self.decode, t, self.cause,
            dispatches=self.decode_dispatches,
            max_gap_s=round(self.decode_max_gap, 6)))
        self.cursor = t
        self.decode = None
        self.cause = ""


def build_breakdown(rid: str,
                    records: Optional[List[dict]] = None) -> Dict[str, Any]:
    """Ordered, cause-tagged segment breakdown for one request.

    Prefers the trace stream (per-chunk resolution); falls back to the
    REQUEST_LOG coarse timeline when the trace has no events for the rid
    (ring evicted, or APP_TRACE was off). Returns ``{"found": False}``
    when neither plane knows the request.
    """
    events = trace_slice(rid, records)
    if events:
        bd = _breakdown_from_trace(rid, events)
        if bd is not None:
            return bd
    return _breakdown_from_timeline(rid)


def _breakdown_from_trace(rid: str,
                          events: List[dict]) -> Optional[Dict[str, Any]]:
    start = end = None
    meta: Dict[str, Any] = {}
    for ev in events:
        k = ev.get("kind")
        if k == "submit" and start is None:
            start = float(ev.get("mono", 0.0))
            for f in ("prompt_tokens", "max_tokens", "slo", "tenant",
                      "handoff", "est_cost_s"):
                if ev.get(f) not in (None, ""):
                    meta[f] = ev[f]
        elif k == "finish":
            end = float(ev.get("mono", 0.0))
            meta["finish"] = ev.get("finish", "")
            if ev.get("error"):
                meta["error"] = ev["error"]
        elif k == "migrate":
            end = float(ev.get("mono", 0.0))
            meta.setdefault("finish", "evacuated")
        elif k == "qos" and ev.get("decision") == "shed":
            end = float(ev.get("mono", 0.0))
            meta["finish"] = "shed"
    if start is None and events and events[0].get("kind") == "router_leg":
        return _breakdown_from_router_legs(rid, events)
    if start is None:
        return None
    if end is None:
        end = float(events[-1].get("mono", start))
        meta.setdefault("finish", "inflight")
    b = _Builder(start)
    for ev in events:
        t = float(ev.get("mono", 0.0))
        if t < start or t > end:
            continue
        k = ev.get("kind")
        if k == "qos" and ev.get("decision") == "shed":
            b.cause = CAUSE_QOS
            b.close(t, reason=str(ev.get("reason", "")))
            b.open("shed", CAUSE_QOS)
        elif k == "admit":
            b.close_decode(t)
            b.close(t)
            b.open("admission")
        elif k == "promote":
            b.pending_cause = (CAUSE_SPILL_PROMOTE
                               if ev.get("source") == "spill"
                               else CAUSE_TIER_PROMOTE)
        elif k == "dispatch":
            phase = ev.get("phase", "")
            if phase in ("prefill", "prefill_long"):
                b.close_decode(t)
                b.close(t)
                b.prefill_chunks += 1
                b.open("prefill_chunk")
            elif phase == "decode":
                if b.decode is None:
                    b.close(t)
                    b.decode = b.cursor
                    b.decode_last = t
                    b.decode_dispatches = 1
                else:
                    b.decode_max_gap = max(b.decode_max_gap,
                                           t - b.decode_last)
                    b.decode_last = t
                    b.decode_dispatches += 1
        elif k == "preempt":
            b.close_decode(t)
            b.cause = b.cause or CAUSE_PREEMPT
            b.close(t, mode=str(ev.get("mode", "")))
            b.open("preempt_wait", CAUSE_PREEMPT)
        elif k == "spill":
            b.close_decode(t)
            b.cause = b.cause or CAUSE_PREEMPT
            b.close(t)
            b.open("spill_wait", CAUSE_PREEMPT)
        elif k == "router_leg":
            # router-axis legs ride along in joined payloads; they do not
            # partition the engine axis
            continue
    if b.decode is not None:
        b.close_decode(end)
    elif b.cursor < end or not b.segments:
        b.close(end)
    _annotate_recompiles(b.segments, start, end)
    total = round(sum(s["dur_s"] for s in b.segments), 6)
    return {"found": True, "rid": rid, "source": "trace",
            "start_mono": round(start, 6), "end_mono": round(end, 6),
            "e2e_s": round(end - start, 6), "segments_total_s": total,
            "segments": b.segments, "meta": meta, "events": len(events)}


def _breakdown_from_router_legs(rid: str,
                                events: List[dict]) -> Dict[str, Any]:
    """Router-axis breakdown: partition [first leg start, last leg end]
    from ``router_leg`` events (each stamped at leg END with its
    duration). Gaps between legs become ``router_gap`` segments, so the
    partition stays exact on the router's own clock."""
    legs = [ev for ev in events if ev.get("kind") == "router_leg"]
    if not legs:
        return {"found": False, "rid": rid}
    bounds = []
    for ev in legs:
        t1 = float(ev.get("mono", 0.0))
        bounds.append((t1 - float(ev.get("dur_s", 0.0) or 0.0), t1, ev))
    start = min(b[0] for b in bounds)
    end = max(b[1] for b in bounds)
    segments: List[Dict[str, Any]] = []
    cursor = start
    meta: Dict[str, Any] = {"axis": "router"}
    for t0, t1, ev in sorted(bounds, key=lambda b: b[1]):
        t0 = max(t0, cursor)
        if t0 > cursor:
            segments.append(_seg("router_gap", cursor, t0))
            cursor = t0
        cause = ""
        if ev.get("hedge_loser"):
            cause = CAUSE_HEDGE_LOSER
        extra = {k: ev[k] for k in ("worker", "hedged", "tokens")
                 if ev.get(k) not in (None, "")}
        if t1 > cursor or not segments:
            segments.append(_seg("router_" + str(ev.get("leg", "leg")),
                                 cursor, t1, cause, **extra))
            cursor = t1
        if ev.get("mode"):
            meta["mode"] = ev["mode"]
    total = round(sum(s["dur_s"] for s in segments), 6)
    return {"found": True, "rid": rid, "source": "router_legs",
            "start_mono": round(start, 6), "end_mono": round(end, 6),
            "e2e_s": round(end - start, 6), "segments_total_s": total,
            "segments": segments, "meta": meta, "events": len(legs)}


def _annotate_recompiles(segments: List[Dict[str, Any]], start: float,
                         end: float) -> None:
    """Program shapes first seen mid-serving (the ledger's ``recompile``
    flight events) inside the request window tag the overlapped segment
    ``recompile_hazard``: the flight recorder stamps each with the same
    mono clock the trace uses."""
    try:
        compiles = [ev for ev in flight_mod.FLIGHT.events(seconds=86400.0)
                    if ev.get("event") == "recompile"
                    and start <= float(ev.get("mono", -1.0)) <= end]
    except Exception:   # annotation only: a malformed flight event must never kill a breakdown
        return
    if not compiles:
        return
    starts = [s["t0_s"] for s in segments]
    for ev in compiles:
        i = max(0, bisect.bisect_right(starts, float(ev["mono"])) - 1)
        seg = segments[i]
        if not seg.get("cause"):
            seg["cause"] = CAUSE_RECOMPILE
        seg["recompiles"] = int(seg.get("recompiles", 0)) + 1


def _breakdown_from_timeline(rid: str) -> Dict[str, Any]:
    """Coarse fallback off REQUEST_LOG perf stamps: queue → admission →
    prefill → decode/stream. Partitions [queued, finished] exactly on
    the perf axis."""
    rec = flight_mod.REQUEST_LOG.get(rid)
    if not rec:
        return {"found": False, "rid": rid}
    ph = rec.get("phases", {}) or {}
    queued = ph.get("queued")
    finished = ph.get("finished")
    if queued is None or finished is None:
        return {"found": False, "rid": rid, "partial": rec}
    marks = [("queue_wait", queued),
             ("admission", ph.get("admitted")),
             ("prefill", ph.get("prefill_start")),
             ("decode_stream", ph.get("first_token"))]
    segments: List[Dict[str, Any]] = []
    cursor = float(queued)
    label = "queue_wait"
    for nxt_label, t in marks[1:] + [("end", finished)]:
        if t is None:
            continue
        t = float(t)
        if t > cursor or not segments:
            cause = ""
            if label == "queue_wait" and rec.get("preemptions"):
                cause = ""
            segments.append(_seg(label, cursor, t, cause))
            cursor = t
        label = nxt_label
    if rec.get("preemptions"):
        for seg in segments:
            if seg["label"] in ("prefill", "decode_stream"):
                seg.setdefault("cause", "")
        segments[-1]["preemptions"] = rec["preemptions"]
    total = round(sum(s["dur_s"] for s in segments), 6)
    meta = {k: rec.get(k) for k in ("finish", "error", "tenant", "slo_class",
                                    "prompt_tokens", "completion_tokens",
                                    "preemptions", "spill_resumes")
            if rec.get(k) not in (None, "", 0)}
    return {"found": True, "rid": rid, "source": "timeline",
            "e2e_s": round(float(finished) - float(queued), 6),
            "segments_total_s": total, "segments": segments, "meta": meta,
            "durations_s": rec.get("durations_s", {})}


class ForensicsPlane:
    """Bounded tail-exemplar ring + breakdown service (process-global
    ``FORENSICS``). ``enabled`` follows APP_FORENSICS=off|on; every hot
    call site guards on it, so off-mode costs one attribute read."""

    def __init__(self) -> None:
        self.enabled = _env_mode() in ("on", "1", "true")
        cap = int(os.environ.get("APP_FORENSICS_CAPACITY", "")
                  or _DEF_CAPACITY)
        self.capacity = max(4, cap)
        self._lock = tracked_lock("forensics._lock")
        self._ring: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._e2e: Deque[float] = deque(maxlen=_P99_RESERVOIR)

    # -- configuration ---------------------------------------------------

    def configure(self, mode: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        """Runtime re-arm (bench rounds, tests). Turning forensics on
        also arms the trace plane — breakdowns are built from its
        events."""
        if mode is not None:
            self.enabled = mode.strip().lower() in ("on", "1", "true")
            if self.enabled and not TRACE.enabled:
                TRACE.configure(mode="on")
        if capacity is not None:
            with self._lock:
                self.capacity = max(4, int(capacity))
                while len(self._ring) > self.capacity:
                    self._ring.popitem(last=False)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._e2e.clear()

    # -- capture (scheduler finish paths) --------------------------------

    def observe(self, req: Any) -> None:
        """Finish-path hook. Callers guard with ``if FORENSICS.enabled``;
        here we judge capture-worthiness: SLO breach/error/shed, or e2e
        above the trailing p99 once the reservoir has warmed up."""
        if not self.enabled:
            return
        rid = str(getattr(req, "request_id", "") or "")
        verdict = getattr(req, "slo", None) or {}
        alerts_mod.ALERTS.observe(req, verdict)
        e2e = float(verdict.get("e2e_s") or 0.0)
        reason = ""
        outcome = verdict.get("outcome", "")
        if outcome in ("breached", "error"):
            reason = "error" if outcome == "error" else "breach"
        elif outcome == "shed":
            reason = "shed"
        elif e2e > 0.0:
            with self._lock:
                vals = sorted(self._e2e)
            if len(vals) >= _P99_MIN_SAMPLES and \
                    e2e >= _percentile(vals, 0.99):
                reason = "tail"
        with self._lock:
            if e2e > 0.0:
                self._e2e.append(e2e)
        if not reason or not rid:
            return
        self.capture(rid, reason, verdict)

    def capture(self, rid: str, reason: str,
                verdict: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Retain the FULL trace slice + breakdown for one request."""
        events = trace_slice(rid)
        exemplar = {
            "rid": rid, "reason": reason,
            "captured_unix": round(clock.wall(), 3),
            "verdict": dict(verdict or {}),
            "breakdown": build_breakdown(rid, events or None),
            "trace": events,
        }
        with self._lock:
            self._ring[rid] = exemplar
            self._ring.move_to_end(rid)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
        REGISTRY.counter("forensics_exemplars_total",
                         labels={"reason": reason}).inc()
        return exemplar

    # -- read surface ----------------------------------------------------

    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            ex = self._ring.get(rid)
            return dict(ex) if ex else None

    def exemplars(self) -> List[Dict[str, Any]]:
        """Newest-first listing (without the trace payloads)."""
        with self._lock:
            rows = list(self._ring.values())
        out = []
        for ex in reversed(rows):
            bd = ex.get("breakdown") or {}
            out.append({"rid": ex["rid"], "reason": ex["reason"],
                        "captured_unix": ex["captured_unix"],
                        "e2e_s": bd.get("e2e_s"),
                        "outcome": (ex.get("verdict") or {}).get("outcome"),
                        "segments": len(bd.get("segments", []) or []),
                        "trace_events": len(ex.get("trace", []) or [])})
        return out

    def top_exemplars(self, n: int = 3) -> List[Dict[str, Any]]:
        """The n slowest captured exemplars (bench round JSON): breakdown
        + verdict, trace slice omitted to keep round lines greppable."""
        with self._lock:
            rows = list(self._ring.values())
        rows.sort(key=lambda ex: float(
            (ex.get("breakdown") or {}).get("e2e_s") or 0.0), reverse=True)
        return [{"rid": ex["rid"], "reason": ex["reason"],
                 "verdict": ex.get("verdict"),
                 "breakdown": ex.get("breakdown")}
                for ex in rows[:max(0, int(n))]]

    def payload(self, rid: str) -> Dict[str, Any]:
        """GET /debug/forensics/<rid> body: captured exemplar when one
        exists, else a live breakdown from whatever the planes still
        hold."""
        ex = self.get(rid)
        if ex is not None:
            return {"enabled": self.enabled, "captured": True, **ex}
        bd = build_breakdown(rid)
        return {"enabled": self.enabled, "captured": False, "rid": rid,
                "breakdown": bd, "trace": trace_slice(rid)}

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._ring)
            samples = len(self._e2e)
            vals = sorted(self._e2e)
        return {"enabled": self.enabled,
                "mode": "on" if self.enabled else "off",
                "capacity": self.capacity, "captured": n,
                "p99_samples": samples,
                "trailing_p99_s": round(_percentile(vals, 0.99), 6)
                if len(vals) >= _P99_MIN_SAMPLES else None}


FORENSICS = ForensicsPlane()


# --------------------------------------------------------------- doctor

def _family_sum(name: str) -> float:
    try:
        return float(sum(REGISTRY.family(name).values()))
    except Exception:   # a missing family reads as zero symptoms
        return 0.0


def _family_rows(name: str) -> Dict[str, float]:
    """Labeled counter family flattened to 'k=v,k=v' → value."""
    try:
        fam = REGISTRY.family(name)
    except Exception:   # absent evidence, not an error
        return {}
    return {",".join(f"{k}={v}" for k, v in key): val
            for key, val in fam.items()}


def _perf_model() -> Any:
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    return DEVTIME.perf()


def _prefill_cost_s(tokens: float) -> float:
    perf = _perf_model()
    if perf is not None:
        try:
            est = perf.prefill_seconds(tokens)
            if est:
                return float(est)
        except Exception:   # a model without the card's peaks: the constant below
            pass
    return 2e-5 * tokens          # FakeCore fallback (tests, no model)


def doctor_payload() -> Dict[str, Any]:
    """GET /debug/doctor body: active symptoms → named causes, ranked by
    estimated device-seconds lost (core/perfmodel.py where a model is
    attached, documented fallbacks otherwise). Each diagnosis names the
    docs/configuration.md knob to turn. Safe in every process — engine
    surfaces are read through sys.modules, never imported."""
    import sys

    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    from generativeaiexamples_tpu_torch.observability.lockwatch import WATCH

    diagnoses: List[Dict[str, Any]] = []

    def add(cause: str, symptom: str, lost_s: float, knob: str,
            severity: str = "warn", **evidence: Any) -> None:
        diagnoses.append({
            "cause": cause, "symptom": symptom,
            "est_device_s_lost": round(max(0.0, lost_s), 6),
            "knob": knob, "severity": severity, "evidence": evidence})

    # recompiles: on the port a program key first seen mid-serving (the
    # device-time ledger's watch); without a measured figure each is
    # charged the reference's 1 s
    comp = DEVTIME.compiles()
    recompiles = int(comp.get("recompiles_total", 0))
    if recompiles:
        add("recompile_hazard",
            f"{recompiles} program shape(s) first seen mid-serving — "
            "shape buckets were never warmed",
            recompiles * 1.0,
            "warm all APP_ENGINE_DECODE_WIDTH_LADDER / "
            "APP_ENGINE_PREFILL_CHUNK buckets at startup; see "
            "GET /debug/compiles",
            severity="critical",
            recompiles_total=recompiles,
            programs=sorted({e.get("program", "") for e in
                             comp.get("events", [])})[:8])

    # padding waste: fraction of attributed device time spent on pad rows
    waste = float(DEVTIME.padding_waste() or 0.0)
    attributed = float(DEVTIME.attributed_s() or 0.0)
    if waste > 0.05 and attributed > 0.0:
        add("padding_waste",
            f"{waste:.0%} of attributed device time is padding",
            waste * attributed,
            "tighten APP_ENGINE_DECODE_WIDTH_LADDER rungs or lower "
            "APP_ENGINE_PREFILL_CHUNK",
            padding_waste_frac=round(waste, 4),
            attributed_s=round(attributed, 3))

    # spill / preemption thrash: every recompute-preempt re-prefills the
    # prompt; every spill resume pays host<->device wire
    preemptions = _family_sum("preemptions")
    spills = _family_sum("kv_spill_total")
    spill_resumes = _family_sum("spill_resumes")
    if preemptions or spills:
        # recomputed prompt work ~ preemptions * mean prompt; without the
        # per-request figure, charge one 512-token re-prefill each
        lost = preemptions * _prefill_cost_s(512.0)
        add("page_pressure",
            f"{int(preemptions)} preemption(s), {int(spills)} spill(s), "
            f"{int(spill_resumes)} spill resume(s) — KV page pool too "
            "small for the working set",
            lost + 0.01 * spill_resumes,
            "raise APP_ENGINE_NUM_PAGES or APP_ENGINE_KV_SPILL_MB; "
            "consider APP_ENGINE_KV_TIER=prefix for returning prefixes",
            severity="critical" if preemptions > 10 else "warn",
            preemptions=int(preemptions), kv_spill_total=int(spills),
            spill_resumes=int(spill_resumes))

    # qos sheds: admission control is refusing work
    sheds = (_family_sum("slo_shed_total")
             + _family_sum("qos_shed_before_prefill_total"))
    if sheds:
        add("qos_shed",
            f"{int(sheds)} request(s) shed at admission",
            0.0,
            "raise tenant quotas (APP_ENGINE_QOS_QUOTA) or add replicas; "
            "sheds protect goodput, so first check slo_pressure",
            sheds=int(sheds),
            by_class=_family_rows("slo_shed_total"))

    # router affinity overrides: sticky placement losing to load
    aff = _family_rows("router_affinity_total")
    overrides = sum(v for k, v in aff.items() if "override" in k)
    if overrides:
        add("affinity_override",
            f"{int(overrides)} prefix-affinity override(s) — sticky "
            "workers were too loaded to honor KV reuse",
            overrides * _prefill_cost_s(256.0),
            "raise APP_ROUTER_AFFINITY_SLACK or add decode replicas",
            affinity=aff)

    # retry budget exhaustion: failover is out of headroom
    denied = (_family_sum("retries_denied_total")
              + _family_sum("retry_budget_exhausted_total"))
    if denied:
        add("retry_budget",
            f"{int(denied)} retry(ies) denied — failover budget "
            "exhausted, failures are surfacing to callers",
            0.0,
            "raise APP_ROUTER_RETRY_BUDGET only after fixing the "
            "underlying worker churn (see /debug/fleet)",
            severity="critical", retries_denied=int(denied))

    # watchdog trips: the driver stalled past its deadline
    trips = _family_sum("engine_watchdog_trips_total")
    if trips:
        add("watchdog_trip",
            f"{int(trips)} watchdog trip(s) — driver ticks stalled",
            0.0,
            "inspect GET /debug/stacks; raise APP_ENGINE_WATCHDOG_S only "
            "if ticks are legitimately that long",
            severity="critical", trips=int(trips))

    # lock inversions (when the lockwatch sanitizer is armed)
    try:
        inversions = list(WATCH.inversions)
    except Exception:   # an unarmed or mid-reset lock watch is no evidence
        inversions = []
    if inversions:
        add("lock_inversion",
            f"{len(inversions)} lock-order inversion(s) witnessed",
            0.0,
            "fix the acquisition order (docs/static_analysis.md); "
            "APP_LOCKWATCH=on reproduces",
            severity="critical",
            edges=[i.get("cycle") or i for i in inversions[:4]])

    # qos live pressure (engine process only — sys.modules, never import)
    qos_mod = sys.modules.get("generativeaiexamples_tpu_torch.engine.qos")
    qos_state = None
    if qos_mod is not None:
        try:
            qos_state = qos_mod.debug_payload()
        except Exception:   # a mid-registration policy answers null
            qos_state = None

    diagnoses.sort(key=lambda d: (d["severity"] != "critical",
                                  -d["est_device_s_lost"]))
    from generativeaiexamples_tpu_torch.observability import slo as slo_mod
    return {
        "healthy": not diagnoses,
        "diagnoses": diagnoses,
        "alerts": alerts_mod.ALERTS.active(),
        "slo_pressure": slo_mod.SLO.pressure(),
        "forensics": FORENSICS.describe(),
        "qos": qos_state,
        "generated_unix": round(clock.wall(), 3),
    }
