"""The port's host-plane modules against the reference's, on the CPU.

Each case runs the same inputs (numpy-seeded where random) through the
reference's module and the port's and holds the results equal: the flight
recorder and request timelines (phases and durations on injected clocks),
the SLO tracker (judging, burn rates and pressure on an injected clock,
breach records, admission headers), the usage ledger (tenant identity,
bills, the cardinality cap, rollups), the event trace (ring, kinds,
windows, the file sink and its rotation), the lock watch (raw primitives
when off, witness edges and inversions when armed), the chaos plane (spec
parsing, seeded schedules, caps, payload and frame corruption on the
port's ``core/kv_wire.py``), the device-time ledger (keys, counts, tokens,
padding, stride, the first-seen watch, the deferred census, fetches) and
the perf model (formulas; the port holds only the H100's peaks).

Also: ``APP_DEVTIME=off`` takes no fence and creates no CUDA event, and
every metric the port registers is in the reference's catalog
(``docs/observability.md``), by ``analysis/metrics_catalog``'s scan of the
port's package.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import generativeaiexamples_tpu
import generativeaiexamples_tpu_torch
from generativeaiexamples_tpu.analysis.metrics_catalog import (
    collect_registered, parse_catalog, pattern_matches)
from generativeaiexamples_tpu.core import kv_wire as jwire
from generativeaiexamples_tpu.core import perfmodel as jperf
from generativeaiexamples_tpu.observability import chaos as jchaos
from generativeaiexamples_tpu.observability import devtime as jdevtime
from generativeaiexamples_tpu.observability import flight as jflight
from generativeaiexamples_tpu.observability import lockwatch as jlock
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu.observability import trace as jtrace
from generativeaiexamples_tpu.observability import usage as jusage
from generativeaiexamples_tpu_torch.core import kv_wire as twire
from generativeaiexamples_tpu_torch.core import perfmodel as tperf
from generativeaiexamples_tpu_torch.observability import chaos as tchaos
from generativeaiexamples_tpu_torch.observability import devtime as tdevtime
from generativeaiexamples_tpu_torch.observability import flight as tflight
from generativeaiexamples_tpu_torch.observability import lockwatch as tlock
from generativeaiexamples_tpu_torch.observability import slo as tslo
from generativeaiexamples_tpu_torch.observability import trace as ttrace
from generativeaiexamples_tpu_torch.observability import usage as tusage

from generativeaiexamples_tpu.core import clock as jclock
from generativeaiexamples_tpu_torch.core import clock as tclock

PAIRS = {
    "flight": (jflight, tflight), "slo": (jslo, tslo),
    "usage": (jusage, tusage), "trace": (jtrace, ttrace),
    "lock": (jlock, tlock), "chaos": (jchaos, tchaos),
    "devtime": (jdevtime, tdevtime), "perf": (jperf, tperf),
    "clock": (jclock, tclock),
}


def both(name, fn):
    """``fn(module)`` on the reference's module and the port's."""
    jmod, tmod = PAIRS[name]
    return fn(jmod), fn(tmod)


class _Clock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class _Req:
    """A scheduler Request's timeline attributes."""

    def __init__(self, rid, submitted, admitted=None, prefill=None,
                 first=None, finished=None, tokens=0, **kw):
        self.request_id = rid
        self.submitted_at = submitted
        self.admitted_at = admitted
        self.prefill_start_at = prefill
        self.first_token_at = first
        self.finished_at = finished
        self.completion_tokens = tokens
        self.prompt_ids = list(range(kw.pop("prompt", 5)))
        self.preemptions = kw.pop("preemptions", 0)
        self.slo_class = kw.pop("slo_class", "interactive")
        self.slo = None
        self.error = kw.pop("error", None)
        for k, v in kw.items():
            setattr(self, k, v)


def _seeded_reqs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t0 = float(rng.uniform(0, 10))
        adm = t0 + float(rng.uniform(0, 0.5))
        first = adm + float(rng.uniform(0, 2.0))
        fin = first + float(rng.uniform(0, 20.0))
        out.append(dict(rid=f"r{i}", submitted=t0, admitted=adm,
                        prefill=adm + 0.01, first=first, finished=fin,
                        tokens=int(rng.integers(1, 80)),
                        slo_class=("interactive", "batch",
                                   "best_effort")[i % 3],
                        finish_reason="eos", tenant=f"t{i % 4}",
                        tier_hit_tokens=int(rng.integers(0, 3)) * 16,
                        prefix_hit_tokens=int(rng.integers(0, 3)) * 16))
    return out


def _strip_times(rec):
    rec = dict(rec)
    rec.pop("finished_unix", None)
    return rec


# ------------------------------------------------------------- flight


def test_flight_ring_bounded_windowed_and_time_gated():
    def run(m):
        rec = m.FlightRecorder(capacity=8, interval_s=0.25)
        clk = m.clock.VirtualClock(start=100.0)
        with m.clock.use(clk):
            for i in range(40):
                clk.advance(0.1)
                rec.maybe_sample(lambda: {"tokens_generated": 10 * i,
                                          "fill": 0.5, "note": "x"})
            rec.event("recompile", program="decode", bucket="s8")
            win = rec.window(0.6)
            return (len(rec), [s.get("tok_s") for s in rec.window()],
                    [s["tokens_generated"] for s in win],
                    [(e["event"], e["program"]) for e in rec.events()],
                    rec.describe())
    j, t = both("flight", run)
    assert j == t
    assert j[0] == 8 and j[3] == [("recompile", "decode")]


def test_request_log_bounded_and_timeline_phases():
    def run(m):
        log = m.RequestLog(capacity=5)
        clk = m.clock.VirtualClock(start=0.0)
        out = []
        with m.clock.use(clk):
            for kw in _seeded_reqs(3, 12):
                req = _Req(**kw)
                out.append(_strip_times(log.record(req)))
            attrs = m.timeline_attributes(_Req(**_seeded_reqs(3, 1)[0]))
        return out, [r["request_id"] for r in log.recent(10)], attrs, \
            log.get("r11") is not None, log.get("r0")
    j, t = both("flight", run)
    assert j == t
    assert j[1] == ["r11", "r10", "r9", "r8", "r7"] and j[4] is None
    assert list(j[0][0]["phases"]) == list(tflight._PHASES)


def test_flight_dump_carries_the_tier_occupancy_and_trace_tail(tmp_path):
    from generativeaiexamples_tpu_torch.engine import kv_tier, qos
    qos.register_policy(None)
    pool = kv_tier.KVSpillPool(1 << 20)
    kv_tier.register_pool(pool)
    ttrace.TRACE.configure(mode="on")
    try:
        ttrace.TRACE.emit("submit", rid="x")
        tflight.FLIGHT.record(tokens_generated=1)
        path = tflight.FLIGHT.dump(str(tmp_path / "dump.json"))
        body = json.loads(open(path).read())
        assert body["kv_tier"]["kind"] == "spill"
        assert [r["kind"] for r in body["trace"]["tail"]] == ["submit"]
        # the QoS plane's state rides every dump once the engine package
        # is loaded (off here: the plane's off payload)
        assert body["qos"]["enabled"] is False
    finally:
        kv_tier.register_pool(None)
        ttrace.TRACE.configure(mode="off")
        ttrace.TRACE.reset()
        tflight.FLIGHT.clear()


# ---------------------------------------------------------------- SLO


def _tracker(m, clk, **kw):
    classes = {
        "interactive": m.SLOClass("interactive", 1.0, 0.25, 30.0, False),
        "batch": m.SLOClass("batch", 10.0, 1.0, 300.0, False),
        "best_effort": m.SLOClass("best_effort", 30.0, 2.0, 600.0, True)}
    knobs = dict(default_class="interactive", target=0.99,
                 fast_window_s=300.0, slow_window_s=3600.0, warn_burn=2.0,
                 critical_burn=10.0, min_events=10)
    knobs.update(kw)
    return m.SloTracker(classes, clock=clk, **knobs)


def test_slo_judging_burn_rates_and_pressure_on_an_injected_clock():
    def run(m):
        clk = _Clock()
        tr = _tracker(m, clk)
        out = []
        for kw in _seeded_reqs(7, 60):
            req = _Req(**kw)
            v = tr.observe(req)
            out.append((v["outcome"], sorted(v.get("breaches", {}))))
            clk.t += 3.0
            out.append(tr.pressure())
        rates = {c: tr.burn_rates(c) for c in tr.classes()}
        payload = tr.debug_payload()
        for b in payload["recent_breaches"]:
            b.pop("ts_unix")
        payload["classes"] = {k: {kk: vv for kk, vv in v.items()
                                  if kk != "lifetime"}
                              for k, v in payload["classes"].items()}
        tr.note_hazard("recompile", {"program": "decode"}, warn_for_s=5.0)
        hazard = tr.pressure()
        clk.t += 10.0
        after = tr.pressure()
        return out, rates, payload, hazard, after
    j, t = both("slo", run)
    assert j == t
    assert ("breached", ["e2e", "ttft"]) in j[0] or \
        any(o[0] == "breached" for o in j[0] if isinstance(o, tuple))


def test_slo_min_events_and_sheddable_classes_keep_pressure_ok():
    def run(m):
        clk = _Clock()
        tr = _tracker(m, clk, min_events=5)
        levels = []
        for i in range(4):   # below min_events: no paging on 4 requests
            tr.observe(_Req(f"a{i}", 0.0, 0.1, 0.1, 50.0, 60.0, 3))
            clk.t += 2.0
            levels.append(tr.pressure())
        for i in range(20):  # best_effort breaches never raise pressure
            tr.observe(_Req(f"b{i}", 0.0, 0.1, 0.1, 500.0, 900.0, 3,
                            slo_class="best_effort"))
        clk.t += 2.0
        levels.append(tr.pressure())
        for i in range(10):
            tr.observe(_Req(f"c{i}", 0.0, 0.1, 0.1, 50.0, 60.0, 3))
        clk.t += 2.0
        levels.append(tr.pressure())
        return levels
    j, t = both("slo", run)
    assert j == t == ["ok"] * 5 + ["critical"]


def test_slo_admission_headers_and_stamping():
    def run(m):
        with m.admission("batch", deadline_ms=5000.0) as adm:
            hdrs = m.outbound_headers({})
            rem = m.remaining_s()
            req = _Req("x", 0.0)
            req.slo_class = ""
            req.deadline_s = None
            m.stamp_request(req)
            stamped = (req.slo_class, round(req.deadline_s))
        parsed = m.parse_inbound({"X-Slo-Class": "best_effort",
                                  "X-Deadline-Ms": "2500"})
        errors = []
        for bad in ({"X-Request-Class": "platinum"},
                    {"X-Request-Deadline-Ms": "soon"}):
            try:
                m.parse_inbound(bad)
            except ValueError as exc:
                errors.append(str(exc))
        out = _Req("y", 0.0)
        out.slo_class, out.deadline_s = "", None
        m.stamp_request(out)
        return (adm.slo_class, sorted(k for k in hdrs if k != "traceparent"),
                hdrs["X-Request-Class"], round(rem), stamped, parsed,
                errors, (out.slo_class, out.deadline_s),
                m.current_admission())
    j, t = both("slo", run)
    assert j == t
    assert j[1] == ["X-Deadline-Ms", "X-Request-Class",
                    "X-Request-Deadline-Ms", "X-Slo-Class"]
    assert j[5] == ("best_effort", 2.5) and len(j[6]) == 2


# -------------------------------------------------------------- usage


def test_tenant_identity_and_handoff_precedence():
    cases = [{"X-Tenant-Id": "acme"}, {"X-Tenant-Id": " other "},
             {"X-Tenant-Id": "anon"}, {"Authorization": "Bearer sk-123"},
             {"X-Api-Key": "k-9"}, {"X-Tenant-Id": "a/b c$d" * 20}, {}]

    def run(m):
        ids = [m.tenant_from_headers(h) for h in cases]
        hand = [m.handoff_tenant(h, {"tenant": "from-payload"})
                for h in cases]
        with m.tenant_scope("scoped"):
            inner = m.current_tenant()
        return ids, hand, inner, m.current_tenant()
    j, t = both("usage", run)
    assert j == t
    assert j[0][1] == "t_other" and j[0][3].startswith("key-")


def test_billing_vectors_cap_and_rollups():
    def run(m):
        led = m.UsageLedger(max_tenants=3)
        keys = []
        for kw in _seeded_reqs(11, 30):
            req = _Req(**kw)
            req.kv_page_seconds = float(len(req.prompt_ids)) * 0.5
            if kw["rid"] == "r5":
                req.kv_import_s = 0.01
            if kw["rid"] == "r6":
                req.error = "boom"
            keys.append(led.bill_request(req))
        led.bill_retry("t0")
        led.bill_hedge("t1")
        snap = led.snapshot()
        for v in snap["tenants"].values():
            v.pop("first_seen_unix")
        return keys, snap, led.rollup(), m.merge_rollups(
            [led.rollup(), led.rollup(), "junk", {"x": "bad"}])
    j, t = both("usage", run)
    assert j == t
    assert set(j[1]["tenants"]) == {"t0", "t1", "t2", "other"}
    assert j[1]["overflowed"] > 0 and j[1]["basis"] == "tokens"


def test_usage_cap_reads_its_env_knob(monkeypatch):
    monkeypatch.setenv("APP_USAGE_MAX_TENANTS", "7")
    assert tusage.UsageLedger().max_tenants == \
        jusage.UsageLedger().max_tenants == 7
    monkeypatch.setenv("APP_USAGE_MAX_TENANTS", "many")
    assert tusage.UsageLedger().max_tenants == 64


# -------------------------------------------------------------- trace


def test_trace_ring_kinds_windows_and_filters():
    def run(m):
        tr = m.EventTrace()
        tr.configure(mode="off")
        tr.emit("submit", rid="a")
        off = tr.describe()
        tr.configure(mode="on", capacity=256)
        clk = m.clock.VirtualClock(start=50.0) if hasattr(m, "clock") \
            else None
        for i in range(300):
            tr.emit(("submit", "admit", "dispatch", "finish")[i % 4],
                    rid=f"r{i}", n=i)
        recs = [{k: v for k, v in r.items() if k != "mono"}
                for r in tr.window(1e9, limit=10, kinds=["finish"])]
        return off, tr.describe(), recs, len(tr.records())
    j, t = both("trace", run)
    assert j == t
    assert j[0]["recorded_total"] == 0 and j[1]["dropped"] == 300 - 256


def test_trace_sink_flush_dump_reload_and_rotation(tmp_path):
    def run(m):
        base = tmp_path / m.__name__.split(".")[0]
        base.mkdir()
        tr = m.EventTrace()
        tr.configure(mode="on", path=str(base / "t.jsonl"))
        tr.rotate_bytes = 2048
        for i in range(400):
            tr.emit("dispatch", phase="decode", steps=8, i=i)
        tr.flush()
        tr.close()
        rotated = os.path.exists(str(base / "t.jsonl.1"))
        n = tr.dump_jsonl(str(base / "ring.jsonl"))
        back = m.read_jsonl(str(base / "ring.jsonl"))
        with open(base / "torn.jsonl", "w") as f:
            f.write('{"v": 1, "kind": "a"}\n{"v": 1, "ki')
        torn = m.read_jsonl(str(base / "torn.jsonl"))
        return rotated, n, [r["i"] for r in back][:5], torn
    j, t = both("trace", run)
    assert j == t and j[0] is True and j[3] == [{"v": 1, "kind": "a"}]


# ---------------------------------------------------------- lock watch


def test_lockwatch_off_returns_raw_and_armed_reports_inversions(
        monkeypatch):
    def run(m):
        monkeypatch.delenv("APP_LOCKWATCH", raising=False)
        raw = type(m.tracked_lock("x")).__name__, type(
            m.tracked_rlock("y")).__name__
        monkeypatch.setenv("APP_LOCKWATCH", "on")
        m.WATCH.reset()
        a, b, c = (m.tracked_lock(n) for n in ("A", "B", "C"))
        r = m.tracked_rlock("R")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:         # closes A -> B -> C -> A
                pass
        with r:
            with r:         # reentry adds no edge
                pass
        with a:
            got = b.acquire(blocking=False)   # non-blocking: no edge
            if got:
                b.release()
        payload = m.WATCH.payload()
        monkeypatch.delenv("APP_LOCKWATCH")
        return (raw, payload["locks"],
                [(e["held"], e["acquired"]) for e in payload["edges"]],
                [inv["cycle"] for inv in payload["inversions"]],
                type(a).__name__)
    j, t = both("lock", run)
    assert j == t
    assert j[0] == ("lock", "RLock") and j[3] == [["C", "A", "B", "C"]]


def test_lockwatch_long_hold_recorded(monkeypatch):
    monkeypatch.setenv("APP_LOCKWATCH", "on")
    try:
        w = tlock.LockWatch()
        w.hold_ms = 1.0
        w.note_acquired("L", True)
        time.sleep(0.01)
        w.note_released("L")
        holds = w.payload()["long_holds"]
        assert holds and holds[0]["lock"] == "L" and holds[0]["stack"]
    finally:
        tlock.WATCH.reset()


# --------------------------------------------------------------- chaos


def test_chaos_spec_schedule_and_cap():
    def run(m):
        try:
            m.parse_spec("http.delay=0.5,bogus=1")
        except ValueError as exc:
            bad = str(exc)
        plane = m.ChaosPlane(mode="on", seed=7,
                             spec="page.exhaust=0.3,tick.stall=0.5/0.01/2")
        plane.sleep = lambda s: None
        pages = [plane.page_fault() for _ in range(40)]
        for _ in range(10):
            plane.tick_fault()
        off = m.ChaosPlane(mode="off")
        return bad, pages, plane.snapshot(), off.page_fault(), \
            off.snapshot()["faults"]
    j, t = both("chaos", run)
    assert j == t
    assert j[2]["faults"]["tick.stall"]["injected"] == 2 and any(j[1])


def _wire_payload(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-1000, 1000, size=(2, 3, 16, 2, 8)).astype(np.float32)
    return {"length": 40, "n_pages": 3, "page_size": 16,
            "prompt_ids": [int(x) for x in rng.integers(0, 255, 40)],
            "k": k, "v": k + 1}


def test_kv_corruption_is_refused_never_served():
    """``corrupt_kv`` truncates or garbles the payload the same way in both
    packages; ``corrupt_wire`` breaks the port's frame so that its decoder
    refuses it (the crc32 or the length), as the reference's refuses its
    own."""
    for fault in ("kv.truncate", "kv.garble"):
        outs = []
        for m, wire in ((jchaos, jwire), (tchaos, twire)):
            plane = m.ChaosPlane(mode="on", seed=3, spec=f"{fault}=1")
            payload = plane.corrupt_kv(_wire_payload(0))
            outs.append((payload["page_size"], payload["k"].shape))
            plane = m.ChaosPlane(mode="on", seed=3, spec=f"{fault}=1")
            frame = wire.encode_kv_frames(
                {k: v for k, v in _wire_payload(1).items()})
            bad = plane.corrupt_wire(frame)
            assert bad != frame
            with pytest.raises(Exception):
                wire.decode_kv_frames(bad)
        assert outs[0] == outs[1]
    plane = tchaos.ChaosPlane(mode="off")
    frame = twire.encode_kv_frames(_wire_payload(2))
    assert plane.corrupt_wire(frame) is frame


# ------------------------------------------------------------- devtime


def _fence_counter(monkeypatch, m):
    calls = []
    monkeypatch.setattr(m, "_fence", lambda arrays: calls.append(1))
    return calls


def _ledger_run(m, mode, n=8, sample_n=4):
    led = m.DevtimeLedger(mode=mode, sample_n=sample_n)
    for i in range(n):
        t0 = led.track()
        led.commit("decode", "s8", np.zeros(2), t0=t0, tokens=4 * (i + 1),
                   padded_tokens=64, weight_passes=8.0)
    led.commit("prefill", "g2", np.zeros(2), t0=led.track(), tokens=24,
               padded_tokens=64, weight_passes=1.0)
    led.commit("kv_export", "p2", device_s=0.5, tokens=10, mfu=False)
    snap = led.snapshot()
    rows = {(r["program"], r["bucket"]): (r["count"], r["timed"],
                                          r["tokens"], r["padded_tokens"],
                                          r["weight_passes"])
            for r in snap["programs"]}
    return rows, snap["totals"]["count"], snap["totals"]["timed"], \
        snap["padding_waste_frac"], snap["mode"]


@pytest.mark.parametrize("mode,fences", [("off", 0), ("sample", 4),
                                         ("on", 17)])
def test_ledger_keys_counts_and_fences_per_mode(monkeypatch, mode, fences):
    """The same commits: equal keys, counts, timed counts, tokens and
    padding; ``off`` takes no fence, ``sample`` fences every 4th commit
    (its marker and its output), ``on`` every commit."""
    jcalls = _fence_counter(monkeypatch, jdevtime)
    tcalls = _fence_counter(monkeypatch, tdevtime)
    j, t = _ledger_run(jdevtime, mode), _ledger_run(tdevtime, mode)
    assert j == t
    assert len(tcalls) == len(jcalls) == fences


def test_off_mode_takes_no_fence_and_creates_no_cuda_event(monkeypatch):
    """``APP_DEVTIME=off`` on a ledger bound to a CUDA device: no fence
    and no event, where ``sample`` makes both (a start and an end event a
    commit, counted through the ledger's one event factory)."""
    fences = _fence_counter(monkeypatch, tdevtime)
    events = []

    class _Event:
        def __init__(self):
            events.append(self)

        def elapsed_time(self, other):
            return 2.0

        def synchronize(self):
            pass

    monkeypatch.setattr(tdevtime, "_new_event", lambda device: _Event())
    led = tdevtime.DevtimeLedger(mode="off")
    led.configure(device=torch.device("cuda"))
    for _ in range(20):
        t0 = led.track()
        led.commit("decode", "s8", torch.zeros(2), t0=t0, tokens=1)
    assert fences == [] and events == []
    assert led.snapshot()["totals"]["timed"] == 0
    led.configure(mode="sample", sample_n=4)
    for _ in range(8):
        t0 = led.track()
        led.commit("decode", "s8", torch.zeros(2), t0=t0, tokens=1)
    assert len(events) == 16
    row = led.snapshot()["programs"][0]
    assert row["timed"] == 2 and row["device_s"] == pytest.approx(0.004)


def test_fence_passes_host_data_and_waits_on_events():
    tdevtime._fence(np.zeros(3))
    tdevtime._fence(torch.zeros(3))
    tdevtime._fence({"a": [torch.zeros(1), np.ones(2)]})
    waited = []

    class _Event:
        def elapsed_time(self, other):
            return 0.0

        def synchronize(self):
            waited.append(1)

    tdevtime._fence(_Event())
    assert waited == [1]


def test_compile_watch_census_and_hazards():
    def run(m):
        led = m.DevtimeLedger(mode="sample", sample_n=2)
        hazards = []
        led.hazard_sink = lambda kind, ev: hazards.append(
            (kind, ev["program"], ev["bucket"]))
        led.mark_warm("decode", "s8")
        led.commit("prefill", "g1", np.zeros(1), t0=led.track(), tokens=3)
        led.mark_serving()
        for bucket in ("s8", "s16", "s16"):
            led.commit("decode", bucket, np.zeros(1), t0=led.track(),
                       tokens=8)
        led.commit("decode_multi", "s2m4", np.zeros(1), t0=led.track(),
                   weight_passes=8.0, defer_census=True)
        led.commit("decode_multi", "s2m4", np.zeros(1), t0=led.track(),
                   weight_passes=8.0, defer_census=True)
        led.note_tokens("decode_multi", "s2m4", 30.0, 64.0)
        led.note_tokens("decode_multi", "s2m4", 10.0, 64.0)
        led.note_tokens("late", "b1", 1.0, 2.0)   # never a compile
        for steps in (8, 16, 0, 8):
            led.note_fetch(steps)
        compiles = [(e["program"], e["bucket"], e["during_serving"])
                    for e in led.compiles()["events"]]
        snap = led.snapshot()
        rows = {(r["program"], r["bucket"]): (r["count"], r["timed"],
                                              r["tokens"],
                                              r["padded_tokens"])
                for r in snap["programs"]}
        rates = {k: v is not None for k, v in led.phase_rates().items()}
        led.reset(keep_warm=True)
        led.commit("decode", "s16", np.zeros(1), t0=led.track())
        again = len(led.compiles()["events"])
        return (compiles, hazards, rows, round(led.padding_waste(), 4),
                round(snap["padding_waste_frac"], 4), led.steps_per_fetch(),
                rates, again)
    j, t = both("devtime", run)
    assert j == t
    assert ("decode", "s16", True) in j[0] and \
        ("prefill", "g1", False) in j[0]
    assert j[1] == [("recompile", "decode", "s16"),
                    ("recompile", "decode_multi", "s2m4")]
    assert j[7] == 0


def test_gauges_and_prometheus_families():
    """A perf model attached: the timed commits set ``engine_mfu`` and
    ``engine_hbm_read_util`` by the same arithmetic in both packages (the
    same peaks given to both)."""
    def run(m, perfm):
        led = m.DevtimeLedger(mode="on")
        led.attach_perf(perfm.PerfModel(n_params=8_000_000_000,
                                        param_bytes=16e9, peak_flops=1e15,
                                        peak_bw=3e12))
        led.commit("decode", "s8", None, device_s=0.04, tokens=64,
                   weight_passes=8.0)
        led.commit("prefill", "g1", None, device_s=0.2, tokens=4096,
                   weight_passes=1.0)
        return led.snapshot()["perf_model"]
    j = run(jdevtime, jperf)
    t = run(tdevtime, tperf)
    assert j == t


# -------------------------------------------------------------- perfmodel


def test_perf_model_formulas_and_the_h100_peaks():
    for jm, tm in ((jperf, tperf),):
        for quant, size in (("none", 2), ("int8", 2), ("none", 4)):
            assert tm.weight_bytes(8_030_261_248, quant, size) == \
                jm.weight_bytes(8_030_261_248, quant, size)
        kw = dict(n_params=8_030_261_248, param_bytes=16_060_522_496.0,
                  peak_flops=989e12, peak_bw=3.35e12)
        jp, tp = jm.PerfModel(**kw), tm.PerfModel(**kw)
        for fn, args in (("flops", (128,)), ("weight_read_bytes", (8,)),
                         ("prefill_seconds", (2048,)),
                         ("mfu", (512, 0.05)),
                         ("hbm_read_util", (8, 0.05))):
            assert getattr(tp, fn)(*args) == getattr(jp, fn)(*args)
    assert tperf.CHIP_PEAKS == {"H100": (989e12, 3.35e12)}
    assert tperf.chip_peaks(torch.device("cpu")) == (None, None)
    assert tperf.chip_peaks(None) == (None, None)
    cpu = tperf.PerfModel.build(10, "none", 2, torch.device("cpu"))
    assert cpu.prefill_seconds(100) is None and cpu.mfu(1, 1.0) is None


def test_tier_prices_by_prefill_seconds_where_peaks_are_known():
    from generativeaiexamples_tpu_torch.engine.kv_tier import PrefixKVTier
    cpu = PrefixKVTier(1 << 20)
    assert cpu._recompute_cost(512) == 512.0
    h100 = tperf.PerfModel(n_params=8_030_261_248, param_bytes=16e9,
                           peak_flops=989e12, peak_bw=3.35e12)
    priced = PrefixKVTier(1 << 20, perf_model=h100)
    assert priced._recompute_cost(512) == pytest.approx(
        2 * 8_030_261_248 * 512 / 989e12)


# --------------------------------------------------------- the catalog


def test_every_metric_the_port_registers_is_in_the_reference_catalog():
    static, dynamic = collect_registered(
        os.path.dirname(generativeaiexamples_tpu_torch.__file__))
    doc = os.path.join(os.path.dirname(generativeaiexamples_tpu.__file__),
                       os.pardir, "docs", "observability.md")
    with open(doc, "r", encoding="utf-8") as f:
        names, patterns = parse_catalog(f.read())
    assert len(static) > 60, sorted(static)
    undocumented = sorted(
        n for n in static
        if n not in names and not any(pattern_matches(p, n)
                                      for p in patterns))
    assert undocumented == []
    assert sorted(dynamic - patterns) == []
    for name in ("engine_device_seconds", "engine_mfu",
                 "engine_hbm_read_util", "engine_recompiles_total",
                 "requests_finished", "slo_requests_total",
                 "usage_tokens_total", "kv_tier_total",
                 "engine_watchdog_trips_total", "chaos_injections_total"):
        assert name in static, name


def test_clock_copies_agree():
    def run(m):
        clk = m.VirtualClock(start=5.0)
        with m.use(clk):
            clk.advance(2.5)
            return m.mono(), m.perf(), m.is_virtual()
    j, t = both("clock", run)
    assert j == t == (7.5, 7.5, True)


def test_threads_share_one_trace_order():
    tr = ttrace.EventTrace()
    tr.configure(mode="on", capacity=4096)

    def emit(i):
        for k in range(100):
            tr.emit("dispatch", worker=i, k=k)

    threads = [threading.Thread(target=emit, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    seqs = [r["seq"] for r in tr.records()]
    assert seqs == list(range(400))
