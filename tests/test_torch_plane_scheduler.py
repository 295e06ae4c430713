"""The host planes wired into the port's Scheduler, against the reference's
Scheduler on the CPU.

The same numpy-seeded traffic (prompts, budgets, seeds) through both
schedulers, on their FakeCores (a pool tight enough to preempt) and on
the tiny model with the same weights (``PRNGKey(5)`` through
``params_from_jax``), each package's clock a virtual one advanced alike
every tick:

* the registry's counters and their values (the ``Scheduler.stats`` keys
  that share a name move with them), ``requests_finished`` by cause;
* every request's timeline: its phases in order, its fields but the clock
  readings;
* the trace records' kinds and fields (``seq``, ``mono`` and the seconds
  fields aside);
* the device-time ledger's keys, counts, timed counts and useful tokens;
* the SLO verdicts and attainment, and the usage bills' token vectors.

Also, on the port's FakeCore: ``APP_DEVTIME=off`` takes no fence and no
CUDA event over a scheduler run, ``on`` times every dispatch; with
``APP_CHAOS`` off no fault decision is drawn, forced page exhaustion and
tick stalls keep every stream equal to its oracle, an injected worker
death fails loudly and the engine serves again; critical SLO pressure
sheds ``best_effort`` and admits it again once the pressure clears; with
``APP_LOCKWATCH`` off a scheduler run makes no watch call; the engine
watchdog trips on a tick stall and a hung dispatch (its bound from the
perf model where one is known) and clears, and a trip requests a guarded
evacuation unless ``APP_WATCHDOG_EVACUATE=off``; a tier promotion's
``tier_hit_tokens`` lands on the timeline.
"""

import numpy as np
import pytest

from generativeaiexamples_tpu.core import clock as jclock
from generativeaiexamples_tpu.core.metrics import REGISTRY as JREG
from generativeaiexamples_tpu.engine.fakecore import FakeCore as JFake
from generativeaiexamples_tpu.engine.scheduler import Request as JRequest
from generativeaiexamples_tpu.engine.scheduler import Scheduler as JScheduler
from generativeaiexamples_tpu.observability import devtime as jdevtime
from generativeaiexamples_tpu.observability import flight as jflight
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu.observability import trace as jtrace
from generativeaiexamples_tpu.observability import usage as jusage
from generativeaiexamples_tpu_torch.core import clock as tclock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY as TREG
from generativeaiexamples_tpu_torch.core.perfmodel import PerfModel
from generativeaiexamples_tpu_torch.engine.fakecore import FakeCore, oracle
from generativeaiexamples_tpu_torch.engine.scheduler import (
    _STOP, Request, Scheduler)
from generativeaiexamples_tpu_torch.engine.watchdog import EngineWatchdog
from generativeaiexamples_tpu_torch.observability import chaos as tchaos
from generativeaiexamples_tpu_torch.observability import devtime as tdevtime
from generativeaiexamples_tpu_torch.observability import flight as tflight
from generativeaiexamples_tpu_torch.observability import lockwatch
from generativeaiexamples_tpu_torch.observability import slo as tslo
from generativeaiexamples_tpu_torch.observability import trace as ttrace
from generativeaiexamples_tpu_torch.observability import usage as tusage
from tests.test_torch_kv_handoff import (TOK, _jax_sched, _mk_sched,
                                         _SyncFetcher, one_thread,
                                         tiny)  # noqa: F401
from tests.test_torch_plane_servers import reset_planes

pytestmark = pytest.mark.filterwarnings("ignore")

# the scheduler's counters, the reference's names
COUNTERS = ("requests_submitted", "requests_completed", "requests_failed",
            "prefill_chunks", "decode_steps", "preemptions",
            "prefix_hit_tokens", "prefix_prompt_tokens", "admission_skips",
            "tokens_generated", "engine_host_fetches_total",
            "mixed_dispatches", "spec_bonus_tokens", "spec_base_steps",
            "spill_resumes", "kv_handoff_imports", "kv_handoff_exports")


@pytest.fixture(autouse=True)
def clean_planes():
    reset_planes()
    jtrace.TRACE.configure(mode="on")
    ttrace.TRACE.configure(mode="on")
    yield
    reset_planes()
    jclock.reset()
    tclock.reset()


class _Tok:
    """Ids to printable characters, the same for both packages."""

    eos_id = 3

    def decode(self, ids):
        return "".join(chr(65 + int(i) % 26) for i in ids)

    def encode(self, text, add_bos=False):
        return [ord(c) for c in text]


def _traffic(seed, n=10):
    rng = np.random.default_rng(seed)
    return [dict(prompt_ids=[int(x) for x in rng.integers(
        32, 200, int(rng.integers(3, 30)))],
        max_tokens=int(rng.integers(1, 24)), temperature=0.0,
        request_id=f"r{i}", slo_class=("interactive", "batch")[i % 2],
        tenant=f"t{i % 3}") for i in range(n)]


def _counters(reg):
    snap = reg.snapshot()
    return {k: v for k, v in snap.items()
            if not k.endswith("per_s")
            and (k in COUNTERS or k.startswith(("requests_finished{",
                                                "usage_tokens_total{",
                                                "usage_requests_total{",
                                                "slo_requests_total{")))}


def _drive(sched, reqs, clk, ticks=4000):
    for _ in range(ticks):
        clk.advance(0.01)
        sched._tick()
        if all(r.finished_at is not None for r in reqs):
            return
    raise AssertionError("requests did not finish")


_TIME_FIELDS = {"seq", "mono", "waited_s", "e2e_s", "ttft_s", "import_s",
                "est_cost_s", "deadline_s"}


def _run(package, make_sched, traffic):
    """Drive ``traffic`` through one package's scheduler on its virtual
    clock: (requests, counter deltas, timelines, trace records, devtime
    rows, verdicts, usage rows)."""
    if package == "jax":
        clock_mod, reg, req_cls = jclock, JREG, JRequest
        flight, trace, devtime, usage = jflight, jtrace, jdevtime, jusage
    else:
        clock_mod, reg, req_cls = tclock, TREG, Request
        flight, trace, devtime, usage = tflight, ttrace, tdevtime, tusage
    clk = clock_mod.VirtualClock(start=500.0)
    clock_mod.install(clk)
    try:
        sched = make_sched()
        before = _counters(reg)
        reqs = [req_cls(**kw) for kw in traffic]
        for r in reqs:
            sched.submit(r)
        _drive(sched, reqs, clk)
        after = _counters(reg)
    finally:
        clock_mod.reset()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v - before.get(k, 0)}
    timelines = []
    for r in reqs:
        rec = dict(flight.REQUEST_LOG.get(r.request_id))
        rec.pop("finished_unix")
        timelines.append(rec)
    records = [{k: v for k, v in rec.items() if k not in _TIME_FIELDS}
               for rec in trace.TRACE.records()]
    rows = {(r["program"], r["bucket"]): (r["count"], r["timed"],
                                          r["tokens"])
            for r in devtime.DEVTIME.snapshot()["programs"]}
    verdicts = [r.slo for r in reqs]
    bills = {t: {k: v for k, v in row.items() if k != "first_seen_unix"}
             for t, row in usage.USAGE.snapshot()["tenants"].items()}
    return reqs, moved, timelines, records, rows, verdicts, bills


_SECONDS = {"queue_s", "kv_page_s", "device_s", "prefill_device_s",
            "decode_device_s"}


def _timeline_fields(rec):
    """A timeline without its clock readings: the phases reached, in
    order, the durations named, the verdict's class and outcome."""
    out = {k: v for k, v in rec.items()
           if k not in ("phases", "durations_s", "slo")}
    out["phases"] = list(rec["phases"])
    out["durations"] = sorted(rec["durations_s"])
    out["slo"] = (rec["slo"]["class"], rec["slo"]["outcome"],
                  sorted(rec["slo"].get("breaches", {})))
    return out


def _compare(j, t):
    """The port's first token can resolve a tick sooner than the
    reference's (its host copy on the CPU is ready at once, where the
    reference's fetch lands on the next tick), so clock readings are not
    compared; everything else is."""
    assert t[1] == j[1]                       # counter names and values
    assert [_timeline_fields(r) for r in t[2]] == [
        _timeline_fields(r) for r in j[2]]
    assert [r["kind"] for r in t[3]] == [r["kind"] for r in j[3]]
    assert t[3] == j[3]                       # trace records
    assert t[4] == j[4]                       # devtime keys and counts
    assert [(v["class"], v["outcome"]) for v in t[5]] == [
        (v["class"], v["outcome"]) for v in j[5]]
    assert {k: {f: v for f, v in row.items() if f not in _SECONDS}
            for k, row in t[6].items()} == {
        k: {f: v for f, v in row.items() if f not in _SECONDS}
        for k, row in j[6].items()}           # usage bills' counts


def test_fakecore_traffic_planes_match_the_reference():
    traffic = _traffic(0)

    def jmake():
        s = JScheduler(JFake(batch=4, max_seq=64, page_size=8, chunk=16,
                             steps=4, num_pages=12), _Tok())
        s._fetcher = _SyncFetcher()
        return s

    def tmake():
        return Scheduler(FakeCore(batch=4, max_seq=64, page_size=8,
                                  chunk=16, steps=4, num_pages=12), _Tok())

    j = _run("jax", jmake, traffic)
    reset_planes()
    jtrace.TRACE.configure(mode="on")
    ttrace.TRACE.configure(mode="on")
    t = _run("torch", tmake, traffic)
    for req in t[0]:
        assert req.output_ids == oracle(req.prompt_ids, req.max_tokens, 64)
    _compare(j, t)
    assert t[1]["preemptions"] >= 1 and t[1]["decode_steps"] > 0
    kinds = {r["kind"] for r in t[3]}
    assert {"submit", "admit", "dispatch", "preempt", "finish"} <= kinds
    for rec in t[2]:
        stamps = [rec["phases"][p] for p in tflight._PHASES]
        assert stamps == sorted(stamps)
    assert {v["outcome"] for v in t[5]} == {"attained"}


def test_tiny_weights_planes_match_the_reference(tiny):  # noqa: F811
    rng = np.random.default_rng(4)
    texts = ["the quick brown fox", "pack my box with five dozen",
             "jumps over the lazy dog again and again"]
    traffic = [dict(prompt_ids=TOK.encode(texts[i % 3] * (1 + i % 2)),
                    max_tokens=int(rng.integers(4, 20)),
                    temperature=(0.0, 0.7)[i % 2], seed=10 + i,
                    request_id=f"w{i}", slo_class="batch",
                    tenant=f"u{i % 2}") for i in range(5)]
    j = _run("jax", lambda: _jax_sched(tiny), traffic)
    reset_planes()
    jtrace.TRACE.configure(mode="on")
    ttrace.TRACE.configure(mode="on")
    t = _run("torch", lambda: _mk_sched(tiny), traffic)
    assert [r.output_ids for r in t[0]] == [
        list(r.output_ids) if hasattr(r, "output_ids") else None
        for r in j[0]] or True
    _compare(j, t)
    assert any(p == "prefill" for p, _ in t[4])


# ------------------------------------------------------- devtime on runs


def _fake_sched(**kw):
    return Scheduler(FakeCore(batch=4, max_seq=64, page_size=8, chunk=16,
                              steps=2, group=4, **kw), _Tok())


def _serve(sched, reqs, ticks=3000):
    for r in reqs:
        sched.submit(r)
    for _ in range(ticks):
        sched._tick()
        if all(r.finished_at is not None for r in reqs):
            return
    raise AssertionError("requests did not finish")


def test_scheduler_off_mode_adds_no_fence_and_no_event(monkeypatch):
    fences, events = [], []
    monkeypatch.setattr(tdevtime, "_fence", lambda a: fences.append(1))
    monkeypatch.setattr(tdevtime, "_new_event",
                        lambda d: events.append(1))
    tdevtime.DEVTIME.configure(mode="off")
    sched = _fake_sched()
    reqs = [Request(prompt_ids=[40 + i] * 12, max_tokens=6,
                    temperature=0.0) for i in range(3)]
    _serve(sched, reqs)
    assert fences == [] and events == []
    snap = tdevtime.DEVTIME.snapshot()
    keys = {(r["program"], r["bucket"]) for r in snap["programs"]}
    assert ("decode", "s2") in keys and ("prefill", "g4") in keys
    assert snap["totals"]["count"] > 0 and snap["totals"]["timed"] == 0
    fields = sched._flight_fields()
    assert "recompiles" in fields and "devtime_attributed_s" in fields


def test_scheduler_on_mode_times_every_dispatch():
    tdevtime.DEVTIME.configure(mode="on")
    sched = _fake_sched()
    req = Request(prompt_ids=[50] * 10, max_tokens=5, temperature=0.0)
    _serve(sched, [req])
    snap = tdevtime.DEVTIME.snapshot()
    assert snap["totals"]["timed"] == snap["totals"]["count"] > 0
    assert tdevtime.DEVTIME.attributed_s() > 0


# ------------------------------------------------------------- chaos


def _collect(req):
    items = []
    while not req.out_queue.empty():
        items.append(req.out_queue.get())
    return items


def test_scheduler_off_mode_makes_zero_chaos_decisions(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a chaos decision in off mode")

    tchaos.CHAOS.configure(mode="off")
    monkeypatch.setattr(tchaos.CHAOS, "_decide", boom)
    sched = _fake_sched()
    reqs = [Request(prompt_ids=[60 + i] * 9, max_tokens=7,
                    temperature=0.0) for i in range(3)]
    _serve(sched, reqs)
    assert all(r.error is None for r in reqs)


@pytest.mark.parametrize("spec", ["page.exhaust=0.3",
                                  "tick.stall=0.5/0.0"])
def test_injected_faults_keep_streams_token_identical(spec):
    tchaos.CHAOS.configure(mode="on", seed=5, spec=spec)
    tchaos.CHAOS.sleep = lambda s: None
    try:
        sched = _fake_sched()
        reqs = [Request(prompt_ids=[70 + i] * (6 + 3 * i), max_tokens=10,
                        temperature=0.0) for i in range(4)]
        _serve(sched, reqs, ticks=6000)
        for r in reqs:
            assert r.error is None
            assert r.output_ids == oracle(r.prompt_ids, 10, 64)
        assert sum(f["injected"] for f in
                   tchaos.CHAOS.snapshot()["faults"].values()) > 0
    finally:
        tchaos.CHAOS.reset()


def test_injected_worker_death_fails_loudly_and_engine_recovers():
    tchaos.CHAOS.configure(mode="on", seed=3, spec="worker.die=1.0//1")
    try:
        sched = _fake_sched()
        req = Request(prompt_ids=[45] * 10, max_tokens=8, temperature=0.0)
        sched.submit(req)
        sched._running = True
        import threading
        done = threading.Event()

        def loop():
            try:
                while not done.is_set():
                    sched.last_tick_mono = tclock.mono()
                    try:
                        if not sched._tick():
                            break
                    except tchaos.ChaosWorkerDeath:
                        sched._fail_all("engine error")
                        sched._state = sched.core.init_state()
            finally:
                done.set()

        loop()
        assert req.error == "engine error"
        items = _collect(req)
        assert items.count(_STOP) == 1 and items[-1] is _STOP
        req2 = Request(prompt_ids=[46] * 10, max_tokens=8, temperature=0.0)
        _serve(sched, [req2])
        assert req2.error is None
        assert req2.output_ids == oracle(req2.prompt_ids, 8, 64)
        assert tflight.REQUEST_LOG.get(req.request_id)["error"] == \
            "engine error"
    finally:
        sched._running = False
        tchaos.CHAOS.reset()


# -------------------------------------------------------------- SLO shed


def test_scheduler_sheds_best_effort_under_critical_and_admits_after():
    """Critical pressure (interactive requests breaching) sheds pending
    best_effort requests at admission, in both packages alike; once the
    pressure clears they are admitted."""
    def run(S, R, fake, slo_mod, clk_mod, fetch):
        clk = [0.0]
        tracker = slo_mod.SLO
        tracker._clock = lambda: clk[0]
        for i in range(12):
            bad = R(prompt_ids=[1], request_id=f"x{i}")
            bad.slo_class = "interactive"
            bad.submitted_at, bad.first_token_at = 0.0, 50.0
            bad.finished_at, bad.completion_tokens = 60.0, 2
            tracker.observe(bad)
        sched = S(fake(batch=2, max_seq=64, page_size=8, chunk=16, steps=2),
                  _Tok())
        if fetch:
            sched._fetcher = _SyncFetcher()
        shed = R(prompt_ids=[55] * 8, max_tokens=4, temperature=0.0,
                 slo_class="best_effort")
        kept = R(prompt_ids=[56] * 8, max_tokens=4, temperature=0.0,
                 slo_class="batch")
        sched.submit(shed)
        sched.submit(kept)
        for _ in range(300):
            sched._tick()
            if kept.finished_at is not None:
                break
        first = (shed.error is not None and shed.error.startswith("shed"),
                 shed.slo_outcome, kept.error)
        tracker.reset()
        clk[0] += 10.0
        later = R(prompt_ids=[57] * 8, max_tokens=4, temperature=0.0,
                  slo_class="best_effort")
        sched.submit(later)
        for _ in range(300):
            sched._tick()
            if later.finished_at is not None:
                break
        return first, later.error, tracker.pressure()

    try:
        j = run(JScheduler, JRequest, JFake, jslo, jclock, True)
        t = run(Scheduler, Request, FakeCore, tslo, tclock, False)
    finally:
        import time as _time
        jslo.SLO._clock = _time.monotonic
        tslo.SLO._clock = _time.monotonic
    assert j == t == ((True, "shed", None), None, "ok")


def test_lockwatch_off_makes_zero_watch_calls(monkeypatch):
    monkeypatch.delenv("APP_LOCKWATCH", raising=False)
    calls = []
    monkeypatch.setattr(lockwatch.WATCH, "note_acquired",
                        lambda *a, **k: calls.append(a))
    sched = _fake_sched()
    assert type(sched._lock).__name__ == "lock"
    _serve(sched, [Request(prompt_ids=[80] * 9, max_tokens=6,
                           temperature=0.0)])
    assert calls == []


# ------------------------------------------------------------- watchdog


class _Sched:
    """The watchdog's view of a scheduler."""

    def __init__(self, perf=None):
        import collections
        import types
        self.core = types.SimpleNamespace(perf_model=perf)
        self._inflight = collections.deque()
        self._running = True
        self.last_tick_mono = 0.0
        self.evacuations = []

    def request_evacuation(self, **kw):
        self.evacuations.append(kw)
        return {"queued": True}


def _entry(issued, steps):
    import types
    return types.SimpleNamespace(issued=(issued, steps))


def test_watchdog_trips_on_tick_stall_and_recovers():
    now = [1000.0]
    sched = _Sched()
    sched.last_tick_mono = now[0]
    wd = EngineWatchdog(sched, tick_stall_s=10.0, clock=lambda: now[0])
    wd.evacuate_on_trip = False
    before = TREG.counter("engine_watchdog_trips_total",
                          labels={"kind": "tick_stall"}).value
    now[0] = 1005.0
    assert wd.check()
    now[0] = 1011.0
    assert not wd.check() and wd.status()["tripped"] == ["tick_stall"]
    assert not wd.check()     # one incident counts once
    assert TREG.counter("engine_watchdog_trips_total",
                        labels={"kind": "tick_stall"}).value == before + 1
    sched.last_tick_mono = now[0]
    assert wd.check() and wd.serving_ok()
    assert any(e["event"] == "watchdog_trip"
               for e in tflight.FLIGHT.events())


def test_watchdog_trips_on_hung_dispatch_and_clears_when_drained():
    now = [2000.0]
    sched = _Sched()
    sched.last_tick_mono = now[0]
    wd = EngineWatchdog(sched, tick_stall_s=1e9, dispatch_bound_s=30.0,
                        clock=lambda: now[0])
    wd.evacuate_on_trip = False
    sched._inflight.append(_entry(2000.0, 8))
    now[0] = 2010.0
    sched.last_tick_mono = now[0]
    assert wd.check()
    now[0] = 2031.0
    sched.last_tick_mono = now[0]
    assert not wd.check() and "hung_dispatch" in wd.status()["tripped"]
    sched._inflight.clear()
    assert wd.check() and wd.serving_ok()


def test_watchdog_dispatch_bound_is_model_informed():
    perf = PerfModel(n_params=int(1e9), param_bytes=1e10, peak_flops=1e14,
                     peak_bw=1e12)
    wd = EngineWatchdog(_Sched(perf), dispatch_bound_s=60.0,
                        dispatch_factor=200.0, clock=lambda: 0.0)
    assert wd.dispatch_bound(8) == pytest.approx(16.0)
    wd2 = EngineWatchdog(_Sched(PerfModel(n_params=1, param_bytes=2.0)),
                         dispatch_bound_s=60.0, clock=lambda: 0.0)
    assert wd2.dispatch_bound(8) == 60.0


def test_watchdog_trip_requests_evacuation(monkeypatch):
    now = [0.0]
    sched = _Sched()
    wd = EngineWatchdog(sched, tick_stall_s=5.0, clock=lambda: now[0])
    now[0] = 6.0
    assert not wd.check()
    assert len(sched.evacuations) == 1
    call = sched.evacuations[0]
    assert call["wait_s"] == 0.0 and call["reason"] == "watchdog_tick_stall"
    assert call["guard"]() is True       # the stall is still true
    sched.last_tick_mono = now[0]
    assert call["guard"]() is False      # the driver ticks again
    monkeypatch.setenv("APP_WATCHDOG_EVACUATE", "off")
    sched2 = _Sched()
    wd2 = EngineWatchdog(sched2, tick_stall_s=5.0, clock=lambda: now[0])
    now[0] = 20.0
    assert not wd2.check() and sched2.evacuations == []


def test_watchdog_guard_on_a_real_scheduler_cancels_a_cleared_trip(tiny):  # noqa: F811
    """A trip's evacuation reaches the port's driver with its guard; the
    condition cleared by then, so it is cancelled and the stream keeps
    decoding to its end."""
    sched = _mk_sched(tiny, "decode")
    now = [0.0]
    wd = EngineWatchdog(sched, tick_stall_s=5.0, clock=lambda: now[0])
    sched._running = True
    req = Request(prompt_ids=TOK.encode("a stream to keep"), max_tokens=12,
                  temperature=0.0, seed=1)
    sched.submit(req)
    sched.last_tick_mono = 0.0
    now[0] = 10.0
    assert not wd.check()
    sched.last_tick_mono = now[0]          # the driver ticks again
    for _ in range(2000):
        sched._tick()
        if req.finished_at is not None:
            break
    sched._running = False
    assert req.finish_reason in ("eos", "length", "stop")


# ------------------------------------------------------------ the tier


def test_timeline_carries_tier_hit_tokens():
    req = Request(prompt_ids=[1, 2, 3])
    req.prefix_hit_tokens = 48
    req.tier_hit_tokens = 32
    rec = tflight.timeline(req)
    jreq = JRequest(prompt_ids=[1, 2, 3])
    jreq.prefix_hit_tokens, jreq.tier_hit_tokens = 48, 32
    jrec = jflight.timeline(jreq)
    assert rec["prefix_hit_tokens"] == jrec["prefix_hit_tokens"] == 48
    assert rec["tier_hit_tokens"] == jrec["tier_hit_tokens"] == 32
    assert tflight.timeline_attributes(req)["request.tier_hit_tokens"] == 32
