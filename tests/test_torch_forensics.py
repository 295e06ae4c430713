"""The port's latency forensics plane (``observability/forensics.py``) and
its ``/debug`` surfaces against the reference's, on the CPU.

The reference's ``tests/test_forensics.py`` cases run on both packages
(``pkg``), each over its own ``Scheduler`` on its ``FakeCore``:
breakdown segments partition the end-to-end span (contiguous, summing to
it within the 6-decimal rounding, and within 5% of the SLO judge's own
e2e); the trace slice joins the GLOBAL dispatch records by their ``rids``
roster; an SLO breach is captured into the exemplar ring and a healthy
request is not; the ring is bounded; ``APP_FORENSICS=off`` makes no
forensics or alert call over a scheduler run; the doctor names the
injected causes (a first-seen shape, page-pressure preemption, a qos
shed) and is healthy on a quiet registry.

Over HTTP the port's stdlib engine server answers the same request as the
reference's aiohttp server: ``/debug/forensics``,
``/debug/forensics/<rid>``, ``/debug/trace?rid=``, ``/debug/alerts``,
``/debug/doctor``, ``/debug/qos`` and ``/health``'s ``alerts_active``
carry the same keys and values, clock readings aside; the off-mode hints
are the reference's.

One numpy-seeded episode through both schedulers ticked by hand on
virtual clocks (a pool tight enough to preempt, ``APP_QOS=fair`` with a
request whose deadline cannot be met, a program first seen mid-serving)
gives the same breakdown labels and causes for every request and the
same diagnoses.

Two reference cases wait for ROADMAP A.17:
``test_disagg_router_legs_sum_to_measured_wall`` needs ``server/failover.py``.
``test_simulate_replays_captured_exemplar`` needs ``ops/simulate.py``.
"""

import asyncio
import concurrent.futures
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from generativeaiexamples_tpu.core import clock as jclock
from generativeaiexamples_tpu.core.metrics import REGISTRY as JREG
from generativeaiexamples_tpu.engine import fakecore as jfake
from generativeaiexamples_tpu.engine import qos as jqos
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.engine.server import ModelServer as JServer
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu.observability import alerts as jalerts
from generativeaiexamples_tpu.observability import devtime as jdevtime
from generativeaiexamples_tpu.observability import forensics as jfor
from generativeaiexamples_tpu.observability import lockwatch as jlock
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu.observability import trace as jtrace
from generativeaiexamples_tpu_torch.core import clock as tclock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY as TREG
from generativeaiexamples_tpu_torch.engine import fakecore as tfake
from generativeaiexamples_tpu_torch.engine import qos as tqos
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.server import serve_in_thread
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TTok)
from generativeaiexamples_tpu_torch.observability import alerts as talerts
from generativeaiexamples_tpu_torch.observability import devtime as tdevtime
from generativeaiexamples_tpu_torch.observability import forensics as tfor
from generativeaiexamples_tpu_torch.observability import lockwatch as tlock
from generativeaiexamples_tpu_torch.observability import slo as tslo
from generativeaiexamples_tpu_torch.observability import trace as ttrace
from tests.test_torch_plane_servers import reset_planes

pytestmark = pytest.mark.filterwarnings("ignore")

PKGS = {
    "jax": SimpleNamespace(name="jax", qos=jqos, sched=jsched, Tok=JTok,
                           fake=jfake, REG=JREG, slo=jslo, devtime=jdevtime,
                           trace=jtrace, clock=jclock, alerts=jalerts,
                           forensics=jfor, lock=jlock),
    "torch": SimpleNamespace(name="torch", qos=tqos, sched=tsched, Tok=TTok,
                             fake=tfake, REG=TREG, slo=tslo,
                             devtime=tdevtime, trace=ttrace, clock=tclock,
                             alerts=talerts, forensics=tfor, lock=tlock),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _arm(p):
    p.trace.TRACE.configure(mode="on", path="")
    p.trace.TRACE.reset()
    p.forensics.FORENSICS.configure(mode="on")
    p.forensics.FORENSICS.reset()
    p.alerts.ALERTS.reset()
    p.slo.SLO.reset()


def _disarm(p):
    p.forensics.FORENSICS.configure(mode="off")
    p.forensics.FORENSICS.reset()
    p.alerts.ALERTS.reset()
    p.slo.SLO.reset()
    p.qos.register_policy(None)
    p.trace.TRACE.configure(mode="off")
    p.trace.TRACE.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in (jqos.MODE_ENV, jqos.WEIGHTS_ENV, jqos.TOKENS_PER_S_ENV):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_FORENSICS", "on")
    reset_planes()
    for p in PKGS.values():
        _arm(p)
    yield
    for p in PKGS.values():
        _disarm(p)
    reset_planes()
    jclock.reset()
    tclock.reset()


class _SyncFetcher:
    """The reference Scheduler's result fetcher in the calling thread."""

    def submit(self, fn, *args, **kw):
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args, **kw))
        return fut

    def shutdown(self, wait=True):
        pass


def _core(p, **core_kw):
    kw = dict(batch=4, max_seq=64, page_size=8, chunk=16, steps=2, group=4)
    kw.update(core_kw)
    core = p.fake.FakeCore(**kw)
    # the port's /health reads the weights' storage and size
    core.quant, core.param_bytes = "none", 0
    return core


def _engine(p, **core_kw):
    core = _core(p, **core_kw)
    sched = p.sched.Scheduler(core, p.Tok())
    sched.start()
    return core, sched


def _assert_partition(bd):
    """Segments tile [start, end] exactly: contiguous, and the total
    equals the e2e up to the 6-decimal per-segment rounding."""
    assert bd["found"], bd
    segs = bd["segments"]
    assert segs
    assert abs(bd["segments_total_s"] - bd["e2e_s"]) < 1e-4
    cursor = bd.get("start_mono")
    if cursor is not None:
        for seg in segs:
            assert abs(seg["t0_s"] - cursor) < 1e-4
            cursor = seg["t0_s"] + seg["dur_s"]
        assert abs(cursor - bd["end_mono"]) < 1e-4


# ------------------------------------------------ critical-path breakdown

def test_breakdown_segments_partition_e2e(pkg):
    _core_, sched = _engine(pkg)
    reqs = [pkg.sched.Request(prompt_ids=[40 + i] * 20, max_tokens=8,
                              temperature=0.0) for i in range(3)]
    try:
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            assert "".join(sched.iter_text(r))
    finally:
        sched.stop()
    for r in reqs:
        bd = pkg.forensics.build_breakdown(r.request_id)
        assert bd["source"] == "trace"
        _assert_partition(bd)
        labels = [s["label"] for s in bd["segments"]]
        assert labels.count("prefill_chunk") >= 1
        assert "decode" in labels
        decode = next(s for s in bd["segments"] if s["label"] == "decode")
        assert decode["dispatches"] >= 1
        assert decode["max_gap_s"] >= 0.0
        assert labels[0] == "queue_wait"
        verdict = r.slo
        assert verdict and verdict["outcome"] == "attained"
        assert abs(bd["e2e_s"] - verdict["e2e_s"]) <= (
            0.05 * verdict["e2e_s"] + 0.02)
        assert bd["meta"]["finish"] in ("stop", "eos", "length")


def test_trace_slice_joins_global_dispatch_rosters(pkg):
    _core_, sched = _engine(pkg)
    r = pkg.sched.Request(prompt_ids=[40] * 12, max_tokens=6,
                          temperature=0.0)
    try:
        sched.submit(r)
        assert "".join(sched.iter_text(r))
    finally:
        sched.stop()
    events = pkg.forensics.trace_slice(r.request_id)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "submit" and "finish" in kinds
    decode = [e for e in events
              if e["kind"] == "dispatch" and e.get("phase") == "decode"]
    assert decode
    assert all(r.request_id in str(e["rids"]).split(",") for e in decode)
    monos = [e["mono"] for e in events]
    assert monos == sorted(monos)
    assert pkg.forensics.trace_slice("no-such-rid") == []


# ------------------------------------------------- tail-exemplar capture

def test_slo_breach_auto_captured_healthy_not(pkg):
    FORENSICS = pkg.forensics.FORENSICS
    breach0 = pkg.REG.counter("forensics_exemplars_total",
                              labels={"reason": "breach"}).value
    _core_, sched = _engine(pkg)
    healthy = pkg.sched.Request(prompt_ids=[40] * 12, max_tokens=6,
                                temperature=0.0)
    doomed = pkg.sched.Request(prompt_ids=[41] * 12, max_tokens=6,
                               temperature=0.0, deadline_s=1e-4)
    try:
        sched.submit(healthy)
        sched.submit(doomed)
        assert "".join(sched.iter_text(healthy))
        assert "".join(sched.iter_text(doomed))
    finally:
        sched.stop()
    assert healthy.slo["outcome"] == "attained"
    assert doomed.slo["outcome"] == "breached"
    ex = FORENSICS.get(doomed.request_id)
    assert ex is not None and ex["reason"] == "breach"
    assert ex["trace"]
    _assert_partition(ex["breakdown"])
    assert FORENSICS.get(healthy.request_id) is None
    assert [e["rid"] for e in FORENSICS.exemplars()] == [doomed.request_id]
    top = FORENSICS.top_exemplars(3)
    assert [t["rid"] for t in top] == [doomed.request_id]
    assert "trace" not in top[0]
    d = FORENSICS.describe()
    assert d["enabled"] is True and d["captured"] == 1
    assert pkg.REG.counter("forensics_exemplars_total",
                           labels={"reason": "breach"}).value == breach0 + 1


def test_exemplar_ring_bounded(pkg):
    FORENSICS, TRACE = pkg.forensics.FORENSICS, pkg.trace.TRACE
    FORENSICS.configure(capacity=4)
    try:
        for i in range(9):
            TRACE.emit("submit", rid=f"cap{i}", prompt_tokens=1)
            TRACE.emit("finish", rid=f"cap{i}", finish="stop")
            FORENSICS.capture(f"cap{i}", "breach", {"outcome": "breached"})
        assert len(FORENSICS.exemplars()) == 4
        assert FORENSICS.get("cap0") is None
        assert FORENSICS.get("cap8") is not None
    finally:
        FORENSICS.configure(capacity=pkg.forensics._DEF_CAPACITY)


# ---------------------------------------------- off-mode: zero call sites

def test_off_mode_makes_zero_forensics_calls(pkg, monkeypatch):
    monkeypatch.delenv("APP_FORENSICS", raising=False)
    FORENSICS, ALERTS = pkg.forensics.FORENSICS, pkg.alerts.ALERTS
    FORENSICS.configure(mode="off")
    calls = []
    monkeypatch.setattr(FORENSICS, "observe",
                        lambda req: calls.append("forensics.observe"))
    monkeypatch.setattr(FORENSICS, "capture",
                        lambda *a, **k: calls.append("forensics.capture"))
    monkeypatch.setattr(ALERTS, "observe",
                        lambda req, verdict: calls.append("alerts.observe"))
    _core_, sched = _engine(pkg)
    try:
        reqs = [pkg.sched.Request(prompt_ids=[40 + i] * 12, max_tokens=6,
                                  temperature=0.0) for i in range(4)]
        reqs.append(pkg.sched.Request(prompt_ids=[50] * 12, max_tokens=6,
                                      temperature=0.0, deadline_s=1e-4))
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            "".join(sched.iter_text(r))
    finally:
        sched.stop()
    assert calls == []


# ----------------------------------------------------- /debug over HTTP

RID = "forens-rid-1"
COMPLETION = {"prompt": "why was this slow", "max_tokens": 6}
PATHS = ("/debug/forensics", f"/debug/forensics/{RID}",
         f"/debug/trace?rid={RID}", f"/debug/trace?rid={RID}&kind=finish",
         "/debug/forensics/zzz-unknown", "/debug/alerts", "/debug/doctor",
         "/debug/qos", "/health")
# clock readings and the fields that carry them
_TIMES = {"mono", "seq", "t0_s", "dur_s", "e2e_s", "start_mono",
          "end_mono", "segments_total_s", "max_gap_s", "waited_s",
          "captured_unix", "generated_unix", "est_cost_s", "ttft_s",
          "deadline_s", "since_mono", "trailing_p99_s"}


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMES}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _reference_bodies(mode):
    """The reference's aiohttp engine server over its FakeCore: one
    completion, then every path of ``PATHS``."""
    from aiohttp.test_utils import TestClient, TestServer
    p = PKGS["jax"]
    p.forensics.FORENSICS.configure(mode=mode)
    sched = p.sched.Scheduler(_core(p), p.Tok())
    sched.start()
    srv = JServer(sched, "fake")

    async def drive():
        client = TestClient(TestServer(srv.app))
        await client.start_server()
        try:
            resp = await client.post("/v1/completions", json=COMPLETION,
                                     headers={"X-Request-Id": RID})
            out = {"completion": (resp.status, await resp.json())}
            for path in PATHS:
                r = await client.get(path)
                raw = await r.text()
                try:
                    body = json.loads(raw)
                except ValueError:
                    body = raw
                out[path] = (r.status, body)
            return out
        finally:
            await client.close()

    try:
        return asyncio.run(drive())
    finally:
        sched.stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _port_bodies(mode):
    p = PKGS["torch"]
    p.forensics.FORENSICS.configure(mode=mode)
    sched = p.sched.Scheduler(_core(p), p.Tok())
    httpd, _thread = serve_in_thread(sched, "fake")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(COMPLETION).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": RID})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = {"completion": (resp.status, json.loads(resp.read()))}
        for path in PATHS:
            out[path] = _get(base + path)
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()


def _keys(d):
    return sorted(d) if isinstance(d, dict) else d


def _phases(records):
    """A request's trace kinds in order, a run of decode dispatches as
    one: how many dispatches a threaded driver issues ahead of a
    request's end (and where a first-seen shape's flight event falls)
    is timing; the ticked episode below compares them exactly."""
    out = []
    for rec in records:
        key = (rec["kind"], rec.get("phase"))
        if not out or key != out[-1] or key != ("dispatch", "decode"):
            out.append(key)
    return out


def _shape(bd):
    """A breakdown's keys, segment labels and meta. The meta's tenant is
    left out: the reference's server stamps an untagged request ``anon``
    on its submit record, the port leaves it empty (ROADMAP C12)."""
    return (_keys(bd), [s["label"] for s in bd["segments"]],
            {k: v for k, v in bd["meta"].items() if k != "tenant"})


def test_debug_surfaces_over_http_match_the_reference(monkeypatch):
    # the reference's router is process-global: no other test's router
    # may join legs into this worker's view
    from generativeaiexamples_tpu.server import failover
    monkeypatch.setattr(failover, "_ROUTER", None)
    want = _reference_bodies("on")
    got = _port_bodies("on")
    for path in ("completion",) + PATHS:
        assert got[path][0] == want[path][0], path
    assert got["completion"][0] == 200
    assert (got["completion"][1]["choices"][0]["text"]
            == want["completion"][1]["choices"][0]["text"])
    # the rid slice: the same kinds in the same order, every record this
    # request's (its own rid or the dispatch roster's)
    jt, tt = want[f"/debug/trace?rid={RID}"][1], \
        got[f"/debug/trace?rid={RID}"][1]
    assert _keys(tt) == _keys(jt) and tt["rid"] == RID
    assert _phases(tt["records"]) == _phases(jt["records"])
    for rec in tt["records"]:
        assert rec.get("rid") == RID or RID in str(rec.get("rids", "")
                                                   ).split(",")
    assert {r["kind"] for r in got[f"/debug/trace?rid={RID}&kind=finish"][
        1]["records"]} == {"finish"}
    # the live breakdown: the same segments and fields, the readings of
    # a threaded run aside (a healthy request: not captured)
    jf, tf = want[f"/debug/forensics/{RID}"][1], \
        got[f"/debug/forensics/{RID}"][1]
    assert tf["enabled"] is True and tf["captured"] is False
    _assert_partition(tf["breakdown"])
    assert _keys(tf) == _keys(jf)
    assert _shape(tf["breakdown"]) == _shape(jf["breakdown"])
    assert _phases(tf["trace"]) == _phases(jf["trace"])
    # an unknown rid is a 404 on both
    assert got["/debug/forensics/zzz-unknown"][0] == 404
    # the ring, the alerts and the doctor: same keys; the values that do
    # not read a clock or the process's history are equal
    jr, tr = want["/debug/forensics"][1], got["/debug/forensics"][1]
    assert _untimed(tr) == _untimed(jr)
    ja, ta = want["/debug/alerts"][1], got["/debug/alerts"][1]
    assert _untimed(ta) == _untimed(ja)
    assert ta["enabled"] is True and ta["objectives"] == [
        "goodput", "ttft", "tpot"]
    jd, td = want["/debug/doctor"][1], got["/debug/doctor"][1]
    assert _keys(td) == _keys(jd)
    assert _untimed(td["forensics"]) == _untimed(jd["forensics"])
    assert td["qos"] == jd["qos"] and td["qos"]["enabled"] is False
    assert td["slo_pressure"] == jd["slo_pressure"]
    assert want["/debug/qos"] == got["/debug/qos"]
    # /health carries the active alerts while forensics is on
    assert got["/health"][1]["alerts_active"] == \
        want["/health"][1]["alerts_active"] == []


def test_forensics_endpoints_off_mode_hint(monkeypatch):
    from generativeaiexamples_tpu.server import failover
    monkeypatch.setattr(failover, "_ROUTER", None)
    monkeypatch.delenv("APP_FORENSICS", raising=False)
    want = _reference_bodies("off")
    got = _port_bodies("off")
    for path in ("/debug/forensics", "/debug/alerts"):
        assert got[path][1]["enabled"] is False
        assert "APP_FORENSICS" in got[path][1]["hint"]
        assert got[path][1]["hint"] == want[path][1]["hint"]
        assert _untimed(got[path][1]) == _untimed(want[path][1])
    assert "alerts_active" not in got["/health"][1]
    assert "alerts_active" not in want["/health"][1]


# ----------------------------------------------------------- the doctor

def test_doctor_names_injected_causes(pkg, monkeypatch):
    """A first-seen shape mid-serving, page-pressure preemption and a qos
    shed before prefill: the doctor names all three, ranks them, points at
    the knobs, and every request's breakdown still partitions its span."""
    REGISTRY, DEVTIME = pkg.REG, pkg.devtime.DEVTIME
    preempt0 = REGISTRY.counter("preemptions").value
    DEVTIME.mark_serving()
    DEVTIME.commit("decode", "doctor-smoke", tokens=1)
    monkeypatch.setenv(pkg.qos.MODE_ENV, "fair")
    _core_, sched = _engine(pkg, num_pages=9)
    monkeypatch.delenv(pkg.qos.MODE_ENV, raising=False)
    assert sched._qos is not None
    sched._qos.configure_estimate(0.01, 0.01)
    doomed = pkg.sched.Request(prompt_ids=[40] * 12, max_tokens=6,
                               temperature=0.0, slo_class="best_effort",
                               deadline_s=0.01)
    storm = [pkg.sched.Request(prompt_ids=[41 + i] * 12, max_tokens=16,
                               temperature=0.0) for i in range(4)]
    try:
        sched.submit(doomed)
        for r in storm:
            sched.submit(r)
        assert "".join(sched.iter_text(doomed)) == ""
        for r in storm:
            assert "".join(sched.iter_text(r))
    finally:
        sched.stop()
    assert doomed.slo_outcome == "shed"
    assert REGISTRY.counter("preemptions").value > preempt0
    doc = pkg.forensics.doctor_payload()
    assert doc["healthy"] is False
    causes = {d["cause"]: d for d in doc["diagnoses"]}
    assert {"recompile_hazard", "page_pressure", "qos_shed"} <= set(causes)
    assert causes["recompile_hazard"]["est_device_s_lost"] >= 1.0
    assert causes["recompile_hazard"]["severity"] == "critical"
    assert causes["page_pressure"]["est_device_s_lost"] > 0.0
    assert "APP_ENGINE_NUM_PAGES" in causes["page_pressure"]["knob"]
    assert "APP_ENGINE_QOS_QUOTA" in causes["qos_shed"]["knob"]
    for d in doc["diagnoses"]:
        assert d["evidence"]
    sevs = [d["severity"] for d in doc["diagnoses"]]
    assert sevs == sorted(sevs, key=lambda s: s != "critical")
    assert doc["qos"] is not None and doc["qos"]["enabled"] is True
    bds = [pkg.forensics.build_breakdown(r.request_id)
           for r in storm + [doomed]]
    for bd in bds:
        _assert_partition(bd)
    tags = {s["cause"] for bd in bds for s in bd["segments"]}
    assert pkg.forensics.CAUSE_PREEMPT in tags
    assert pkg.forensics.CAUSE_QOS in tags
    assert any(s["label"] == "shed" for s in bds[-1]["segments"])


def test_doctor_healthy_on_quiet_registry(pkg, monkeypatch):
    DEVTIME, WATCH = pkg.devtime.DEVTIME, pkg.lock.WATCH
    monkeypatch.setattr(pkg.forensics, "_family_sum", lambda name: 0.0)
    monkeypatch.setattr(pkg.forensics, "_family_rows", lambda name: {})
    monkeypatch.setattr(DEVTIME, "compiles", lambda: {
        "events": [], "warmed_keys": 0, "recompiles_total": 0})
    monkeypatch.setattr(DEVTIME, "padding_waste", lambda: 0.0)
    monkeypatch.setattr(type(WATCH), "inversions", property(lambda self: []))
    doc = pkg.forensics.doctor_payload()
    assert doc["healthy"] is True and doc["diagnoses"] == []


# ------------------------- one seeded episode, both schedulers by hand

def _episode_traffic(seed):
    rng = np.random.default_rng(seed)
    out = [dict(prompt_ids=[int(x) for x in rng.integers(32, 200, 12)],
                max_tokens=6, temperature=0.0, request_id="doomed",
                tenant="bulk", slo_class="best_effort", deadline_s=0.002)]
    for i in range(6):
        out.append(dict(
            prompt_ids=[int(x) for x in rng.integers(
                32, 200, int(rng.integers(8, 20)))],
            max_tokens=int(rng.integers(8, 20)), temperature=0.0,
            request_id=f"e{i}", tenant=("gold", "bulk")[i % 2],
            slo_class="batch",
            # two with budgets no run on this clock meets: breached
            deadline_s=(0.05 if i in (1, 4) else None)))
    return out


def _episode(p, traffic, monkeypatch):
    """The episode on ``p``'s scheduler, ticked by hand on a virtual
    clock: (breakdowns' labels and causes, exemplar reasons, diagnoses
    over this episode's counters: the registry is process-global, so the
    doctor reads each family's change over the episode)."""
    fams = ("preemptions", "kv_spill_total", "spill_resumes",
            "slo_shed_total", "qos_shed_before_prefill_total",
            "router_affinity_total", "retries_denied_total",
            "retry_budget_exhausted_total", "engine_watchdog_trips_total")
    before = {f: dict(p.REG.family(f)) for f in fams}
    recompiles0 = p.REG.counter("engine_recompiles_total").value
    monkeypatch.setenv(p.qos.MODE_ENV, "fair")
    monkeypatch.setenv(p.qos.WEIGHTS_ENV, "gold=4,bulk=1,*=1")
    clk = p.clock.VirtualClock(start=100.0)
    p.clock.install(clk)
    try:
        sched = p.sched.Scheduler(_core(p, steps=4, num_pages=10), p.Tok())
        if hasattr(sched, "_fetcher"):
            sched._fetcher = _SyncFetcher()
        sched._qos.configure_estimate(1e-3, 1e-3)
        p.devtime.DEVTIME.mark_serving()
        reqs = [p.sched.Request(**kw) for kw in traffic]
        for r in reqs:
            sched.submit(r)
        for _ in range(6000):
            clk.advance(0.01)
            sched._tick()
            if all(r.finished_at is not None for r in reqs):
                break
        else:
            raise AssertionError("requests did not finish")
        bds = {r.request_id: p.forensics.build_breakdown(r.request_id)
               for r in reqs}

        def delta_sum(name):
            fam = p.REG.family(name)
            return float(sum(v - before.get(name, {}).get(k, 0.0)
                             for k, v in fam.items()))

        def delta_rows(name):
            fam = p.REG.family(name)
            return {",".join(f"{k}={v}" for k, v in key):
                    val - before.get(name, {}).get(key, 0.0)
                    for key, val in fam.items()
                    if val - before.get(name, {}).get(key, 0.0)}

        compiles = p.devtime.DEVTIME.compiles()
        compiles["recompiles_total"] = (
            p.REG.counter("engine_recompiles_total").value - recompiles0)
        monkeypatch.setattr(p.forensics, "_family_sum", delta_sum)
        monkeypatch.setattr(p.forensics, "_family_rows", delta_rows)
        monkeypatch.setattr(p.devtime.DEVTIME, "compiles", lambda: compiles)
        doc = p.forensics.doctor_payload()
        monkeypatch.undo()
    finally:
        p.clock.reset()
    for bd in bds.values():
        _assert_partition(bd)
    shape = {rid: [(s["label"], s["cause"]) for s in bd["segments"]]
             for rid, bd in bds.items()}
    reasons = {e["rid"]: e["reason"]
               for e in p.forensics.FORENSICS.exemplars()}
    diag = [(d["cause"], d["severity"], d["est_device_s_lost"],
             {k: v for k, v in d["evidence"].items()})
            for d in doc["diagnoses"]]
    return shape, reasons, diag


def test_seeded_episode_matches_the_reference(monkeypatch):
    traffic = _episode_traffic(11)
    j = _episode(PKGS["jax"], traffic, monkeypatch)
    reset_planes()
    for p in PKGS.values():
        _arm(p)
    monkeypatch.setenv("APP_FORENSICS", "on")
    t = _episode(PKGS["torch"], traffic, monkeypatch)
    assert t[0] == j[0]          # every request's segment labels and causes
    assert t[1] == j[1]          # the exemplars captured, and why
    assert t[2] == j[2]          # the diagnoses
    assert t[1]["doomed"] == "shed"
    causes = {d[0] for d in t[2]}
    assert {"recompile_hazard", "page_pressure", "qos_shed"} <= causes
    assert any(c == tfor.CAUSE_PREEMPT for segs in t[0].values()
               for _, c in segs)
