"""The port's QoS admission plane (``engine/qos.py``) against the
reference's, on the CPU.

Every case of the reference's ``tests/test_qos.py`` runs on both packages
(``pkg``): tenant-map parsing and mode resolution; ``APP_QOS`` off makes
no qos call and stays FIFO over each package's ``Scheduler`` on its
``FakeCore``; weighted-fair interleave, EDF within a tenant with resumes
first; quota throttle and refill; charge and settle conservation and the
weighted true-up; ``pick_victim`` by overuse, then slack; shed before
prefill with no prefill program dispatched, and a class that is not
sheddable never shed; ``hedge_delay``; the debug payload off and on; the
estimate override and the cardinality fold. These are host arithmetic:
every comparison is exact, and each package must give the reference
test's numbers.

The case that matters most for the port: one numpy-seeded arrival
sequence of two tenants weighted 4:1 and a request whose deadline cannot
be met, through both schedulers over their FakeCores (a pool tight enough
to preempt) on virtual clocks advanced alike, with the service estimate
pinned to one rate a token (the token basis scaled: no device-time ledger
on the CPU). The admission order, the shed set, the preemption victims,
every stream and ``/debug/qos``'s virtual times are equal.
"""

import concurrent.futures
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from generativeaiexamples_tpu.core import clock as jclock
from generativeaiexamples_tpu.core.metrics import REGISTRY as JREG
from generativeaiexamples_tpu.engine import fakecore as jfake
from generativeaiexamples_tpu.engine import qos as jqos
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu.observability import devtime as jdevtime
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu.observability import trace as jtrace
from generativeaiexamples_tpu_torch.core import clock as tclock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY as TREG
from generativeaiexamples_tpu_torch.engine import fakecore as tfake
from generativeaiexamples_tpu_torch.engine import qos as tqos
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.tokenizer import (
    ByteTokenizer as TTok)
from generativeaiexamples_tpu_torch.observability import devtime as tdevtime
from generativeaiexamples_tpu_torch.observability import slo as tslo
from generativeaiexamples_tpu_torch.observability import trace as ttrace
from tests.test_torch_plane_servers import reset_planes

pytestmark = pytest.mark.filterwarnings("ignore")

PKGS = {
    "jax": SimpleNamespace(qos=jqos, sched=jsched, Tok=JTok, fake=jfake,
                           REG=JREG, slo=jslo, devtime=jdevtime,
                           trace=jtrace, clock=jclock),
    "torch": SimpleNamespace(qos=tqos, sched=tsched, Tok=TTok, fake=tfake,
                             REG=TREG, slo=tslo, devtime=tdevtime,
                             trace=ttrace, clock=tclock),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _qos_clean(monkeypatch):
    """Both packages' policy registrations empty and the env unarmed; the
    SLO trackers reset first (a leftover critical pressure would shed the
    best_effort requests these cases aim at the qos path)."""
    for key in (jqos.MODE_ENV, jqos.WEIGHTS_ENV, jqos.TOKENS_PER_S_ENV):
        monkeypatch.delenv(key, raising=False)
    reset_planes()
    yield
    for m in (jqos, tqos):
        m.register_policy(None)
    reset_planes()
    jclock.reset()
    tclock.reset()


def _req(tenant="", prompt=10, max_tokens=8, deadline_s=None, rid=None,
         completion=0, slo_class=""):
    return SimpleNamespace(
        prompt_ids=[40] * prompt, max_tokens=max_tokens, tenant=tenant,
        request_id=rid or f"r{id(object())}", completion_tokens=completion,
        deadline_s=deadline_s, submitted_at=time.perf_counter(),
        kv_import_s=None, slo_class=slo_class)


def _job(req, gen_ids=(), admit_seq=0, spill=None):
    return SimpleNamespace(request=req, gen_ids=list(gen_ids),
                           admit_seq=admit_seq, spill=spill)


class _SyncFetcher:
    """The reference Scheduler's result fetcher run in the calling
    thread, so both schedulers can be ticked by hand."""

    def submit(self, fn, *args, **kw):
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args, **kw))
        return fut

    def shutdown(self, wait=True):
        pass


def _fair_sched(pkg, **core_kw):
    os.environ[pkg.qos.MODE_ENV] = "fair"
    try:
        sched = pkg.sched.Scheduler(pkg.fake.FakeCore(**core_kw), pkg.Tok())
    finally:
        os.environ.pop(pkg.qos.MODE_ENV, None)
    if hasattr(sched, "_fetcher"):
        sched._fetcher = _SyncFetcher()
    return sched


# ------------------------------------------------------------- env parsing

def test_parse_tenant_map(pkg):
    per, default = pkg.qos.parse_tenant_map("acme=4, beta =1.5,*=2")
    assert per == {"acme": 4.0, "beta": 1.5}
    assert default == 2.0
    per, default = pkg.qos.parse_tenant_map("bad,x=zero,evil=-1,other=3")
    assert per == {"t_other": 3.0}
    assert default is None


def test_qos_mode_resolution(pkg, monkeypatch):
    assert pkg.qos.qos_mode() == "off"
    assert pkg.qos.qos_mode(SimpleNamespace(qos="fair")) == "fair"
    monkeypatch.setenv(pkg.qos.MODE_ENV, "fair")
    assert pkg.qos.qos_mode(SimpleNamespace(qos="off")) == "fair"
    monkeypatch.setenv(pkg.qos.MODE_ENV, "bogus")
    assert pkg.qos.qos_mode() == "off"


def test_engine_config_field_arms_the_port_plane(monkeypatch):
    """``APP_ENGINE_QOS=fair`` is the config field the mode reads when the
    bare env is unset (the reference's field, now served by the port)."""
    from generativeaiexamples_tpu_torch.core.config import load_config
    monkeypatch.setenv("APP_ENGINE_QOS", "fair")
    eng = load_config().engine
    assert tqos.qos_mode(eng) == "fair"
    sched = tsched.Scheduler(tfake.FakeCore(
        batch=2, max_seq=64, page_size=8, chunk=16, steps=2, group=4,
    ), TTok())
    # the FakeCore's own config is the default (off)
    assert sched._qos is None
    assert tqos.policy_from_env(eng) is not None


# -------------------------------------------------- zero-overhead (off)

def test_off_mode_makes_zero_qos_calls_and_stays_fifo(pkg, monkeypatch):
    calls = []
    for name in ("order", "charge_admission", "settle", "pick_victim",
                 "should_shed"):
        monkeypatch.setattr(
            pkg.qos.QosPolicy, name,
            lambda self, *a, _n=name, **k: calls.append(_n))
    core = pkg.fake.FakeCore(batch=2, max_seq=64, page_size=8, chunk=16,
                             steps=2, group=4)
    sched = pkg.sched.Scheduler(core, pkg.Tok())
    assert sched._qos is None
    sched.start()
    try:
        reqs = [pkg.sched.Request(prompt_ids=[40 + i] * 12, max_tokens=4,
                                  temperature=0.0, tenant=f"t{i}")
                for i in range(5)]
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            assert "".join(sched.iter_text(r))
            assert r.error is None
    finally:
        sched.stop()
    assert calls == []
    admitted = [r.admitted_at for r in reqs]
    assert admitted == sorted(admitted)


# ------------------------------------------------------------- WFQ / EDF

def test_weighted_fair_interleave(pkg):
    policy = pkg.qos.QosPolicy(weights={"a": 3.0, "b": 1.0})
    jobs = ([_job(_req("a", prompt=5, max_tokens=5)) for _ in range(6)]
            + [_job(_req("b", prompt=5, max_tokens=5)) for _ in range(6)])
    tenants = [j.request.tenant for j in policy.order(jobs, 8)]
    assert tenants.count("a") == 6 and tenants.count("b") == 2


def test_edf_within_tenant_and_resumes_first(pkg):
    policy = pkg.qos.QosPolicy()
    tight = _job(_req("t", deadline_s=1.0, rid="tight"))
    loose = _job(_req("t", deadline_s=30.0, rid="loose"))
    nodl = _job(_req("t", deadline_s=None, rid="nodl"))
    resume = _job(_req("t", deadline_s=None, rid="resume"),
                  gen_ids=[1, 2], admit_seq=3)
    out = policy.order([nodl, loose, resume, tight], 10)
    assert [j.request.request_id for j in out] == [
        "resume", "tight", "loose", "nodl"]


def test_quota_throttle_excludes_then_refills(pkg):
    clock = [100.0]
    policy = pkg.qos.QosPolicy(tokens_per_s={"m": 10.0},
                               clock=lambda: clock[0])
    throttles0 = pkg.REG.counter("qos_quota_throttles_total",
                                 labels={"tenant": "m"}).value
    policy.charge_admission(_req("m", prompt=15, max_tokens=10, rid="m1"))
    later = _job(_req("m", prompt=2, max_tokens=2, rid="m2"))
    free = _job(_req("free", prompt=2, max_tokens=2, rid="f1"))
    out = policy.order([later, free], 10)
    assert [j.request.request_id for j in out] == ["f1"]
    assert pkg.REG.counter("qos_quota_throttles_total",
                           labels={"tenant": "m"}).value == throttles0 + 1
    clock[0] += 2.0
    out = policy.order([later, free], 10)
    assert {j.request.request_id for j in out} == {"f1", "m2"}


def test_charge_settle_conservation_and_refund(pkg):
    clock = [0.0]
    policy = pkg.qos.QosPolicy(tokens_per_s={"m": 100.0},
                               clock=lambda: clock[0])
    req = _req("m", prompt=10, max_tokens=50, rid="c1")
    policy.charge_admission(req)
    assert policy.outstanding() == 1
    req.completion_tokens = 5
    policy.settle(req)
    assert policy.outstanding() == 0
    snap = policy.snapshot()["tenants"]["m"]
    assert snap["quota_bucket_tokens"] == pytest.approx(185.0, abs=0.01)
    policy.settle(req)
    assert policy.outstanding() == 0


def test_settle_true_up_is_weighted_and_basis_consistent(pkg):
    policy = pkg.qos.QosPolicy(weights={"w": 4.0})
    req = _req("w", prompt=20, max_tokens=40, rid="w1")
    policy.charge_admission(req)
    assert policy.snapshot()["tenants"]["w"]["virtual_time"] == 15.0
    policy.configure_estimate(0.001, 0.001)
    req.completion_tokens = 20
    policy.settle(req)
    assert policy.snapshot()["tenants"]["w"]["virtual_time"] == 10.0


def test_pick_victim_prefers_overusing_tenant_then_slack(pkg):
    policy = pkg.qos.QosPolicy()
    for i in range(5):
        policy.charge_admission(_req("hog", prompt=50, max_tokens=50,
                                     rid=f"h{i}"))
    old_hog = _job(_req("hog"), admit_seq=1)
    young_meek = _job(_req("meek"), admit_seq=9)
    assert policy.pick_victim([old_hog, young_meek]) is old_hog
    p2 = pkg.qos.QosPolicy()
    tight = _job(_req("x", deadline_s=0.5), admit_seq=8)
    lazy = _job(_req("x", deadline_s=None), admit_seq=2)
    assert p2.pick_victim([tight, lazy]) is lazy


def test_tenant_overuse_hint_reads_the_snapshot_without_the_lock(pkg):
    """The KV tier prices evictions under its own lock, so the hint it
    calls must answer while another thread holds the QoS lock (no
    ``kv_tier._lock -> qos._lock`` edge), and equal the locked reading."""
    policy = pkg.qos.QosPolicy()
    for i in range(3):
        policy.charge_admission(_req("hog", prompt=20, max_tokens=20,
                                     rid=f"o{i}"))
    want = policy.tenant_overuse_s("hog")
    got = []
    with policy._lock:
        import threading
        th = threading.Thread(
            target=lambda: got.append(policy.tenant_overuse_hint("hog")))
        th.start()
        th.join(timeout=5)
    assert got == [want] and want > 0
    assert policy.tenant_overuse_hint("nobody") == 0.0


# --------------------------------------------------- shed-before-prefill

def _prefill_commits(pkg):
    return sum(r["count"] for r in pkg.devtime.DEVTIME.snapshot()["programs"]
               if r["program"].startswith("prefill"))


def test_shed_before_prefill_fires_before_any_prefill_program(pkg):
    core_kw = dict(batch=2, max_seq=64, page_size=8, chunk=16, steps=2,
                   group=4)
    sched = _fair_sched(pkg, **core_kw)
    assert sched._qos is not None
    sched._qos.configure_estimate(0.01, 0.01)
    chunks0 = pkg.REG.counter("prefill_chunks").value
    shed0 = pkg.REG.counter("qos_shed_before_prefill_total",
                            labels={"tenant": "anon"}).value
    pf0 = _prefill_commits(pkg)
    sched.start()
    try:
        doomed = pkg.sched.Request(prompt_ids=[40] * 12, max_tokens=8,
                                   temperature=0.0, slo_class="best_effort",
                                   deadline_s=0.01)
        sched.submit(doomed)
        assert "".join(sched.iter_text(doomed)) == ""
        assert doomed.slo_outcome == "shed"
        assert doomed.error and "shed" in doomed.error
        fine = pkg.sched.Request(prompt_ids=[44] * 12, max_tokens=6,
                                 temperature=0.0)
        sched.submit(fine)
        want = pkg.Tok().decode(pkg.fake.oracle(fine.prompt_ids, 6, 64))
        assert "".join(sched.iter_text(fine)) == want
    finally:
        sched.stop()
    assert pkg.REG.counter("qos_shed_before_prefill_total",
                           labels={"tenant": "anon"}).value == shed0 + 1
    assert pkg.REG.counter("prefill_chunks").value == chunks0 + 1
    assert _prefill_commits(pkg) == pf0 + 1
    assert sched._qos.outstanding() == 0


def test_non_sheddable_class_never_sheds_before_prefill(pkg):
    sched = _fair_sched(pkg, batch=2, max_seq=64, page_size=8, chunk=16,
                        steps=2, group=4)
    sched._qos.configure_estimate(0.01, 0.01)
    sched.start()
    try:
        req = pkg.sched.Request(prompt_ids=[40] * 12, max_tokens=4,
                                temperature=0.0, slo_class="interactive",
                                deadline_s=0.001)
        sched.submit(req)
        want = pkg.Tok().decode(pkg.fake.oracle(req.prompt_ids, 4, 64))
        assert "".join(sched.iter_text(req)) == want
        assert req.error is None and req.slo_outcome != "shed"
    finally:
        sched.stop()


# ------------------------------------------------------- hedging + debug

def test_hedge_delay_scales_with_load_and_floors_at_service(pkg):
    hd = pkg.qos.hedge_delay
    assert hd(0.0, 10, 8) == 0.0
    assert hd(0.2, 0, 8) == pytest.approx(0.2)
    assert hd(0.2, 8, 8) == pytest.approx(0.4)
    assert hd(0.2, 0, 8, service_s=1.0) == pytest.approx(1.0)
    assert hd(0.2, 10_000, 8) == pytest.approx(1.6)
    assert hd(0.2, 0, 8, service_s=3.0) == pytest.approx(3.0)
    assert (hd(0.3, 5, 4, service_s=0.9), hd(0.1, 3, 2)) == (
        jqos.hedge_delay(0.3, 5, 4, service_s=0.9), jqos.hedge_delay(0.1, 3, 2))


def test_debug_payload_off_and_on(pkg):
    pkg.qos.register_policy(None)
    off = pkg.qos.debug_payload()
    assert off == jqos.debug_payload()
    assert off["enabled"] is False and off["mode"] == "off"
    policy = pkg.qos.QosPolicy(weights={"a": 2.0})
    policy.charge_admission(_req("a", rid="d1"))
    pkg.qos.register_policy(policy)
    on = pkg.qos.debug_payload()
    assert on["enabled"] is True
    assert on["tenants"]["a"]["weight"] == 2.0
    assert on["tenants"]["a"]["virtual_time"] == 9.0   # (10 + 8) / 2
    assert on["outstanding_admissions"] == 1
    assert on["estimate"]["basis"] in ("none", "devtime", "analytic")


def test_estimate_override_and_cardinality_fold(pkg):
    policy = pkg.qos.QosPolicy(max_tenants=3)
    policy.configure_estimate(0.002, 0.005)
    assert policy.estimate_service_s(100, 10) == pytest.approx(0.25)
    assert policy.snapshot()["estimate"]["basis"] == "override"
    seen = [policy.canonical(f"tenant{i}") for i in range(40)]
    assert "other" in seen
    assert len(set(seen)) <= policy.snapshot()["max_tenants"] + 1
    ref = jqos.QosPolicy(max_tenants=3)
    assert seen == [ref.canonical(f"tenant{i}") for i in range(40)]


# ----------------------------------- both schedulers on one seeded traffic

WEIGHTS = "gold=4,bulk=1,*=1"


def _two_tenant_traffic(seed):
    """bulk's backlog, then gold's requests, then a best_effort request
    whose 2 ms deadline cannot cover its estimated service."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        out.append(dict(
            prompt_ids=[int(x) for x in rng.integers(32, 200,
                                                     int(rng.integers(6, 20)))],
            max_tokens=int(rng.integers(6, 20)), temperature=0.0,
            request_id=f"bulk{i}", tenant="bulk", slo_class="batch"))
    for i in range(4):
        out.append(dict(
            prompt_ids=[int(x) for x in rng.integers(32, 200,
                                                     int(rng.integers(6, 20)))],
            max_tokens=int(rng.integers(6, 20)), temperature=0.0,
            request_id=f"gold{i}", tenant="gold", slo_class="batch"))
    out.append(dict(prompt_ids=[int(x) for x in rng.integers(32, 200, 12)],
                    max_tokens=16, temperature=0.0, request_id="doomed",
                    tenant="bulk", slo_class="best_effort",
                    deadline_s=0.002))
    return out


def _run_fair(pkg, traffic, monkeypatch):
    monkeypatch.setenv(pkg.qos.MODE_ENV, "fair")
    monkeypatch.setenv(pkg.qos.WEIGHTS_ENV, WEIGHTS)
    pkg.trace.TRACE.configure(mode="on")
    clk = pkg.clock.VirtualClock(start=100.0)
    pkg.clock.install(clk)
    try:
        sched = pkg.sched.Scheduler(pkg.fake.FakeCore(
            batch=4, max_seq=64, page_size=8, chunk=16, steps=4,
            num_pages=10), pkg.Tok())
        if hasattr(sched, "_fetcher"):
            sched._fetcher = _SyncFetcher()
        # one rate a token for prefill and decode: the token basis, scaled
        sched._qos.configure_estimate(1e-3, 1e-3)
        reqs = [pkg.sched.Request(**kw) for kw in traffic]
        for r in reqs:
            sched.submit(r)
        for _ in range(6000):
            clk.advance(0.01)
            sched._tick()
            if all(r.finished_at is not None for r in reqs):
                break
        else:
            raise AssertionError("requests did not finish")
        qos_body = pkg.qos.debug_payload()
    finally:
        pkg.clock.reset()
        pkg.trace.TRACE.configure(mode="off")
    records = pkg.trace.TRACE.records()
    admits = [r["rid"] for r in records
              if r["kind"] == "admit" and not r.get("resume")]
    shed = sorted(r["rid"] for r in records
                  if r["kind"] == "qos" and r.get("decision") == "shed")
    victims = [r["rid"] for r in records if r["kind"] == "preempt"]
    dispatched = {rid for r in records if r["kind"] == "dispatch"
                  for rid in str(r.get("rids", "")).split(",") if rid}
    vt = {"global": qos_body["global_virtual_time"],
          **{t: row["virtual_time"]
             for t, row in qos_body["tenants"].items()}}
    pkg.trace.TRACE.reset()
    streams = ["".join(sched.iter_text(r)) for r in reqs]
    return (admits, shed, victims, streams, vt, dispatched, reqs,
            sched._qos.outstanding())


def test_two_tenants_fair_share_matches_the_reference(monkeypatch):
    traffic = _two_tenant_traffic(7)
    j = _run_fair(PKGS["jax"], traffic, monkeypatch)
    reset_planes()
    t = _run_fair(PKGS["torch"], traffic, monkeypatch)
    assert t[0] == j[0]          # admission order
    assert t[1] == j[1] == ["doomed"]
    assert t[2] == j[2]          # preemption victims, in order
    assert t[3] == j[3]          # every stream
    assert t[4] == j[4]          # /debug/qos's virtual times
    # the shed request reached no dispatch; the rest equal their oracles
    assert "doomed" not in t[5]
    for req, text in zip(t[6], t[3]):
        if req.request_id == "doomed":
            assert req.slo_outcome == "shed" and text == ""
        else:
            assert text == TTok().decode(tfake.oracle(
                req.prompt_ids, req.max_tokens, 64))
    # page pressure preempted, and the first victim is the overusing
    # tenant's (bulk runs ahead of its 1/5 share)
    assert t[2] and t[2][0].startswith("bulk")
    # gold's four are admitted before bulk's backlog drains
    order = t[0]
    assert max(order.index(f"gold{i}") for i in range(4)) < \
        order.index("bulk11")
    assert t[7] == j[7] == 0     # every reservation settled
