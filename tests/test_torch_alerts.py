"""The port's burn-rate alerts (``observability/alerts.py``) against the
reference's, on the CPU.

Every case of the reference's ``tests/test_alerts.py`` runs on both
packages (``pkg``), each manager on a shared ``FakeClock``, so both burn
windows are hand-computable: with target=0.9 the error budget is 0.1,
and burn = (bad/total)/0.1 (10 bad of 20 events is a burn of 5.0: warn
at 2, not critical at 8). The cases: per-objective badness, hand-computed
burn rates, the min-events gate, both windows must burn, the raise,
escalate and clear edges (gauges, FLIGHT events, the raise log), the
coupling into the SLO hazard, per-tenant isolation and the cardinality
fold, the evaluate TTL, the payload shape and reset. The numbers are host
arithmetic and compared exactly (``pytest.approx`` only where the
reference's case uses it for a hand-computed burn).

Beside them: one numpy-seeded stream of verdicts, tenants and clock
advances through both packages' managers gives the same active set at
every step and the same raise log.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from generativeaiexamples_tpu.core.metrics import REGISTRY as JREG
from generativeaiexamples_tpu.observability import alerts as jalerts
from generativeaiexamples_tpu.observability import flight as jflight
from generativeaiexamples_tpu.observability import slo as jslo
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY as TREG
from generativeaiexamples_tpu_torch.observability import alerts as talerts
from generativeaiexamples_tpu_torch.observability import flight as tflight
from generativeaiexamples_tpu_torch.observability import slo as tslo

PKGS = {
    "jax": SimpleNamespace(alerts=jalerts, REG=JREG, FLIGHT=jflight.FLIGHT,
                           slo=jslo),
    "torch": SimpleNamespace(alerts=talerts, REG=TREG,
                             FLIGHT=tflight.FLIGHT, slo=tslo),
}

KNOBS = dict(target=0.9, fast_window_s=300.0, slow_window_s=3600.0,
             warn_burn=2.0, critical_burn=8.0, min_events=10)


class FakeClock:
    def __init__(self, t: float = 10_000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def mgr(pkg):
    # the flight ring is process-global: another test's alert events of
    # the same names must not count here
    pkg.FLIGHT.clear()
    clk = FakeClock()
    m = pkg.alerts.AlertManager(clock_fn=clk, **KNOBS)
    yield m, clk
    m.reset()
    pkg.slo.SLO.reset()      # note_hazard coupling floors global pressure


def _req(tenant="acme"):
    return SimpleNamespace(tenant=tenant)


def _verdict(outcome="attained", cls="burnmath", breaches=None):
    v = {"class": cls, "outcome": outcome}
    if breaches:
        v["breaches"] = breaches
    return v


def _feed(m, n_bad, n_good, cls="burnmath", tenant="acme"):
    for _ in range(n_bad):
        m.observe(_req(tenant), _verdict("breached", cls))
    for _ in range(n_good):
        m.observe(_req(tenant), _verdict("attained", cls))


def _active(m, name):
    return {a["alert"]: a for a in m.evaluate(force=True)}.get(name)


# --------------------------------------------------------- badness rules

def test_is_bad_per_objective(pkg):
    _is_bad = pkg.alerts._is_bad
    assert _is_bad("goodput", {"outcome": "breached"})
    assert _is_bad("goodput", {"outcome": "error"})
    assert _is_bad("goodput", {"outcome": "shed"})
    assert not _is_bad("goodput", {"outcome": "attained"})
    # ttft/tpot: only their own breach dimension (or a hard error) —
    # a shed request never saw a first token, so it scores neither
    v = {"outcome": "breached", "breaches": {"ttft": {"observed_s": 9}}}
    assert _is_bad("ttft", v)
    assert not _is_bad("tpot", v)
    assert not _is_bad("ttft", {"outcome": "shed"})
    assert _is_bad("tpot", {"outcome": "error"})
    assert not _is_bad("ttft", {"outcome": "attained"})


# ----------------------------------------------------- hand-computed math

def test_burn_rate_hand_computed_warn_not_critical(mgr):
    m, _clk = mgr
    # 10 bad / 20 total, budget 0.1: burn = 0.5/0.1 = 5.0 → ≥ warn(2),
    # < critical(8); both windows see the same 20 events
    _feed(m, n_bad=10, n_good=10)
    row = _active(m, "goodput:class:burnmath")
    assert row is not None
    assert row["severity"] == "warn"
    assert row["fast_burn"] == pytest.approx(5.0)
    assert row["slow_burn"] == pytest.approx(5.0)
    # the tenant scope alerts independently with identical math
    trow = _active(m, "goodput:tenant:acme")
    assert trow is not None and trow["fast_burn"] == pytest.approx(5.0)
    # ttft saw no ttft-dimension breaches: quiet
    assert _active(m, "ttft:class:burnmath") is None


def test_min_events_gate(mgr):
    m, _clk = mgr
    # 9 events, all bad: burn = 10.0 but under min_events(10) → no alert
    _feed(m, n_bad=9, n_good=0)
    assert m.evaluate(force=True) == []
    # the 10th event crosses the gate → critical (burn 10.0 ≥ 8)
    _feed(m, n_bad=1, n_good=0)
    row = _active(m, "goodput:class:burnmath")
    assert row is not None and row["severity"] == "critical"


def test_both_windows_must_burn(mgr):
    """A fast-window cliff over a healthy long history must NOT page:
    the slow window gates one-blip noise (the SRE multi-window rule)."""
    m, clk = mgr
    _feed(m, n_bad=0, n_good=100)          # long healthy history
    clk.advance(600.0)                     # past fast(300), inside slow
    _feed(m, n_bad=10, n_good=10)
    row = _active(m, "goodput:class:burnmath")
    # fast burn = 5.0 but slow = (10/120)/0.1 ≈ 0.83 < warn(2) → quiet
    assert row is None
    # once the healthy history ages out of the slow window, the same
    # fast-window signal fires
    clk.advance(3601.0)
    _feed(m, n_bad=10, n_good=10)
    row = _active(m, "goodput:class:burnmath")
    assert row is not None and row["severity"] == "warn"


# --------------------------------------------------- raise / clear edges

def test_raise_escalate_clear_edges(pkg, mgr):
    m, clk = mgr
    REGISTRY, FLIGHT = pkg.REG, pkg.FLIGHT
    warn_fired0 = REGISTRY.counter("alerts_fired_total",
                                   labels={"severity": "warn"}).value
    crit_fired0 = REGISTRY.counter("alerts_fired_total",
                                   labels={"severity": "critical"}).value
    name = "goodput:class:edges"

    _feed(m, n_bad=10, n_good=10, cls="edges")   # burn 5.0 → warn
    assert _active(m, name)["severity"] == "warn"
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "warn"}).value == 1
    # both the class and tenant scopes raised: +2 on the severity counter
    assert REGISTRY.counter("alerts_fired_total",
                            labels={"severity": "warn"}
                            ).value == warn_fired0 + 2
    since = _active(m, name)["since_mono"]

    _feed(m, n_bad=80, n_good=0, cls="edges")    # 90/100 bad → 9.0 ≥ 8
    row = _active(m, name)
    assert row["severity"] == "critical"
    assert row["since_mono"] == since       # escalation, not a new alert
    # the warn gauge dropped when the severity escalated
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "warn"}).value == 0
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "critical"}).value == 1
    assert REGISTRY.counter("alerts_fired_total",
                            labels={"severity": "critical"}
                            ).value == crit_fired0 + 2

    # the raise edges published FLIGHT events and the raise-edge log
    ev = [e for e in FLIGHT.events()
          if e.get("event") == "alert_raised" and e.get("alert") == name]
    assert len(ev) == 2                     # warn, then critical
    assert [r["severity"] for r in m.fired()
            if r["alert"] == name] == ["warn", "critical"]

    # fast window empties → under min_events → clear edge
    clk.advance(400.0)
    assert _active(m, name) is None
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "critical"}).value == 0
    cleared = [e for e in FLIGHT.events()
               if e.get("event") == "alert_cleared"
               and e.get("alert") == name]
    assert len(cleared) == 1


def test_raise_couples_into_slo_hazard(pkg, mgr):
    m, _clk = mgr
    slo_mod = pkg.slo
    slo_mod.SLO.reset()
    _feed(m, n_bad=20, n_good=0)
    m.evaluate(force=True)
    payload = slo_mod.SLO.debug_payload()
    assert payload["hazard_active"]
    kinds = {h["kind"] for h in payload["recent_hazards"]}
    assert any(k.startswith("alert:goodput") for k in kinds)


# ------------------------------------------------------ tenant isolation

def test_per_tenant_isolation(mgr):
    """One noisy tenant must not page its neighbors: the noisy tenant's
    scope alerts while the quiet tenant's stays green (the shared class
    scope sees the blend)."""
    m, _clk = mgr
    for _ in range(20):
        m.observe(_req("noisy"), _verdict("breached", cls="iso"))
    for _ in range(200):
        m.observe(_req("quiet"), _verdict("attained", cls="iso"))
    active = {a["alert"] for a in m.evaluate(force=True)}
    assert "goodput:tenant:noisy" in active
    assert "goodput:tenant:quiet" not in active
    # class blend: 20/220 bad → burn ≈ 0.91 < warn(2) → no class page
    assert "goodput:class:iso" not in active


def test_tenant_scope_cardinality_folds_to_other(mgr):
    m, _clk = mgr
    for i in range(40):
        m.observe(_req(f"t{i}"), _verdict("breached", cls="card"))
    scopes = {s for (_obj, s) in m._windows if s.startswith("tenant:")}
    # bounded: the cap plus the overflow bucket, never 40 series
    assert len(scopes) <= 9
    assert "tenant:other" in scopes


# ----------------------------------------------------------- TTL + payload

def test_evaluate_ttl_caches_between_observes(mgr):
    m, clk = mgr
    _feed(m, n_bad=10, n_good=10)
    assert _active(m, "goodput:class:burnmath") is not None
    # within the TTL a non-forced evaluate is a cached dict walk
    clk.advance(0.5)
    assert any(a["alert"] == "goodput:class:burnmath"
               for a in m.evaluate())
    # forcing re-evaluates immediately
    assert any(a["alert"] == "goodput:class:burnmath"
               for a in m.evaluate(force=True))


def test_payload_shape(mgr):
    m, clk = mgr
    _feed(m, n_bad=20, n_good=0)
    clk.advance(2.0)           # past the eval TTL: payload() re-evaluates
    body = m.payload()
    assert body["objectives"] == ["goodput", "ttft", "tpot"]
    assert body["rules"]["target"] == 0.9
    assert body["rules"]["windows_s"] == {"fast": 300.0, "slow": 3600.0}
    assert body["rules"]["thresholds"] == {"warn": 2.0, "critical": 8.0}
    assert body["rules"]["min_events"] == 10
    assert body["fired_total"] >= 1
    assert body["recent_fired"][-1]["alert"].startswith("goodput:")
    assert body["active"]


def test_reset_zeroes_gauges(pkg, mgr):
    m, _clk = mgr
    REGISTRY = pkg.REG
    _feed(m, n_bad=20, n_good=0)
    m.evaluate(force=True)
    name = "goodput:class:burnmath"
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "critical"}).value == 1
    m.reset()
    assert REGISTRY.gauge("alert_active",
                          labels={"alert": name,
                                  "severity": "critical"}).value == 0
    assert m.active() == [] and m.fired() == []


# ------------------------------------------- one seeded stream, both packages

def _stream(seed, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        outcome = ("attained", "breached", "error", "shed")[
            int(rng.choice(4, p=[0.6, 0.25, 0.05, 0.1]))]
        breaches = {}
        if outcome == "breached":
            for obj in ("ttft", "tpot"):
                if rng.random() < 0.6:
                    breaches[obj] = {"observed_s": float(rng.random())}
        out.append((float(rng.exponential(8.0)),
                    f"t{int(rng.integers(0, 12))}",
                    ("interactive", "batch")[int(rng.integers(0, 2))],
                    outcome, breaches))
    return out


def test_seeded_stream_edges_match_the_reference():
    steps = _stream(3)

    def run(p):
        clk = FakeClock()
        m = p.alerts.AlertManager(clock_fn=clk, **KNOBS)
        seen = []
        try:
            for dt, tenant, cls, outcome, breaches in steps:
                clk.advance(dt)
                v = {"class": cls, "outcome": outcome}
                if breaches:
                    v["breaches"] = breaches
                m.observe(SimpleNamespace(tenant=tenant), v)
                seen.append(sorted((a["alert"], a["severity"], a["fast_burn"],
                                    a["slow_burn"], a["since_mono"])
                                   for a in m.evaluate(force=True)))
            return seen, m.fired(), sorted(s for (_o, s) in m._windows)
        finally:
            m.reset()
            p.slo.SLO.reset()

    j, t = run(PKGS["jax"]), run(PKGS["torch"])
    assert t == j
    assert any(seen for seen in t[0]) and t[1]   # the stream raised alerts
    assert "tenant:other" in t[2]                # and folded tenants
