"""QoS admission plane: weighted-fair tenant queuing, deadline-aware
admission, and cost-modeled hedging.

A copy of ``generativeaiexamples_tpu/engine/qos.py`` (standard library
only) with its imports pointed at the port. ``Scheduler._admit`` is FIFO
with bounded bypass, so without this plane one flooding tenant starves the
others and a request whose deadline is already lost still burns prefill
programs. The plane is the policy layer over the signals the other planes
keep (deadlines and burn rates, ``observability/slo.py``; device-time
rates, ``observability/devtime.py``; tenant identity,
``observability/usage.py``):

  * **Weighted fair queuing with virtual time.**  Each tenant owns a
    virtual clock; admitting a request advances it by the request's
    estimated service COST divided by the tenant's weight
    (``APP_QOS_TENANT_WEIGHTS``, e.g. ``"acme=4,other=1,*=1"``).  Cost is
    the usage plane's resource vector basis: device-seconds when the
    device-time ledger holds timed samples (``DEVTIME.phase_rates``),
    token counts otherwise: the same devtime-else-tokens fallback
    ``observability/usage.py`` bills with. On the card the ledger's
    device seconds are a dispatch's stream span, which on this host-bound
    engine is the host's issue time, so the device-seconds basis prices
    the host-bound service rate. The scheduler admits from the tenant with
    the LOWEST virtual time, so a flooding tenant's clock races ahead and
    obeying tenants keep their weighted share; a newly-backlogged tenant's
    clock floors at the global virtual time, so idling never banks
    credit.  Tenants past the cardinality cap fold into the usage plane's
    ``"other"`` bucket, so metric labels stay bounded exactly as
    ``usage_*`` families do.

  * **Earliest-deadline-first within a tenant** plus **shed-before-
    prefill**: at admission, prefill+decode service time is estimated
    (measured phase rates when the ledger has them, ``core/perfmodel``'s
    analytic envelope otherwise) and a sheddable request whose remaining
    deadline budget cannot cover it is shed loudly (``slo_outcome="shed"``)
    before any prefill program is dispatched.

  * **Slack-aware preemption**: page-pressure victim selection weighs
    tenant overuse (virtual-time lead) and SLO slack, not just slot age:
    overusing tenants spill/preempt first, and a stream about to miss its
    deadline is preempted last.

  * **Cost-modeled hedging** (:func:`hedge_delay`, ``server/resilience.py``):
    the router's static hedge delay scales with the candidate worker's
    advertised queue depth and the expected service time.

Gate: ``APP_QOS=off|fair`` (bare env wins over the ``APP_ENGINE_QOS``
config field).  ``off`` is the default and is behavior-identical to the
FIFO scheduler: the scheduler holds no policy object and makes zero qos
calls on the serving path (test-enforced).  Token-rate quotas come from
``APP_QOS_TOKENS_PER_S`` (same ``tenant=value`` map syntax; tenants
without an entry are unmetered).  Surfaces: ``qos_*`` metric families
and ``GET /debug/qos`` (server/common.py).
"""

from __future__ import annotations

import heapq
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability import usage as usage_mod
from generativeaiexamples_tpu_torch.observability.lockwatch import (
    tracked_rlock)
from generativeaiexamples_tpu_torch.observability.usage import env_int

logger = logging.getLogger(__name__)

MODE_ENV = "APP_QOS"
WEIGHTS_ENV = "APP_QOS_TENANT_WEIGHTS"
TOKENS_PER_S_ENV = "APP_QOS_TOKENS_PER_S"

_MODES = ("off", "fair")

# EDF slack is clamped into this band before victim scoring so one
# deadline-free stream (slack = +inf) cannot erase the overuse signal
_SLACK_CAP_S = 600.0


def parse_tenant_map(raw: str, name: str = "") -> Tuple[Dict[str, float],
                                                        Optional[float]]:
    """Parse a ``tenant=value,tenant2=value2,*=default`` map (the
    ``APP_QOS_TENANT_WEIGHTS`` / ``APP_QOS_TOKENS_PER_S`` syntax) into
    ``(per_tenant, default)``.  Tenant keys are sanitized exactly like the
    usage plane's (one identity space); malformed entries warn and drop —
    a typo'd knob must never take the serving path down."""
    out: Dict[str, float] = {}
    default: Optional[float] = None
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            logger.warning("ignoring malformed %s entry %r (want "
                           "tenant=value)", name or "tenant map", part)
            continue
        try:
            num = float(value.strip())
        except ValueError:
            logger.warning("ignoring non-numeric %s entry %r",
                           name or "tenant map", part)
            continue
        key = key.strip()
        if key == "*":
            default = num
            continue
        tenant = usage_mod.sanitize_tenant(key)
        if not tenant:
            logger.warning("ignoring empty tenant key in %s entry %r",
                           name or "tenant map", part)
            continue
        if num <= 0:
            # a zero/negative weight or rate would starve the tenant
            # forever — the no-starvation invariant the fuzz harness
            # asserts; drop loudly instead
            logger.warning("ignoring non-positive %s for tenant %r "
                           "(would starve it)", name or "value", tenant)
            continue
        out[tenant] = num
    return out, default


def request_remaining_s(req: Any, now: Optional[float] = None
                        ) -> Optional[float]:
    """Remaining deadline budget of a scheduler Request right now.
    ``Request.deadline_s`` is the REMAINING budget stamped at submit (the
    cross-process contract — never an absolute instant), so remaining =
    deadline_s - elapsed-since-submit, on the same perf_counter clock the
    timeline stamps use.  None = no deadline."""
    deadline = getattr(req, "deadline_s", None)
    if deadline is None:
        return None
    submitted = getattr(req, "submitted_at", None)
    if submitted is None:
        return float(deadline)
    now = clock.perf() if now is None else now
    return float(deadline) - (now - submitted)


# Cost-modeled hedge trigger: the one implementation lives in
# server/resilience.py (the routing process consumes it without importing
# the engine package); re-exported here because this module is the QoS
# plane's documented surface.
from generativeaiexamples_tpu_torch.server.resilience import hedge_delay  # noqa: E402,F401


def _mono_clock() -> float:
    """Default QosPolicy clock: the injected process clock
    (``core/clock.py``; time.monotonic live)."""
    return clock.mono()


class QosPolicy:
    """Per-process admission policy: WFQ virtual time + EDF + quotas.

    Thread-safety: consulted by the engine driver thread (ordering,
    charges, victim picks) and read by HTTP debug threads; one RLock
    guards the tenant tables.  ``clock`` must be monotonic (tests inject
    a fake — the quota buckets and nothing else read it; request-deadline
    math stays on the perf clock the Request stamps use). The default is
    the process's injected mono clock (core/clock.py)."""

    def __init__(self,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 tokens_per_s: Optional[Dict[str, float]] = None,
                 perf_model: Optional[Any] = None,
                 batch_hint: int = 1,
                 max_tenants: Optional[int] = None,
                 clock=None) -> None:
        self._lock = tracked_rlock("qos._lock")
        self._clock = clock if clock is not None else _mono_clock
        self._weights = dict(weights or {})
        self._default_weight = max(1e-6, float(default_weight))
        self._quota_rate = dict(tokens_per_s or {})
        self._perf = perf_model
        self._batch_hint = max(1, int(batch_hint))
        # bounded identity space: configured tenants are always first-class;
        # the rest admit until the cap, then fold into "other" (the usage
        # plane's overflow bucket — metric labels stay bounded)
        self._max_tenants = max(
            len(self._weights) + len(self._quota_rate) + 2,
            max_tenants if max_tenants is not None
            else env_int("APP_USAGE_MAX_TENANTS", 64))
        self._known = set(self._weights) | set(self._quota_rate)
        # WFQ state: per-tenant virtual clocks + the global floor
        self._vtime: Dict[str, float] = {}
        self._global_v = 0.0
        # lock-free overuse snapshot (tenant_overuse_hint): rebuilt under
        # the lock at every charge/settle/order, read WITHOUT it — the KV
        # tier prices evictions under its own lock, and taking the QoS
        # lock there orders kv_tier._lock -> qos._lock (half a deadlock
        # cycle lockwatch exists to catch)
        self._overuse_snap: Tuple[frozenset, Dict[str, float]] = (
            frozenset(self._known), {})
        # token-bucket quotas: level per metered tenant (starts full at
        # the burst cap = 2 s of rate), last-refill stamp
        self._bucket: Dict[str, float] = {
            t: self._burst(t) for t in self._quota_rate}
        self._refilled_at: Optional[float] = None
        self._throttled_now: set = set()
        # admitted-but-unsettled reservations: request_id -> (tenant,
        # virtual cost charged, quota tokens reserved, the rate basis the
        # cost was computed in).  The fuzz harness asserts this drains to
        # empty through preemptions, evacuations, and driver resets —
        # quota conservation.
        self._outstanding: Dict[str, Tuple[str, float, int,
                                           Optional[Tuple[float,
                                                          float]]]] = {}
        self._depth_tenants: set = set()   # tenants with a nonzero gauge
        # estimate-rate cache (devtime phase_rates takes a lock and walks
        # the ledger; one read per ~250 ms is plenty for admission math)
        self._rates_cache: Tuple[float, Optional[float], Optional[float],
                                 str] = (-1.0, None, None, "none")
        self._est_override: Optional[Tuple[float, float]] = None

    # ------------------------------------------------------------ identity

    def canonical(self, tenant: Any) -> str:
        """The bounded label-safe key ``tenant`` schedules under (folds
        past the cap into ``"other"``, mirroring the usage ledger)."""
        t = usage_mod.sanitize_tenant(tenant) or usage_mod.DEFAULT_TENANT
        with self._lock:
            if (t in self._known or len(self._known) < self._max_tenants
                    or t in (usage_mod.OVERFLOW_TENANT,
                             usage_mod.DEFAULT_TENANT)):
                self._known.add(t)
                return t
        return usage_mod.OVERFLOW_TENANT

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self._default_weight)

    def _burst(self, tenant: str) -> float:
        """Quota bucket capacity: two seconds of the tenant's rate (so a
        paced client rides through scheduler tick jitter), never below
        one token (a positive rate must always make progress)."""
        return max(1.0, 2.0 * self._quota_rate.get(tenant, 0.0))

    # ----------------------------------------------------------- estimates

    def configure_estimate(self, prefill_s_per_tok: Optional[float],
                           decode_s_per_tok: Optional[float]) -> None:
        """Pin explicit service-time rates (tests, bench A/B arms) —
        overrides both the devtime measurement and the analytic model."""
        with self._lock:
            if prefill_s_per_tok is None or decode_s_per_tok is None:
                self._est_override = None
            else:
                self._est_override = (float(prefill_s_per_tok),
                                      float(decode_s_per_tok))
            self._rates_cache = (-1.0, None, None, "none")

    def _rates(self) -> Tuple[Optional[float], Optional[float], str]:
        """(prefill_s_per_tok, decode_s_per_tok, basis).  Preference:
        explicit override → devtime-measured phase rates (the device-time
        ledger's amortized costs) → the analytic perfmodel envelope (prefill
        compute-bound at peak FLOPs; decode weight-read-bound, amortized
        over the configured batch) → (None, None, "none") when nothing
        can estimate (CPU fakes with APP_DEVTIME=off) — shedding then
        never fires, it only ever turns ON with a defensible number."""
        with self._lock:
            if self._est_override is not None:
                pf, dc = self._est_override
                return pf, dc, "override"
            stamp, pf, dc, basis = self._rates_cache
        now = self._clock()
        if stamp >= 0 and now - stamp < 0.25:
            return pf, dc, basis
        pf = dc = None
        basis = "none"
        try:
            from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
            measured = DEVTIME.phase_rates()
            pf, dc = measured.get("prefill"), measured.get("decode")
            if pf is not None and dc is not None:
                basis = "devtime"
        except Exception:
            logger.debug("devtime phase rates unavailable", exc_info=True)
        if basis == "none" and self._perf is not None:
            peak_flops = getattr(self._perf, "peak_flops", None)
            peak_bw = getattr(self._perf, "peak_bw", None)
            if peak_flops and peak_bw:
                pf = 2.0 * self._perf.n_params / peak_flops
                dc = (self._perf.param_bytes / peak_bw) / self._batch_hint
                basis = "analytic"
        with self._lock:
            self._rates_cache = (now, pf, dc, basis)
        return pf, dc, basis

    def estimate_service_s(self, n_prompt: int,
                           max_tokens: int) -> Optional[float]:
        """Expected prefill+decode service seconds for a request, or None
        when no basis exists (shed-before-prefill stays off then)."""
        pf, dc, _basis = self._rates()
        if pf is None or dc is None:
            return None
        return pf * max(0, int(n_prompt)) + dc * max(0, int(max_tokens))

    def _charge_rates(self) -> Optional[Tuple[float, float]]:
        """The (prefill, decode) per-token rates a charge is costed with,
        or None for the token-count basis. Captured ONCE per admission and
        stored with the reservation, so the settle-side true-up always
        subtracts like units — a devtime basis arming mid-request must
        not mix token counts with device-seconds."""
        pf, dc, _basis = self._rates()
        if pf is not None and dc is not None:
            return (pf, dc)
        return None

    @staticmethod
    def _cost_with(rates: Optional[Tuple[float, float]], n_prompt: int,
                   n_out: int) -> float:
        if rates is None:
            return float(n_prompt + n_out)
        pf, dc = rates
        return pf * n_prompt + dc * n_out

    def _cost(self, req: Any) -> float:
        """Virtual-time service cost of one request: device-seconds when
        a rate basis exists, token counts otherwise (the usage plane's
        devtime-else-tokens billing basis)."""
        return self._cost_with(self._charge_rates(),
                               len(getattr(req, "prompt_ids", []) or []),
                               int(getattr(req, "max_tokens", 0) or 0))

    def _cost_actual(self, req: Any,
                     rates: Optional[Tuple[float, float]]) -> float:
        """Realized cost at settle time, in the SAME basis the charge
        used: actual completion tokens, and no prompt component for
        KV-handoff imports (their prefill billed on the prefill worker —
        mirrors usage.bill_request)."""
        imported = getattr(req, "kv_import_s", None) is not None
        n_prompt = 0 if imported else len(
            getattr(req, "prompt_ids", []) or [])
        out_toks = int(getattr(req, "completion_tokens", 0) or 0)
        return self._cost_with(rates, n_prompt, out_toks)

    # ------------------------------------------------------------ ordering

    def _refill_locked(self, now: float) -> None:
        if not self._quota_rate:
            return
        last = self._refilled_at
        self._refilled_at = now
        if last is None:
            return
        dt = max(0.0, now - last)
        for t, rate in self._quota_rate.items():
            self._bucket[t] = min(self._burst(t),
                                  self._bucket.get(t, 0.0) + rate * dt)

    def _edf_key(self, job: Any, now: float) -> Tuple[int, float, float]:
        """Within-tenant order: resumes first (they already streamed to a
        client and may pin spill/grammar state), then earliest remaining
        deadline, then arrival."""
        req = job.request
        resume = bool(getattr(job, "gen_ids", None)) \
            or getattr(job, "spill", None) is not None
        rem = request_remaining_s(req, now)
        return (0 if resume else 1,
                rem if rem is not None else float("inf"),
                getattr(req, "submitted_at", 0.0) or 0.0)

    def order(self, jobs: List[Any], limit: int) -> List[Any]:
        """Admission-priority prefix of the pending queue: per-tenant EDF
        merged by weighted-fair virtual time, quota-throttled tenants held
        back this pass (their jobs stay pending; the bucket refills on the
        injected clock, so every request still eventually dispatches).
        Returns at most ``limit`` jobs; the caller's page-fit /
        bounded-bypass machinery runs unchanged on top."""
        if not jobs:
            # the backlog drained: zero the depth gauges of tenants that
            # had one, or the surface reports a queue that no longer exists
            for t in self._depth_tenants:
                REGISTRY.gauge("qos_queue_depth", labels={"tenant": t}
                               ).set(0)
            self._depth_tenants = set()
            return []
        now_q = self._clock()
        now_req = clock.perf()
        limit = max(0, int(limit))
        buckets: Dict[str, List[Any]] = {}
        for job in jobs:
            buckets.setdefault(self.canonical(job.request.tenant),
                               []).append(job)
        depths = {t: len(js) for t, js in buckets.items()}
        for t, js in buckets.items():
            # only the merge's consumable prefix needs ordering: a flood
            # tenant backlogging thousands must not cost a full sort per
            # admission pass on the driver thread — nsmallest is
            # O(n log limit) and the merge below never reads past `limit`
            if len(js) > limit:
                buckets[t] = heapq.nsmallest(
                    limit, js, key=lambda j: self._edf_key(j, now_req))
            else:
                js.sort(key=lambda j: self._edf_key(j, now_req))
        out: List[Any] = []
        with self._lock:
            self._refill_locked(now_q)
            throttled = {t for t in buckets
                         if t in self._quota_rate
                         and self._bucket.get(t, 0.0) <= 0.0}
            for t in throttled - self._throttled_now:
                REGISTRY.counter("qos_quota_throttles_total",
                                 labels={"tenant": t}).inc()
            self._throttled_now = throttled
            live = [t for t in buckets if t not in throttled]
            vt = {t: max(self._vtime.get(t, self._global_v), self._global_v)
                  for t in buckets}
            if live:
                # the global clock tracks the busiest backlog's floor so
                # a tenant arriving later starts at "now", not at zero
                self._global_v = max(self._global_v,
                                     min(vt[t] for t in live))
            idx = {t: 0 for t in buckets}
            while len(out) < limit:
                cands = [t for t in live if idx[t] < len(buckets[t])]
                if not cands:
                    break
                t = min(cands, key=lambda name: (vt[name], name))
                job = buckets[t][idx[t]]
                idx[t] += 1
                out.append(job)
                vt[t] += self._cost(job.request) / self._weight(t)
            self._publish_overuse_locked()
        # gauges outside the lock (REGISTRY locks internally); tenants
        # whose backlog drained reset to 0 so the surface never lies
        # (depths captured pre-truncation — the gauge reports the real
        # backlog, not the merge's bounded prefix)
        seen = set(buckets)
        for t, depth in depths.items():
            REGISTRY.gauge("qos_queue_depth", labels={"tenant": t}
                           ).set(depth)
        for t in self._depth_tenants - seen:
            REGISTRY.gauge("qos_queue_depth", labels={"tenant": t}).set(0)
        self._depth_tenants = seen
        return out

    # ------------------------------------------------------------- charges

    def charge_admission(self, req: Any) -> None:
        """Charge a FIRST admission: advance the tenant's virtual clock by
        estimated cost / weight, reserve quota tokens (prompt + the full
        generation budget; settle refunds the unrun part), and record the
        reservation for conservation accounting.  Resumes re-admit without
        re-charging — preemption must not double-bill."""
        tenant = self.canonical(getattr(req, "tenant", ""))
        rates = self._charge_rates()
        est = self._cost_with(rates,
                              len(getattr(req, "prompt_ids", []) or []),
                              int(getattr(req, "max_tokens", 0) or 0))
        reserve = (len(getattr(req, "prompt_ids", []) or [])
                   + int(getattr(req, "max_tokens", 0) or 0))
        now = self._clock()
        with self._lock:
            self._refill_locked(now)
            if tenant in self._quota_rate:
                # dip-below-zero semantics: admission requires a positive
                # bucket, the charge may overdraw — a request larger than
                # the burst still makes progress instead of starving
                self._bucket[tenant] = self._bucket.get(tenant, 0.0) \
                    - reserve
            v = max(self._vtime.get(tenant, self._global_v),
                    self._global_v) + est / self._weight(tenant)
            self._vtime[tenant] = v
            rid = str(getattr(req, "request_id", "") or id(req))
            self._outstanding[rid] = (tenant, est, reserve, rates)
            self._publish_overuse_locked()
        REGISTRY.gauge("qos_virtual_time", labels={"tenant": tenant}
                       ).set(round(v, 6))
        REGISTRY.counter("qos_admissions_total",
                         labels={"tenant": tenant}).inc()

    def settle(self, req: Any) -> None:
        """Close a request's reservation at its terminal event (finish,
        failure, evacuation, driver reset): true the tenant's virtual
        clock up/down by actual-vs-estimated cost and refund the unused
        quota reservation.  Idempotent (the reservation pops once), and a
        never-admitted request (shed, oversized) is a no-op."""
        rid = str(getattr(req, "request_id", "") or id(req))
        with self._lock:
            entry = self._outstanding.pop(rid, None)
            if entry is None:
                return
            tenant, est, reserved, rates = entry
            # true-up in the CHARGE's units and through the tenant's
            # weight — the charge advanced the clock by est/weight, so
            # the correction is (actual-est)/weight, or a high-weight
            # tenant finishing under budget would claw back weight-times
            # what it was ever charged
            actual = self._cost_actual(req, rates)
            self._vtime[tenant] = max(
                0.0, self._vtime.get(tenant, 0.0)
                + (actual - est) / self._weight(tenant))
            if tenant in self._quota_rate:
                imported = getattr(req, "kv_import_s", None) is not None
                used = (0 if imported
                        else len(getattr(req, "prompt_ids", []) or [])) \
                    + int(getattr(req, "completion_tokens", 0) or 0)
                self._bucket[tenant] = min(
                    self._burst(tenant),
                    self._bucket.get(tenant, 0.0)
                    + max(0, reserved - used))
            v = self._vtime[tenant]
            self._publish_overuse_locked()
        REGISTRY.gauge("qos_virtual_time", labels={"tenant": tenant}
                       ).set(round(v, 6))

    # ----------------------------------------------------------- shedding

    def should_shed(self, req: Any, n_tokens: int,
                    now: Optional[float] = None) -> Optional[float]:
        """Shed-before-prefill check: the estimated prefill+decode service
        time when the request's remaining deadline budget cannot cover it
        (the caller sheds with that estimate in the error text), else
        None.  No estimate basis, no deadline → never shed here (the
        burn-rate shedder in observability/slo.py still applies)."""
        est = self.estimate_service_s(
            n_tokens, int(getattr(req, "max_tokens", 0) or 0))
        if est is None:
            return None
        rem = request_remaining_s(req, now)
        if rem is None or rem >= est:
            return None
        return est

    def note_shed(self, req: Any) -> None:
        REGISTRY.counter("qos_shed_before_prefill_total",
                         labels={"tenant": self.canonical(
                             getattr(req, "tenant", ""))}).inc()

    # ---------------------------------------------------------- preemption

    def pick_victim(self, jobs: List[Any]) -> Any:
        """Slack-aware page-pressure victim: prefer the job whose tenant
        is furthest AHEAD of the global virtual clock (overuse — the
        flooding tenant pays for the pool pressure it causes), then the
        job with the most SLO slack (it can absorb a spill/recompute
        without breaching), then the youngest admission (the FIFO
        tie-break, so equal-standing tenants behave exactly as before).
        The caller's spill path applies to whoever is picked — overusing
        tenants spill first by construction."""
        now = clock.perf()
        with self._lock:
            vt = dict(self._vtime)
            floor = self._global_v

        def score(job: Any) -> Tuple[float, float, int]:
            tenant = self.canonical(job.request.tenant)
            overuse = max(0.0, vt.get(tenant, floor) - floor)
            rem = request_remaining_s(job.request, now)
            if rem is None:
                slack = _SLACK_CAP_S
            else:
                left = max(0, int(job.request.max_tokens)
                           - len(getattr(job, "gen_ids", []) or []))
                est = self.estimate_service_s(0, left) or 0.0
                slack = min(max(rem - est, -_SLACK_CAP_S), _SLACK_CAP_S)
            return (round(overuse, 4), slack,
                    int(getattr(job, "admit_seq", 0)))

        return max(jobs, key=score)

    def tenant_overuse_s(self, tenant: str) -> float:
        """How far AHEAD of the global virtual clock a tenant is running
        (seconds of weighted service beyond its fair share; 0.0 for
        tenants at or behind the clock). The same overuse signal
        :meth:`pick_victim` ranks on, exported so the prefix KV tier's
        eviction pricing (engine/kv_tier.py) can compose with it: cached
        prefixes contributed by a flooding tenant evict first, exactly
        as that tenant's live jobs spill first."""
        t = self.canonical(tenant)
        with self._lock:
            return max(0.0, self._vtime.get(t, self._global_v)
                       - self._global_v)

    def _publish_overuse_locked(self) -> None:
        """Rebuild the lock-free overuse snapshot (one atomic whole-tuple
        rebind — readers never observe a mid-update dict).  Caller holds
        ``_lock``."""
        g = self._global_v
        snap = {t: v - g for t, v in self._vtime.items() if v > g}
        self._overuse_snap = (frozenset(self._known), snap)

    def tenant_overuse_hint(self, tenant: str) -> float:
        """:meth:`tenant_overuse_s` from the published snapshot, WITHOUT
        taking the QoS lock — the read the prefix KV tier's eviction
        pricing uses *under its own lock* (engine/kv_tier.py).  At most
        one charge/settle/order stale, which is fine for an eviction
        bias; never taking the lock is what keeps the static lock graph
        (and lockwatch's witness graph) free of a kv_tier->qos edge."""
        known, snap = self._overuse_snap
        t = usage_mod.sanitize_tenant(tenant) or usage_mod.DEFAULT_TENANT
        if t not in known:
            t = usage_mod.OVERFLOW_TENANT
        return snap.get(t, 0.0)

    # ----------------------------------------------------------- reporting

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/qos`` body."""
        pf, dc, basis = self._rates()
        with self._lock:
            tenants = sorted(self._known
                             | set(self._vtime) | set(self._bucket))
            body = {
                t: {
                    "weight": self._weight(t),
                    "virtual_time": round(self._vtime.get(t, 0.0), 6),
                    "tokens_per_s": self._quota_rate.get(t),
                    "quota_bucket_tokens": (
                        round(self._bucket[t], 3)
                        if t in self._bucket else None),
                    "throttled": t in self._throttled_now,
                }
                for t in tenants
            }
            out = {
                "enabled": True,
                "mode": "fair",
                "default_weight": self._default_weight,
                "global_virtual_time": round(self._global_v, 6),
                "outstanding_admissions": len(self._outstanding),
                "max_tenants": self._max_tenants,
                "tenants": body,
            }
        out["estimate"] = {
            "basis": basis,
            "prefill_s_per_tok": (round(pf, 9) if pf is not None else None),
            "decode_s_per_tok": (round(dc, 9) if dc is not None else None),
        }
        return out

    # ------------------------------------------------- conservation (tests)

    def outstanding(self) -> int:
        """Open admission reservations — the fuzz harness asserts this
        drains to zero (quota conservation through preemptions,
        evacuations, and driver resets)."""
        with self._lock:
            return len(self._outstanding)


# ---------------------------------------------------------------------------
# process-global registration (the /debug/qos surface answers from here,
# like server/failover.register_router)
# ---------------------------------------------------------------------------

_POLICY: Optional[QosPolicy] = None


def register_policy(policy: Optional[QosPolicy]) -> None:
    global _POLICY
    _POLICY = policy


def current_policy() -> Optional[QosPolicy]:
    return _POLICY


def debug_payload() -> Dict[str, Any]:
    policy = _POLICY
    if policy is None:
        return {"enabled": False, "mode": qos_mode(),
                "hint": "set APP_QOS=fair (engine worker env) to enable "
                        "the admission plane; docs/scheduling.md"}
    return policy.snapshot()


def qos_mode(cfg: Any = None) -> str:
    """Resolve the plane's mode: the bare APP_QOS env wins (the
    APP_DEVTIME / APP_KV_SPILL_MB override convention), else the engine
    config field, else off.  Unknown values warn and fall back to off —
    a typo must never change admission behavior silently to 'sort of
    on'."""
    raw = (os.environ.get(MODE_ENV, "").strip().lower()
           or str(getattr(cfg, "qos", "") or "").strip().lower() or "off")
    if raw not in _MODES:
        logger.warning("unknown %s=%r; falling back to off (valid: %s)",
                       MODE_ENV, raw, "|".join(_MODES))
        return "off"
    return raw


def policy_from_env(cfg: Any = None, perf_model: Any = None,
                    batch_hint: int = 1) -> Optional[QosPolicy]:
    """The scheduler's construction seam: None unless APP_QOS=fair —
    off-mode schedulers hold NO policy object and the admission path
    stays byte-identical FIFO (one ``is not None`` check, the
    APP_CHAOS/APP_DEVTIME zero-overhead pattern)."""
    if qos_mode(cfg) != "fair":
        # an off-mode scheduler REPLACING a fair one must also replace
        # the registration (latest-built wins, like register_router) —
        # /debug/qos must never serve a dead policy's state as enabled
        register_policy(None)
        return None
    weights, w_default = parse_tenant_map(
        os.environ.get(WEIGHTS_ENV, ""), WEIGHTS_ENV)
    quotas, q_default = parse_tenant_map(
        os.environ.get(TOKENS_PER_S_ENV, ""), TOKENS_PER_S_ENV)
    if q_default is not None:
        logger.warning("%s: '*' default rates are not applied (unmetered "
                       "tenants stay unmetered — a universal rate would "
                       "throttle the anon bucket too); name tenants "
                       "explicitly", TOKENS_PER_S_ENV)
    policy = QosPolicy(weights=weights,
                       default_weight=(w_default if w_default is not None
                                       else 1.0),
                       tokens_per_s=quotas,
                       perf_model=perf_model,
                       batch_hint=batch_hint)
    register_policy(policy)
    return policy
