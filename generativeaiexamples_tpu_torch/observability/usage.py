"""Fleet usage plane: who spent the chip, per tenant, across workers.

A copy of ``generativeaiexamples_tpu/observability/usage.py`` (standard
library only) with its imports pointed at the port. The failover router
and its fleet aggregation are not ported (ROADMAP A.17): ``/debug/fleet``
answers with this process's local view.

ROADMAP item 4 asks for per-tenant token-rate quotas and weighted fair
queuing — but quotas need something to enforce AGAINST, and until this
module the tree had no tenant concept at all.  Meanwhile the disaggregated
route spans router + prefill + decode processes whose telemetry
never met: each worker answers ``/metrics`` alone, so "what did this
tenant cost the fleet" was unanswerable.  RAGO (arxiv 2503.14649) frames
serving optimization as a measured search — this is the measurement half
the future scheduler/affinity work enforces against, the same way the
devtime ledger is the measurement half of the roofline work.

One process-global ledger (``USAGE``), three layers:

  * **Identity.**  A request's tenant comes from the ``X-Tenant-Id``
    header (or a stable hash of its API key; default ``"anon"``),
    sanitized to a label-safe token.  The failover router forwards the
    header on EVERY dispatch of a logical request — the prefill→handoff
    pair included — and the KV-handoff payload carries it too, so one
    logical chat bills its prefill-worker and decode-replica device time
    to the same tenant.  A contextvar (:func:`set_tenant` /
    :func:`tenant_scope`) propagates the identity through the chain
    server's sync generators onto the router's outbound headers.

  * **Billing.**  The scheduler bills every finished (or failed) request
    a resource vector: queue seconds, prefill/decode device-seconds
    (joined from the DEVTIME per-dispatch ledger by prorating each
    program family's timed device seconds over its useful tokens —
    :meth:`DevtimeLedger.phase_rates`; when ``APP_DEVTIME=off`` leaves no
    timed samples the vector falls back to token counts as the cost
    proxy, ``basis: "tokens"``), tokens in/out, KV **page-seconds**
    (pages held × wall seconds, stamped in scheduler.py at
    alloc/grow/release/export), prefix-hit tokens, and router-side
    retries/hedges.  Per-tenant Prometheus families
    (``usage_requests_total{tenant=...}`` and kin) ride ``/metrics``.

  * **Bounded cardinality.**  Label values are where metrics registries
    die: tenant ids are caller-controlled strings, so the ledger admits
    at most ``APP_USAGE_MAX_TENANTS`` distinct tenants (default 64) and
    folds the rest into the ``"other"`` bucket — test-enforced.

Surfaces: ``GET /debug/usage`` (this process), the compact
``usage_by_tenant`` rollup riding every engine ``/health`` body (the
probe cycle the router already runs), and the router's ``GET
/debug/fleet`` (per-worker role/occupancy/MFU/prefix-hit/watchdog cards
plus the fleet-summed tenant rollups — see server/failover.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import logging
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, Mapping, Optional

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

logger = logging.getLogger(__name__)



def env_int(name: str, default: int) -> int:
    """An int env knob with a warn-and-default parse (the reference's
    ``core/config.env_int``; APP_USAGE_MAX_TENANTS reads through it)."""
    raw = os.environ.get(name, "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r", name, raw)
    return default


DEFAULT_TENANT = "anon"
OVERFLOW_TENANT = "other"

# label-safe tenant tokens: the id becomes a Prometheus label value and a
# JSON key on several debug surfaces — never trusted further than that
_TENANT_RE = re.compile(r"[^A-Za-z0-9_.:\-]")
_TENANT_MAX_LEN = 64


def sanitize_tenant(raw: Any) -> str:
    """Normalize a caller-supplied tenant id to a label-safe token;
    empty/None → ``""`` (callers choose their own default).  A caller
    CLAIMING a sentinel name (``other``/``anon``) is escaped with a
    ``t_`` prefix: real traffic must never alias the ledger's overflow/
    default buckets — a customer named "other" would otherwise absorb
    every folded tenant's bills (and vice versa).  Escaping happens at
    this one extraction boundary, so the identity stays stable across
    the handoff payload round-trip (idempotent re-sanitization)."""
    if raw is None:
        return ""
    tenant = _TENANT_RE.sub("", str(raw).strip())[:_TENANT_MAX_LEN]
    if tenant in (OVERFLOW_TENANT, DEFAULT_TENANT):
        return "t_" + tenant
    return tenant


def tenant_from_headers(headers: Mapping[str, str],
                        default: str = DEFAULT_TENANT) -> str:
    """Extract the request's tenant identity from HTTP headers.

    ``X-Tenant-Id`` wins (the explicit contract, and what the failover
    router stamps on every dispatch).  Without it, an API key
    (``Authorization: Bearer …`` / ``X-Api-Key``) identifies the tenant
    as a short stable blake2b digest — the raw key must never become a
    metric label or debug-surface string.  Neither present → ``default``.
    """
    explicit = sanitize_tenant(headers.get("X-Tenant-Id"))
    if explicit:
        return explicit
    key = (headers.get("Authorization") or headers.get("X-Api-Key")
           or "").strip()
    if key:
        if key.lower().startswith("bearer "):
            key = key[7:].strip()
        if key:
            return "key-" + hashlib.blake2b(
                key.encode("utf-8"), digest_size=5).hexdigest()
    return default


def handoff_tenant(headers: Mapping[str, str],
                   payload: Mapping[str, Any]) -> str:
    """Tenant identity for a KV-handoff admission — one logical chat must
    bill ONE tenant across the disaggregated route, so precedence is:
    explicit ``X-Tenant-Id`` header (the router forwards it on every
    dispatch) → the tenant the prefill worker stamped into the payload →
    API-key hash / ``anon``.  The key hash ranks BELOW the payload tenant
    here (unlike plain endpoints): an auth-fronted decode worker must not
    split the chat's legs across two tenant keys."""
    return (sanitize_tenant(headers.get("X-Tenant-Id"))
            or sanitize_tenant(payload.get("tenant"))
            or tenant_from_headers(headers))


# --------------------------------------------------------------------------
# contextvar propagation (chain server → router outbound headers)
# --------------------------------------------------------------------------

_TENANT_CTX: contextvars.ContextVar[str] = contextvars.ContextVar(
    "usage_tenant", default="")


def set_tenant(tenant: str) -> contextvars.Token:
    return _TENANT_CTX.set(sanitize_tenant(tenant))


def reset_tenant(token: contextvars.Token) -> None:
    _TENANT_CTX.reset(token)


def current_tenant() -> str:
    """The ambient tenant identity ("" when none was admitted) — the
    router reads this onto its outbound ``X-Tenant-Id`` header."""
    return _TENANT_CTX.get()


@contextlib.contextmanager
def tenant_scope(tenant: str):
    token = set_tenant(tenant)
    try:
        yield
    finally:
        reset_tenant(token)


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

_VECTOR_FIELDS = (
    "requests", "errors", "queue_s", "prefill_device_s", "decode_device_s",
    "tokens_in", "tokens_out", "prefix_hit_tokens", "kv_page_s",
    "retries", "hedges", "handoffs",
)


class _TenantVector:
    """Accumulated resource vector for one tenant."""

    __slots__ = _VECTOR_FIELDS + ("first_seen_unix",)

    def __init__(self) -> None:
        for f in _VECTOR_FIELDS:
            setattr(self, f, 0.0)
        self.first_seen_unix = time.time()

    _COUNT_FIELDS = frozenset({"requests", "errors", "tokens_in",
                               "tokens_out", "prefix_hit_tokens", "retries",
                               "hedges", "handoffs"})

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in _VECTOR_FIELDS:
            v = getattr(self, f)
            out[f] = int(v) if f in self._COUNT_FIELDS else round(v, 6)
        out["device_s"] = round(self.prefill_device_s
                                + self.decode_device_s, 6)
        out["first_seen_unix"] = round(self.first_seen_unix, 3)
        return out


class UsageLedger:
    """Process-global per-tenant usage ledger (see module doc).

    Thread-safety: billed from the engine driver thread, router chat
    threads, and test harnesses; one lock guards the tenant map.  Metric
    emission happens outside the lock (REGISTRY has its own locks).
    """

    def __init__(self, max_tenants: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantVector] = {}
        self._max = max(1, max_tenants if max_tenants is not None
                        else env_int("APP_USAGE_MAX_TENANTS", 64))
        self._overflowed = 0        # bill events folded into "other"

    @property
    def max_tenants(self) -> int:
        return self._max

    def configure(self, max_tenants: Optional[int] = None) -> None:
        """Runtime override (tests, bench)."""
        with self._lock:
            if max_tenants is not None:
                self._max = max(1, int(max_tenants))

    def reset(self) -> None:
        """Drop accumulated vectors (tests, bench phases). The Prometheus
        families keep their lifetime values — counters are monotonic."""
        with self._lock:
            self._tenants.clear()
            self._overflowed = 0

    # ----------------------------------------------------------- admission

    def _vec_locked(self, tenant: str):
        """Caller holds the lock. Admits a tenant key, folding NEW tenants
        past the cardinality cap into the overflow bucket — the label
        space on /metrics and every rollup surface stays bounded no
        matter how many distinct ids callers mint.  Returns the
        ``(canonical_key, vector)`` pair so metric labels and ledger rows
        can never disagree."""
        vec = self._tenants.get(tenant)
        if vec is not None:
            return tenant, vec
        if (len(self._tenants) >= self._max
                and tenant not in (OVERFLOW_TENANT, DEFAULT_TENANT)):
            self._overflowed += 1
            tenant = OVERFLOW_TENANT
            vec = self._tenants.get(tenant)
            if vec is not None:
                return tenant, vec
        vec = self._tenants[tenant] = _TenantVector()
        return tenant, vec

    def canonical(self, tenant: Any) -> str:
        """The key a bill for ``tenant`` would land under RIGHT NOW
        (sanitized; overflow-folded past the cap) — what metric labels
        use, so labels and ledger rows can never disagree."""
        t = sanitize_tenant(tenant) or DEFAULT_TENANT
        with self._lock:
            if t in self._tenants or len(self._tenants) < self._max \
                    or t in (OVERFLOW_TENANT, DEFAULT_TENANT):
                return t
        return OVERFLOW_TENANT

    # ------------------------------------------------------------- billing

    def bill_request(self, req: Any) -> str:
        """Bill one finished (or failed) scheduler Request; returns the
        canonical tenant key it landed under.  Called by the scheduler
        BEFORE the request log write and the stream release, so a client
        that reads ``[DONE]`` and immediately polls ``/debug/usage``
        finds its own request already billed.

        Device-seconds join the DEVTIME ledger by proration: each program
        family's timed seconds-per-useful-token rate × this request's
        tokens.  A request admitted via KV handoff (``kv_import_s`` set)
        bills NO prompt tokens and no prefill seconds — its prefill
        worker already billed them, so the fleet-summed vector counts
        each logical chat's prompt exactly once.
        """
        tenant = sanitize_tenant(getattr(req, "tenant", "")) or DEFAULT_TENANT
        imported = getattr(req, "kv_import_s", None) is not None
        prompt_toks = 0 if imported else len(
            getattr(req, "prompt_ids", []) or [])
        out_toks = int(getattr(req, "completion_tokens", 0) or 0)
        hit_toks = int(getattr(req, "prefix_hit_tokens", 0) or 0)
        page_s = float(getattr(req, "kv_page_seconds", 0.0) or 0.0)
        sub = getattr(req, "submitted_at", None)
        adm = getattr(req, "admitted_at", None)
        queue_s = max(0.0, adm - sub) if (sub is not None
                                          and adm is not None) else 0.0
        rates = _phase_rates()
        pf_rate = rates.get("prefill")
        dc_rate = rates.get("decode")
        # prefix-cache hits skipped prefill compute — only the recomputed
        # suffix bills prefill device time
        pf_s = ((prompt_toks - min(hit_toks, prompt_toks)) * pf_rate
                if pf_rate is not None else 0.0)
        dc_s = out_toks * dc_rate if dc_rate is not None else 0.0
        err = bool(getattr(req, "error", None))
        handoff = getattr(req, "finish_reason", None) == "handoff"
        with self._lock:
            key, vec = self._vec_locked(tenant)
            vec.requests += 1
            vec.errors += 1 if err else 0
            vec.queue_s += queue_s
            vec.prefill_device_s += pf_s
            vec.decode_device_s += dc_s
            vec.tokens_in += prompt_toks
            vec.tokens_out += out_toks
            vec.prefix_hit_tokens += hit_toks
            vec.kv_page_s += page_s
            vec.handoffs += 1 if handoff else 0
        # bounded-label Prometheus families, outside the lock
        REGISTRY.counter("usage_requests_total",
                         labels={"tenant": key}).inc()
        if prompt_toks:
            REGISTRY.counter("usage_tokens_total",
                             labels={"tenant": key, "dir": "in"}
                             ).inc(prompt_toks)
        if out_toks:
            REGISTRY.counter("usage_tokens_total",
                             labels={"tenant": key, "dir": "out"}
                             ).inc(out_toks)
        if pf_s:
            REGISTRY.counter("usage_device_seconds",
                             labels={"tenant": key, "phase": "prefill"}
                             ).inc(pf_s)
        if dc_s:
            REGISTRY.counter("usage_device_seconds",
                             labels={"tenant": key, "phase": "decode"}
                             ).inc(dc_s)
        if page_s:
            REGISTRY.counter("usage_kv_page_seconds",
                             labels={"tenant": key}).inc(page_s)
        return key

    def _bump(self, field: str, tenant: Optional[str]) -> str:
        t = sanitize_tenant(tenant) if tenant else current_tenant()
        t = t or DEFAULT_TENANT
        with self._lock:
            key, vec = self._vec_locked(t)
            setattr(vec, field, getattr(vec, field) + 1)
        return key

    def bill_retry(self, tenant: Optional[str] = None) -> None:
        """Count a router retry against the (ambient) tenant — retries
        burn fleet capacity even when the request eventually succeeds."""
        key = self._bump("retries", tenant)
        REGISTRY.counter("usage_retries_total", labels={"tenant": key}).inc()

    def bill_hedge(self, tenant: Optional[str] = None) -> None:
        """Count a launched hedge leg (a deliberate duplicate dispatch)."""
        key = self._bump("hedges", tenant)
        REGISTRY.counter("usage_hedges_total", labels={"tenant": key}).inc()

    # ----------------------------------------------------------- reporting

    def rollup(self) -> Dict[str, Dict[str, float]]:
        """Compact per-tenant rollup riding the engine ``/health`` body —
        the piggyback on the router's existing probe cycle, so keep it
        small: one short-keyed dict per tenant.  Rows are built UNDER the
        lock (as snapshot() does): a concurrent bill must never leak a
        half-applied vector (requests bumped, tokens not yet) into the
        fleet view."""
        with self._lock:
            return {
                t: {
                    "req": int(v.requests),
                    "tok_in": int(v.tokens_in),
                    "tok_out": int(v.tokens_out),
                    "device_s": round(v.prefill_device_s
                                      + v.decode_device_s, 4),
                    "queue_s": round(v.queue_s, 4),
                    "kv_page_s": round(v.kv_page_s, 4),
                    "prefix_hit_tok": int(v.prefix_hit_tokens),
                }
                for t, v in self._tenants.items()
            }

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/usage`` body: full vectors, cap state, and the
        billing basis (``devtime`` when the DEVTIME ledger holds timed
        samples to prorate, ``tokens`` when the off mode left only token
        counts)."""
        rates = _phase_rates()
        with self._lock:
            tenants = {t: v.snapshot() for t, v in self._tenants.items()}
            overflowed = self._overflowed
            cap = self._max
        return {
            "basis": ("devtime"
                      if any(r is not None for r in rates.values())
                      else "tokens"),
            "phase_rates_s_per_token": {
                k: (round(v, 9) if v is not None else None)
                for k, v in rates.items()},
            "max_tenants": cap,
            "n_tenants": len(tenants),
            "overflowed": overflowed,
            "tenants": tenants,
        }


def merge_rollups(rollups: Iterable[Mapping[str, Mapping[str, float]]]
                  ) -> Dict[str, Dict[str, float]]:
    """Fleet-sum per-worker ``usage_by_tenant`` rollups (the router's
    ``/debug/fleet`` aggregation): same-tenant vectors add field-wise, so
    a disaggregated chat's prefill-worker and decode-replica legs land in
    ONE row."""
    out: Dict[str, Dict[str, float]] = {}
    for rollup in rollups:
        if not isinstance(rollup, Mapping):
            continue
        for tenant, vec in rollup.items():
            if not isinstance(vec, Mapping):
                continue
            agg = out.setdefault(str(tenant), {})
            for field, value in vec.items():
                try:
                    agg[field] = round(agg.get(field, 0) + float(value), 4)
                except (TypeError, ValueError):
                    continue
    return out


def _phase_rates() -> Dict[str, Optional[float]]:
    """DEVTIME's prefill/decode seconds-per-token rates (lazy import —
    usage is imported by core-adjacent modules and must not pull the
    ledger's torch dependency at import time)."""
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    return DEVTIME.phase_rates()


def worker_perf_card() -> Dict[str, Any]:
    """Compact chip-utilization card for the engine ``/health`` body —
    the per-worker numbers the router's ``/debug/fleet`` view wants that
    the load surface (running/prefilling/waiting/batch) doesn't carry:
    MFU (max over weight-bearing programs), HBM read util, padding
    waste, and mid-serving recompiles.

    MFU/HBM come from the devtime ledger's trailing-window gauges, which
    HOLD their last value while the engine idles (no decay).  The max
    runs only over programs with a timed commit in the last 60 s
    (``DEVTIME.fresh_programs``) — a one-off prefill burst's 0.5 must
    not read as the current MFU of a decode-only steady state — and
    ``measured_age_s`` carries the overall staleness for the consumer:
    a fully idle worker reports ``mfu: null`` with an old age."""
    from generativeaiexamples_tpu_torch.observability.devtime import DEVTIME
    fresh = DEVTIME.fresh_programs(max_age_s=60.0)
    mfu_series = [value for lk, value in REGISTRY.family("engine_mfu").items()
                  if dict(lk).get("program") in fresh]
    age = DEVTIME.last_timed_age_s()
    return {
        "mfu": round(max(mfu_series), 4) if mfu_series else None,
        "hbm_read_util": round(
            REGISTRY.gauge("engine_hbm_read_util").value, 4),
        "measured_age_s": round(age, 3) if age is not None else None,
        "padding_waste_frac": round(DEVTIME.padding_waste(), 4),
        "recompiles": int(
            REGISTRY.counter("engine_recompiles_total").value),
    }


USAGE = UsageLedger()
