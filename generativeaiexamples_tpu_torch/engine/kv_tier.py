"""Host KV tiers: the request-keyed spill pool and the prefix-addressed tier.

Port of ``generativeaiexamples_tpu/engine/kv_tier.py``. With a byte budget
armed (``APP_KV_SPILL_MB`` or ``EngineConfig.kv_spill_mb``), a page-exhaust
preemption demotes the victim's pages to host RAM (``Scheduler._spill_out``)
and promotion re-imports them at re-admission (``Scheduler._admit_spilled``):
one transfer each way, no re-prefill.

``APP_KV_TIER=off`` (the default) serves :class:`KVSpillPool`: it only
accounts, the payloads ride their jobs, and a spill that would pass the
budget is refused, so the scheduler recomputes.

``APP_KV_TIER=prefix`` serves :class:`PrefixKVTier`, which re-keys the same
pool by the page-chain hashes the device prefix cache computes
(``engine/prefix_cache.chain_hashes``, seeded ``"{epoch}|{adapter}"``):

  * a spilled request contributes its full-page prefix run under those
    hashes, pinned by its request id while the spill is live;
  * when the id releases (promotion, finish, failure, evacuation) the entry
    is retained as refcounted cache: the returning conversation's hit;
  * admission probes the tier for the longest cached prefix of a prompt
    (deepest hash first) and promotes the covered run with a partial page
    import (``EngineCore.import_pages_kv``): no prefill over the span, the
    tail prefills as a fresh admission does;
  * eviction is priced by value (recompute cost x recency x hits); an
    entry with ``refs > 0`` or a live id pin is never evicted;
  * an optional disk tier (``APP_KV_TIER_DISK_MB``) writes retained entries
    behind, on one background thread, as ``core/kv_wire.py`` frames, so a
    RAM eviction demotes instead of dropping. A frame that fails its crc32
    is a loud error and the entry dies: it is never served.

Pricing and counters, as there: ``_recompute_cost`` prices an entry by
``core/perfmodel``'s prefill-seconds estimate when the card's peaks are
known (the engine's ``perf_model``, the H100's), by its token count
otherwise (the CPU). The pools count into ``core/metrics.REGISTRY``
(``kv_spill_total{outcome}``, ``kv_tier_total{outcome}``,
``kv_tier_probe_total{outcome}`` and the ``kv_spill_bytes`` /
``kv_tier_*`` gauges) and, beside it, into the ``stats`` dict they are
given (the scheduler's: ``kv_spill_<outcome>``, ``kv_tier_<outcome>``,
``kv_tier_probe_<hit|miss>``). The lock is ``lockwatch.tracked_lock``.

The QoS plane composes with the price, as there: a contributor's SLO slack
(``engine/qos.request_remaining_s`` at the spill; an undated request is
maximally slack) keeps entries of requests with little slack longest, and
with ``APP_QOS=fair`` the scheduler sets the tenant victim bias
(``set_victim_bias(QosPolicy.tenant_overuse_hint)``), which divides an
entry's value by one plus its tenant's virtual-time lead, so a flooding
tenant's prefixes evict first. The hint reads the policy's published
snapshot without the QoS lock: pricing runs under the tier's lock, and
the tier never orders ``kv_tier._lock`` before ``qos._lock``.
"""

from __future__ import annotations

import atexit
import logging
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.core import clock, kv_wire
from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability.lockwatch import (
    tracked_lock)

logger = logging.getLogger(__name__)

# slack values are clamped here (mirrors engine/qos.py's cap): an undated
# request is "maximally slack", never infinitely valuable
_SLACK_CAP_S = 600.0



def payload_nbytes(payload: Dict[str, Any]) -> int:
    """Host bytes a spilled payload occupies: every array-valued entry (a
    tensor's or an array's ``nbytes``), plus ``prompt_ids`` at 4 bytes a
    token; the other scalars are noise next to the pages."""
    total = 0
    for key, value in payload.items():
        n = getattr(value, "nbytes", None)
        if n is not None:
            total += int(n)
        elif key == "prompt_ids" and value is not None:
            total += 4 * len(value)
    return total


def spill_budget_bytes(cfg: Any = None) -> int:
    """The spill budget in bytes: the bare env ``APP_KV_SPILL_MB`` wins,
    else ``EngineConfig.kv_spill_mb``, else 0 (off: preemption
    recomputes)."""
    raw = os.environ.get("APP_KV_SPILL_MB", "").strip()
    if raw:
        try:
            return max(0, int(float(raw))) * (1 << 20)
        except ValueError:
            pass
    mb = int(getattr(cfg, "kv_spill_mb", 0) or 0)
    return max(0, mb) * (1 << 20)


def tier_mode(cfg: Any = None) -> str:
    """``off`` (default: the request-keyed spill pool) or ``prefix`` (the
    prefix-addressed tier). The bare env ``APP_KV_TIER`` wins over
    ``EngineConfig.kv_tier``; any other value is logged and read as off
    rather than arming a cache the operator did not name."""
    raw = os.environ.get("APP_KV_TIER", "").strip().lower()
    if not raw:
        raw = str(getattr(cfg, "kv_tier", "off") or "off").strip().lower()
    if raw in ("off", "prefix"):
        return raw
    logger.warning("APP_KV_TIER=%r is not off|prefix; tier stays off", raw)
    return "off"


def tier_disk_bytes(cfg: Any = None) -> int:
    """Disk-tier byte budget: the bare env ``APP_KV_TIER_DISK_MB`` wins,
    else ``EngineConfig.kv_tier_disk_mb``, else 0 (no disk tier)."""
    raw = os.environ.get("APP_KV_TIER_DISK_MB", "").strip()
    if raw:
        try:
            return max(0, int(float(raw))) * (1 << 20)
        except ValueError:
            pass
    mb = int(getattr(cfg, "kv_tier_disk_mb", 0) or 0)
    return max(0, mb) * (1 << 20)


def tier_hot_k() -> int:
    """How many hottest prefix hashes ride each /health advert."""
    try:
        return max(0, int(os.environ.get("APP_KV_TIER_HOT_K", "") or 8))
    except ValueError:
        return 8


class KVSpillPool:
    """Byte-budgeted registry of spilled KV payloads, one a request. The
    payloads ride the scheduler's jobs; the pool keeps the host footprint
    under ``budget_bytes``: a spill that would pass it is refused
    (``kv_spill_over_budget``) and the preemption recomputes."""

    _OUTCOMES: Tuple[str, ...] = tuple(
        f"kv_spill_{o}" for o in ("spilled", "over_budget", "promoted",
                                  "dropped", "evacuated"))

    def __init__(self, budget_bytes: int,
                 stats: Optional[Dict[str, int]] = None) -> None:
        self.budget_bytes = int(budget_bytes)
        self._lock = tracked_lock("kv_tier._lock")
        self._bytes: Dict[str, int] = {}
        self._used = 0
        self._stats = stats if stats is not None else {}
        # every outcome's key exists from the start, so a reader that
        # copies the dict never sees it grow under another thread
        for outcome in self._OUTCOMES:
            self._stats.setdefault(outcome, 0)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def __len__(self) -> int:
        with self._lock:
            return len(self._bytes)

    def _count(self, outcome: str, plane: str = "spill") -> None:
        """Count one outcome into the registry and the stats dict, and
        refresh the occupancy gauges."""
        key = f"kv_{plane}_{outcome}"
        self._stats[key] = self._stats.get(key, 0) + 1
        if plane == "spill":
            REGISTRY.counter("kv_spill_total",
                             labels={"outcome": outcome}).inc()
        elif plane == "tier":
            REGISTRY.counter("kv_tier_total",
                             labels={"outcome": outcome}).inc()
        else:
            REGISTRY.counter("kv_tier_probe_total",
                             labels={"outcome": outcome}).inc()
        self._gauge()

    def _gauge(self) -> None:
        REGISTRY.gauge("kv_spill_bytes").set(self._used)

    def admit(self, rid: str, payload: Dict[str, Any]) -> bool:
        """Charge ``payload``'s bytes to the pool; False when over budget
        (the caller takes the recompute path)."""
        n = payload_nbytes(payload)
        with self._lock:
            if rid in self._bytes:
                # a re-spill of the same request replaces its charge
                self._used -= self._bytes.pop(rid)
            if self._used + n > self.budget_bytes:
                self._count("over_budget")
                return False
            self._bytes[rid] = n
            self._used += n
        self._count("spilled")
        return True

    def release(self, rid: str, outcome: str = "promoted") -> Optional[int]:
        """Return a request's bytes to the budget (promoted back, or the
        job ended while spilled); None when it held none."""
        with self._lock:
            n = self._bytes.pop(rid, None)
            if n is None:
                return None
            self._used -= n
        self._count(outcome)
        return n

    def occupancy(self) -> Dict[str, Any]:
        """Point-in-time occupancy snapshot."""
        with self._lock:
            return {"kind": "spill",
                    "budget_bytes": self.budget_bytes,
                    "used_bytes": self._used,
                    "held": len(self._bytes)}


@dataclass
class _TierEntry:
    """One cached prefix run: the payload whose first ``depth`` pages
    are addressable by the chain hashes ``hashes[0..depth-1]``."""

    key: bytes                         # deepest chain hash == identity
    hashes: Tuple[bytes, ...]          # h_0 .. h_{depth-1}
    depth: int                         # full pages covered
    tokens: int                        # depth * page_size (pricing basis)
    payload: Optional[Dict[str, Any]]  # RAM copy; None = disk-resident only
    nbytes: int = 0                    # RAM charge while retained
    linked_rid: str = ""               # live spill pinning this entry
    refs: int = 0                      # checkout pins (promote in flight)
    hits: int = 0
    last_use: float = field(default_factory=clock.mono)
    disk_path: str = ""
    disk_bytes: int = 0
    tenant: str = ""
    slack_s: float = _SLACK_CAP_S      # contributor's SLO slack


class PrefixKVTier(KVSpillPool):
    """Prefix-addressed, refcounted, value-priced KV store (module doc).

    Accounting: the rid registry (inherited) charges live spill payloads;
    ``cached_bytes`` charges retained entries. ``used_bytes`` — the
    budget the operator set — covers BOTH: retaining an entry moves its
    charge from the rid row to the entry, it never doubles it."""

    _OUTCOMES = KVSpillPool._OUTCOMES + tuple(
        f"kv_tier_{o}" for o in (
            "contributed", "retained", "replaced", "evicted", "demoted",
            "evicted_disk", "disk_write", "disk_load", "disk_corrupt",
            "promoted", "import_failed", "hit_tokens", "probe_hit",
            "probe_miss"))

    def __init__(self, budget_bytes: int,
                 disk_budget_bytes: int = 0,
                 disk_dir: Optional[str] = None,
                 half_life_s: float = 300.0,
                 perf_model: Any = None,
                 stats: Optional[Dict[str, int]] = None) -> None:
        super().__init__(budget_bytes, stats)
        # core/perfmodel.PerfModel of the engine: prices entries in
        # prefill seconds where the card's peaks are known
        self._perf = perf_model
        self._entries: Dict[bytes, _TierEntry] = {}
        self._by_hash: Dict[bytes, Tuple[bytes, int]] = {}
        self._rid_link: Dict[str, bytes] = {}
        self._cached = 0
        self._half_life_s = float(half_life_s)
        # QoS composition hook: tenant -> overuse seconds (virtual-time
        # lead). Entries from overusing tenants evict first.
        self._victim_bias: Optional[Callable[[str], float]] = None
        # disk tier (write-behind): ops drain on ONE background thread so
        # file I/O never blocks the driver and never runs under _lock
        self.disk_budget_bytes = int(disk_budget_bytes)
        self._disk_used = 0
        self._disk_dir = disk_dir
        self._disk_q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._disk_thread: Optional[threading.Thread] = None
        self._close_registered = False

    # ------------------------------------------------------------- accounting

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used + self._cached

    @property
    def cached_bytes(self) -> int:
        """RAM bytes held by RETAINED entries (refcount cache), excluding
        live rid-pinned spill payloads."""
        with self._lock:
            return self._cached

    @property
    def disk_used_bytes(self) -> int:
        with self._lock:
            return self._disk_used

    def entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def live_refs(self) -> int:
        """Open pins: checkout refs + live rid links — the fuzz harness
        asserts this drains to zero (refcount conservation through
        preemptions, chaos, and driver resets)."""
        with self._lock:
            return (sum(e.refs for e in self._entries.values())
                    + len(self._rid_link))

    def set_victim_bias(self, fn: Optional[Callable[[str], float]]) -> None:
        """tenant -> overuse seconds (the QoS plane's virtual-time lead);
        entries of overusing tenants evict first. None removes it."""
        self._victim_bias = fn

    def count_tier(self, outcome: str) -> None:
        """Count a promotion's outcome the scheduler decides
        (``kv_tier_promoted``, ``kv_tier_import_failed``)."""
        self._count(outcome, "tier")

    # --------------------------------------------------------------- pricing

    def _gauge(self) -> None:
        REGISTRY.gauge("kv_spill_bytes").set(self._used)
        REGISTRY.gauge("kv_tier_bytes").set(self._cached)
        REGISTRY.gauge("kv_tier_entries").set(len(self._entries))
        if self.disk_budget_bytes:
            REGISTRY.gauge("kv_tier_disk_bytes").set(self._disk_used)

    def _recompute_cost(self, tokens: int) -> float:
        """What re-prefilling ``tokens`` would cost: core/perfmodel's
        prefill-seconds estimate when the card's peaks are known, the
        token count itself otherwise (relative ordering is what eviction
        needs, and an unknown denominator must never price every entry
        at zero)."""
        fn = getattr(self._perf, "prefill_seconds", None)
        est = fn(tokens) if fn is not None else None
        return float(est) if est is not None else float(tokens)

    def _score_locked(self, e: _TierEntry, now: float) -> float:
        """Eviction value (lower evicts first): recompute cost × recency
        decay × hit history, kept longer when the contributor had little
        SLO slack, discounted by the contributing tenant's QoS overuse."""
        value = self._recompute_cost(e.tokens)
        age = max(0.0, now - e.last_use)
        value *= max(0.5 ** (age / self._half_life_s), 1e-3)
        value *= 1.0 + min(e.hits, 8)
        slack = min(max(e.slack_s, 0.0), _SLACK_CAP_S)
        value *= 1.0 + (_SLACK_CAP_S - slack) / _SLACK_CAP_S
        bias = self._victim_bias
        if bias is not None:
            try:
                value /= 1.0 + max(0.0, float(bias(e.tenant) or 0.0))
            except Exception:   # a pricing hook never breaks eviction
                pass
        return value

    # -------------------------------------------------------------- eviction

    def _drop_entry_locked(self, e: _TierEntry, outcome: str) -> None:
        """Remove an entry's RAM presence; full removal when no disk copy
        survives. NEVER called on a pinned entry — the callers filter."""
        if e.payload is not None:
            self._cached -= e.nbytes
            e.payload = None
            e.nbytes = 0
        if e.disk_path and outcome != "evicted_disk":
            self._count("demoted", "tier")
            return   # demoted: the disk copy keeps the entry addressable
        self._entries.pop(e.key, None)
        for h in e.hashes:
            ref = self._by_hash.get(h)
            if ref is not None and ref[0] == e.key:
                del self._by_hash[h]
        if e.disk_path:
            self._disk_used -= e.disk_bytes
            self._disk_q.put(("del", e.disk_path))
        self._count(outcome, "tier")

    def _evict_for_locked(self, need: int) -> None:
        """Value-priced eviction until ``need`` more bytes fit. Only
        unpinned RAM-resident entries are candidates; an entry with a
        checkout ref or a live rid link is untouchable by construction."""
        now = clock.mono()
        while self._used + self._cached + need > self.budget_bytes:
            cands = [e for e in self._entries.values()
                     if e.refs == 0 and not e.linked_rid
                     and e.payload is not None]
            if not cands:
                return
            victim = min(cands, key=lambda e: self._score_locked(e, now))
            self._drop_entry_locked(victim, "evicted")

    # ------------------------------------------------------------ rid plane

    def admit(self, rid: str, payload: Dict[str, Any]) -> bool:
        """Charge a spilled payload, evicting retained cache first when
        the budget demands it — live requests outrank history. False =
        over budget even with every unpinned entry gone (recompute
        fallback, same contract as the base pool)."""
        n = payload_nbytes(payload)
        stale_key: Optional[bytes] = None
        with self._lock:
            if rid in self._bytes:
                self._used -= self._bytes.pop(rid)
                # a re-spill replaces the payload the old entry shares —
                # drop the stale entry rather than serve old arrays
                stale_key = self._rid_link.pop(rid, None)
            if stale_key is not None:
                e = self._entries.get(stale_key)
                if e is not None and e.linked_rid == rid:
                    e.linked_rid = ""
                    self._drop_entry_locked(e, "replaced")
            self._evict_for_locked(n)
            if self._used + self._cached + n > self.budget_bytes:
                self._count("over_budget")
                return False
            self._bytes[rid] = n
            self._used += n
        self._count("spilled")
        return True

    def release(self, rid: str, outcome: str = "promoted") -> Optional[int]:
        """Release a rid's charge. Unlike the base pool, a linked tier
        entry is RETAINED: its bytes move from the rid row to the cached
        plane (no net change against the budget) and the entry becomes an
        evictable, value-priced prefix — the returning-conversation hit."""
        retained: Optional[_TierEntry] = None
        with self._lock:
            n = self._bytes.pop(rid, None)
            if n is None:
                return None
            self._used -= n
            key = self._rid_link.pop(rid, None)
            if key is not None:
                e = self._entries.get(key)
                if e is not None and e.linked_rid == rid:
                    e.linked_rid = ""
                    if e.payload is not None:
                        e.nbytes = payload_nbytes(e.payload)
                        self._cached += e.nbytes
                        e.last_use = clock.mono()
                        retained = e
        self._count(outcome)
        if retained is not None:
            self._count("retained", "tier")
            if self.disk_budget_bytes > 0 and not retained.disk_path:
                # write-behind: the disk copy is made AHEAD of eviction so
                # a later RAM demotion is instant and lossless
                self._ensure_disk_thread()
                self._disk_q.put(("write", retained.key, retained.payload))
        return n

    # ----------------------------------------------------------- tier plane

    def contribute(self, rid: str, hashes: Sequence[bytes],
                   payload: Dict[str, Any], tokens: int,
                   tenant: str = "",
                   slack_s: Optional[float] = None) -> bool:
        """Register a spilled payload's full-page prefix run under its
        chain hashes. The entry shares the rid's payload arrays (zero
        copy) and is pinned by the rid until :meth:`release`."""
        if not hashes:
            return False
        key = bytes(hashes[-1])
        with self._lock:
            if rid not in self._bytes:
                return False   # admit failed or raced a release
            prev = self._entries.get(key)
            if prev is not None:
                if prev.linked_rid and prev.linked_rid != rid:
                    return False   # pinned by another live spill
                if prev.refs > 0:
                    return False   # promote in flight reads its arrays
                self._drop_entry_locked(prev, "replaced")
            e = _TierEntry(
                key=key,
                hashes=tuple(bytes(h) for h in hashes),
                depth=len(hashes),
                tokens=int(tokens),
                payload=payload,
                tenant=str(tenant or ""),
                slack_s=(_SLACK_CAP_S if slack_s is None
                         else min(max(float(slack_s), 0.0), _SLACK_CAP_S)),
                linked_rid=rid,
            )
            self._entries[key] = e
            for i, h in enumerate(e.hashes):
                self._by_hash[h] = (key, i + 1)
            self._rid_link[rid] = key
        self._count("contributed", "tier")
        return True

    def probe(self, hashes: Sequence[bytes]
              ) -> Optional[Tuple[bytes, int]]:
        """Longest cached prefix of a prompt's chain hashes, deepest
        first: ``(entry_key, covered_pages)`` or None. Read-only — the
        caller promotes via :meth:`checkout`/:meth:`checkin`."""
        if not hashes:
            return None
        with self._lock:
            for i in range(len(hashes) - 1, -1, -1):
                ref = self._by_hash.get(bytes(hashes[i]))
                if ref is None:
                    continue
                key, depth = ref
                e = self._entries.get(key)
                if e is None or (e.payload is None and not e.disk_path):
                    continue
                self._count("hit", "tier_probe")
                return key, depth
        self._count("miss", "tier_probe")
        return None

    def checkout(self, key: bytes) -> Optional[Dict[str, Any]]:
        """Pin an entry for a promote and return its payload (RAM, or a
        one-shot disk load — the crc32-framed file either decodes exactly
        or fails loudly and the entry dies). None = evicted since the
        probe, or the disk copy is corrupt; the caller re-prefills. Pair
        every non-None return with :meth:`checkin`."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            e.refs += 1
            e.hits += 1
            e.last_use = clock.mono()
            payload = e.payload
            path = e.disk_path
        if payload is not None:
            return payload
        # disk load: blocking file I/O OUTSIDE the lock. The driver pays
        # one read per promote — comparable to the fetch=True export the
        # spill already does, and strictly cheaper than the re-prefill
        # this load avoids.
        try:
            with open(path, "rb") as f:
                data = f.read()
            payload = kv_wire.decode_kv_frames(data)
        except Exception as exc:
            # corruption is LOUD and terminal for the entry: a bad frame
            # must become a re-prefill, never served garbage KV
            logger.warning("kv tier disk entry %s unreadable (%s); "
                           "dropping", path, exc)
            self._count("disk_corrupt", "tier")
            with self._lock:
                e = self._entries.get(key)
                if e is not None:
                    e.refs = max(0, e.refs - 1)
                    if e.refs == 0 and not e.linked_rid:
                        self._drop_entry_locked(e, "evicted_disk")
            return None
        self._count("disk_load", "tier")
        return payload

    def checkin(self, key: bytes) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.refs = max(0, e.refs - 1)

    # ---------------------------------------------------------- fleet advert

    def hot_stats(self, k: Optional[int] = None) -> Dict[str, Any]:
        """The /health piggyback: tier occupancy + the top-K hottest
        entries' h₀ hex digests (the shareable OPENING page — what a
        router-side conversation key can actually match)."""
        k = tier_hot_k() if k is None else int(k)
        with self._lock:
            now = clock.mono()
            live = [e for e in self._entries.values()
                    if e.payload is not None or e.disk_path]
            live.sort(key=lambda e: self._score_locked(e, now), reverse=True)
            hot: List[str] = []
            for e in live:
                h0 = e.hashes[0].hex()
                if h0 not in hot:
                    hot.append(h0)
                if len(hot) >= k:
                    break
            return {
                "kv_tier_bytes": self._cached,
                "kv_tier_entries": len(self._entries),
                "kv_tier_disk_bytes": self._disk_used,
                "kv_tier_hot": hot,
            }

    def occupancy(self) -> Dict[str, Any]:
        with self._lock:
            live_refs = sum(e.refs for e in self._entries.values())
            return {"kind": "prefix",
                    "budget_bytes": self.budget_bytes,
                    "used_bytes": self._used,
                    "cached_bytes": self._cached,
                    "held": len(self._bytes),
                    "entries": len(self._entries),
                    "live_refs": live_refs,
                    "disk_budget_bytes": self.disk_budget_bytes,
                    "disk_used_bytes": self._disk_used}

    # ------------------------------------------------------------- disk tier

    def _ensure_disk_thread(self) -> None:
        if self._disk_thread is not None and self._disk_thread.is_alive():
            return
        self._disk_thread = threading.Thread(target=self._disk_loop,
                                             name="kv-tier-disk",
                                             daemon=True)
        self._disk_thread.start()
        if not self._close_registered:
            # bounded-join shutdown: a daemon dies mid-os.replace at
            # interpreter exit, leaving a torn .tmp next to the store
            atexit.register(self.close)
            self._close_registered = True

    def close(self, timeout_s: float = 2.0) -> None:
        """Bounded shutdown of the write-behind thread: sentinel-stop,
        then join with a deadline (atexit and the scheduler's drain path
        both land here — shutdown must never hang on a slow disk)."""
        t = self._disk_thread
        if t is None or not t.is_alive():
            return
        self._disk_q.put(None)
        t.join(timeout_s)
        self._disk_thread = None

    def _disk_dir_path(self) -> str:
        if self._disk_dir is None:
            self._disk_dir = os.environ.get("APP_KV_TIER_DISK_DIR", "") or \
                os.path.join(tempfile.gettempdir(),
                             f"gaix_kv_tier_{os.getpid()}")
        os.makedirs(self._disk_dir, exist_ok=True)
        return self._disk_dir

    def _disk_loop(self) -> None:
        """Write-behind drain: encode + write crc32-framed files, then
        publish the path under the lock. All file I/O lives here — never
        under ``_lock``, never on the driver thread."""
        while True:
            op = self._disk_q.get()
            if op is None:
                return
            try:
                if op[0] == "del":
                    try:
                        os.remove(op[1])
                    except OSError:
                        pass
                    continue
                _, key, payload = op
                data = kv_wire.encode_kv_frames(payload)
                path = os.path.join(self._disk_dir_path(),
                                    f"{key.hex()}.kvw")
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
                dead: List[str] = []
                with self._lock:
                    e = self._entries.get(key)
                    if e is None:
                        dead.append(path)
                    else:
                        e.disk_path = path
                        e.disk_bytes = len(data)
                        self._disk_used += len(data)
                        dead = self._enforce_disk_budget_locked()
                for p in dead:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                self._count("disk_write", "tier")
            except Exception:
                logger.exception("kv tier disk write-behind failed")

    def _enforce_disk_budget_locked(self) -> List[str]:
        """Delete lowest-value disk copies past the disk budget; returns
        the file paths for the CALLER to remove outside the lock."""
        dead: List[str] = []
        now = clock.mono()
        while self._disk_used > self.disk_budget_bytes:
            cands = [e for e in self._entries.values()
                     if e.disk_path and e.refs == 0 and not e.linked_rid]
            if not cands:
                break
            victim = min(cands, key=lambda e: self._score_locked(e, now))
            dead.append(victim.disk_path)
            self._disk_used -= victim.disk_bytes
            victim.disk_path = ""
            victim.disk_bytes = 0
            if victim.payload is None:
                self._drop_entry_locked(victim, "evicted_disk")
        return dead

    def drain_disk(self, timeout_s: float = 5.0) -> None:
        """Block until queued write-behind ops have drained (tests)."""
        deadline = clock.mono() + timeout_s
        while not self._disk_q.empty() and clock.mono() < deadline:
            time.sleep(0.01)


# ---------------------------------------------------------------------------
# process-level registry (flight dump / debug surfaces)
# ---------------------------------------------------------------------------

_POOL: Optional[KVSpillPool] = None


def register_pool(pool: Optional[KVSpillPool]) -> None:
    """Record the serving scheduler's spill pool / prefix tier so a
    process-global surface can read its occupancy without holding a
    scheduler reference (the flight recorder's dump,
    ``observability/flight.py``). The last one constructed wins (one serving scheduler a process;
    test schedulers overwrite freely)."""
    global _POOL
    _POOL = pool


def current_pool() -> Optional[KVSpillPool]:
    return _POOL


def occupancy_payload() -> Dict[str, Any]:
    pool = _POOL
    if pool is None:
        return {"enabled": False, "mode": tier_mode(),
                "hint": "set APP_KV_SPILL_MB / APP_KV_TIER=prefix on the "
                        "engine worker to arm the host tier"}
    return pool.occupancy()
