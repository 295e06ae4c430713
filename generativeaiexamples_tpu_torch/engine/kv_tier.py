"""Host-RAM spill pool for preempted slots' KV pages.

Port of the request-keyed part of ``generativeaiexamples_tpu/engine/
kv_tier.py`` (``payload_nbytes``, ``spill_budget_bytes``, ``tier_mode``,
``KVSpillPool``). With a byte budget armed (``APP_KV_SPILL_MB`` or
``EngineConfig.kv_spill_mb``), a page-exhaust preemption demotes the
victim's pages to host RAM (``Scheduler._spill_out``) and promotion
re-imports them at re-admission (``Scheduler._admit_spilled``): one
transfer each way, no re-prefill. The pool only accounts: the payloads
ride their jobs, and a spill that would pass the budget is refused, so the
scheduler takes the recompute path.

The reference counts into its metrics registry, which the port lacks until
ROADMAP A.10; the pool counts into the ``stats`` dict it is given (the
scheduler's), as ``kv_spill_<outcome>``. The prefix-addressed tier
(``APP_KV_TIER=prefix``, ``PrefixKVTier``) is the next slice (ROADMAP A.9,
second part): ``tier_mode`` refuses anything but ``off``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional


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
    """``off``: the request-keyed spill pool. The bare env ``APP_KV_TIER``
    wins over ``EngineConfig``'s; any other value than ``off`` raises (the
    prefix tier is not ported yet)."""
    raw = os.environ.get("APP_KV_TIER", "").strip().lower()
    if not raw:
        raw = str(getattr(cfg, "kv_tier", "off") or "off").strip().lower()
    if raw != "off":
        raise NotImplementedError(
            f"APP_KV_TIER={raw!r}: the prefix-addressed host KV tier is not "
            f"served by the PyTorch port yet (ROADMAP A.9, second part)")
    return raw


class KVSpillPool:
    """Byte-budgeted registry of spilled KV payloads, one a request. The
    payloads ride the scheduler's jobs; the pool keeps the host footprint
    under ``budget_bytes``: a spill that would pass it is refused
    (``kv_spill_over_budget``) and the preemption recomputes."""

    def __init__(self, budget_bytes: int,
                 stats: Optional[Dict[str, int]] = None) -> None:
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._bytes: Dict[str, int] = {}
        self._used = 0
        self._stats = stats if stats is not None else {}

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def _count(self, outcome: str) -> None:
        key = f"kv_spill_{outcome}"
        self._stats[key] = self._stats.get(key, 0) + 1

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
