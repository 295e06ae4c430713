"""Compatibility path of the spill pool, as the reference keeps one: the
pool lives in ``engine/kv_tier.py``."""

from __future__ import annotations

from generativeaiexamples_tpu_torch.engine.kv_tier import (  # noqa: F401
    KVSpillPool,
    payload_nbytes,
    spill_budget_bytes,
    tier_mode,
)

__all__ = ["KVSpillPool", "payload_nbytes", "spill_budget_bytes",
           "tier_mode"]
