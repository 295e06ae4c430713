"""Deterministic fault-injection plane: prove the failure semantics, don't
hope for them.

A copy of ``generativeaiexamples_tpu/observability/chaos.py`` (standard
library only) with its imports pointed at the port. The port's engine
server gates ``/v1/chat/completions``, ``/v1/completions`` and
``/v1/kv/*`` (``server_fault``: a delay is slept on the handler's thread,
an error answers 503); the scheduler takes the page, spill and tick
faults; ``corrupt_kv`` / ``corrupt_wire`` act on the port's
``core/kv_wire.py`` payloads and frames. The client-side faults serve the
failover router, which is ROADMAP A.17.

The disaggregated dataplane (router → prefill worker → KV handoff → decode
replica) grew real failure paths — circuit-breaking, mid-stream
resume, topology-collapse fallback, handoff validation — but each was only
exercised by the bespoke test that shipped it. This module makes failure a
first-class, *reproducible* input: a seeded schedule of injected faults at
the seams that actually break in production, so the chaos test matrix
(tests/test_chaos.py), the fuzz harness, and ``bench.py --chaos`` can all
drive the same fault classes and assert the same contract — every stream
either completes token-identical after recovery or terminates with a loud
typed error; never a hang, never silent corruption.

Gating follows the ``APP_DEVTIME`` pattern exactly: ``APP_CHAOS`` is
``off`` by default and off means ZERO work on hot paths — call sites guard
on :attr:`ChaosPlane.enabled` (one attribute read) and a tier-1 test
enforces that no fault decision (no RNG draw, no sleep, no counter) ever
happens in off mode (tests/test_chaos.py, the analogue of devtime's
zero-fence test).

Fault catalog (``APP_CHAOS_SPEC``, comma-separated
``fault=prob[/param[/max]]`` entries — ``param`` is fault-specific,
``max`` caps total injections for deterministic "fail N times then
recover" schedules):

  * ``http.delay``  — sleep ``param`` seconds before a dispatch
                      (client side) or before serving (engine side);
  * ``http.drop``   — connection reset on a router→worker dispatch
                      (raises :class:`ChaosConnectionReset`, a
                      ``ConnectionResetError`` — the router's transport-
                      failure path handles it like a real peer death);
  * ``http.error``  — a 5xx: client side raises :class:`ChaosHttpError`
                      (a ``ConnectionError``), engine side answers 503;
  * ``kv.truncate`` — drop the last page row of an exported KV handoff
                      payload (the decode side MUST 409 loudly —
                      ``validate_handoff`` cross-checks buffer shapes);
                      on the BINARY wire (:meth:`ChaosPlane.corrupt_wire`)
                      also truncates the encoded frame's tail — the frame
                      length prefix must 400 it;
  * ``kv.garble``   — corrupt the payload's geometry metadata
                      (page_size), same loud-409 contract; on the binary
                      wire, flips bits inside a raw array segment — only
                      the per-segment crc32 can catch that (loud 400);
  * ``tick.stall``  — sleep ``param`` seconds inside a scheduler tick
                      (what the engine watchdog exists to detect);
  * ``page.exhaust``— force a KV page allocation to fail (pool-pressure
                      preemption storms on demand);
  * ``worker.die``  — raise :class:`ChaosWorkerDeath` inside a scheduler
                      tick: the driver's crash path fails every in-flight
                      request loudly and resets (engine/scheduler._loop).

Determinism: every fault key draws from its own ``random.Random`` stream
seeded by ``(APP_CHAOS_SEED, fault)``, so the decision sequence for one
fault class is a pure function of the seed and that class's call count —
independent of how other fault sites interleave. The same seed + spec +
workload replays the same fault schedule.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

logger = logging.getLogger(__name__)

_MODES = ("off", "on")

# fault -> default param (seconds for delays/stalls; unused otherwise)
_FAULTS: Dict[str, float] = {
    "http.delay": 0.05,
    "http.drop": 0.0,
    "http.error": 0.0,
    "kv.truncate": 0.0,
    "kv.garble": 0.0,
    "tick.stall": 0.05,
    "page.exhaust": 0.0,
    "spill.exhaust": 0.0,
    "worker.die": 0.0,
}

# a deliberately mixed default schedule for `APP_CHAOS=on` with no spec:
# transport flakiness + scheduler stalls + pool pressure, no worker death
DEFAULT_SPEC = ("http.delay=0.05/0.05,http.drop=0.03,http.error=0.03,"
                "tick.stall=0.01/0.05,page.exhaust=0.05,kv.truncate=0.02")


class ChaosFault(Exception):
    """Base of every injected-fault exception — the TYPED part of the
    'loud typed error' contract: a consumer (or test) can always tell an
    injected fault from an organic bug."""


class ChaosConnectionReset(ChaosFault, ConnectionResetError):
    """Injected connection reset on an HTTP dispatch (client side)."""


class ChaosHttpError(ChaosFault, ConnectionError):
    """Injected 5xx-equivalent transport failure (client side)."""


class ChaosWorkerDeath(ChaosFault):
    """Injected engine-driver death: the scheduler loop's crash handler
    fails every in-flight request loudly and resets device state."""


def _env_config() -> Tuple[str, int, str]:
    raw = (os.environ.get("APP_CHAOS", "").strip().lower() or "off")
    if raw not in _MODES:
        logger.warning("APP_CHAOS=%r is not off|on; using off", raw)
        raw = "off"
    try:
        seed = int(os.environ.get("APP_CHAOS_SEED", "") or 0)
    except ValueError:
        seed = 0
    spec = os.environ.get("APP_CHAOS_SPEC", "").strip()
    return raw, seed, spec


def parse_spec(spec: str) -> Dict[str, Tuple[float, float, Optional[int]]]:
    """``fault=prob[/param[/max]]`` entries → {fault: (prob, param, max)}.
    Unknown fault names are a loud ValueError — a typo'd spec silently
    injecting nothing would let a chaos run pass vacuously."""
    out: Dict[str, Tuple[float, float, Optional[int]]] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"chaos spec entry {entry!r} must be "
                             f"fault=prob[/param[/max]]")
        fault, rest = entry.split("=", 1)
        fault = fault.strip()
        if fault not in _FAULTS:
            raise ValueError(f"unknown chaos fault {fault!r}; known: "
                             f"{sorted(_FAULTS)}")
        parts = rest.split("/")
        prob = float(parts[0]) if parts[0] else 1.0
        param = (float(parts[1]) if len(parts) > 1 and parts[1]
                 else _FAULTS[fault])
        cap = (int(parts[2]) if len(parts) > 2 and parts[2] else None)
        out[fault] = (max(0.0, min(1.0, prob)), param, cap)
    return out


class ChaosPlane:
    """Process-global fault injector (``CHAOS``), off by default.

    Hot call sites guard on :attr:`enabled` — when off, no method here is
    even entered (and the tier-1 zero-overhead test enforces that no
    decision is drawn either way). When on, each fault key decides from
    its own seeded RNG stream; every injection counts into
    ``chaos_injections_total{fault,site}``.
    """

    def __init__(self, mode: Optional[str] = None, seed: Optional[int] = None,
                 spec: Optional[str] = None) -> None:
        env_mode, env_seed, env_spec = _env_config()
        self._lock = threading.Lock()
        self._on = (mode if mode in _MODES else env_mode) == "on"
        self._seed = env_seed if seed is None else int(seed)
        self._spec_str = env_spec if spec is None else spec
        try:
            self._faults = parse_spec(self._spec_str or
                                      (DEFAULT_SPEC if self._on else ""))
        except ValueError as exc:
            # env-sourced construction happens at IMPORT in every process
            # (engine, router, chains): a stale/typo'd APP_CHAOS_SPEC must
            # not take the stack down — least so with chaos off. Warn and
            # DISABLE rather than fall back to a default schedule: a typo'd
            # spec silently injecting something else would make a chaos
            # run's numbers lie. configure() (deliberate, runtime) still
            # raises loudly.
            logger.warning("ignoring invalid APP_CHAOS_SPEC (%s); "
                           "chaos DISABLED", exc)
            self._on = False
            self._faults = {}
        self._rngs: Dict[str, random.Random] = {}
        self._counts: Dict[str, int] = {}      # injections per fault
        self._draws: Dict[str, int] = {}       # decisions per fault
        # injectable sleep so tests and the fuzz harness can run stall
        # schedules without real wall-clock cost
        self.sleep = time.sleep

    # ------------------------------------------------------------ lifecycle

    @property
    def enabled(self) -> bool:
        return self._on

    def configure(self, mode: Optional[str] = None,
                  seed: Optional[int] = None,
                  spec: Optional[str] = None) -> None:
        """Runtime override (tests, bench's chaos round). Resets the RNG
        streams and counters so a configured run replays from decision 0."""
        with self._lock:
            if mode is not None:
                if mode not in _MODES:
                    raise ValueError(f"chaos mode must be one of {_MODES}, "
                                     f"got {mode!r}")
                self._on = mode == "on"
            if seed is not None:
                self._seed = int(seed)
            if spec is not None:
                self._spec_str = spec
            self._faults = parse_spec(
                self._spec_str or (DEFAULT_SPEC if self._on else ""))
            self._rngs.clear()
            self._counts.clear()
            self._draws.clear()

    def reset(self) -> None:
        """Back to the environment's configuration (tests) — including
        the injectable sleep, so a test that swapped it cannot leak a
        no-op sleep into later chaos runs in the same process."""
        mode, seed, spec = _env_config()
        self.configure(mode=mode, seed=seed, spec=spec)
        self.sleep = time.sleep

    # ------------------------------------------------------------- deciding

    def _decide(self, fault: str) -> Optional[float]:
        """One deterministic decision for ``fault``: the param when this
        call injects, None otherwise. THE enforcement point of the
        zero-overhead contract — the tier-1 off-mode test monkeypatches
        this and asserts it is never reached."""
        with self._lock:
            entry = self._faults.get(fault)
            if entry is None:
                return None
            prob, param, cap = entry
            if cap is not None and self._counts.get(fault, 0) >= cap:
                return None
            rng = self._rngs.get(fault)
            if rng is None:
                rng = self._rngs[fault] = random.Random(
                    f"{self._seed}:{fault}")
            self._draws[fault] = self._draws.get(fault, 0) + 1
            if rng.random() >= prob:
                return None
            self._counts[fault] = self._counts.get(fault, 0) + 1
        return param

    def _record(self, fault: str, site: str) -> None:
        REGISTRY.counter("chaos_injections_total",
                         labels={"fault": fault, "site": site}).inc()
        logger.info("chaos: injected %s at %s", fault, site)

    # ---------------------------------------------------------------- hooks

    def http_fault(self, site: str) -> None:
        """Client-side HTTP fault at a dispatch site (server/failover.py):
        may sleep (http.delay), raise :class:`ChaosConnectionReset`
        (http.drop), or raise :class:`ChaosHttpError` (http.error). Call
        INSIDE the dispatch's try block so the injected failure takes the
        same retry/circuit-break path a real one would."""
        if not self._on:
            return
        delay = self._decide("http.delay")
        if delay is not None:
            self._record("http.delay", site)
            self.sleep(delay)
        if self._decide("http.drop") is not None:
            self._record("http.drop", site)
            raise ChaosConnectionReset(f"chaos: connection reset at {site}")
        if self._decide("http.error") is not None:
            self._record("http.error", site)
            raise ChaosHttpError(f"chaos: injected 5xx at {site}")

    def server_fault(self, site: str) -> Optional[Tuple[str, float]]:
        """Server-side HTTP fault decision for an async handler (engine/
        server.py): ``("delay", seconds)`` — the handler must await-sleep
        it, never block the loop — or ``("error", 0)`` — answer 503 — or
        None. Drop stays a client-side fault (a server cannot portably
        fake a TCP reset from inside aiohttp)."""
        if not self._on:
            return None
        delay = self._decide("http.delay")
        if delay is not None:
            self._record("http.delay", site)
            return ("delay", delay)
        if self._decide("http.error") is not None:
            self._record("http.error", site)
            return ("error", 0.0)
        return None

    def corrupt_kv(self, payload: Dict[str, Any],
                   site: str = "kv") -> Dict[str, Any]:
        """Maybe corrupt an exported KV handoff payload (prefill side,
        BEFORE wire encoding). Truncation drops the last page row of every
        buffer; garbling bumps the claimed page_size. Either way the
        decode side's ``validate_handoff`` must refuse with a loud 409 —
        the contract this fault class exists to prove (served garbage KV
        would be silent corruption, the one unforgivable outcome)."""
        if not self._on:
            return payload
        if self._decide("kv.truncate") is not None:
            self._record("kv.truncate", site)
            out = dict(payload)
            for key in ("k", "v", "k_s", "v_s"):
                arr = out.get(key)
                if arr is not None and getattr(arr, "ndim", 0) >= 2 \
                        and arr.shape[1] > 0:
                    out[key] = arr[:, :-1]
            return out
        if self._decide("kv.garble") is not None:
            self._record("kv.garble", site)
            out = dict(payload)
            out["page_size"] = int(out.get("page_size", 0) or 0) + 1
            return out
        return payload

    def corrupt_wire(self, body: bytes, site: str = "kv.wire") -> bytes:
        """Maybe corrupt an ENCODED binary KV frame (prefill side, AFTER
        wire encoding — the transport-level counterpart of
        :meth:`corrupt_kv`). Truncation drops the body's tail; garbling
        flips bits inside the segment area. Either way the decode side's
        frame validation (core/kv_wire.decode_kv_frames: length prefix +
        per-segment crc32) must refuse with a loud 400 BEFORE
        ``validate_handoff`` — raw binary segments stay shape-valid under
        bit flips, so without the crc this fault class would be served as
        silent garbage KV (the JSON wire gets its equivalent check free
        from the b64/JSON parse)."""
        if not self._on:
            return body
        if self._decide("kv.truncate") is not None:
            self._record("kv.truncate", site)
            return body[:max(8, len(body) - max(1, len(body) // 4))]
        if self._decide("kv.garble") is not None:
            self._record("kv.garble", site)
            # flip bytes at 3/4 depth: for any real payload that lands in
            # an array segment (headers are a few hundred bytes of a
            # multi-KB body), which only the crc32 can catch
            out = bytearray(body)
            pos = (len(out) * 3) // 4
            for i in range(pos, min(pos + 8, len(out))):
                out[i] ^= 0xFF
            return bytes(out)
        return body

    def tick_fault(self, site: str = "scheduler") -> None:
        """Scheduler-tick fault (engine/scheduler._tick): a stall (sleep —
        the watchdog's tick-heartbeat detects sustained ones) or worker
        death (raise — the driver loop's crash handler fails all in-flight
        requests loudly and resets)."""
        if not self._on:
            return
        stall = self._decide("tick.stall")
        if stall is not None:
            self._record("tick.stall", site)
            self.sleep(stall)
        if self._decide("worker.die") is not None:
            self._record("worker.die", site)
            raise ChaosWorkerDeath(f"chaos: worker death injected at {site}")

    def spill_fault(self, site: str = "kv_spill") -> bool:
        """Force the host spill pool to refuse a demotion (pool-exhaust on
        demand): the scheduler treats True exactly like an over-budget
        pool — the preemption falls back to the recompute path, which must
        stay token-identical (the fuzz spill menus assert it)."""
        if not self._on:
            return False
        if self._decide("spill.exhaust") is not None:
            self._record("spill.exhaust", site)
            return True
        return False

    def page_fault(self, site: str = "kv_pages") -> bool:
        """Force a KV page allocation to fail (pool exhaustion on demand):
        the scheduler treats True exactly like an empty allocator — head-
        of-line waits, page growth preempts the youngest slot."""
        if not self._on:
            return False
        if self._decide("page.exhaust") is not None:
            self._record("page.exhaust", site)
            return True
        return False

    # ------------------------------------------------------------ reporting

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/chaos`` body: mode, seed, active spec, and
        per-fault decision/injection counts."""
        with self._lock:
            faults = {
                fault: {"prob": prob, "param": param, "max": cap,
                        "decisions": self._draws.get(fault, 0),
                        "injected": self._counts.get(fault, 0)}
                for fault, (prob, param, cap) in sorted(self._faults.items())
            }
        return {"mode": "on" if self._on else "off",
                "seed": self._seed,
                "spec": self._spec_str or (DEFAULT_SPEC if self._on else ""),
                "faults": faults}


CHAOS = ChaosPlane()
