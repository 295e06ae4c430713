"""Engine watchdog: detect a hung dispatch or a stalled scheduler tick and
take the worker out of rotation BEFORE clients time out into it.

Port of ``generativeaiexamples_tpu/engine/watchdog.py``. The hung-dispatch
bound reads the head of the scheduler's in-flight decode dispatches: its
issue instant and steps (``_Dispatch.issued``), which the port's
scheduler stamps when it issues the dispatch.

The scheduler's driver loop already fails loudly on exceptions
(engine/scheduler._loop), but two failure shapes produce no exception at
all: a device dispatch that never completes (wedged runtime, dead tunnel
to the card — the result copy's event never completes) and a
driver thread stuck inside one tick (a pathological compile, a blocked
host call). Both leave ``/health`` green while every stream hangs — the
exact "dead component with /health green" failure mode the rest of the
stack is built to avoid.

The watchdog is a daemon thread polling two heartbeats:

  * **tick heartbeat** — the driver stamps ``scheduler.last_tick_mono``
    every loop iteration; a gap beyond ``APP_WATCHDOG_TICK_STALL_S``
    (default 30 s; the idle loop ticks every 50 ms) while the scheduler
    is running trips ``tick_stall``.
  * **oldest in-flight dispatch** — every decode dispatch rides its
    issue timestamp; the completion bound is MODEL-INFORMED where the
    chip is known: a K-step decode dispatch is weight-read-bound, so its
    expected device time is ``K × param_bytes / peak_hbm_bw``
    (core/perfmodel.py — the same arithmetic the devtime gauges use),
    and the trip bound is ``APP_WATCHDOG_DISPATCH_FACTOR`` (default 200)
    times that, floored at 2 s. On unknown chips (CPU, simulators) the
    absolute ``APP_WATCHDOG_DISPATCH_S`` bound (default 60 s) applies —
    an unknown denominator must never disable the watchdog.

A trip: counts ``engine_watchdog_trips_total{kind}``, records a flight-
recorder event, raises a ``watchdog_<kind>`` hazard through the SLO
pressure plane (observability/slo.py — routers see warn pressure on the
next probe), logs at error, and flips :attr:`healthy` False — the engine's
``/health`` answers 503 while unhealthy, so the routing frontend
(server/failover.py) circuit-breaks the worker away from live traffic.
Recovery is condition-based: when ticks resume and the stuck dispatch
clears, ``healthy`` returns True (each NEW trip is edge-counted).

**Graceful drain** rides the same switch: ``drain()`` (POST /debug/drain)
answers 503 on /health without touching serving — in-flight streams
finish, the router routes new work away, and ``undrain()`` (or
``?off=1``) re-admits the worker. That is the operator's zero-drop
worker-rotation primitive.

Gate: ``APP_WATCHDOG`` = on (default) | off. The thread costs one
monotonic read and two attribute peeks per poll (0.5 s) — nothing rides
the scheduler's hot path.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability import slo as slo_mod
from generativeaiexamples_tpu_torch.observability.flight import FLIGHT

logger = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    """A float env knob with a warn-and-default parse (the reference's
    ``core/config.env_float``)."""
    raw = os.environ.get(name, "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            logger.warning("ignoring non-numeric %s=%r", name, raw)
    return default


def watchdog_enabled() -> bool:
    return (os.environ.get("APP_WATCHDOG", "").strip().lower()
            or "on") != "off"


class EngineWatchdog:
    """Health arbiter for one scheduler (see module doc)."""

    def __init__(self, scheduler: Any,
                 tick_stall_s: Optional[float] = None,
                 dispatch_bound_s: Optional[float] = None,
                 dispatch_factor: Optional[float] = None,
                 poll_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.scheduler = scheduler
        self.tick_stall_s = (tick_stall_s if tick_stall_s is not None
                             else _env_float("APP_WATCHDOG_TICK_STALL_S",
                                             30.0))
        self.dispatch_bound_s = (
            dispatch_bound_s if dispatch_bound_s is not None
            else _env_float("APP_WATCHDOG_DISPATCH_S", 60.0))
        self.dispatch_factor = (
            dispatch_factor if dispatch_factor is not None
            else _env_float("APP_WATCHDOG_DISPATCH_FACTOR", 200.0))
        self.poll_s = poll_s
        self._clock = clock
        self.healthy = True
        self.draining = False
        # live-migration on trip (APP_WATCHDOG_EVACUATE, default on): a
        # trip queues a NON-blocking full evacuation — if/when the driver
        # can still tick, every live slot's mid-decode snapshot parks for
        # the router to resume on peers (scheduler.request_evacuation)
        # instead of stranding in-flight KV on a sick worker. A wedged
        # driver simply never serves the request, and the router's
        # re-prefill fallback owns recovery (the hard-death path).
        self.evacuate_on_trip = (os.environ.get(
            "APP_WATCHDOG_EVACUATE", "").strip().lower() or "on") != "off"
        self._tripped: Dict[str, bool] = {}    # kind -> currently tripped
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # the family exists (0-valued) from startup so a scrape before the
        # first trip still sees the catalog
        REGISTRY.counter("engine_watchdog_trips_total",
                         labels={"kind": "tick_stall"})
        REGISTRY.counter("engine_watchdog_trips_total",
                         labels={"kind": "hung_dispatch"})

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="engine-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def drain(self) -> None:
        """Graceful drain: /health goes 503 (router routes away) while
        serving continues — in-flight streams finish normally."""
        if not self.draining:
            logger.warning("engine drain requested: /health now answers "
                           "503; in-flight streams keep serving")
            REGISTRY.gauge("engine_draining").set(1)
            FLIGHT.event("drain", action="start")
        self.draining = True

    def undrain(self) -> None:
        if self.draining:
            logger.info("engine drain lifted: /health serving again")
            REGISTRY.gauge("engine_draining").set(0)
            FLIGHT.event("drain", action="stop")
        self.draining = False

    # ------------------------------------------------------------- checking

    def _expected_dispatch_s(self, steps: int) -> Optional[float]:
        """Model-informed expected device seconds for a ``steps``-deep
        decode dispatch: decode is weight-read-bound, so steps full
        weight reads at peak HBM bandwidth (core/perfmodel.py) is the
        fastest it can possibly complete."""
        perf = getattr(self.scheduler.core, "perf_model", None)
        if perf is None or not getattr(perf, "peak_bw", None):
            return None
        try:
            return perf.weight_read_bytes(max(1, steps)) / perf.peak_bw
        except Exception as exc:
            logger.debug("watchdog perf bound unavailable: %s", exc)
            return None

    def dispatch_bound(self, steps: int) -> float:
        expected = self._expected_dispatch_s(steps)
        if expected is None:
            return self.dispatch_bound_s
        return max(2.0, self.dispatch_factor * expected)

    def _trip(self, kind: str, detail: Dict[str, Any]) -> None:
        if not self._tripped.get(kind):
            # edge-counted: one trip per continuous incident, not per poll
            self._tripped[kind] = True
            REGISTRY.counter("engine_watchdog_trips_total",
                             labels={"kind": kind}).inc()
            FLIGHT.event("watchdog_trip", kind=kind, **detail)
            slo_mod.SLO.note_hazard(f"watchdog_{kind}", detail)
            logger.error("engine watchdog tripped: %s %s — /health now "
                         "answers 503 until the condition clears",
                         kind, detail)
            if self.evacuate_on_trip and hasattr(self.scheduler,
                                                 "request_evacuation"):
                try:
                    # guard: the DRIVER re-evaluates the conditions at the
                    # instant it can act. A tick_stall trip is stale BY
                    # CONSTRUCTION once the driver is ticking again (it
                    # just stamped the heartbeat), and a transient
                    # hung_dispatch that drained meanwhile must not kill
                    # every live stream on a now-healthy worker.
                    self.scheduler.request_evacuation(
                        wait_s=0.0, reason=f"watchdog_{kind}",
                        guard=self.condition_still_true)
                except Exception as exc:
                    logger.warning("trip evacuation request failed: %s", exc)
        self.healthy = False

    def _clear(self, kind: str) -> None:
        if self._tripped.get(kind):
            self._tripped[kind] = False
            logger.warning("engine watchdog: %s condition cleared", kind)

    def check(self) -> bool:
        """One evaluation pass (the poll loop's body; tests call it
        directly with a fake clock). Returns the resulting health."""
        sched = self.scheduler
        now = self._clock()
        # tick heartbeat
        last_tick = getattr(sched, "last_tick_mono", None)
        running = bool(getattr(sched, "_running", False))
        if running and last_tick is not None \
                and now - last_tick > self.tick_stall_s:
            self._trip("tick_stall",
                       {"stalled_s": round(now - last_tick, 3),
                        "bound_s": self.tick_stall_s})
        else:
            self._clear("tick_stall")
        # oldest in-flight dispatch (racy peek from another thread: the
        # deque may mutate underneath — IndexError just means the pipeline
        # drained, which is the healthy answer)
        hung = False
        try:
            inflight = getattr(sched, "_inflight", None)
            if inflight:
                issued_at, steps = inflight[0].issued
                age = now - issued_at
                bound = self.dispatch_bound(steps)
                if age > bound:
                    hung = True
                    self._trip("hung_dispatch",
                               {"age_s": round(age, 3),
                                "bound_s": round(bound, 3),
                                "steps": int(steps)})
        except (IndexError, TypeError, AttributeError):
            pass
        if not hung:
            self._clear("hung_dispatch")
        self.healthy = not any(self._tripped.values())
        return self.healthy

    def condition_still_true(self) -> bool:
        """Side-effect-free re-evaluation of the trip conditions (no
        trip/clear/counter mutation — safe to call from the scheduler's
        driver thread concurrently with the poll loop): is a tick stall
        or hung dispatch true RIGHT NOW? Guards queued trip-evacuations
        so a condition that cleared while the request waited cancels the
        sweep instead of evacuating a healthy worker."""
        sched = self.scheduler
        now = self._clock()
        last_tick = getattr(sched, "last_tick_mono", None)
        if bool(getattr(sched, "_running", False)) and last_tick is not None \
                and now - last_tick > self.tick_stall_s:
            return True
        try:
            inflight = getattr(sched, "_inflight", None)
            if inflight:
                issued_at, steps = inflight[0].issued
                if now - issued_at > self.dispatch_bound(steps):
                    return True
        except (IndexError, TypeError, AttributeError):
            pass
        return False

    def status(self) -> Dict[str, Any]:
        """The /health body's watchdog block."""
        return {
            "healthy": self.healthy,
            "draining": self.draining,
            "tripped": sorted(k for k, v in self._tripped.items() if v),
            "bounds": {"tick_stall_s": self.tick_stall_s,
                       "dispatch_s": self.dispatch_bound_s,
                       "dispatch_factor": self.dispatch_factor},
        }

    def serving_ok(self) -> bool:
        """Should /health answer 200? False while tripped OR draining."""
        return self.healthy and not self.draining

    # ----------------------------------------------------------------- loop

    def _loop(self) -> None:
        logger.info("engine watchdog started (tick_stall=%.0fs "
                    "dispatch_bound=%.0fs factor=%.0f)",
                    self.tick_stall_s, self.dispatch_bound_s,
                    self.dispatch_factor)
        while self._running:
            try:
                self.check()
            except Exception:
                logger.exception("watchdog check failed")
            time.sleep(self.poll_s)
