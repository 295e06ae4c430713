"""Injectable clock — the ONE time source scheduler/QoS/KV-tier policy
code reads, so the trace-replay simulator (ops/simulate.py) can drive the
real policy objects on a virtual clock.

Live serving pays one attribute read + one function call over the direct
``time.*`` call; the win is that every duration, deadline, quota refill,
and recency score in policy code is computed from a clock the simulator
owns. A tpulint rule (``clock-injection``, analysis/rules.py) keeps direct
``time.time()``/``time.monotonic()``/``time.perf_counter()`` calls out of
the policy modules so the seam cannot silently erode.

Three faces, matching the codebase's existing clock discipline:

  * :func:`mono`  — interval arithmetic (quota buckets, recency, cadence);
  * :func:`perf`  — request-timeline stamps and deadline math (the
    ``Request`` dataclass's native clock);
  * :func:`wall`  — reported timestamps ONLY, never subtracted.

Under the default :class:`SystemClock` these are exactly
``time.monotonic`` / ``time.perf_counter`` / ``time.time``. A
:class:`VirtualClock` pins mono == perf (one virtual timeline) and offsets
wall from a fixed epoch, so replayed runs are deterministic and
reproducible independent of host speed.

A copy of ``generativeaiexamples_tpu/core/clock.py`` (standard library
only), kept in the port because the port imports nothing of that package.
The host KV tier (``engine/kv_tier.py``) reads :func:`mono`. The replay
simulator and the lint rule named above are not ported (ROADMAP A.17).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class SystemClock:
    """The live default: thin pass-throughs to the stdlib clocks."""

    virtual = False

    def mono(self) -> float:
        return time.monotonic()

    def perf(self) -> float:
        return time.perf_counter()

    def wall(self) -> float:
        return time.time()


class VirtualClock:
    """Simulator-owned timeline: time moves only when :meth:`advance` is
    called. ``mono`` and ``perf`` read the SAME value — in a simulated
    run there is exactly one notion of now — and ``wall`` is that value
    plus a fixed epoch so trace records still carry plausible absolute
    stamps."""

    virtual = True

    def __init__(self, start: float = 0.0, wall_epoch: float = 1.7e9):
        self._now = float(start)
        self._wall_epoch = float(wall_epoch)

    def mono(self) -> float:
        return self._now

    def perf(self) -> float:
        return self._now

    def wall(self) -> float:
        return self._wall_epoch + self._now

    def advance(self, dt: float) -> float:
        """Move virtual time forward by ``dt`` seconds (never backward —
        a negative step would violate every monotonic-clock assumption
        the policy code makes)."""
        if dt > 0:
            self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        if t > self._now:
            self._now = float(t)
        return self._now


_active: SystemClock = SystemClock()
_install_lock = threading.Lock()


def active():
    """The currently installed clock object (SystemClock unless a
    simulator installed a virtual one)."""
    return _active


def is_virtual() -> bool:
    return getattr(_active, "virtual", False)


def mono() -> float:
    return _active.mono()


def perf() -> float:
    return _active.perf()


def wall() -> float:
    return _active.wall()


def install(clock) -> None:
    """Swap the process-wide clock. Simulator-only: live servers never
    call this; tests restore via :func:`reset` / :func:`use`."""
    global _active
    with _install_lock:
        _active = clock


def reset() -> None:
    install(SystemClock())


@contextmanager
def use(clock):
    """Scoped install — the simulator's run loop and tests wrap episodes
    in this so a crashed run cannot leak virtual time into live code."""
    prev = _active
    install(clock)
    try:
        yield clock
    finally:
        install(prev)
