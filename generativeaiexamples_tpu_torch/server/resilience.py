"""Unified resilience policy: jittered backoff, retry budgets, deadline-aware
retry cutoff, and hedged dispatch — ONE copy for every retry loop.

Before this module, retry/timeout/backoff discipline was scattered: the
failover router retried back-to-back with no delay, the supervisor's
restart backoff was ``min(2**restarts, 60)`` with no jitter (a crashed
stack restarts as a synchronized herd), and the event agent slept a linear
``retry_delay_s * attempt``. Each was individually defensible and jointly
incoherent — and none of them knew about the SLO plane, so a request
whose deadline had already passed would still burn pool capacity on
retries nobody could use.

Policy pieces (each independently usable; :class:`ResiliencePolicy`
composes them for the router's loops):

  * **Full-jitter exponential backoff** (:func:`full_jitter_backoff`):
    ``uniform(0, min(cap, base * 2^attempt))`` — the AWS-architecture
    result: full jitter decorrelates a retry (or restart) herd better
    than equal or decorrelated jitter at the same mean delay.
  * **Retry budget** (:class:`RetryBudget`): a token bucket refilled by
    *first attempts* (``ratio`` tokens each, capped at ``burst``) and
    spent by retries. Under a sustained outage total retries across the
    pool are bounded by ``ratio × requests + burst`` — a retry storm can
    amplify an outage by at most ``1 + ratio``, instead of
    ``max_attempts``× (the classic metastable-failure amplifier).
  * **Deadline-aware cutoff**: a retry that cannot finish before the
    request's SLO deadline (observability/slo.py admission context) is
    shed, not attempted — the capacity goes to requests that can still
    meet their objective. ``retries_denied_total{pool,reason}`` counts
    every budget/deadline/attempt-cap denial.
  * **Hedged dispatch** (:func:`hedged_call`): launch the secondary when
    the primary hasn't produced a result within the hedge delay; first
    success wins, losers are handed to ``cancel``. The router uses this
    for KV-handoff opens against the second-least-loaded decode replica
    (``APP_ROUTER_HEDGE_S``) — tail-latency insurance priced at one
    duplicate dispatch, never a correctness mechanism.

Everything takes injectable ``rng``/``sleep``/``clock`` so tests pin exact
delays; metrics ride the shared REGISTRY.

Port of ``generativeaiexamples_tpu/server/resilience.py``: when
``before_retry`` is given no ``deadline_s`` it reads the ambient SLO
admission's remaining budget (``observability/slo.remaining_s``; None
outside an admission context, where no deadline applies).
"""

from __future__ import annotations

import logging
import queue as queue_mod
import random
import threading
import time
from typing import Any, Callable, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY

logger = logging.getLogger(__name__)

_RNG = random.Random()


def full_jitter_backoff(attempt: int, base_s: float = 0.5,
                        cap_s: float = 60.0,
                        rng: Optional[random.Random] = None) -> float:
    """Delay before retry/restart number ``attempt`` (1-based): uniform in
    ``[0, min(cap_s, base_s * 2^(attempt-1))]`` — full jitter, so N
    processes backing off together spread instead of thundering in sync
    (the supervisor's restart herd, the router's retry burst)."""
    ceiling = min(float(cap_s), float(base_s) * (2.0 ** max(0, attempt - 1)))
    return (rng or _RNG).uniform(0.0, ceiling)


class RetryBudget:
    """Token-bucket retry budget for one pool.

    ``note_request()`` (every FIRST attempt) deposits ``ratio`` tokens,
    capped at ``burst``; ``try_spend()`` (every retry) consumes one token
    or refuses. The bucket starts full so cold-start blips retry freely;
    under a sustained outage the spend rate is bounded by the deposit
    rate — amplification ≤ 1 + ratio.
    """

    def __init__(self, name: str = "pool", ratio: float = 0.2,
                 burst: float = 10.0) -> None:
        self.name = name
        self.ratio = float(ratio)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def note_request(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
        REGISTRY.counter("retry_budget_exhausted_total",
                         labels={"pool": self.name}).inc()
        return False


class ResiliencePolicy:
    """Retry gate for one pool's dispatch loops: attempt cap + retry budget
    + deadline cutoff + jittered backoff, in one call.

    Usage (the router's shape)::

        for attempt in range(policy.max_attempts):
            if attempt and not policy.before_retry(attempt):
                break                      # denied: budget/deadline/cap
            try:
                ... dispatch ...
                return
            except TransportError:
                continue

    ``before_retry`` returns False (recording why) instead of raising so
    the caller's existing last-error reporting stays intact.
    """

    def __init__(self, name: str, max_attempts: int = 4,
                 base_s: float = 0.05, cap_s: float = 2.0,
                 budget: Optional[RetryBudget] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.name = name
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.budget = budget
        self._rng = rng or _RNG
        self._sleep = sleep

    def note_request(self) -> None:
        """Call once per logical request (first attempt): feeds the retry
        budget's token deposit."""
        if self.budget is not None:
            self.budget.note_request()

    def backoff_s(self, attempt: int) -> float:
        return full_jitter_backoff(attempt, self.base_s, self.cap_s,
                                   self._rng)

    def _deny(self, reason: str) -> bool:
        REGISTRY.counter("retries_denied_total",
                         labels={"pool": self.name, "reason": reason}).inc()
        logger.info("retry denied for pool %s: %s", self.name, reason)
        return False

    def before_retry(self, attempt: int,
                     deadline_s: Optional[float] = None) -> bool:
        """Gate retry number ``attempt`` (1-based; attempt 0 is the first
        try and is never gated). Checks the attempt cap, the pool's retry
        budget, and the request's remaining SLO deadline (the ambient
        admission context when ``deadline_s`` is None — a request past its
        deadline is shed, not retried); on approval sleeps the jittered
        backoff and returns True."""
        if attempt >= self.max_attempts:
            return self._deny("attempts")
        delay = self.backoff_s(attempt)
        if deadline_s is None:
            from generativeaiexamples_tpu_torch.observability import (
                slo as slo_mod)
            deadline_s = slo_mod.remaining_s()
        if deadline_s is not None and deadline_s <= delay:
            # the backoff alone would eat the remaining budget: nothing
            # this retry produces can arrive before the deadline
            return self._deny("deadline")
        if self.budget is not None and not self.budget.try_spend():
            return self._deny("budget")
        REGISTRY.counter("retry_attempts_total",
                         labels={"pool": self.name}).inc()
        if delay > 0:
            self._sleep(delay)
        return True


def hedge_delay(base_s: float, queue_depth: int, batch: int,
                service_s: Optional[float] = None) -> float:
    """Cost-modeled hedge trigger (the QoS plane's router half —
    engine/qos.py re-exports this; it lives HERE because the routing
    process must never import the jax-pulling engine package for 15
    lines of arithmetic): how long to give the primary replica before a
    duplicate leg launches.  A loaded worker opens late for a LEGITIMATE
    reason (its queue), so the static ``APP_ROUTER_HEDGE_S`` scales with
    the advertised queue depth normalized by slot capacity, floored at
    the expected service time when an estimate exists — hedging fires on
    anomaly, not on known load.  The runaway cap is 8x the base OR the
    service floor, whichever is larger: capping BELOW the floor would
    re-enable hedging on every legitimately-slow open, exactly the
    duplicate-dispatch storm the floor exists to prevent."""
    base_s = max(0.0, float(base_s))
    if base_s <= 0.0:
        return 0.0
    depth_scale = 1.0 + max(0, int(queue_depth)) / float(max(1, int(batch)))
    delay = base_s * depth_scale
    floor = float(service_s) if service_s is not None and service_s > 0 \
        else 0.0
    delay = max(delay, floor)
    return min(delay, max(base_s * 8.0, floor))


def hedged_call(fns: Sequence[Callable[[], Any]], hedge_after_s: float,
                cancel: Optional[Callable[[Any], None]] = None,
                on_error: Optional[Callable[[int, Exception], None]] = None,
                name: str = "hedge",
                clock: Callable[[], float] = time.monotonic
                ) -> Tuple[Any, int]:
    """Run ``fns[0]``; if it hasn't returned within ``hedge_after_s``,
    launch ``fns[1]`` (then ``fns[2]``…, one hedge step per delay window).
    Returns ``(result, index)`` of the first success; late results are
    passed to ``cancel`` (close the stream, release the connection). All
    failing → the last error re-raises.

    ``on_error(index, exc)`` fires for EVERY failing leg — including a
    loser whose error would otherwise be masked by the winner. Without
    it, a hedge winning against a hard-down primary would swallow the
    primary's failure and the caller could never circuit-break it.

    Threads are daemons: an abandoned straggler can only ever hold its own
    socket, and ``cancel`` reclaims it the moment it lands."""
    if not fns:
        raise ValueError("hedged_call needs at least one callable")
    results: "queue_mod.Queue" = queue_mod.Queue()

    def run(ix: int) -> None:
        try:
            results.put(("ok", ix, fns[ix]()))
        except Exception as exc:   # tpulint: disable=except-swallow -- the error is DELIVERED: it rides the result queue to the caller, which re-raises the last one
            results.put(("err", ix, exc))

    launched = 1
    # tpulint: disable=daemon-shutdown -- hedge legs are call-scoped: the
    # result queue delivers every leg's outcome to THIS frame before it
    # returns (or the drainer below reaps stragglers); no join point
    # exists at process shutdown
    threading.Thread(target=run, args=(0,), daemon=True,
                     name=f"{name}-0").start()
    finished = 0
    last_err: Optional[Exception] = None
    winner: Optional[Tuple[Any, int]] = None
    while finished < launched:
        timeout = hedge_after_s if (launched < len(fns)
                                    and winner is None) else None
        try:
            kind, ix, value = results.get(timeout=timeout)
        except queue_mod.Empty:
            # hedge window expired with no result: launch the next leg
            REGISTRY.counter("hedges_total", labels={"pool": name}).inc()
            # tpulint: disable=daemon-shutdown -- call-scoped hedge leg (see above)
            threading.Thread(target=run, args=(launched,), daemon=True,
                             name=f"{name}-{launched}").start()
            launched += 1
            continue
        finished += 1
        if kind == "ok":
            # first success wins — the loop exits here, so anything still
            # in flight lands on the drainer thread below, never back in
            # this loop
            winner = (value, ix)
            if finished < launched:
                # stragglers still in flight: reap them on a drainer
                # thread so the winner streams immediately
                remaining = launched - finished

                def drain(n: int) -> None:
                    for _ in range(n):
                        k, i, v = results.get()
                        try:
                            if k == "ok" and cancel is not None:
                                cancel(v)
                            elif k == "err" and on_error is not None:
                                on_error(i, v)
                        except Exception as exc:
                            logger.debug("hedge drain callback "
                                         "failed: %s", exc)

                # tpulint: disable=daemon-shutdown -- reaps in-flight legs
                # so the winner streams now; exits after `remaining` gets
                threading.Thread(target=drain, args=(remaining,),
                                 daemon=True,
                                 name=f"{name}-drain").start()
            break
        else:
            last_err = value
            if on_error is not None:
                try:
                    on_error(ix, value)
                except Exception as exc:
                    logger.debug("hedge on_error callback failed: %s", exc)
            if launched < len(fns) and winner is None:
                # a leg failing FAST is better information than the hedge
                # timer: move to the next leg immediately
                # tpulint: disable=daemon-shutdown -- call-scoped hedge leg (see above)
                threading.Thread(target=run, args=(launched,), daemon=True,
                                 name=f"{name}-{launched}").start()
                launched += 1
    if winner is not None:
        if winner[1] > 0:
            REGISTRY.counter("hedge_wins_total",
                             labels={"pool": name}).inc()
        return winner
    assert last_err is not None
    raise last_err
