"""Cross-request micro-batching for the encoder programs.

Port of ``generativeaiexamples_tpu/encoders/microbatch.py``. Concurrent
callers enqueue their items and block on a future; a worker thread
coalesces everything that arrives within a small wait window (or until
the batch is full) into ONE dispatch of the wrapped function, then routes
each caller's slice of the results back, so N in-flight RAG requests cost
about one encoder dispatch instead of N (the stage-scheduling fix RAGO,
arxiv 2503.14649, names the dominant lever in RAG serving).

Semantics:

  * a submission is never split across dispatches: result routing is a
    contiguous span of the batch output (the wrapped fn chunks internally
    past its own max batch);
  * the window closes EARLY when ``max_items`` fill, so a saturated queue
    dispatches back-to-back with zero added latency;
  * a lone caller waits at most ``window_s`` (default 2 ms);
  * the queue is bounded (``max_queue`` submissions): a caller past it
    waits, which pushes back on an ingest burst;
  * a dispatch failure propagates to every caller in that batch and the
    worker keeps serving (no poisoned queue);
  * ``close()`` drains the queue under the lock, failing what it drained.

Observability: per-submission queue wait and per-dispatch fill land in
``<name>_wait_s`` / ``<name>_batch_fill`` / ``<name>_batch_requests``
histograms and the ``<name>_dispatches`` counter (``core/metrics.py``).
Each dispatch's wall time goes to the device-time ledger as a
pre-measured commit (``DEVTIME.commit(name, "b<pow2 batch>", device_s=)``:
the dispatch returns host results, so no fence is taken in any mode).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability.devtime import (
    DEVTIME, pow2_bucket)


class _Pending:
    __slots__ = ("items", "event", "result", "error", "enqueued_at")

    def __init__(self, items: Sequence[Any]) -> None:
        self.items = items
        self.event = threading.Event()
        self.result: Optional[Sequence[Any]] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.perf_counter()


class MicroBatcher:
    """Coalesce concurrent ``submit()`` calls into single dispatches.

    ``dispatch`` takes the concatenated item list and must return one result
    per item, index-aligned (e.g. an ``(n, dim)`` array or a length-n
    sequence) — each caller gets back the contiguous slice covering its own
    items, so results can never leak across requests.
    """

    def __init__(self, dispatch: Callable[[List[Any]], Sequence[Any]],
                 max_items: int = 64, window_s: float = 0.002,
                 max_queue: int = 1024, name: str = "microbatch") -> None:
        self._dispatch = dispatch
        self.max_items = max(1, max_items)
        self.window_s = max(0.0, window_s)
        self.max_queue = max_queue
        self.name = name
        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{name}-batcher")
        self._worker.start()

    # ------------------------------------------------------------------- API

    def submit(self, items: Sequence[Any]) -> Sequence[Any]:
        """Block until the batch containing ``items`` is dispatched; return
        this submission's results (index-aligned with ``items``)."""
        if not items:
            return []
        pending = _Pending(items)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{self.name} batcher is closed")
            while len(self._queue) >= self.max_queue and not self._closed:
                # bounded queue: back-pressure the caller instead of letting
                # an ingest burst grow the queue without limit
                self._cv.wait(timeout=0.05)
            if self._closed:
                raise RuntimeError(f"{self.name} batcher is closed")
            self._queue.append(pending)
            self._cv.notify_all()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def close(self) -> None:
        # Drain the queue UNDER the lock before joining: once popped here
        # the worker can never claim these pendings, so a slow in-flight
        # dispatch cannot race close() into double-completing a submission
        # (the already-popped batch it is working on finishes normally).
        with self._cv:
            self._closed = True
            drained, self._queue = self._queue, []
            self._cv.notify_all()
        for p in drained:
            p.error = RuntimeError(f"{self.name} batcher closed")
            p.event.set()
        self._worker.join(timeout=5)

    # ---------------------------------------------------------------- worker

    def _take_batch(self) -> List[_Pending]:
        """Wait for work, then hold the window open until it expires or the
        batch fills. Returns the drained submissions (possibly exceeding
        max_items by the last submission — never split across dispatches)."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(timeout=0.1)
            if not self._queue:
                return []
            deadline = time.perf_counter() + self.window_s
            while (sum(len(p.items) for p in self._queue) < self.max_items):
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closed:
                    break
                self._cv.wait(timeout=remaining)
            batch: List[_Pending] = []
            count = 0
            while self._queue and (not batch or
                                   count + len(self._queue[0].items)
                                   <= self.max_items):
                p = self._queue.pop(0)
                count += len(p.items)
                batch.append(p)
            self._cv.notify_all()   # wake writers blocked on max_queue
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            now = time.perf_counter()
            flat: List[Any] = []
            for p in batch:
                REGISTRY.histogram(f"{self.name}_wait_s").observe(
                    now - p.enqueued_at)
                flat.extend(p.items)
            REGISTRY.histogram(f"{self.name}_batch_fill").observe(len(flat))
            REGISTRY.histogram(f"{self.name}_batch_requests").observe(
                len(batch))
            REGISTRY.counter(f"{self.name}_dispatches").inc()
            t0 = time.perf_counter()
            try:
                results = self._dispatch(flat)
                if len(results) != len(flat):
                    raise RuntimeError(
                        f"{self.name} dispatch returned {len(results)} "
                        f"results for {len(flat)} items")
            except Exception as exc:   # routed to the batch's callers
                for p in batch:
                    p.error = exc
                    p.event.set()
                continue
            # devtime: the dispatch blocked until its results were on the
            # host, so its wall is a pre-measured duration; mfu=False keeps
            # encoder items out of the LLM's model-FLOP gauges
            b2 = pow2_bucket(len(flat))
            DEVTIME.commit(self.name, f"b{b2}",
                           device_s=time.perf_counter() - t0,
                           tokens=len(flat), padded_tokens=b2, mfu=False)
            start = 0
            for p in batch:
                p.result = results[start:start + len(p.items)]
                start += len(p.items)
                p.event.set()
