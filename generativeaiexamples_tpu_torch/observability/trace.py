"""Canonical fleet event trace — the replayable record of every scheduling
decision (docs/simulation.md).

The flight recorder (observability/flight.py) answers "what did the gauges
look like"; this plane answers "what exactly happened, in what order":
one schema-versioned record per admission, QoS decision, dispatch,
preemption, spill, tier promote, migration, router placement, and finish —
stamped with the mono clock (core/clock.py, so simulated runs stamp
virtual time), tenant, token counts, prefix hash, and the perfmodel
estimated cost where one exists. A trace is sufficient for
``ops/simulate.py`` to reconstruct the arrival process and re-drive the
REAL policy objects, which is the whole point: record once, replay any
what-if.

Gating follows the house zero-overhead pattern (``APP_TRACE=off|on``,
default off): call sites in hot paths guard on ``TRACE.enabled`` — one
attribute read, no record built, no lock touched. Enabled, records land
in a bounded ring (``APP_TRACE_CAPACITY``, default 65536) served by
``GET /debug/trace?window=`` and ``flight.dump()``; with
``APP_TRACE_PATH`` set they are ALSO write-behind appended as JSONL and
size-rotated (``APP_TRACE_ROTATE_MB``, one ``.1`` predecessor kept) so a
long serving run's trace survives the ring.

Record shape (schema v1)::

    {"v": 1, "seq": 17, "mono": 12.034, "kind": "dispatch", ...fields}

``seq`` is a process-wide total order (the mono stamp alone cannot break
ties inside one tick). Field vocabulary per kind is documented in
docs/simulation.md and deliberately flat — every value JSON-scalar — so
a trace line greps and a replayer never needs nested parsing.
"""

from __future__ import annotations

import atexit
import json
import os
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

from generativeaiexamples_tpu_torch.core import clock
from generativeaiexamples_tpu_torch.observability.lockwatch import tracked_lock

SCHEMA_VERSION = 1

_DEF_CAPACITY = 65536
_DEF_ROTATE_MB = 64
_FLUSH_EVERY = 128


def _env_mode() -> str:
    return (os.environ.get("APP_TRACE", "").strip().lower() or "off")


class EventTrace:
    """Bounded, optionally disk-rotated event trace (process-global
    ``TRACE``). Thread-safe: the scheduler driver thread, router worker
    threads, and HTTP handlers all emit into the same stream."""

    def __init__(self) -> None:
        self.enabled = _env_mode() in ("on", "1", "true")
        cap = int(os.environ.get("APP_TRACE_CAPACITY", "") or _DEF_CAPACITY)
        self.capacity = max(256, cap)
        self.path = os.environ.get("APP_TRACE_PATH", "").strip() or None
        self.rotate_bytes = int(float(
            os.environ.get("APP_TRACE_ROTATE_MB", "") or _DEF_ROTATE_MB)
            * 1024 * 1024)
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        self._pending: List[str] = []
        self._seq = 0
        self._total = 0
        self._lock = tracked_lock("trace._lock")
        # write-behind: full batches drain on ONE dedicated writer thread
        # (started lazily at first batch), so file I/O never runs on an
        # emitting thread — the driver tick and HTTP handlers pay one
        # list-append, never an fsync
        self._wq: "queue_mod.Queue[Optional[List[str]]]" = queue_mod.Queue()
        self._inflight = 0            # batches enqueued, not yet on disk
        self._writer: Optional[threading.Thread] = None
        # a bench worker subprocess may exit with < _FLUSH_EVERY lines
        # buffered; close() flushes them and bounded-joins the writer so
        # the daemon never dies mid-write at interpreter exit
        atexit.register(self.close)

    # -- configuration (bench / simulator / tests) -----------------------

    def configure(self, mode: Optional[str] = None,
                  path: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        """Runtime re-arm: bench rounds and the simulator switch tracing
        on without re-execing the process. ``path=''`` detaches the file
        sink; a new capacity re-rings (drops history)."""
        with self._lock:
            if mode is not None:
                self.enabled = mode.strip().lower() in ("on", "1", "true")
            if path is not None:
                self.path = path or None
            if capacity is not None:
                self.capacity = max(256, int(capacity))
                self._ring = deque(self._ring, maxlen=self.capacity)

    def reset(self) -> None:
        """Drop all recorded state (simulator runs start from a clean
        stream; live servers never call this)."""
        with self._lock:
            self._ring.clear()
            self._pending = []
            self._seq = 0
            self._total = 0

    # -- recording -------------------------------------------------------

    def emit(self, kind: str, **fields) -> None:
        """Append one event. Callers on hot paths guard with
        ``if TRACE.enabled`` so the disabled cost is one attribute read;
        this re-check only closes the configure() race."""
        if not self.enabled:
            return
        rec = {"v": SCHEMA_VERSION, "mono": clock.mono(), "kind": kind}
        rec.update(fields)
        batch: Optional[List[str]] = None
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._total += 1
            self._ring.append(rec)
            if self.path is not None:
                self._pending.append(json.dumps(rec, separators=(",", ":"),
                                                default=str))
                if len(self._pending) >= _FLUSH_EVERY:
                    batch, self._pending = self._pending, []
                    self._inflight += 1
        if batch is not None:
            self._wq.put(batch)
            self._ensure_writer()

    def flush(self, timeout_s: float = 2.0) -> None:
        """Push buffered lines to the file sink and bounded-wait for the
        writer to land every in-flight batch: dump paths and tests read
        the file synchronously after this returns."""
        batch: Optional[List[str]] = None
        with self._lock:
            if self._pending:
                batch, self._pending = self._pending, []
                self._inflight += 1
            waiting = self._inflight > 0
        if batch is not None:
            self._wq.put(batch)
        if not waiting:
            return
        self._ensure_writer()
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    return
            time.sleep(0.002)

    def close(self, timeout_s: float = 2.0) -> None:
        """Bounded shutdown (atexit): flush buffered lines, then
        sentinel-stop the writer thread and join with a deadline so a
        slow disk can never hang interpreter exit."""
        self.flush(timeout_s)
        with self._lock:
            t, self._writer = self._writer, None
        if t is not None and t.is_alive():
            self._wq.put(None)
            t.join(timeout_s)

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="trace-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            batch = self._wq.get()
            if batch is None:
                return
            try:
                self._write(batch)
            finally:
                with self._lock:
                    self._inflight -= 1

    def _write(self, lines: List[str]) -> None:
        # file I/O happens on the writer thread with NO lock held
        # (lock-discipline): emitters keep appending to the ring/buffer
        # while this thread writes
        path = self.path
        if not path:
            return
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
            if os.path.getsize(path) > self.rotate_bytes:
                os.replace(path, path + ".1")
        except OSError:
            # a full disk must never take the serving thread down; the
            # ring keeps the recent window either way
            from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
            REGISTRY.counter("trace_write_errors_total").inc()

    # -- read surface ----------------------------------------------------

    def describe(self) -> Dict[str, object]:
        with self._lock:
            buffered = len(self._ring)
            total = self._total
        return {
            "schema_version": SCHEMA_VERSION,
            "enabled": self.enabled,
            "mode": "on" if self.enabled else "off",
            "capacity": self.capacity,
            "buffered": buffered,
            "recorded_total": total,
            "dropped": max(0, total - buffered),
            "path": self.path,
        }

    def window(self, seconds: float, limit: int = 4096,
               kinds: Optional[Iterable[str]] = None) -> List[dict]:
        """Events from the last ``seconds`` of mono time, newest ``limit``
        kept, oldest-first — the /debug/trace body and the flight dump's
        trace tail both read through here."""
        cutoff = clock.mono() - max(0.0, float(seconds))
        want = frozenset(kinds) if kinds is not None else None
        with self._lock:
            recs = [r for r in self._ring
                    if r.get("mono", 0.0) >= cutoff
                    and (want is None or r.get("kind") in want)]
        if limit and len(recs) > limit:
            recs = recs[-limit:]
        return recs

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def dump_jsonl(self, path: str) -> int:
        """Write the full ring as JSONL (the simulator's input format —
        identical line shape to the rotation sink). Returns the record
        count."""
        recs = self.records()
        with open(path, "w", encoding="utf-8") as f:
            for rec in recs:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=str) + "\n")
        return len(recs)


def read_jsonl(path: str) -> List[dict]:
    """Load a trace file (ring dump or rotated sink) — tolerant of a
    torn final line from a killed process, loud on anything else."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # a mid-write kill can tear the last line; anything torn
                # earlier means the file is not a trace
                remainder = f.read().strip()
                if remainder:
                    raise ValueError(
                        f"{path}:{i + 1}: undecodable trace line")
                break
            out.append(rec)
    return out


TRACE = EventTrace()
