"""Runtime lock-order sanitizer.

A copy of ``generativeaiexamples_tpu/observability/lockwatch.py``
(standard library only), kept in the port because the port imports
nothing of that package.

Lock ordering wired through a callback, a thread boundary or a data
structure is invisible to static analysis. This module checks it at
runtime: the serving plane's locks are constructed through
:func:`tracked_lock` / :func:`tracked_rlock`, and while armed every
*blocking* acquisition is recorded into a witness order graph — lock A
held while lock B is acquired adds edge ``A → B``. The first acquisition
that would close a cycle is reported as an **inversion** with BOTH
witness stacks (the acquisition that created the conflicting edge and
the one that closed the cycle), which is the full deadlock diagnosis: no
need to actually deadlock, one interleaving of each order suffices.

Gating is the house zero-overhead pattern (``APP_LOCKWATCH=off|on``,
default off, the ``APP_DEVTIME`` shape): when off the factories return
**raw** ``threading.Lock``/``RLock`` objects — not a pass-through
wrapper, the real primitive — so the serving hot path pays literally
nothing, a property the test suite enforces by counting watch calls over
a real scheduler tick. The env is re-read at every construction, so a
test (or the fuzz harness) arming ``APP_LOCKWATCH=on`` before building a
Scheduler gets tracked locks without touching module import order.

Also watched: holds longer than ``APP_LOCKWATCH_HOLD_MS`` (default 100)
are recorded with the holder's stack — a long hold under the scheduler
lock is the latency smoking gun even when ordering is clean. The whole
payload is served by ``GET /debug/locks`` (server/common.py).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

_DEF_HOLD_MS = 100.0


def _env_on() -> bool:
    return (os.environ.get("APP_LOCKWATCH", "").strip().lower()
            in ("on", "1", "true"))


def _stack(skip: int = 2, limit: int = 10) -> List[str]:
    """Trimmed caller stack, innermost last — ``skip`` drops the
    lockwatch frames themselves so reports start at the acquire site."""
    frames = traceback.extract_stack()[:-skip]
    return [f"{f.filename}:{f.lineno} in {f.name}" for f in frames[-limit:]]


class LockWatch:
    """Process-global witness graph (``WATCH``). Internal state is
    guarded by a single RAW lock — the watcher must never watch itself."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.hold_ms = float(
            os.environ.get("APP_LOCKWATCH_HOLD_MS", "") or _DEF_HOLD_MS)
        # (held, acquired) -> first witness: both stacks + thread name
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._adj: Dict[str, set] = {}
        self._locks_seen: set = set()
        self._inversions: List[dict] = []
        self._long_holds: "deque[dict]" = deque(maxlen=256)

    # -- per-thread held stack -------------------------------------------

    def _held(self) -> List[dict]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    # -- recording -------------------------------------------------------

    def note_acquired(self, name: str, blocking: bool) -> None:
        """Called AFTER the underlying acquire succeeds. Reentrant
        re-acquisition (RLock) bumps a depth counter and adds no edges —
        re-entry cannot deadlock against itself."""
        held = self._held()
        for entry in held:
            if entry["name"] == name:
                entry["depth"] += 1
                return
        stack = _stack(skip=3)
        if blocking:
            # only a BLOCKING acquire can participate in a deadlock, but
            # the locks already held count however they were acquired
            for entry in held:
                self._note_edge(entry, name, stack)
        held.append({"name": name, "t0": time.monotonic(),
                     "stack": stack, "depth": 1})
        with self._mu:
            self._locks_seen.add(name)

    def note_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry["name"] != name:
                continue
            entry["depth"] -= 1
            if entry["depth"] > 0:
                return
            del held[i]
            held_ms = (time.monotonic() - entry["t0"]) * 1000.0
            if held_ms > self.hold_ms:
                with self._mu:
                    self._long_holds.append({
                        "lock": name,
                        "held_ms": round(held_ms, 3),
                        "thread": threading.current_thread().name,
                        "stack": entry["stack"],
                    })
            return

    def _note_edge(self, held_entry: dict, acquired: str,
                   acquire_stack: List[str]) -> None:
        a, b = held_entry["name"], acquired
        if a == b:
            return
        with self._mu:
            witness = {
                "held": a,
                "acquired": b,
                "thread": threading.current_thread().name,
                "held_stack": held_entry["stack"],
                "acquire_stack": acquire_stack,
            }
            if (a, b) not in self._edges:
                self._edges[(a, b)] = witness
                self._adj.setdefault(a, set()).add(b)
            # would this edge close a cycle?  walk b -> ... -> a
            path = self._find_path(b, a)
            if path is not None:
                conflict = self._edges.get((path[0], path[1]))
                self._inversions.append({
                    "cycle": [a] + path,
                    "this": witness,
                    "conflict": conflict,
                })

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS in the witness graph; returns ``[src, ..., dst]`` or None.
        Caller holds ``self._mu``."""
        seen = {src}
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        while stack:
            node, path = stack.pop()
            for nxt in self._adj.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- read surface ----------------------------------------------------

    @property
    def inversions(self) -> List[dict]:
        with self._mu:
            return list(self._inversions)

    def payload(self) -> dict:
        """The /debug/locks body: the whole witness graph plus every
        inversion and long hold observed since arming."""
        with self._mu:
            return {
                "enabled": True,
                "hold_ms": self.hold_ms,
                "locks": sorted(self._locks_seen),
                "edges": [
                    {"held": a, "acquired": b, "thread": w["thread"]}
                    for (a, b), w in sorted(self._edges.items())
                ],
                "inversions": list(self._inversions),
                "long_holds": list(self._long_holds),
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._adj.clear()
            self._locks_seen.clear()
            self._inversions.clear()
            self._long_holds.clear()


WATCH = LockWatch()


class TrackedLock:
    """Wrapper around ``threading.Lock``/``RLock`` reporting every
    acquisition to :data:`WATCH`. Only constructed while the watch is
    armed — the off path never sees this class."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner: Union[threading.Lock, type(None)]
                 = None, reentrant: bool = False) -> None:
        self.name = name
        self._inner = inner if inner is not None else (
            threading.RLock() if reentrant else threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            WATCH.note_acquired(self.name, blocking)
        return got

    def release(self) -> None:
        WATCH.note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"


def tracked_lock(name: str) -> Union[threading.Lock, TrackedLock]:
    """A ``threading.Lock`` for ``name`` — RAW when ``APP_LOCKWATCH`` is
    off (zero overhead, enforced by test), tracked when armed. The env
    is read per construction, not per module import."""
    if not _env_on():
        return threading.Lock()
    return TrackedLock(name)


def tracked_rlock(name: str) -> Union[threading.RLock, TrackedLock]:
    """Reentrant variant — re-acquisition by the owner records no edge."""
    if not _env_on():
        return threading.RLock()
    return TrackedLock(name, reentrant=True)
