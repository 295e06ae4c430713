"""Device-time attribution plane: which program burned the card, live.

Port of ``generativeaiexamples_tpu/observability/devtime.py`` on CUDA
events. The serving engine says which program FAMILY the time went to,
whether a program shape first seen mid-serving caused a latency cliff,
and what a KV handoff costs per request. One process-global ledger
(``DEVTIME``), three layers:

  * **Dispatch ledger.** Every device program the engine issues is
    classified into a ``(program, bucket)`` key, the reference's keys —
    ``decode[+gram][+top] / s<steps>``, ``mixed / g<G>s<K>``,
    ``prefill / g<G>``, ``prefill_long / n<len>``, ``kv_export / p<pages>``,
    ``kv_import / p<pages>``, encoder micro-batches ``embed|rerank /
    b<batch>`` — and accumulates count, device/queue/issue seconds, useful
    vs padded token rows, and weight-read passes. Served as
    ``engine_device_seconds{program,bucket}`` plus live ``engine_mfu
    {program}`` / ``engine_hbm_read_util`` gauges (formulas from
    core/perfmodel.py, the H100's peaks) and the ``GET /debug/devtime``
    breakdown.

  * **Sampling gate.** ``APP_DEVTIME`` = ``off`` (default: counts only,
    ZERO added device fences and ZERO CUDA events — test-enforced) |
    ``sample`` (one timing fence every ``APP_DEVTIME_SAMPLE_N``-th
    commit; device seconds extrapolated by the stride) | ``on`` (fence
    every dispatch — full attribution for debugging; it serializes the
    two dispatches the scheduler keeps in flight, so never the serving
    default). Every fence routes through :func:`_fence`, which waits on a
    CUDA event recorded behind the dispatch (CPU tensors and numpy arrays
    pass through untouched); every event comes from :func:`_new_event`.
    With timing on, :meth:`DevtimeLedger.track` records a timing-enabled
    event on the card's current stream before the dispatch is issued and
    :meth:`DevtimeLedger.commit` one after it; the previous dispatch's end
    event is the drain marker. A timed commit's ``queue_s`` is the host's
    wait for the marker (work queued ahead), its ``device_s`` the events'
    elapsed time from the dispatch's start to its end on the stream. The
    start event is recorded before the host issues the dispatch, so on an
    engine whose host is slower than the card the span is the host's
    issue time (``issue_s``), not the kernels': it holds every gap in
    which the stream waits for the eager host to launch the next kernel.
    ``device_s`` is therefore an upper bound on the dispatch's kernel
    time, and ``engine_mfu`` / ``engine_hbm_read_util``, derived from it,
    lower bounds on the card's utilization; the device's busy and idle
    share come from a trace (``torch.profiler``), not from this ledger.
    The untimed events of the scheduler's result copies
    (``engine.HostCopy``) are not used.

  * **Compile-watch.** :meth:`DevtimeLedger.mark_warm` records every key
    ``EngineCore.warmup`` visited; :meth:`mark_serving` closes that window
    (Scheduler.start). On the card nothing is compiled per shape as XLA
    does, so the metric keeps its name and means "a program shape first
    seen after ``mark_serving`` that warmup never visited": its first run
    pays the cold costs warmup exists to take off the serving path
    (kernel first launches, cuBLAS plan and workspace choice, caching
    allocator growth). It counts into ``engine_recompiles_total``, is
    recorded as a flight-recorder event and (when timing is enabled)
    raised as a ``recompile`` hazard through the SLO pressure plane.
    ``GET /debug/compiles`` lists every such event with its key; these
    keys are the shapes a graph capture of the serving programs must
    visit.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from generativeaiexamples_tpu_torch.core.metrics import REGISTRY
from generativeaiexamples_tpu_torch.observability.flight import FLIGHT

logger = logging.getLogger(__name__)

_MODES = ("off", "sample", "on")
_WINDOW = 256          # trailing timed samples per program for live gauges
_COMPILE_LOG = 256     # bounded compile-event history


def _env_mode() -> Tuple[str, int]:
    """(mode, sample_n) from the environment: the bare ``APP_DEVTIME``
    wins, else the config-documented ``APP_ENGINE_DEVTIME``
    (core/config.py EngineConfig.devtime), else off."""
    raw = (os.environ.get("APP_DEVTIME", "").strip().lower()
           or os.environ.get("APP_ENGINE_DEVTIME", "").strip().lower()
           or "off")
    if raw not in _MODES:
        logger.warning("APP_DEVTIME=%r is not off|sample|on; using off", raw)
        raw = "off"
    try:
        n = int(os.environ.get("APP_DEVTIME_SAMPLE_N", "") or 16)
    except ValueError:
        n = 16
    return raw, max(1, n)


def pow2_bucket(n: int, start: int = 1) -> int:
    """Smallest power-of-two multiple of ``start`` covering ``n`` — THE
    bucket function every ledger key derives from (kv page counts, encoder
    batch sizes, long-prefill lengths). One copy, so committing sites and
    warm-key marking can never fork the key space."""
    b = max(1, start)
    while b < n:
        b *= 2
    return b


def _cuda_leaf(obj: Any):
    """The first CUDA tensor inside a (nested) dispatch output, or None."""
    if isinstance(obj, (list, tuple)):
        for item in obj:
            leaf = _cuda_leaf(item)
            if leaf is not None:
                return leaf
        return None
    if isinstance(obj, dict):
        return _cuda_leaf(list(obj.values()))
    if getattr(getattr(obj, "device", None), "type", None) == "cuda":
        return obj
    return None


def _new_event(device) -> Any:
    """The ONE CUDA event factory of the ledger: a timing-enabled event
    recorded now on ``device``'s current stream (tests monkeypatch this
    to prove ``off`` creates none)."""
    import torch
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _fence(target: Any) -> None:
    """The ONE device fence the ledger ever takes — the sampling gate's
    enforcement point (tests monkeypatch this to prove ``off`` adds zero
    fences). A CUDA event is waited on; an output holding CUDA tensors
    gets an event recorded behind it on its device's current stream and
    waited on; CPU tensors and numpy arrays pass through untouched, so
    FakeCore and CPU-engine scheduler tests take the identical path."""
    if hasattr(target, "elapsed_time") and hasattr(target, "synchronize"):
        target.synchronize()
        return
    leaf = _cuda_leaf(target)
    if leaf is None:
        return
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaf.device))
    event.synchronize()


class _Stamp(float):
    """``track()``'s instant on the host clock, carrying the start event
    recorded on the card's stream before the dispatch was issued."""

    event: Any = None


class _Entry:
    """Accumulator for one (program, bucket) ledger key."""

    __slots__ = ("program", "bucket", "count", "timed", "device_s", "queue_s",
                 "issue_s", "tokens", "padded_tokens", "timed_tokens",
                 "weight_passes", "first_seen_unix", "first_timed_s",
                 "last_timed_mono", "window", "pending_timed")

    def __init__(self, program: str, bucket: str) -> None:
        self.program = program
        self.bucket = bucket
        self.count = 0
        self.timed = 0
        self.device_s = 0.0
        self.queue_s = 0.0
        self.issue_s = 0.0         # host time to issue the async dispatch
        self.tokens = 0.0          # useful token positions processed
        self.padded_tokens = 0.0   # positions the program actually padded to
        self.timed_tokens = 0.0    # tokens of the TIMED dispatches only
        self.weight_passes = 0.0   # full weight-set HBM reads
        self.first_seen_unix = time.time()
        self.first_timed_s: Optional[float] = None
        self.last_timed_mono: Optional[float] = None
        # trailing timed (tokens, device_s, weight_passes) for live gauges
        self.window: deque = deque(maxlen=_WINDOW)
        # TIMED defer_census commits awaiting their note_tokens() census —
        # their device_s is already in; pairing the deferred tokens back
        # keeps phase_rates' device-seconds-per-token honest
        self.pending_timed = 0

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "program": self.program, "bucket": self.bucket,
            "count": self.count, "timed": self.timed,
            "device_s": round(self.device_s, 6),
            "queue_s": round(self.queue_s, 6),
            "issue_s": round(self.issue_s, 6),
            "tokens": int(self.tokens),
            "padded_tokens": int(self.padded_tokens),
            "weight_passes": round(self.weight_passes, 2),
            "row_util": (round(self.tokens / self.padded_tokens, 4)
                         if self.padded_tokens else None),
            "first_seen_unix": round(self.first_seen_unix, 3),
        }
        if self.timed:
            # sampled mode times 1/N of the dispatches: the estimate scales
            # the timed seconds by the observed count ratio (uniformity
            # assumption, stated in docs/observability.md)
            out["est_device_s"] = round(
                self.device_s * self.count / self.timed, 6)
            out["first_timed_s"] = (round(self.first_timed_s, 6)
                                    if self.first_timed_s is not None
                                    else None)
            steady = sorted(d for _, d, _ in self.window)
            out["steady_p50_s"] = (round(steady[len(steady) // 2], 6)
                                   if steady else None)
        return out


class DevtimeLedger:
    """Process-global dispatch ledger + compile-watch (see module doc).

    Thread-safety: commits arrive from the engine driver thread, encoder
    micro-batch workers and test threads; one lock guards the maps, and
    the (optional) fence always runs OUTSIDE it so a slow device sync never
    serializes other committers.
    """

    def __init__(self, mode: Optional[str] = None,
                 sample_n: Optional[int] = None) -> None:
        env_mode, env_n = _env_mode()
        self._mode = mode if mode in _MODES else env_mode
        self._sample_n = max(1, int(sample_n or env_n))
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _Entry] = {}
        self._compiles: deque = deque(maxlen=_COMPILE_LOG)
        self._warm: set = set()
        self._serving = False
        self._commits = 0
        self._marker: Any = None          # previous dispatch's end event
        self._device: Any = None          # the card the engine serves on
        self._perf = None                 # core.perfmodel.PerfModel
        # global trailing window of (weight_passes, device_s) for the
        # engine_hbm_read_util gauge (weight-bearing programs only)
        self._bw_window: deque = deque(maxlen=_WINDOW)
        # global trailing window of (useful, padded) token counts for the
        # engine_padding_waste_frac gauge — a CENSUS (every commit with a
        # padded count reports, no fence involved), so the gauge is live
        # even in the zero-fence off mode. Running totals keep the
        # per-commit cost O(1) (the window evicts at fixed maxlen) — the
        # off mode's counting-only cheapness must hold on the hot path.
        self._pad_window: deque = deque(maxlen=_WINDOW)
        self._pad_useful = 0.0
        self._pad_padded = 0.0
        # monotonic of the newest TIMED commit: consumers of the live
        # gauges (the usage plane's worker card) read the age to judge
        # staleness — gauges hold their last value while idle, they do
        # not decay
        self._last_timed_mono: Optional[float] = None
        # tests may redirect the recompile hazard away from the global SLO
        self.hazard_sink: Optional[Callable[[str, Dict[str, Any]], None]] = None
        # host-fetch accounting (multi-step decode plane): every device→host
        # result fetch counts into engine_host_fetches_total; fetches that
        # deliver decode steps also feed a trailing window whose mean is
        # the engine_steps_per_fetch gauge — THE observable the multi-step
        # decode ladder (EngineConfig.decode_multistep) exists to raise.
        # Census like the pad window: no fence, live even in off mode.
        self._fetch_window: deque = deque(maxlen=_WINDOW)
        self._fetch_steps = 0.0
        # the metric families exist (0-valued) from process start, so a
        # scrape before the first dispatch still sees the catalog
        REGISTRY.counter("engine_recompiles_total")
        REGISTRY.counter("engine_host_fetches_total")
        REGISTRY.gauge("engine_steps_per_fetch")
        REGISTRY.gauge("engine_hbm_read_util")
        REGISTRY.gauge("engine_padding_waste_frac")

    # ------------------------------------------------------------ lifecycle

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def timing_enabled(self) -> bool:
        return self._mode != "off"

    def configure(self, mode: Optional[str] = None,
                  sample_n: Optional[int] = None, device: Any = None) -> None:
        """Runtime override (the engine at init, tests). ``device``: the
        ``torch.device`` the engine serves on; a CUDA one arms the timing
        events, anything else leaves timing on the host clock."""
        with self._lock:
            if device is not None:
                self._device = (device if getattr(device, "type", None)
                                == "cuda" else None)
            if mode is not None:
                if mode not in _MODES:
                    raise ValueError(f"devtime mode must be one of {_MODES}, "
                                     f"got {mode!r}")
                self._mode = mode
                if mode == "off":
                    self._marker = None   # drop the held buffer reference
            if sample_n is not None:
                self._sample_n = max(1, int(sample_n))

    def attach_perf(self, perf) -> None:
        """Install the analytic model (core/perfmodel.PerfModel) the live
        MFU/HBM gauges derive from; None detaches (gauges stop updating)."""
        with self._lock:
            self._perf = perf

    def perf(self):
        """The attached analytic model, or None — the forensics doctor
        costs symptoms in device-seconds through this."""
        with self._lock:
            return self._perf

    def mark_warm(self, program: str, bucket: Any) -> None:
        """Record that warmup compiled this key — its first dispatch is not
        a compile event (EngineCore.warmup calls this per compiled key)."""
        with self._lock:
            self._warm.add((program, str(bucket)))

    def mark_serving(self) -> None:
        """Close the warm window (Scheduler.start): keys first seen after
        this that warmup never compiled count as mid-serving recompiles."""
        with self._lock:
            self._serving = True

    def reset(self, keep_warm: bool = False) -> None:
        """Drop accumulated stats (tests, a measurement pass).
        ``keep_warm`` preserves the warm-key set and serving flag — AND
        folds every already-seen key into it (those programs are compiled
        in this process, whether warmup or a lazy first use compiled them)
        — so a stats reset can never re-announce an old compile as a fresh
        recompile."""
        with self._lock:
            if keep_warm:
                self._warm.update(self._entries.keys())
            self._entries.clear()
            self._compiles.clear()
            self._commits = 0
            self._marker = None
            self._bw_window.clear()
            self._pad_window.clear()
            self._pad_useful = 0.0
            self._pad_padded = 0.0
            self._fetch_window.clear()
            self._fetch_steps = 0.0
            self._last_timed_mono = None
            if not keep_warm:
                self._warm.clear()
                self._serving = False

    # --------------------------------------------------------------- commit

    def track(self) -> float:
        """Stamp taken immediately before issuing a dispatch; pass it to
        :meth:`commit` as ``t0`` so issue/queue/device time can split.
        With timing on and a CUDA device bound it also records the
        dispatch's start event; ``off`` records nothing."""
        now = time.perf_counter()
        if self._mode == "off" or self._device is None:
            return now
        stamp = _Stamp(now)
        stamp.event = _new_event(self._device)
        return stamp

    def commit(self, program: str, bucket: Any, out: Any = None, *,
               t0: Optional[float] = None, tokens: float = 0,
               padded_tokens: float = 0, weight_passes: float = 0.0,
               device_s: Optional[float] = None, mfu: bool = True,
               retain: bool = True, defer_census: bool = False) -> None:
        """Account one issued device program.

        ``out`` is an output tensor (or a tuple / dict of them) of the
        dispatch — the fence target when this commit is sampled and no
        start event was recorded; the dispatch's end event (or, on the
        host clock, ``out`` itself) becomes the queue-drain marker for the
        next sampled commit unless ``retain`` is False. ``device_s`` short-circuits the
        gate for callers that already synced (kv export's copy-out, the
        encoder micro-batch whose dispatch blocks on results): the
        pre-measured duration is recorded with no extra fence in ANY mode.
        ``mfu=False`` keeps non-LLM programs (encoders, KV moves) out of
        the model-FLOP gauges — their tokens are not model forward passes.
        ``defer_census=True`` declares that this dispatch's useful-token
        census arrives later via :meth:`note_tokens` (multi-step decode:
        per-slot early exits are only known once the block is fetched);
        a TIMED deferred commit is remembered so the late tokens still
        pair with its device seconds — otherwise ``phase_rates`` would
        divide real device time by zero tokens and inflate the decode
        rate every downstream consumer (usage billing, the simulator's
        QoS costing) prorates with.
        """
        bucket = str(bucket)
        key = (program, bucket)
        t_commit = time.perf_counter()
        queue_s = 0.0
        # a pre-measured commit is a CENSUS (every occurrence reports), so
        # it must never be stride-extrapolated like a 1/N gate sample
        pre_measured = device_s is not None
        timed = pre_measured
        if not timed and out is not None and t0 is not None:
            start = getattr(t0, "event", None)
            end = (_new_event(self._device)
                   if start is not None and self._mode != "off" else None)
            with self._lock:
                if self._mode == "off":
                    due = False
                else:
                    self._commits += 1
                    due = (self._mode == "on"
                           or self._commits % self._sample_n == 0)
                marker = self._marker if due else None
                if self._mode != "off" and retain:
                    self._marker = end if end is not None else out
            if due:
                if marker is not None:
                    _fence(marker)
                    queue_s = max(0.0, time.perf_counter() - t_commit)
                t_dev = time.perf_counter()
                if end is not None:
                    _fence(end)
                    device_s = start.elapsed_time(end) / 1000.0
                else:
                    _fence(out)
                    device_s = time.perf_counter() - t_dev
                timed = True
        issue_s = max(0.0, t_commit - t0) if t0 is not None else 0.0
        with self._lock:
            entry = self._entries.get(key)
            first = entry is None
            if first:
                entry = self._entries[key] = _Entry(program, bucket)
            entry.count += 1
            entry.tokens += tokens
            entry.padded_tokens += padded_tokens
            entry.weight_passes += weight_passes
            pad_frac = None
            if padded_tokens:
                # census padding accounting (no fence): the live
                # engine_padding_waste_frac gauge the batch-width /
                # spec-width ladders are steered against
                if len(self._pad_window) == self._pad_window.maxlen:
                    old_u, old_p = self._pad_window[0]
                    self._pad_useful -= old_u
                    self._pad_padded -= old_p
                self._pad_window.append((tokens, padded_tokens))
                self._pad_useful += tokens
                self._pad_padded += padded_tokens
                if self._pad_padded:
                    pad_frac = 1.0 - self._pad_useful / self._pad_padded
            if timed:
                # issue seconds only for TIMED commits: attributed_s() sums
                # device+queue+issue, and mixing census issue time with
                # 1/N-sampled device time would make the total meaningless
                # in sample mode (mode=on — the a measurement pass —
                # times everything, so nothing is lost there)
                entry.issue_s += issue_s
            perf = self._perf
            stride = (self._sample_n
                      if self._mode == "sample" and not pre_measured else 1)
            gauge_sums = None
            if timed:
                entry.timed += 1
                entry.device_s += device_s
                entry.queue_s += queue_s
                entry.timed_tokens += tokens
                if defer_census:
                    entry.pending_timed += 1
                entry.last_timed_mono = time.monotonic()
                self._last_timed_mono = entry.last_timed_mono
                if entry.first_timed_s is None:
                    entry.first_timed_s = device_s
                entry.window.append((tokens, device_s, weight_passes))
                if weight_passes:
                    self._bw_window.append((weight_passes, device_s))
                if perf is not None:
                    # window sums gathered under the lock — deques must not
                    # be iterated while another committer appends
                    gauge_sums = (
                        sum(t for t, _, _ in entry.window),
                        sum(d for _, d, _ in entry.window),
                        sum(w for w, _ in self._bw_window),
                        sum(d for _, d in self._bw_window),
                    )
            if first:
                event = self._first_seen_locked(key)
            else:
                event = None
        # metrics + hazards OUTSIDE the lock (REGISTRY has its own locks;
        # the SLO sink may take the tracker's)
        if pad_frac is not None:
            REGISTRY.gauge("engine_padding_waste_frac").set(
                round(pad_frac, 4))
        if timed:
            # sampled mode extrapolates by the stride so the Prometheus
            # counter tracks attributed seconds, not 1/N of them
            REGISTRY.counter(
                "engine_device_seconds",
                labels={"program": program, "bucket": bucket}).inc(
                device_s * stride)
            if gauge_sums is not None:
                self._update_gauges(program, perf, mfu, gauge_sums)
        elif first:
            # the family exists from the key's first (untimed) dispatch on;
            # engine_mfu only for model-forward programs — a permanently-0
            # gauge for kv/encoder programs would average a fake idle chip
            # into any aggregation over the program label
            REGISTRY.counter("engine_device_seconds",
                             labels={"program": program, "bucket": bucket})
            if mfu:
                REGISTRY.gauge("engine_mfu", labels={"program": program})
        if event is not None:
            self._announce_compile(event)

    def note_fetch(self, steps: float = 0.0) -> None:
        """Account one device→host result fetch (the scheduler's _fetch
        fetch seam, where ``HostCopy`` results land, is the ONE call
        site).
        ``steps`` is the decode steps the fetched block carries (0 for
        non-decode fetches: first-token snapshots, KV exports) — positive
        values feed the trailing window behind ``engine_steps_per_fetch``.
        Census semantics: no fence, counts in every mode."""
        if steps > 0:
            with self._lock:
                if len(self._fetch_window) == self._fetch_window.maxlen:
                    self._fetch_steps -= self._fetch_window[0]
                self._fetch_window.append(steps)
                self._fetch_steps += steps
                spf = self._fetch_steps / len(self._fetch_window)
            REGISTRY.gauge("engine_steps_per_fetch").set(round(spf, 2))
        REGISTRY.counter("engine_host_fetches_total").inc()

    def steps_per_fetch(self) -> float:
        """Mean decode steps delivered per result fetch over the trailing
        window (0.0 with no data) — the flight recorder's
        ``steps_per_fetch`` field reads this."""
        with self._lock:
            n = len(self._fetch_window)
            return self._fetch_steps / n if n else 0.0

    def note_tokens(self, program: str, bucket: Any, tokens: float,
                    padded_tokens: float) -> None:
        """Deferred useful-vs-padded census for a dispatch whose useful
        token count is only known at RESULT time: a multi-step decode scan
        early-exits on device (EOS / stop maybe-match pause), so tokens
        actually emitted per slot are in the fetched block, not the
        dispatch plan. The dispatch-time :meth:`commit` carries the timing
        and compile-watch with no token census; this adds the honest
        counts once the block lands, so ``engine_padding_waste_frac``
        prices early-exited scan steps as the padding they are."""
        bucket = str(bucket)
        with self._lock:
            entry = self._entries.get((program, bucket))
            if entry is None:
                entry = self._entries[(program, bucket)] = _Entry(program,
                                                                  bucket)
            entry.tokens += tokens
            entry.padded_tokens += padded_tokens
            if entry.pending_timed > 0:
                # settle a TIMED defer_census commit: its device_s landed
                # at dispatch time with zero tokens — pairing the census
                # back keeps phase_rates / MFU window sums honest
                entry.pending_timed -= 1
                entry.timed_tokens += tokens
                entry.window.append((tokens, 0.0, 0.0))
            pad_frac = None
            if padded_tokens:
                if len(self._pad_window) == self._pad_window.maxlen:
                    old_u, old_p = self._pad_window[0]
                    self._pad_useful -= old_u
                    self._pad_padded -= old_p
                self._pad_window.append((tokens, padded_tokens))
                self._pad_useful += tokens
                self._pad_padded += padded_tokens
                if self._pad_padded:
                    pad_frac = 1.0 - self._pad_useful / self._pad_padded
        if pad_frac is not None:
            REGISTRY.gauge("engine_padding_waste_frac").set(
                round(pad_frac, 4))

    def _update_gauges(self, program: str, perf, mfu: bool,
                       sums: Tuple[float, float, float, float]) -> None:
        wt, wd, bw_w, bw_d = sums
        if mfu:
            m = perf.mfu(wt, wd)
            if m is not None:
                REGISTRY.gauge("engine_mfu",
                               labels={"program": program}).set(round(m, 4))
        util = perf.hbm_read_util(bw_w, bw_d)
        if util is not None:
            REGISTRY.gauge("engine_hbm_read_util").set(round(util, 4))

    # -------------------------------------------------------- compile-watch

    def _first_seen_locked(self, key: Tuple[str, str]) -> Optional[Dict]:
        """Caller holds the lock. A key's first dispatch is a compile event
        unless warmup compiled it; one seen mid-serving is a RECOMPILE."""
        if key in self._warm:
            return None
        event = {
            "program": key[0], "bucket": key[1],
            "ts_unix": round(time.time(), 3),
            "during_serving": self._serving,
        }
        self._compiles.append(event)
        return event

    def _announce_compile(self, event: Dict[str, Any]) -> None:
        if not event["during_serving"]:
            return
        REGISTRY.counter("engine_recompiles_total").inc()
        FLIGHT.event("recompile", program=event["program"],
                     bucket=event["bucket"])
        logger.warning(
            "program %s bucket %s first seen mid-serving: warmup never "
            "visited it, so live requests pay its cold first run "
            "(latency cliff); see GET /debug/compiles", event["program"],
            event["bucket"])
        if not self.timing_enabled:
            return   # default off-mode: observe-only, no pressure coupling
        try:
            sink = self.hazard_sink
            if sink is not None:
                sink("recompile", dict(event))
            else:
                from generativeaiexamples_tpu_torch.observability import slo
                slo.SLO.note_hazard("recompile", dict(event))
        except Exception as exc:
            logger.debug("recompile hazard sink failed: %s", exc)

    # ------------------------------------------------------------ reporting

    def attributed_s(self) -> float:
        """Total seconds the ledger can attribute to named programs
        (device + queue + issue; timed samples only, no extrapolation)."""
        with self._lock:
            return sum(e.device_s + e.queue_s + e.issue_s
                       for e in self._entries.values())

    def last_timed_age_s(self) -> Optional[float]:
        """Seconds since the newest timed commit (None = never timed) —
        how stale the live MFU/HBM gauges are: they hold their last
        trailing-window value while the engine idles, so a consumer must
        pair the value with this age."""
        with self._lock:
            last = self._last_timed_mono
        return None if last is None else max(0.0, time.monotonic() - last)

    def fresh_programs(self, max_age_s: float = 60.0) -> set:
        """Programs with a timed commit inside the trailing window — the
        per-program gauges (``engine_mfu{program}``) HOLD their last
        value forever, so consumers aggregating across programs (the
        usage plane's worker card) must restrict to programs that are
        actually still dispatching or a one-off prefill burst's MFU
        would read as 'current' all day."""
        now = time.monotonic()
        with self._lock:
            return {e.program for e in self._entries.values()
                    if e.last_timed_mono is not None
                    and now - e.last_timed_mono <= max_age_s}

    def phase_rates(self) -> Dict[str, Optional[float]]:
        """Timed device-seconds per useful token for the two model-forward
        program families — ``prefill`` (prefill / prefill_long) and
        ``decode`` (decode / mixed variants) — the proration join the
        usage plane (observability/usage.py) bills requests with.  Rates
        come from TIMED dispatches only (device_s over timed_tokens, both
        recorded by the same sampled commits), so sample-mode stride
        never skews the ratio; a family with no timed samples (the
        default off mode) reports None and billing falls back to token
        counts."""
        sums = {"prefill": [0.0, 0.0], "decode": [0.0, 0.0]}
        with self._lock:
            for entry in self._entries.values():
                if not entry.timed or not entry.timed_tokens:
                    continue
                if entry.program.startswith("prefill"):
                    fam = sums["prefill"]
                elif entry.program.startswith(("decode", "mixed")):
                    fam = sums["decode"]
                else:
                    continue
                fam[0] += entry.device_s
                fam[1] += entry.timed_tokens
        return {k: (s / t if t else None) for k, (s, t) in sums.items()}

    def padding_waste(self) -> float:
        """Padded-token fraction NOT carrying useful positions over the
        trailing commit window (0.0 with no data) — the flight recorder's
        ``padding_waste_frac`` field and the batch-width ladder's
        scoreboard read this."""
        with self._lock:
            pad_u, pad_p = self._pad_useful, self._pad_padded
        return (1.0 - pad_u / pad_p) if pad_p else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/devtime`` body. Each key's ``device_s`` is the
        stream span of its timed dispatches, bounded below by the host's
        time to issue them (module docstring): an upper bound on kernel
        time, so the utilization gauges read low on a host-bound engine."""
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: -(e.device_s or e.count))
            rows = [e.snapshot() for e in entries]
            perf = self._perf
            mode, sample_n = self._mode, self._sample_n
            serving = self._serving
            pad_u, pad_p = self._pad_useful, self._pad_padded
        totals = {
            "count": sum(r["count"] for r in rows),
            "timed": sum(r["timed"] for r in rows),
            "device_s": round(sum(r["device_s"] for r in rows), 6),
            "queue_s": round(sum(r["queue_s"] for r in rows), 6),
            "issue_s": round(sum(r["issue_s"] for r in rows), 6),
        }
        out: Dict[str, Any] = {
            "mode": mode, "sample_n": sample_n, "serving": serving,
            "programs": rows, "totals": totals,
            "padding_waste_frac": (round(1.0 - pad_u / pad_p, 4)
                                   if pad_p else 0.0),
            "steps_per_fetch": round(self.steps_per_fetch(), 2),
            "host_fetches_total": REGISTRY.counter(
                "engine_host_fetches_total").value,
            "recompiles_total": REGISTRY.counter(
                "engine_recompiles_total").value,
        }
        if perf is not None:
            out["perf_model"] = {
                "n_params": perf.n_params,
                "param_bytes": perf.param_bytes,
                "peak_flops": perf.peak_flops,
                "peak_bw": perf.peak_bw,
            }
        return out

    def compiles(self) -> Dict[str, Any]:
        """The ``GET /debug/compiles`` body: every first-seen event
        (newest first) with its key; ``during_serving`` marks the ones
        ``engine_recompiles_total`` counts (the latency cliffs)."""
        with self._lock:
            events = list(self._compiles)[::-1]
            warm = len(self._warm)
        return {
            "events": events,
            "warmed_keys": warm,
            "recompiles_total": REGISTRY.counter(
                "engine_recompiles_total").value,
        }


DEVTIME = DevtimeLedger()
