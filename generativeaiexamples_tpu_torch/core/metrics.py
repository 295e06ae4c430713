"""Serving metrics registry: req/s, TTFT, tokens/s/chip, batch occupancy.

A copy of ``generativeaiexamples_tpu/core/metrics.py`` (which imports no
JAX), kept in the port because the port imports nothing of that package.
The engine (scheduler, prefix cache, host KV tier), the encoders, the
servers and the host planes (``observability/``) count into
:data:`REGISTRY` under the reference's names.

The reference has no first-class metrics (metrics ride on spans; SURVEY §5.5) —
these are the north-star measurements in BASELINE.json, so the TPU stack makes
them first-class:

  * lock-protected ``Counter`` (monotonic), ``Gauge`` (last-value set/inc/dec),
    and streaming ``Histogram`` with exact percentiles over a bounded
    reservoir;
  * **labeled families**: ``REGISTRY.counter("requests_finished",
    labels={"finish": "eos"})`` keys a distinct time series per label set,
    rendered as ``requests_finished{finish="eos"}`` on both surfaces;
  * two exposition formats from one registry: ``snapshot()`` (the JSON
    ``/metrics`` blob) and ``render_prometheus()`` (text exposition format
    0.0.4 — scrapeable by a stock Prometheus without a sidecar exporter;
    histograms export ``_count``/``_sum`` plus quantile gauges, summary-style);
  * **windowed rates**: ``snapshot()`` reports each counter's
    ``<name>_rate_per_s`` over the window since the previous snapshot (the
    scrape interval), alongside the lifetime ``<name>_per_s`` average —
    lifetime rates go stale minutes into serving, the windowed rate is the
    current throughput a dashboard actually wants.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _render_name(name: str, key: LabelKey) -> str:
    """Canonical series name: ``name`` or ``name{k="v",...}`` (the same
    rendering serves as the JSON snapshot key and the Prometheus line)."""
    if not key:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return f"{name}{{{inner}}}"


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


class Counter:
    """Monotonic counter (one labeled series of a family)."""

    def __init__(self, name: str, labels: Optional[Mapping[str, str]] = None
                 ) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-value metric: queue depths, pool fill, batch occupancy *now*
    (counters answer "how many ever", gauges answer "how many right now" —
    the flight recorder mirrors its per-step engine state into these)."""

    def __init__(self, name: str, labels: Optional[Mapping[str, str]] = None
                 ) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir histogram with exact percentiles (keeps newest N).

    ``observe`` sits on the decode hot path (``decode_batch_fill``,
    ``fetch_rtt_s`` fire per dispatch), so it is O(1): a deque append +
    popleft — the old list reservoir paid ``pop(0)`` (shift every sample)
    plus a sorted-list ``insort`` + eviction (two more O(n) memmoves) on
    EVERY observe past capacity. The sorted view is built lazily at
    ``percentile()`` time instead (one O(n log n) sort amortized over every
    quantile of a scrape — reads are scrape-rate, writes are token-rate).
    """

    def __init__(self, name: str, max_samples: int = 4096,
                 labels: Optional[Mapping[str, str]] = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self._max = max_samples
        self._ring: Deque[float] = deque(maxlen=max_samples)
        self._sorted: List[float] = []
        self._dirty = False
        self._count = 0
        self._sum = 0.0
        self._exemplar: Optional[Tuple[Dict[str, str], float, float]] = None
        self._lock = threading.Lock()

    def observe(self, value: float,
                exemplar: Optional[Mapping[str, str]] = None) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._ring.append(value)      # maxlen evicts the oldest
            self._dirty = True
            if exemplar:
                # newest exemplar wins: the point is "show me A trace for
                # this series", and recency beats any sampling scheme for
                # an incident drill-down (wall ts: exemplar timestamps are
                # reported instants, not interval math)
                self._exemplar = (dict(exemplar), float(value), time.time())

    @property
    def exemplar(self) -> Optional[Tuple[Dict[str, str], float, float]]:
        """(labels, value, unix_ts) of the newest exemplar-carrying
        observation (e.g. ``{"trace_id": ...}`` on the SLO path)."""
        with self._lock:
            return self._exemplar

    def percentile(self, q: float) -> float:
        with self._lock:
            if self._dirty:
                self._sorted = sorted(self._ring)
                self._dirty = False
            if not self._sorted:
                return 0.0
            idx = min(len(self._sorted) - 1, int(q / 100.0 * len(self._sorted)))
            return self._sorted[idx]

    def tail(self, n: int) -> List[float]:
        """The newest ``n`` observations, oldest first (bounded by the
        reservoir). Lets a bench window per-phase percentiles out of one
        histogram by differencing counts — the A/B consumer the KV-wire
        round uses; the exposition surfaces stay sum/count/percentile."""
        if n <= 0:
            return []
        with self._lock:
            return list(self._ring)[-n:]

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        """Total of all observed values (never evicted, unlike the
        percentile reservoir) — lets callers window a mean over an interval
        by differencing (sum, count) snapshots; bench.py windows the
        encoder micro-batch wait stats to the measured RAG phase this way."""
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0


class MetricsRegistry:
    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._lock = threading.Lock()
        # monotonic: uptime and rate windows are DURATIONS — an NTP step
        # on the wall clock must never yield a negative scrape window
        self._start = time.monotonic()
        # previous-snapshot counter values: the delta window for _rate_per_s
        self._rate_prev: Dict[str, float] = {}
        self._rate_t: float = self._start

    def counter(self, name: str,
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter(name, labels)
            return self._counters[key]

    def gauge(self, name: str,
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge(name, labels)
            return self._gauges[key]

    def histogram(self, name: str,
                  labels: Optional[Mapping[str, str]] = None) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = Histogram(name, labels=labels)
            return self._histograms[key]

    def family(self, name: str) -> Dict[LabelKey, float]:
        """Every live series of one counter/gauge family, keyed by its
        label set — the read surface label-bounded aggregations (the
        usage plane's per-worker MFU card, the cardinality-cap tests)
        use instead of groping through a full snapshot()."""
        with self._lock:
            out: Dict[LabelKey, float] = {
                lk: c.value for (n, lk), c in self._counters.items()
                if n == name}
            out.update({lk: g.value for (n, lk), g in self._gauges.items()
                        if n == name})
        return out

    def snapshot(self) -> Dict[str, object]:
        """JSON metrics blob. Counters carry both a lifetime ``_per_s`` and
        a ``_rate_per_s`` windowed over the interval since the previous
        snapshot — with a periodic scraper that window IS the scrape
        interval, so the rate tracks *current* throughput. Concurrent
        scrapers share the window state (each scrape resets it); point one
        collector at a process, not five.
        """
        now = time.monotonic()
        uptime = now - self._start
        with self._lock:
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            window = now - self._rate_t
            prev = self._rate_prev
            # capture values and swap the window state under ONE lock hold:
            # a concurrent scrape then deltas against THIS capture over its
            # own (short) window — never lifetime totals over microseconds
            values = {(name, lk): c.value
                      for (name, lk), c in self._counters.items()}
            self._rate_prev = {_render_name(name, lk): v
                               for (name, lk), v in values.items()}
            self._rate_t = now
        out: Dict[str, object] = {"uptime_s": round(uptime, 3),
                                  "rate_window_s": round(window, 3)}
        for (name, lk), value in values.items():
            key = _render_name(name, lk)
            out[key] = value
            out[f"{key}_per_s"] = round(value / uptime, 4) if uptime > 0 else 0.0
            delta = value - prev.get(key, 0.0)
            out[f"{key}_rate_per_s"] = (round(delta / window, 4)
                                        if window > 1e-9 else 0.0)
        for (name, lk), g in gauges.items():
            out[_render_name(name, lk)] = g.value
        for (name, lk), h in histograms.items():
            out[_render_name(name, lk)] = {
                "count": h.count,
                "sum": round(h.sum, 6),
                "mean": round(h.mean, 6),
                "p50": round(h.percentile(50), 6),
                "p90": round(h.percentile(90), 6),
                "p99": round(h.percentile(99), 6),
            }
        return out

    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4 — or, with
        ``openmetrics=True``, OpenMetrics 1.0 (``# EOF`` terminator and
        **exemplars**: a histogram observed with ``exemplar={"trace_id":
        ...}`` renders ``… # {trace_id="…"} <value> <ts>`` on its
        ``_count`` sample, so a latency series links to a concrete trace).
        Exemplars are OpenMetrics-only: format 0.0.4 parsers reject the
        ``#`` suffix, and existing scrapers keep byte-stable output.

        Counters/gauges render as single samples per labeled series;
        histograms render summary-style — ``name{quantile="0.5"}`` exact
        reservoir quantiles plus the cumulative ``name_count``/``name_sum``
        (what ``rate(name_sum[1m]) / rate(name_count[1m])`` dashboards
        consume).
        """
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
            start = self._start
        lines.append("# TYPE process_uptime_seconds gauge")
        lines.append(f"process_uptime_seconds {time.monotonic() - start:.3f}")
        typed: set = set()
        for (name, lk), c in counters:
            pname = _sanitize(name)
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} counter")
            lines.append(f"{_render_name(pname, lk)} {c.value}")
        for (name, lk), g in gauges:
            pname = _sanitize(name)
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{_render_name(pname, lk)} {g.value}")
        for (name, lk), h in histograms:
            pname = _sanitize(name)
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} summary")
            for q in (0.5, 0.9, 0.99):
                qkey = lk + (("quantile", f"{q}"),)
                lines.append(
                    f"{_render_name(pname, qkey)} {h.percentile(q * 100)}")
            count_line = f"{_render_name(pname + '_count', lk)} {h.count}"
            if openmetrics:
                ex = h.exemplar
                if ex is not None:
                    ex_labels, ex_value, ex_ts = ex
                    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                                     for k, v in sorted(ex_labels.items()))
                    count_line += (f" # {{{inner}}} {ex_value} "
                                   f"{ex_ts:.3f}")
            lines.append(count_line)
            lines.append(f"{_render_name(pname + '_sum', lk)} {h.sum}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
