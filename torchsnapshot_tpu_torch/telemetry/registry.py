"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints, in order:

- **Thread-safe and asyncio-safe.** Every mutation is a few dict ops
  under one ``threading.Lock`` — no awaits, no I/O, callable from the
  scheduler's event loop, the mirror worker thread, and the async-take
  commit thread alike.
- **Near-zero cost when no sink is attached.** Recording is always on
  (a lock + dict update per observation, ~100 ns); the *sinks* — the
  JSONL event log and the Prometheus text file (sink.py) — only run
  when explicitly enabled via knobs. There is no per-observation
  callback machinery to pay for.
- **Stable exposition.** Series are keyed ``name{label="value",...}``
  with sorted labels — the Prometheus text convention — so counter
  snapshots, deltas, and the exposition writer all agree on identity.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Wall-clock buckets spanning sub-millisecond CRCs to multi-minute
# durable drains; +Inf is implicit (the overflow bucket).
DEFAULT_SECONDS_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_LabelItems = Tuple[Tuple[str, str], ...]
_SeriesKey = Tuple[str, _LabelItems]


def series_key(name: str, labels: Dict[str, str]) -> str:
    """Flattened series identity, Prometheus-style:
    ``name`` or ``name{k="v",...}`` with labels sorted by key."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`series_key` (reports parse counter deltas back
    into per-plugin tables with this)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for item in rest.rstrip("}").split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        labels[k] = v.strip('"')
    return name, labels


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1


class MetricsRegistry:
    """One process's metrics. Use the module-level singleton via
    ``telemetry.metrics()``; direct construction is for tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_SeriesKey, float] = {}
        self._gauges: Dict[_SeriesKey, float] = {}
        self._histograms: Dict[_SeriesKey, _Histogram] = {}

    # -- recording -------------------------------------------------------

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> _SeriesKey:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def counter_inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels: str) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def histogram_observe(
        self,
        name: str,
        value: float,
        buckets: Optional[Sequence[float]] = None,
        **labels: str,
    ) -> None:
        key = self._key(name, labels)
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = _Histogram(buckets or DEFAULT_SECONDS_BUCKETS)
                self._histograms[key] = hist
            hist.observe(value)

    # -- reading ---------------------------------------------------------

    def counters_snapshot(self) -> Dict[str, float]:
        """Flattened ``series -> value`` view of every counter; the
        baseline half of per-snapshot report deltas."""
        with self._lock:
            return {
                series_key(name, dict(labels)): v
                for (name, labels), v in self._counters.items()
            }

    def counters_delta_since(
        self, baseline: Dict[str, float]
    ) -> Dict[str, float]:
        """Counter movement since a :meth:`counters_snapshot`, zero-delta
        series dropped. Registry counters are process-global: concurrent
        work (another pipeline, the mirror) lands in the same window."""
        out: Dict[str, float] = {}
        for key, value in self.counters_snapshot().items():
            delta = value - baseline.get(key, 0.0)
            if delta:
                out[key] = delta
        return out

    def collect(self) -> Dict[str, Dict]:
        """Full dump for the exposition writer: ``{"counters": {...},
        "gauges": {...}, "histograms": {series: {"buckets": [(le,
        cumulative), ...], "sum": s, "count": n}}}``."""
        with self._lock:
            counters = {
                series_key(n, dict(l)): v
                for (n, l), v in self._counters.items()
            }
            gauges = {
                series_key(n, dict(l)): v for (n, l), v in self._gauges.items()
            }
            histograms = {}
            for (n, l), h in self._histograms.items():
                cumulative = []
                running = 0
                for le, c in zip(h.buckets, h.counts):
                    running += c
                    cumulative.append((le, running))
                cumulative.append((float("inf"), h.count))
                histograms[series_key(n, dict(l))] = {
                    "buckets": cumulative,
                    "sum": h.sum,
                    "count": h.count,
                }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def reset(self) -> None:
        """Drop everything (tests simulating a fresh process)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
