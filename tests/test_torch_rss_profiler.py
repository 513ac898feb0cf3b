"""The port's RSS profiler (``utils/rss_profiler.py``): the sampler sees
a large transient allocation, stays small without one, and marks each
new peak on the flight recorder.

Ports of the JAX package's ``tests/test_rss_profiler.py`` and of the
``rss:peak`` case of its ``tests/test_trace.py``. The port reads the RSS
from ``/proc/self/statm`` (no ``psutil``); the last case holds that
reading against ``psutil``'s, which this test environment has.
"""

import time

import numpy as np
import psutil

from torchsnapshot_tpu_torch.telemetry import names, trace
from torchsnapshot_tpu_torch.utils.rss_profiler import RSSDeltas, current_rss_bytes, measure_rss_deltas


def test_measures_peak_allocation() -> None:
    deltas = RSSDeltas()
    nbytes = 256 * 1024 * 1024
    with measure_rss_deltas(deltas, sample_period_seconds=0.01):
        blob = np.ones(nbytes // 8, dtype=np.float64)
        blob += 1.0  # touch every page
        s = float(blob.sum())
        del blob
    assert s > 0
    assert len(deltas.deltas) >= 1
    assert deltas.peak_bytes > nbytes // 2


def test_no_allocation_small_peak() -> None:
    deltas = RSSDeltas()
    with measure_rss_deltas(deltas, sample_period_seconds=0.01):
        x = sum(range(1000))
    assert x == 499500
    assert len(deltas.deltas) >= 1
    assert deltas.peak_bytes < 64 * 1024 * 1024


def test_rss_profiler_emits_peak_instant() -> None:
    rec = trace.get_recorder()
    mark = rec.mark()
    deltas = RSSDeltas()
    with measure_rss_deltas(deltas, sample_period_seconds=0.005):
        ballast = np.ones(8 << 20, dtype=np.uint8)
        ballast[::4096] = 2
        time.sleep(0.02)
    events = [e for e in rec.events_since(mark) if e["name"] == names.INSTANT_RSS_PEAK]
    assert events, "no rss:peak instant recorded"
    peaks = [e["args"]["delta_bytes"] for e in events]
    assert all(p > 0 for p in peaks) and peaks == sorted(peaks)
    del ballast


def test_statm_reading_matches_psutil() -> None:
    ballast = np.ones(32 << 20, dtype=np.uint8)
    ours, theirs = current_rss_bytes(), psutil.Process().memory_info().rss
    assert abs(ours - theirs) < 4 << 20
    del ballast
