"""RSS sampling for proving bounded-memory checkpointing.

Copy of ``torchsnapshot_tpu/utils/rss_profiler.py``: a context manager
that samples the process RSS on a background thread (100 ms period) and
records deltas against the RSS at entry, with the same ``RSSDeltas``
fields, ``rss_peak_delta_bytes`` gauge and ``rss:peak`` instants. The JAX
module reads the RSS through ``psutil``, which is not a dependency here:
this one reads ``/proc/self/statm`` (resident pages times the page size),
as the scheduler reads ``/proc/meminfo``.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Generator, List

from .. import telemetry
from ..telemetry import names as metric_names
from ..telemetry.trace import get_recorder as _trace_recorder

_SAMPLE_PERIOD_SECONDS = 0.1
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")


def current_rss_bytes() -> int:
    """This process's resident set size, in bytes."""
    with open("/proc/self/statm", "rb") as f:
        return int(f.read().split()[1]) * _PAGE_SIZE


@dataclass
class RSSDeltas:
    """Sampled ``rss - rss_at_entry`` values, in bytes."""

    deltas: List[int] = field(default_factory=list)

    @property
    def peak_bytes(self) -> int:
        return max(self.deltas, default=0)


@contextmanager
def measure_rss_deltas(
    rss_deltas: RSSDeltas,
    sample_period_seconds: float = _SAMPLE_PERIOD_SECONDS,
) -> Generator[None, None, None]:
    """Sample RSS deltas into ``rss_deltas`` until the block exits.

    The sampler thread is joined on EVERY exit path (the block raising
    included), and its peak delta feeds the telemetry registry's
    ``rss_peak_delta_bytes`` gauge — bench runs and snapshot reports
    read memory pressure from the same place. Each NEW peak also lands
    as an ``rss:peak`` instant event in the flight recorder, so the
    moment host memory crested is placeable on the span timeline
    (which write/stage was in flight when RSS peaked)."""
    baseline = current_rss_bytes()
    stop = threading.Event()
    peak_seen = [0]

    def note(delta: int) -> None:
        rss_deltas.deltas.append(delta)
        if delta > peak_seen[0]:
            peak_seen[0] = delta
            _trace_recorder().instant(
                metric_names.INSTANT_RSS_PEAK, delta_bytes=delta
            )

    def sampler() -> None:
        while not stop.is_set():
            try:
                note(current_rss_bytes() - baseline)
            except Exception:  # noqa: BLE001 - a failed sample must not
                # wedge the thread (join below would then hang forever)
                break
            stop.wait(sample_period_seconds)

    thread = threading.Thread(
        target=sampler, name="rss-profiler", daemon=True
    )
    thread.start()
    try:
        yield
    finally:
        # Unconditional stop+join FIRST: nothing before the join may
        # raise, or an exception in the block would leak the sampler.
        stop.set()
        thread.join()
        try:
            note(current_rss_bytes() - baseline)
        finally:
            telemetry.metrics().gauge_set(
                metric_names.RSS_PEAK_DELTA_BYTES, rss_deltas.peak_bytes
            )
