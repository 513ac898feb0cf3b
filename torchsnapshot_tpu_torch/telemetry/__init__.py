"""Checkpoint telemetry: the process-wide metrics registry and the span
recorder that the write/read pipeline and the storage plugins record into.

The counterpart of ``torchsnapshot_tpu/telemetry/__init__.py``, cut to
what the take/restore path calls: ``metrics()``, ``record_phase``,
``observe_io`` and ``safe_rate_mb_s``. The per-operation reports, sinks,
doctor, SLO engine, incident bundles, ledger and watchdog are not part of
this package yet.
"""

from __future__ import annotations

from . import names, trace
from .registry import MetricsRegistry

__all__ = [
    "MetricsRegistry",
    "metrics",
    "names",
    "observe_io",
    "record_phase",
    "reset_metrics",
    "safe_rate_mb_s",
    "trace",
]

_REGISTRY = MetricsRegistry()

# Below this elapsed time a bytes/elapsed rate is numerical noise.
MIN_RATE_ELAPSED_S = 1e-3


def safe_rate_mb_s(nbytes: float, elapsed_s: float) -> float:
    """Throughput in MB/s, 0.0 when the elapsed time is zero or too
    small to carry signal (guards the div-by-~0 -> inf MB/s report)."""
    if elapsed_s < MIN_RATE_ELAPSED_S:
        return 0.0
    return nbytes / 1024**2 / elapsed_s


def metrics() -> MetricsRegistry:
    """The process-wide registry every instrumented layer records into."""
    return _REGISTRY


def reset_metrics() -> None:
    """Drop all recorded metrics (tests simulating a fresh process)."""
    _REGISTRY.reset()


def record_phase(phase: str, elapsed_s: float) -> None:
    """Publish one pipeline-phase completion into the registry's phase
    histogram and its last-writer-wins phase-timing channel."""
    _REGISTRY.record_phase_timing(phase, elapsed_s)
    _REGISTRY.histogram_observe(
        names.SNAPSHOT_PHASE_SECONDS, elapsed_s, phase=phase
    )


def observe_io(plugin: str, op: str, nbytes: int, seconds: float) -> None:
    """One storage operation's accounting (op: "write" | "read")."""
    if op == "write":
        _REGISTRY.counter_inc(
            names.STORAGE_WRITE_BYTES_TOTAL, nbytes, plugin=plugin
        )
        _REGISTRY.counter_inc(names.STORAGE_WRITE_OPS_TOTAL, plugin=plugin)
        _REGISTRY.histogram_observe(
            names.STORAGE_WRITE_SECONDS, seconds, plugin=plugin
        )
    else:
        _REGISTRY.counter_inc(
            names.STORAGE_READ_BYTES_TOTAL, nbytes, plugin=plugin
        )
        _REGISTRY.counter_inc(names.STORAGE_READ_OPS_TOTAL, plugin=plugin)
        _REGISTRY.histogram_observe(
            names.STORAGE_READ_SECONDS, seconds, plugin=plugin
        )
