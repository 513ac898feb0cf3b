"""Checkpoint telemetry: the process-wide metrics registry, the span
recorder and its stall watchdog, per-operation reports with their
critical paths and their sinks, live progress heartbeats, the
per-manager step history, the run ledger and the goodput engine, and
above them the doctor, the SLO engine and incident bundles.

The counterpart of ``torchsnapshot_tpu/telemetry/__init__.py``, in the
same file formats: a take, restore or mirror job of the port leaves the
records a JAX run leaves (``.telemetry.jsonl`` reports with the sink on,
``.trace-<kind>-rank<r>.json`` exports with the trace sink on,
``.progress-rank<r>.json`` heartbeats, and under a manager root
``.telemetry-history.jsonl`` and ``.ledger.jsonl``), and each package's
readers parse the other's, with incident bundles under
``<root>/.bundles/`` and the autotuner's ``.tuner-state.json`` beside
them.

Under them all, the wire observatory (wire.py) puts a trace context on
every frame sent inside a ``wire.propagate`` block, counts frames, bytes,
dials and RPCs per endpoint, and runs the fleet metrics plane: bounded
``__obs/`` snapshots on the coordination store that ``telemetry fleet``
renders and ``doctor.diagnose_fleet`` judges.

``python -m torchsnapshot_tpu_torch.telemetry`` is the JAX package's
CLI: ``stats <events.jsonl>`` (the default), ``trace <snapshot>``,
``doctor <snapshot>`` (``--trend``, ``--bundle``, ``--fleet``),
``goodput <root>``, ``diff <a> <b>``, ``fleet <host:port | root>``,
``slo <root>`` and ``bundle <root>``.
"""

from __future__ import annotations

from . import (
    bundle,
    critpath,
    doctor,
    goodput,
    history,
    ledger,
    names,
    progress,
    slo,
    trace,
    watchdog,
    wire,
)
from .progress import current_progress
from .registry import (
    DEFAULT_SECONDS_BUCKETS,
    MetricsRegistry,
    parse_series_key,
    series_key,
)
from .report import (
    SnapshotReport,
    aggregate_across_ranks,
    build_report,
    clock_offsets_from_gather,
    merge_pipeline_telemetry,
)
from .sink import (
    emit_report,
    events_path_for,
    last_report,
    load_events,
    render_prometheus,
    write_prometheus_textfile,
)

__all__ = [
    "DEFAULT_SECONDS_BUCKETS",
    "MetricsRegistry",
    "SnapshotReport",
    "aggregate_across_ranks",
    "build_report",
    "bundle",
    "clock_offsets_from_gather",
    "critpath",
    "current_progress",
    "doctor",
    "emit_report",
    "events_path_for",
    "goodput",
    "history",
    "last_report",
    "ledger",
    "load_events",
    "merge_pipeline_telemetry",
    "metrics",
    "names",
    "observe_io",
    "parse_series_key",
    "progress",
    "record_phase",
    "render_prometheus",
    "reset_metrics",
    "reset_trace",
    "safe_rate_mb_s",
    "series_key",
    "slo",
    "trace",
    "watchdog",
    "wire",
    "write_prometheus_textfile",
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


def reset_trace() -> None:
    """Drop the flight recorder's ring and open-span table (tests
    simulating a fresh process)."""
    trace.get_recorder().reset()


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
