"""Report sinks: JSONL event log + Prometheus text exposition.

Copy of ``torchsnapshot_tpu/telemetry/sink.py``. A failed op's report
(rank 0) also freezes an incident bundle (``telemetry/bundle.py``), as
in the JAX package.

Two knob-controlled outputs, both best-effort (a telemetry write must
never fail a checkpoint — failures log a warning and the operation
proceeds):

- **JSONL event log** — one ``SnapshotReport`` JSON object per line.
  ``TORCHSNAPSHOT_TPU_TELEMETRY_DIR`` appends to
  ``<dir>/events.jsonl``; without it, ``TORCHSNAPSHOT_TPU_TELEMETRY=1``
  appends to ``<snapshot_path>/.telemetry.jsonl`` when the snapshot
  path is local (bare/``fs://`` paths; a ``tiered://`` path uses its
  fast tier). Object-store paths have no append primitive, so they
  require the directory knob. Either package's
  ``load_events`` reads this log.
- **Prometheus text file** — ``TORCHSNAPSHOT_TPU_PROM_FILE`` names a
  path rewritten atomically (tmp + rename) with the registry's full
  state after every report emission; point a node-exporter textfile
  collector at it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import List, Optional

from .. import knobs
from . import names
from .registry import MetricsRegistry
from .report import SnapshotReport

logger: logging.Logger = logging.getLogger(__name__)

EVENTS_BASENAME = "events.jsonl"
SNAPSHOT_EVENTS_BASENAME = ".telemetry.jsonl"


def atomic_write_text(path: str, text: str) -> None:
    """Atomic file publish (pid-suffixed tmp + rename, parent created):
    a concurrent reader never observes a torn document. The one
    implementation behind every telemetry artifact that gets rewritten
    in place — the Prometheus textfile, trace exports, progress
    heartbeats, the step history."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)

# Last emitted report per (kind, snapshot path) — process-wide,
# lock-guarded: the in-memory channel the manager's step-history
# recorder reads — a save that just committed needs its own take
# report without re-parsing the sink file (which may not even be
# enabled). Keyed by path too: overlapping async saves (step N's
# commit thread finishing after step N+1's) must each find THEIR
# report, not whichever landed last.
_LAST_REPORTS: dict = {}
_LAST_REPORTS_LOCK = threading.Lock()


def last_report(
    *kinds: str, path: Optional[str] = None
) -> Optional[SnapshotReport]:
    """The most recent report emitted in this process among ``kinds``
    (any kind when none given), optionally restricted to one snapshot
    ``path``; None before a matching emission."""
    with _LAST_REPORTS_LOCK:
        candidates = [
            r
            for (k, p), r in _LAST_REPORTS.items()
            if (not kinds or k in kinds) and (path is None or p == path)
        ]
    if not candidates:
        return None
    return max(candidates, key=lambda r: r.unix_ts)


def local_fs_root(url_path: Optional[str]) -> Optional[str]:
    """The local directory a snapshot URL writes to, or None for
    object-store schemes. Tiered URLs resolve through the fast tier
    (where the take commits — and where an events file survives the
    durable mirror untouched, since the mirror only copies blobs the
    take recorded)."""
    if not url_path:
        return None
    if "://" not in url_path:
        return url_path
    if url_path.startswith("fs://"):
        return url_path[len("fs://") :]
    if url_path.startswith("tiered://"):
        from ..storage_plugin import split_tiered_url

        try:
            tiers = split_tiered_url(url_path)
        except ValueError:
            return None
        if tiers is not None:
            return local_fs_root(tiers[0])
    return None


def events_path_for(snapshot_path: Optional[str]) -> Optional[str]:
    """Where a report about ``snapshot_path`` should be appended, or
    None when no JSONL sink is configured."""
    telemetry_dir = knobs.get_telemetry_dir()
    if telemetry_dir:
        return os.path.join(telemetry_dir, EVENTS_BASENAME)
    if not knobs.is_telemetry_sink_enabled():
        return None
    root = local_fs_root(snapshot_path)
    if root is None:
        return None
    return os.path.join(root, SNAPSHOT_EVENTS_BASENAME)


def emit_report(
    report: SnapshotReport, registry: Optional[MetricsRegistry] = None
) -> Optional[str]:
    """Append ``report`` to the configured JSONL sink (returns the file
    written, or None when no sink applies) and refresh the Prometheus
    text file if one is configured. Never raises."""
    if registry is None:
        from . import metrics

        registry = metrics()
    registry.counter_inc(names.SNAPSHOT_REPORTS_TOTAL, kind=report.kind)
    with _LAST_REPORTS_LOCK:
        _LAST_REPORTS[(report.kind, report.path)] = report
        # Bounded: retention keyed by arbitrary paths must not grow
        # with an arbitrarily long run (one manager produces a new
        # path per step).
        while len(_LAST_REPORTS) > 64:
            _LAST_REPORTS.pop(next(iter(_LAST_REPORTS)))
    path: Optional[str] = None
    try:
        path = events_path_for(report.path)
        if path is not None:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(report.to_json() + "\n")
    except Exception as e:  # noqa: BLE001 - telemetry must not fail the op
        logger.warning("telemetry: could not append report to %r: %r", path, e)
        path = None
    prom = knobs.get_prometheus_textfile()
    if prom is not None:
        try:
            write_prometheus_textfile(prom, registry)
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "telemetry: could not write prometheus file %r: %r", prom, e
            )
    if report.error and report.rank == 0:
        # A failed op is a black-box trigger: freeze the evidence while
        # the failure's traces, heartbeats and ledger tail still exist.
        # Rate-limited and size-capped inside capture_bundle.
        try:
            from .bundle import capture_bundle

            capture_bundle(
                report.path,
                trigger="failed-op",
                reason=f"{report.kind}: {report.error}"[:200],
                snapshot_path=report.path,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("telemetry: failed-op bundle capture failed: %r", e)
    return path


def load_events(path: str) -> List[dict]:
    """Parse a JSONL event log, skipping torn/corrupt lines (a crash
    mid-append leaves at most one)."""
    events: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                logger.warning("telemetry: skipping corrupt event line")
    return events


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _fmt(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def render_prometheus(registry: MetricsRegistry) -> str:
    """The registry's full state in the Prometheus text format (0.0.4):
    counters, gauges, and histograms with cumulative ``le`` buckets."""
    data = registry.collect()
    lines: List[str] = []
    for series, value in sorted(data["counters"].items()):
        lines.append(f"{series} {_fmt(value)}")
    for series, value in sorted(data["gauges"].items()):
        lines.append(f"{series} {_fmt(value)}")
    for series, hist in sorted(data["histograms"].items()):
        name, brace, rest = series.partition("{")
        base_labels = rest.rstrip("}") if brace else ""
        for le, cumulative in hist["buckets"]:
            label_items = [f'le="{_fmt(le)}"']
            if base_labels:
                label_items.insert(0, base_labels)
            lines.append(
                f"{name}_bucket{{{','.join(label_items)}}} {cumulative}"
            )
        suffix = f"{{{base_labels}}}" if base_labels else ""
        lines.append(f"{name}_sum{suffix} {_fmt(hist['sum'])}")
        lines.append(f"{name}_count{suffix} {hist['count']}")
    return "\n".join(lines) + "\n"


def write_prometheus_textfile(
    path: str, registry: Optional[MetricsRegistry] = None
) -> None:
    """Atomic rewrite (tmp + rename): a scraper never reads a torn file."""
    if registry is None:
        from . import metrics

        registry = metrics()
    atomic_write_text(path, render_prometheus(registry))
