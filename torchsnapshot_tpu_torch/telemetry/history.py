"""Rolling per-manager step-telemetry history + trend regression detection.

Copy of ``torchsnapshot_tpu/telemetry/history.py``, in the same schema, so
that a root that both packages' managers extended holds one history.
``detect_trend_regressions`` has no caller in this package until the
doctor is ported.

BENCH_r05's 120s -> 71s take-time swing was only diagnosable because a
human happened to be comparing two BENCH records by hand. This module
makes the comparison structural: every committed manager step — and
every manager-served restore, so recovery time trends too — appends a
compact summary of its SnapshotReport to
``<root>/.telemetry-history.jsonl`` (rank 0, local roots; a tiered root
uses its fast tier), bounded to the newest
``TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS`` records (default 512; <= 0
disables recording). ``doctor --trend`` / ``snapshot_stats trend``
then flag steps whose take time, per-phase time, throughput, or budget
wait sit outside a rolling median ± MAD baseline of the preceding
steps — the "this step regressed against the last N" check no longer
requires eyeballing Perfetto.

Summary schema (one JSON object per line)::

    {step, kind, path, unix_ts, take_s, phases: {...}, bytes_moved,
     blobs, mb_s, budget_wait_s, peak_staged_bytes, error}

``take_s`` is the pipeline's wall clock (the max phase-completion
offset).
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
from typing import Any, Dict, List, Optional

from .. import knobs
from .report import SnapshotReport

logger: logging.Logger = logging.getLogger(__name__)

HISTORY_BASENAME = ".telemetry-history.jsonl"

# Serializes the read-trim-rewrite append cycle: two overlapping
# async-save commit threads appending concurrently must not lose a
# record (or tear the shared pid-suffixed tmp file).
_APPEND_LOCK = threading.Lock()

# Trend thresholds (documented in docs/observability.md): a value
# regresses when its deviation exceeds max(MAD_K * MAD, MIN_REL *
# median, the metric's absolute noise floor) — the MAD term adapts to
# noisy histories, the relative floor keeps a perfectly-flat history
# (MAD 0) from flagging, and the absolute floor keeps millisecond-scale
# checkpoints (where 3-decimal rounding alone doubles a value) from
# producing false verdicts.
TREND_WINDOW = 8
TREND_MAD_K = 4.0
TREND_MIN_REL = 0.3
# Absolute noise floors: time-like metrics below this deviation carry
# no operational signal (the phase offsets themselves round to 1 ms);
# throughput is a secondary signal (every real throughput regression
# shows up in take_s too), so its floor is set high enough that the
# garbage rates of sub-10 ms pipelines never flag.
TREND_MIN_ABS_S = 0.05
TREND_MIN_ABS_MB_S = 5.0
# Fewer prior records than this and the baseline carries no signal.
TREND_MIN_BASELINE = 2


def history_path_for(root: str) -> Optional[str]:
    """Where a manager root's history lives, or None for object-store
    roots (no local append primitive; history is a local operator aid,
    not a durability artifact)."""
    from .sink import local_fs_root

    local = local_fs_root(root)
    if local is None:
        return None
    return os.path.join(local, HISTORY_BASENAME)


def summarize_report(
    report: SnapshotReport, step: Optional[int] = None
) -> Dict[str, Any]:
    """One step's compact history record from its SnapshotReport."""
    phases = dict(report.phases)
    take_s = max(phases.values(), default=0.0)
    from . import safe_rate_mb_s

    return {
        "step": step,
        "kind": report.kind,
        "path": report.path,
        "unix_ts": round(report.unix_ts, 3),
        "take_s": round(take_s, 3),
        "phases": phases,
        "bytes_moved": report.bytes_moved,
        "blobs": report.blobs,
        "mb_s": round(safe_rate_mb_s(report.bytes_moved, take_s), 3),
        "budget_wait_s": round(report.budget_wait_s, 6),
        "peak_staged_bytes": report.peak_staged_bytes,
        # Async takes: the training-visible span — None elsewhere.
        # Rides into doctor --trend so a step whose visible time creeps
        # up (a deferral regression) flags like any other metric.
        "visible_s": (
            round(report.visible_s, 6) if report.visible_s is not None else None
        ),
        # Cross-rank coordination cost (None for single-process ops):
        # barrier waits plus max(store wire time, exchange wall) — the
        # exchange's own store round trips live inside exchange_s, so
        # summing both would double-charge them; same formula as the
        # doctor's coordination-bound rule, whose trend companion this
        # series is (a step whose coordination time creeps up — world
        # grew, store degraded — flags like any other metric).
        "coordination_s": (
            round(
                float(report.coordination.get("barrier_wait_s", 0.0))
                + max(
                    float(report.coordination.get("store_s", 0.0)),
                    float(report.coordination.get("exchange_s", 0.0)),
                ),
                6,
            )
            if report.coordination is not None
            else None
        ),
        # Wall the op spent on actual sockets (None for ops that put
        # nothing on the wire — all-zero baselines never flag): dial
        # time plus request/reply round-trip time from the report's
        # wire split. The trend companion of the wire-dial-stalled /
        # wire-hot-endpoint fleet rules — a step whose socket time
        # creeps up (backlog stall, hot owner) flags here first.
        "wire_s": (
            round(
                float(report.wire.get("dial_s", 0.0))
                + float(report.wire.get("rpc_s", 0.0)),
                6,
            )
            if report.wire is not None
            else None
        ),
        # Which write-path variant served the take's bytes (vectorized /
        # direct / fused / buffered): alongside ``tunables``, what lets
        # doctor --trend correlate a write-path knob flip with the
        # efficiency move it caused.
        "write_path": (
            dict(report.write_path) if report.write_path is not None else None
        ),
        # The effective tunable-knob values the take ran under: lets a
        # trend regression be correlated with the knob change that
        # caused it (the autotuner's decision log cross-references the
        # same keys).
        "tunables": (
            dict(report.tunables) if report.tunables is not None else None
        ),
        # Blocking-chain attribution (telemetry/critpath.py; None for
        # pre-critpath reports / overrun trace windows): the dominant
        # path segment, attribution coverage, and per-segment gated
        # seconds. Feeds one ``critpath_<segment>_s`` trend series per
        # segment plus the doctor's critical-path-shifted rule — a step
        # whose bottleneck MOVED flags even when the wall barely did.
        "critpath": (
            {
                "dominant": report.critical_path.get("dominant"),
                "coverage": report.critical_path.get("coverage"),
                "segments": {
                    k: round(float(v), 6)
                    for k, v in (
                        report.critical_path.get("segments") or {}
                    ).items()
                },
            }
            if report.critical_path
            else None
        ),
        "error": report.error,
    }


def append_summary(root: str, summary: Dict[str, Any]) -> Optional[str]:
    """Append one record, enforcing the rolling bound (atomic rewrite
    when trimming). Returns the history path, or None when disabled /
    non-local. Best-effort: history must never fail a save."""
    max_records = knobs.get_history_max_records()
    if max_records <= 0:
        return None
    path = history_path_for(root)
    if path is None:
        return None
    try:
        from .sink import atomic_write_text

        with _APPEND_LOCK:
            records = load_history(path)
            records.append(summary)
            if len(records) > max_records:
                records = records[-max_records:]
            # Atomic rewrite: the bound trims old records, and a
            # concurrent trend reader must never see a torn file.
            atomic_write_text(
                path,
                "".join(
                    json.dumps(rec, sort_keys=True) + "\n" for rec in records
                ),
            )
        return path
    except Exception as e:  # noqa: BLE001 - history must never fail a save
        logger.warning("history: could not append to %r: %r", path, e)
        return None


def load_history(path: str) -> List[Dict[str, Any]]:
    """Parse a history file, oldest first; [] when absent. Torn/corrupt
    lines are skipped (a crash mid-rewrite leaves at most one)."""
    if not os.path.exists(path):
        return []
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                logger.warning("history: skipping corrupt record line")
    return records


# ---------------------------------------------------------------------------
# Trend regression detection
# ---------------------------------------------------------------------------

# metric key -> (label, direction): +1 flags increases (times, waits),
# -1 flags decreases (throughput).
_TREND_METRICS = {
    "take_s": ("take wall clock", 1),
    "budget_wait_s": ("memory-budget wait", 1),
    "mb_s": ("throughput", -1),
    # Async takes' training-visible span (None/0 for sync takes —
    # all-zero baselines never flag): a step whose visible time creeps
    # up is a deferral regression, the same defect the doctor's
    # async-visible-stall rule catches per-op.
    "visible_s": ("async visible span", 1),
    # Coordination wall (barrier + store + exchange; None/0 for
    # single-process ops — all-zero baselines never flag): the trend
    # companion of the per-op coordination-bound rule.
    "coordination_s": ("coordination time", 1),
    # Socket wall (dial + RPC round trips; None/0 for wire-less ops):
    # the trend companion of the wire-dial-stalled fleet rule.
    "wire_s": ("wire time", 1),
}


def _metric_series(records: List[Dict[str, Any]]) -> Dict[str, List[float]]:
    """Aligned per-metric value series (take/budget/throughput plus one
    series per phase seen anywhere in the history; records missing a
    phase contribute 0.0 — a phase that appears is itself signal)."""
    series: Dict[str, List[float]] = {k: [] for k in _TREND_METRICS}
    phase_names = sorted(
        {p for r in records for p in (r.get("phases") or {})}
    )
    for p in phase_names:
        series[f"phase_{p}_s"] = []
    # Critical-path segments follow the phases' dynamic pattern: one
    # series per segment seen anywhere in the history (records missing
    # it contribute 0.0 — a segment that appears is itself signal).
    seg_names = sorted(
        {
            s
            for r in records
            for s in ((r.get("critpath") or {}).get("segments") or {})
        }
    )
    for s in seg_names:
        series[f"critpath_{s}_s"] = []
    for r in records:
        for k in _TREND_METRICS:
            series[k].append(float(r.get(k) or 0.0))
        phases = r.get("phases") or {}
        for p in phase_names:
            series[f"phase_{p}_s"].append(float(phases.get(p, 0.0)))
        segments = (r.get("critpath") or {}).get("segments") or {}
        for s in seg_names:
            series[f"critpath_{s}_s"].append(float(segments.get(s, 0.0)))
    return series


def _direction(metric: str) -> int:
    if metric in _TREND_METRICS:
        return _TREND_METRICS[metric][1]
    return 1  # phase durations: increases regress


def _abs_floor(metric: str) -> float:
    return TREND_MIN_ABS_MB_S if metric == "mb_s" else TREND_MIN_ABS_S


def detect_trend_regressions(
    records: List[Dict[str, Any]],
    window: int = TREND_WINDOW,
    mad_k: float = TREND_MAD_K,
    min_rel: float = TREND_MIN_REL,
) -> List[Dict[str, Any]]:
    """Regression evidence rows over a history (oldest first): each row
    names the record (step/path/kind), the metric, its value, and the
    rolling baseline (median, MAD over the preceding ``window`` records
    *of the same kind*) it breached. Throughput regresses downward;
    times upward. Kinds are separate populations: now that restores
    append history rows too (recovery-time trends), a restore's wall
    must neither pollute the take baseline nor be judged against it."""
    out: List[Dict[str, Any]] = []
    by_kind: Dict[str, List[int]] = {}
    for i, rec in enumerate(records):
        by_kind.setdefault(str(rec.get("kind") or "take"), []).append(i)
    for kind in sorted(by_kind):
        indices = by_kind[kind]
        if len(indices) <= TREND_MIN_BASELINE:
            continue
        group = [records[i] for i in indices]
        series = _metric_series(group)
        for metric, values in series.items():
            sign = _direction(metric)
            for i in range(TREND_MIN_BASELINE, len(values)):
                baseline = values[max(0, i - window) : i]
                if len(baseline) < TREND_MIN_BASELINE:
                    continue
                med = statistics.median(baseline)
                mad = statistics.median(abs(v - med) for v in baseline)
                threshold = max(
                    mad_k * mad, min_rel * abs(med), _abs_floor(metric)
                )
                deviation = sign * (values[i] - med)
                if deviation > threshold:
                    rec = group[i]
                    out.append(
                        {
                            "index": indices[i],
                            "step": rec.get("step"),
                            "kind": kind,
                            "path": rec.get("path"),
                            "metric": metric,
                            "value": round(values[i], 3),
                            "baseline_median": round(med, 3),
                            "baseline_mad": round(mad, 3),
                            "threshold": round(threshold, 3),
                            "window": len(baseline),
                        }
                    )
    out.sort(key=lambda row: (row["index"], row["metric"]))
    return out
