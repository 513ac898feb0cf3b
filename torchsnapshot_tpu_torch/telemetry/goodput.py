"""Run-level goodput: attribute a training run's wall time and storage
spend from its checkpoint ledger.

Copy of ``torchsnapshot_tpu/telemetry/goodput.py``: ``analyze`` of one
ledger gives the same attribution in either package. The doctor rules
that read it are not part of this package yet.

The LLM checkpoint I/O literature frames goodput/ETTR — not per-save
latency — as the metric that decides checkpoint interval and tiering
policy. This module is that calculation over the run ledger
(``telemetry/ledger.py``): every run's measured wall time is split into

- **train** — the residual: time the run made forward progress;
- **visible stall** — training blocked inside takes (the whole wall
  for sync takes, return-to-caller for async ones);
- **restore / recovery** — time spent serving restores (cold resume
  and post-interruption recovery alike);
- **lost work** — for each interrupted segment, the time between the
  last committed (or restored) progress point and the segment's last
  sign of life: work a restart replays. Where a preemption event
  recorded the step, the loss is also counted in steps.

The buckets sum to the ledger-measured wall time by construction
(train is the residual, clamped at zero). Overlapped overhead — the
async takes' background D2H drain, the tiered mirror's durability lag
— is reported alongside, NOT inside the sum: it cost bandwidth, not
train-visible time. Storage spend comes from the surviving
``step-committed`` records: bytes newly written vs. base-referenced
per retained step (the incremental reuse ratio is a direct scout for a
content-addressed store), plus per-tier totals from the mirror's
settle events.

Three surfaces:

- CLI — ``python -m torchsnapshot_tpu_torch.telemetry.goodput <root>``
  (``--json`` for the machine-readable analysis);
- Prometheus — :func:`publish_gauges` refreshes the ``goodput_*``
  gauges in the process registry (the manager calls it after every
  committed step);
- doctor — the ``goodput-degraded`` / ``recovery-cost-high`` rules
  (telemetry/doctor.py) emit ranked verdicts citing ledger records.

See docs/goodput.md.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

from . import names
from .ledger import find_ledger_for, load_ledger

logger: logging.Logger = logging.getLogger(__name__)


def _ts(record: Dict[str, Any], default: float = 0.0) -> float:
    try:
        return float(record.get("unix_ts", default))
    except (TypeError, ValueError):
        return default


def _split_segments(
    records: Sequence[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Raw segments: one per run-start, each carrying its start record
    and the events that followed it (pre-run-start records — a ledger
    whose trim dropped history — are ignored; the trim re-anchors the
    newest run-start so the active segment never loses its start)."""
    out: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for r in records:
        if r.get("event") == names.EVENT_RUN_START:
            cur = {"start": r, "records": []}
            out.append(cur)
        elif cur is not None:
            cur["records"].append(r)
    return out


def _segment_summary(
    raw: Dict[str, Any], interrupted: bool
) -> Dict[str, Any]:
    start = raw["start"]
    recs: List[Dict[str, Any]] = raw["records"]
    start_ts = _ts(start)
    end_ts = max([start_ts] + [_ts(r, start_ts) for r in recs])
    wall = max(0.0, end_ts - start_ts)

    visible = 0.0
    restore = 0.0
    recovery_restore = 0.0
    drain = 0.0
    mirror_lags: List[float] = []
    commits: List[Dict[str, Any]] = []
    preempt: Optional[Dict[str, Any]] = None
    last_progress_ts = start_ts
    for r in recs:
        ev = r.get("event")
        if ev == names.EVENT_VISIBLE_STALL:
            visible += float(r.get("visible_s") or 0.0)
        elif ev == names.EVENT_RESTORE_SERVED:
            restore += float(r.get("restore_s") or 0.0)
            # Restores before the segment's first commit are the
            # RECOVERY restores (resuming from the previous segment's
            # checkpoint); later ones are deliberate (eval rollbacks,
            # restore_best) and must not inflate the preceding
            # interruption's recovery cost.
            if not commits:
                recovery_restore += float(r.get("restore_s") or 0.0)
            last_progress_ts = max(last_progress_ts, _ts(r, start_ts))
        elif ev == names.EVENT_STAGED_DRAIN:
            drain += float(r.get("drain_s") or 0.0)
        elif ev == names.EVENT_MIRROR_SETTLED:
            mirror_lags.append(float(r.get("lag_s") or 0.0))
        elif ev == names.EVENT_STEP_COMMITTED:
            commits.append(r)
            last_progress_ts = max(last_progress_ts, _ts(r, start_ts))
        elif ev == names.EVENT_PREEMPTION and not r.get("gave_up"):
            preempt = r

    last_commit_step = commits[-1].get("step") if commits else None
    lost_work = 0.0
    lost_steps: Optional[int] = None
    if interrupted:
        # Work after the last durable/recovered progress point died
        # with the segment — a restart replays it. In steps when the
        # preemption saver recorded where the world was.
        lost_work = max(0.0, end_ts - last_progress_ts)
        if (
            preempt is not None
            and preempt.get("step") is not None
            and last_commit_step is not None
        ):
            lost_steps = max(
                0, int(preempt["step"]) - int(last_commit_step)
            )
    train = max(0.0, wall - visible - restore - lost_work)
    return {
        "segment": start.get("segment"),
        "start_ts": round(start_ts, 6),
        "end_ts": round(end_ts, 6),
        "wall_s": round(wall, 6),
        "train_s": round(train, 6),
        "visible_stall_s": round(visible, 6),
        "restore_s": round(restore, 6),
        "recovery_restore_s": round(recovery_restore, 6),
        "lost_work_s": round(lost_work, 6),
        "lost_steps": lost_steps,
        "staged_drain_s": round(drain, 6),
        "mirror_lag_max_s": round(max(mirror_lags), 3) if mirror_lags else 0.0,
        "steps_committed": len(commits),
        "last_committed_step": last_commit_step,
        "preemption_step": (
            preempt.get("step") if preempt is not None else None
        ),
        "interrupted": interrupted,
    }


def _storage_summary(
    records: Sequence[Dict[str, Any]]
) -> Dict[str, Any]:
    committed: Dict[int, Dict[str, Any]] = {}
    reclaimed_bytes = 0
    reclaimed_steps = 0
    mirror_settles: List[Dict[str, Any]] = []
    saw_mirror = False
    for r in records:
        ev = r.get("event")
        if ev == names.EVENT_STEP_COMMITTED and r.get("step") is not None:
            committed[int(r["step"])] = r
        elif ev == names.EVENT_GC_RECLAIMED:
            reclaimed_bytes += int(r.get("bytes_reclaimed") or 0)
            reclaimed_steps += 1
        elif ev == names.EVENT_MIRROR_SETTLED:
            saw_mirror = True
            mirror_settles.append(r)
    # Per-tier parity: 'primary' counts only RETAINED steps (GC prunes
    # their step-committed records), so the durable sum must filter the
    # same way — mirror-settled events survive pruning for time
    # attribution, and summing them all would report GC'd history as
    # live durable spend.
    durable_bytes = sum(
        int(r.get("nbytes") or 0)
        for r in mirror_settles
        if not r.get("error")
        and r.get("step") is not None
        and int(r["step"]) in committed
    )
    steps = sorted(committed)
    new_total = sum(
        int(committed[s].get("bytes_new") or 0) for s in steps
    )
    reused_total = sum(
        int(committed[s].get("bytes_reused") or 0) for s in steps
    )
    grand_total = sum(
        int(committed[s].get("bytes_total") or 0) for s in steps
    )
    by_tier: Dict[str, int] = {"primary": new_total}
    if saw_mirror:
        by_tier["durable"] = durable_bytes
    return {
        "retained_steps": len(steps),
        "per_step": [
            {
                "step": s,
                "bytes_new": int(committed[s].get("bytes_new") or 0),
                "bytes_reused": int(committed[s].get("bytes_reused") or 0),
                "bytes_total": int(committed[s].get("bytes_total") or 0),
            }
            for s in steps
        ],
        "bytes_new_total": new_total,
        "bytes_reused_total": reused_total,
        "bytes_per_retained_step": (
            int(new_total / len(steps)) if steps else 0
        ),
        # How much of the retained state rides on base references
        # instead of fresh bytes — keep-last-N at ~1x storage is this
        # ratio approaching 1.0.
        "incremental_reuse_ratio": (
            round(reused_total / grand_total, 4) if grand_total else 0.0
        ),
        "reclaimed_steps": reclaimed_steps,
        "reclaimed_bytes": reclaimed_bytes,
        "by_tier": by_tier,
    }


def analyze(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The full ledger analysis: per-run attribution (runs split on run
    id, segments on run-start events) plus the storage-cost summary."""
    raw_segments = _split_segments(records)
    grouped: List[Dict[str, Any]] = []
    for seg in raw_segments:
        rid = str(seg["start"].get("run_id") or "?")
        if not grouped or grouped[-1]["run_id"] != rid:
            grouped.append({"run_id": rid, "raw": []})
        grouped[-1]["raw"].append(seg)

    runs: List[Dict[str, Any]] = []
    for g in grouped:
        n = len(g["raw"])
        segments: List[Dict[str, Any]] = []
        for idx, seg in enumerate(g["raw"]):
            followed = idx < n - 1
            # The final segment is open (or ended cleanly) unless its
            # trail stops at an un-acted-on preemption notice.
            tail_preempted = (
                not followed
                and bool(seg["records"])
                and seg["records"][-1].get("event") == names.EVENT_PREEMPTION
                and not seg["records"][-1].get("gave_up")
            )
            segments.append(
                _segment_summary(seg, interrupted=followed or tail_preempted)
            )
        wall = sum(s["wall_s"] for s in segments)
        visible = sum(s["visible_stall_s"] for s in segments)
        restore = sum(s["restore_s"] for s in segments)
        lost = sum(s["lost_work_s"] for s in segments)
        train = sum(s["train_s"] for s in segments)
        downtime = sum(
            max(0.0, b["start_ts"] - a["end_ts"])
            for a, b in zip(segments, segments[1:])
        )
        known_lost_steps = [
            s["lost_steps"] for s in segments if s["lost_steps"] is not None
        ]
        interruptions: List[Dict[str, Any]] = []
        for idx, s in enumerate(segments):
            if not s["interrupted"]:
                continue
            nxt = segments[idx + 1] if idx + 1 < len(segments) else None
            restore_next = (
                nxt["recovery_restore_s"] if nxt is not None else 0.0
            )
            restart_gap = (
                max(0.0, nxt["start_ts"] - s["end_ts"])
                if nxt is not None
                else 0.0
            )
            interruptions.append(
                {
                    "segment": s["segment"],
                    "preemption_step": s["preemption_step"],
                    "last_committed_step": s["last_committed_step"],
                    "lost_steps": s["lost_steps"],
                    "lost_work_s": s["lost_work_s"],
                    "restore_s": round(restore_next, 6),
                    "restart_gap_s": round(restart_gap, 6),
                    # The checkpoint-attributable price of the
                    # interruption: replayed work + the restore that
                    # recovered it (the restart gap is scheduling, cited
                    # but not charged).
                    "recovery_cost_s": round(
                        s["lost_work_s"] + restore_next, 6
                    ),
                }
            )
        runs.append(
            {
                "run_id": g["run_id"],
                "segments": segments,
                "wall_s": round(wall, 6),
                "downtime_s": round(downtime, 6),
                "train_s": round(train, 6),
                "visible_stall_s": round(visible, 6),
                "restore_s": round(restore, 6),
                "lost_work_s": round(lost, 6),
                "lost_steps": (
                    sum(known_lost_steps) if known_lost_steps else None
                ),
                "staged_drain_s": round(
                    sum(s["staged_drain_s"] for s in segments), 6
                ),
                "mirror_lag_max_s": max(
                    (s["mirror_lag_max_s"] for s in segments), default=0.0
                ),
                "steps_committed": sum(
                    s["steps_committed"] for s in segments
                ),
                "interruptions": interruptions,
                "overhead_fraction": (
                    round((visible + restore + lost) / wall, 4)
                    if wall > 0
                    else 0.0
                ),
            }
        )
    return {
        "events": len(records),
        "runs": runs,
        "storage": _storage_summary(records),
    }


def latest_run(analysis: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    runs = analysis.get("runs") or []
    return runs[-1] if runs else None


def analyze_root(root: str) -> Optional[Dict[str, Any]]:
    """Load + analyze a manager root's (or ledger file's) ledger; None
    when no ledger exists."""
    path = find_ledger_for(root)
    if path is None:
        return None
    analysis = analyze(load_ledger(path))
    analysis["ledger_file"] = path
    return analysis


# ---------------------------------------------------------------------------
# Prometheus surface
# ---------------------------------------------------------------------------


def publish_gauges(root: str, registry: Optional[Any] = None) -> bool:
    """Refresh the ``goodput_*`` gauges from ``root``'s ledger (latest
    run), and rewrite the Prometheus textfile if one is configured —
    the manager calls this after every committed step so scrapes track
    the run, not just the last op. Best-effort; returns False when no
    ledger exists or publication failed."""
    try:
        analysis = analyze_root(root)
        if analysis is None:
            return False
        run = latest_run(analysis)
        if run is None:
            return False
        if registry is None:
            from . import metrics

            registry = metrics()
        storage = analysis["storage"]
        registry.gauge_set(
            names.GOODPUT_OVERHEAD_FRACTION, run["overhead_fraction"]
        )
        registry.gauge_set(names.GOODPUT_TRAIN_SECONDS, run["train_s"])
        registry.gauge_set(
            names.GOODPUT_VISIBLE_STALL_SECONDS, run["visible_stall_s"]
        )
        registry.gauge_set(names.GOODPUT_RECOVERY_SECONDS, run["restore_s"])
        registry.gauge_set(
            names.GOODPUT_LOST_WORK_SECONDS, run["lost_work_s"]
        )
        registry.gauge_set(
            names.GOODPUT_LOST_STEPS, run["lost_steps"] or 0
        )
        registry.gauge_set(
            names.GOODPUT_STORAGE_BYTES_PER_STEP,
            storage["bytes_per_retained_step"],
        )
        registry.gauge_set(
            names.GOODPUT_INCREMENTAL_REUSE_RATIO,
            storage["incremental_reuse_ratio"],
        )
        from .. import knobs

        prom = knobs.get_prometheus_textfile()
        if prom is not None:
            from .sink import write_prometheus_textfile

            write_prometheus_textfile(prom, registry)
        return True
    except Exception as e:  # noqa: BLE001 - telemetry must not fail the op
        logger.warning("goodput: gauge publication failed: %r", e)
        return False


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _pct(part: float, whole: float) -> str:
    return f"{100.0 * part / whole:5.1f}%" if whole > 0 else "    -"


def _mb(nbytes: float) -> float:
    return nbytes / 1024**2


def render(analysis: Dict[str, Any]) -> str:
    lines: List[str] = []
    for run in analysis["runs"]:
        wall = run["wall_s"]
        lines.append(
            f"run {run['run_id']}: {len(run['segments'])} segment(s), "
            f"wall {wall:.1f}s"
            + (
                f" (+{run['downtime_s']:.1f}s restart downtime)"
                if run["downtime_s"] > 0
                else ""
            )
            + f", {run['steps_committed']} step(s) committed, "
            f"checkpoint overhead {100.0 * run['overhead_fraction']:.1f}%"
        )
        lines.append(
            f"  train            {run['train_s']:>10.2f} s  "
            f"{_pct(run['train_s'], wall)}"
        )
        lines.append(
            f"  visible stall    {run['visible_stall_s']:>10.2f} s  "
            f"{_pct(run['visible_stall_s'], wall)}"
        )
        lines.append(
            f"  restore/recovery {run['restore_s']:>10.2f} s  "
            f"{_pct(run['restore_s'], wall)}"
        )
        lost_steps = (
            f"  ({run['lost_steps']} step(s))"
            if run["lost_steps"] is not None
            else ""
        )
        lines.append(
            f"  lost work        {run['lost_work_s']:>10.2f} s  "
            f"{_pct(run['lost_work_s'], wall)}{lost_steps}"
        )
        lines.append(
            f"  overlapped (not charged): staged drain "
            f"{run['staged_drain_s']:.2f} s, mirror lag max "
            f"{run['mirror_lag_max_s']:.2f} s"
        )
        for itr in run["interruptions"]:
            where = (
                f"preempted at step {itr['preemption_step']}"
                if itr["preemption_step"] is not None
                else "interrupted"
            )
            lines.append(
                f"  segment {itr['segment']} {where}: recovery cost "
                f"{itr['recovery_cost_s']:.2f}s "
                f"(lost work {itr['lost_work_s']:.2f}s + restore "
                f"{itr['restore_s']:.2f}s; restart gap "
                f"{itr['restart_gap_s']:.2f}s)"
            )
    storage = analysis["storage"]
    if storage["retained_steps"]:
        tier_str = ", ".join(
            f"{tier} {_mb(b):.1f} MB"
            for tier, b in sorted(storage["by_tier"].items())
        )
        lines.append(
            f"storage: {storage['retained_steps']} retained step(s), "
            f"{_mb(storage['bytes_per_retained_step']):.1f} MB/step new, "
            f"incremental reuse "
            f"{100.0 * storage['incremental_reuse_ratio']:.1f}%, "
            f"reclaimed {_mb(storage['reclaimed_bytes']):.1f} MB "
            f"across {storage['reclaimed_steps']} GC'd step(s) "
            f"[{tier_str}]"
        )
    if not lines:
        lines.append("no runs recorded")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json as _json

    p = argparse.ArgumentParser(
        prog="python -m torchsnapshot_tpu_torch.telemetry.goodput",
        description=(
            "Attribute a training run's wall time (train vs. checkpoint "
            "overhead vs. recovery vs. lost work) and storage spend "
            "from its run ledger (<root>/.ledger.jsonl)."
        ),
    )
    p.add_argument(
        "root",
        help="manager root (or a .ledger.jsonl file) to analyze",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable analysis instead of the text report",
    )
    args = p.parse_args(list(argv) if argv is not None else None)

    analysis = analyze_root(args.root)
    if analysis is None:
        print(
            f"goodput: no run ledger found for {args.root!r} (ledgers "
            f"record at <root>/.ledger.jsonl; enable with "
            f"TORCHSNAPSHOT_TPU_LEDGER=1)"
        )
        return 1
    if args.json:
        print(_json.dumps(analysis, indent=1, sort_keys=True))
        return 0
    print(f"goodput: {analysis['ledger_file']} ({analysis['events']} event(s))")
    print(render(analysis))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
