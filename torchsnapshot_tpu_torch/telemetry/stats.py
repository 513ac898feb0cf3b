"""snapshot-stats: render per-step tables from a telemetry event log.

Copy of ``torchsnapshot_tpu/telemetry/stats.py``: benchmarks and
operators read the same JSONL event log the sinks write, so the numbers
in a benchmark table and the numbers an operator tails are the same.

CLI (``python -m torchsnapshot_tpu_torch.telemetry``)::

    snapshot-stats <events.jsonl> [--kind take] [--path-contains step_]
    snapshot-stats stats <events.jsonl>   # the same, by name
    snapshot-stats trace <snapshot-dir>   # merge per-rank flight-recorder
                                          # traces (telemetry/trace.py)
    snapshot-stats doctor <snapshot-dir>  # rule-based diagnosis
                                          # (telemetry/doctor.py)
    snapshot-stats trend <manager-root>   # per-step regression check
                                          # (doctor --trend shorthand)
    snapshot-stats goodput <manager-root> # run-level wall-time
                                          # attribution + storage spend
                                          # (telemetry/goodput.py)
    snapshot-stats diff <before> <after>  # critical-path / bench-record
                                          # differential comparison
                                          # (telemetry/critpath.py;
                                          # operands may be incident
                                          # bundle dirs)
    snapshot-stats fleet <host:port|root> # live fleet table of the wire
                                          # observatory's __obs/ plane
                                          # (telemetry/wire.py)
    snapshot-stats slo <root>             # judge the declared SLOs with
                                          # burn-rate math
                                          # (telemetry/slo.py)
    snapshot-stats bundle <root>          # list / capture incident
                                          # black-box bundles
                                          # (telemetry/bundle.py)

Output: one row per (path, kind, rank) record — phase durations,
bytes, throughput, budget wait, retries — followed by a per-tier
throughput table and any cross-rank straggler lines rank 0 attached.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from .sink import SNAPSHOT_EVENTS_BASENAME, load_events


def find_events_for(snapshot_path: str) -> List[dict]:
    """Events recorded for one snapshot, newest last; [] when none
    exist. Used by ``fsck --stats``. Probes both sinks: the
    snapshot-adjacent ``.telemetry.jsonl``, and — when
    ``TORCHSNAPSHOT_TPU_TELEMETRY_DIR`` is set (the higher-precedence
    sink, where reports actually went) — that directory's
    ``events.jsonl`` filtered to this snapshot's path."""
    from .. import knobs
    from .sink import EVENTS_BASENAME, local_fs_root

    events: List[dict] = []
    root = local_fs_root(snapshot_path)
    if root is not None:
        path = os.path.join(root, SNAPSHOT_EVENTS_BASENAME)
        if os.path.exists(path):
            events.extend(load_events(path))
    telemetry_dir = knobs.get_telemetry_dir()
    if telemetry_dir:
        path = os.path.join(telemetry_dir, EVENTS_BASENAME)
        if os.path.exists(path):
            want = _norm_snapshot_path(snapshot_path)
            events.extend(
                e
                for e in load_events(path)
                if _norm_snapshot_path(str(e.get("path", ""))) == want
            )
    return events


def _norm_snapshot_path(path: str) -> str:
    """Spelling-insensitive snapshot-path identity for event filtering:
    local paths resolve (relative vs absolute, trailing slash); URL
    paths only drop the trailing slash."""
    if "://" in path:
        return path.rstrip("/")
    return os.path.normpath(os.path.abspath(path))


def _mb(nbytes: float) -> float:
    return nbytes / 1024**2


def _rate_mb_s(nbytes: float, seconds: float) -> Optional[float]:
    """Table variant of the shared guard: None (rendered '-') when the
    elapsed time carries no signal."""
    from . import MIN_RATE_ELAPSED_S, safe_rate_mb_s

    if seconds < MIN_RATE_ELAPSED_S:
        return None
    return safe_rate_mb_s(nbytes, seconds)


def _fmt_rate(rate: Optional[float]) -> str:
    return "-" if rate is None else f"{rate:.1f}"


def _short_path(path: str, limit: int = 40) -> str:
    return path if len(path) <= limit else "…" + path[-(limit - 1) :]


def render_summary(events: Sequence[dict]) -> str:
    """Per-record table + per-plugin throughput + straggler lines."""
    if not events:
        return "no telemetry events"
    lines: List[str] = []
    header = (
        f"{'path':<42} {'kind':<13} {'rank':>4} {'phases':<34} "
        f"{'MB':>9} {'MB/s':>8} {'wait_s':>7} {'retries':>7}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for ev in events:
        phases = ev.get("phases", {})
        phase_str = " ".join(
            f"{name}={phases[name]:.2f}s" for name in sorted(phases)
        )
        total_bytes = ev.get("bytes_moved", 0)
        # Throughput over the longest phase (the pipeline's wall clock):
        # phases are completion offsets, so the max IS the elapsed time.
        elapsed = max(phases.values(), default=0.0)
        retries = ev.get("retries", {})
        n_retries = int(
            retries.get("attempts", 0) + retries.get("gcs_recover_attempts", 0)
        )
        lines.append(
            f"{_short_path(ev.get('path', '?')):<42} "
            f"{ev.get('kind', '?'):<13} "
            f"{ev.get('rank', 0):>4} "
            f"{phase_str:<34.34} "
            f"{_mb(total_bytes):>9.2f} "
            f"{_fmt_rate(_rate_mb_s(total_bytes, elapsed)):>8} "
            f"{ev.get('budget_wait_s', 0.0):>7.3f} "
            f"{n_retries:>7}"
        )

    plugin_totals: Dict[str, Dict[str, float]] = {}
    for ev in events:
        for plugin, fields in ev.get("plugins", {}).items():
            agg = plugin_totals.setdefault(
                plugin, {"write_bytes": 0.0, "read_bytes": 0.0}
            )
            agg["write_bytes"] += fields.get("write_bytes", 0.0)
            agg["read_bytes"] += fields.get("read_bytes", 0.0)
    if plugin_totals:
        lines.append("")
        lines.append("per-plugin totals:")
        for plugin in sorted(plugin_totals):
            agg = plugin_totals[plugin]
            lines.append(
                f"  {plugin:<8} wrote {_mb(agg['write_bytes']):>10.2f} MB   "
                f"read {_mb(agg['read_bytes']):>10.2f} MB"
            )

    straggler_lines: List[str] = []
    for ev in events:
        agg = ev.get("aggregated")
        if not agg:
            continue
        for metric in sorted(agg):
            spread = agg[metric]
            straggler_lines.append(
                f"  {_short_path(ev.get('path', '?'))} {metric}: "
                f"min={spread['min']} median={spread['median']} "
                f"max={spread['max']} straggler=rank {spread['straggler']}"
            )
    if straggler_lines:
        lines.append("")
        lines.append("cross-rank spread (rank 0 aggregation):")
        lines.extend(straggler_lines)

    mirror_events = [ev for ev in events if ev.get("kind") == "mirror"]
    if mirror_events:
        lines.append("")
        lines.append("mirror jobs:")
        for ev in mirror_events:
            m = ev.get("mirror", {})
            status = "FAILED" if ev.get("error") else "ok"
            lines.append(
                f"  {_short_path(ev.get('path', '?'))}: "
                f"{ev.get('blobs', 0)} blobs, "
                f"{_mb(ev.get('bytes_moved', 0)):.2f} MB, "
                f"lag {m.get('lag_s', 0.0):.2f}s, {status}"
            )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "stats":
        # ``... telemetry stats <events.jsonl>``: the default table, by name.
        argv = argv[1:]
    if argv and argv[0] == "trace":
        # ``python -m torchsnapshot_tpu_torch.telemetry trace <snapshot>``:
        # cross-rank trace merge + straggler summary.
        from .trace import main as trace_main

        return trace_main(argv[1:])
    if argv and argv[0] == "doctor":
        # ``python -m torchsnapshot_tpu_torch.telemetry doctor <snapshot>``
        # (and ``doctor --trend <root>``): rule-based diagnosis.
        from .doctor import main as doctor_main

        return doctor_main(argv[1:])
    if argv and argv[0] == "trend":
        # ``snapshot-stats trend <root>``: shorthand for doctor --trend.
        from .doctor import main as doctor_main

        return doctor_main(["--trend", *argv[1:]])
    if argv and argv[0] == "goodput":
        # ``python -m torchsnapshot_tpu_torch.telemetry goodput <root>``:
        # run-level wall-time attribution + storage-cost curves from
        # the run ledger (telemetry/goodput.py).
        from .goodput import main as goodput_main

        return goodput_main(argv[1:])
    if argv and argv[0] == "diff":
        # ``python -m torchsnapshot_tpu_torch.telemetry diff <before> <after>``:
        # differential critical-path / bench-record comparison
        # (telemetry/critpath.py).
        from .critpath import diff_main

        return diff_main(argv[1:])
    if argv and argv[0] == "fleet":
        # ``python -m torchsnapshot_tpu_torch.telemetry fleet <target>``:
        # the live per-publisher table of the __obs/ metrics plane on the
        # coordination store (telemetry/wire.py).
        from .wire import fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "slo":
        # ``python -m torchsnapshot_tpu_torch.telemetry slo <root>``: judge
        # the declared SLOs over a root's (or bundle's) run ledger +
        # step history with burn-rate math (telemetry/slo.py).
        from .slo import main as slo_main

        return slo_main(argv[1:])
    if argv and argv[0] == "bundle":
        # ``python -m torchsnapshot_tpu_torch.telemetry bundle <root>``: list
        # (or --capture) incident black-box bundles
        # (telemetry/bundle.py).
        from .bundle import main as bundle_main

        return bundle_main(argv[1:])

    p = argparse.ArgumentParser(
        prog="snapshot-stats",
        description="Render per-step tables from a checkpoint-telemetry "
        "JSONL event log.",
    )
    p.add_argument("events", help="events.jsonl / .telemetry.jsonl path")
    p.add_argument(
        "--kind",
        default=None,
        help="only records of this kind (take, restore, mirror, ...)",
    )
    p.add_argument(
        "--path-contains",
        default=None,
        help="only records whose snapshot path contains this substring",
    )
    args = p.parse_args(argv)
    if not os.path.exists(args.events):
        print(f"snapshot-stats: {args.events}: no such file")
        return 1
    events = load_events(args.events)
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.path_contains:
        events = [
            e for e in events if args.path_contains in e.get("path", "")
        ]
    print(render_summary(events))
    return 0
