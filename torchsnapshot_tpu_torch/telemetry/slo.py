"""Declared checkpoint SLOs, judged continuously with burn-rate math.

Copy of ``torchsnapshot_tpu/telemetry/slo.py``, with the same objectives,
knobs and ledger events: either package's ``evaluate_root`` judges a root
the other's manager wrote, and gives the same judgment.

The stack records the signals (SnapshotReports, the run ledger, step
history) but none of it says whether the service is keeping its
*promises*. This module declares those
promises as a registry of objectives over signals already recorded —
nothing here instruments an op — and re-judges them on rank 0 at every
committed manager step:

- ``take-visible-stall``: visible training stall per take stays under
  the async visible budget.
- ``restore-wall``: restores serve within the restore wall budget.
- ``mirror-durability-lag``: fast-tier-only exposure per step stays
  under the mirror lag budget.
- ``cdn-staleness``: publish-to-swap staleness per subscriber swap
  stays under the CDN staleness budget.
- ``goodput-overhead``: checkpoint overhead per commit interval stays
  under the overhead fraction budget.
- ``coordination-fraction``: coordination's share of a take's wall
  stays under the coordination fraction budget.

Each objective is judged with multi-window burn-rate math (the SRE
workbook's alerting model): a sample is *bad* when it exceeds the
objective's target; ``burn = bad-fraction / error-budget-fraction`` over
a window, so burn 1.0 means the error budget is being spent exactly at
the sustainable rate. Two windows fire on different failure shapes — a
short window with a high threshold catches cliffs (a plugin suddenly
slow, a tier gone) within a few steps, and a long window with threshold
~1.0 catches drift the short window averages away. An objective
*breaches* when either window's burn crosses its threshold; targets,
windows, thresholds and the budget are all knobs, and a non-positive
target disables that objective alone.

``evaluate_step`` is the manager's post-commit hook: it refreshes the
``slo_burn_rate{objective}`` gauges, posts an edge-triggered
``slo-breach`` ledger event per objective episode (one record when an
objective *starts* burning, not one per evaluated step), and asks
telemetry/bundle.py for one incident bundle per evaluation that saw a
fresh breach. ``python -m torchsnapshot_tpu_torch.telemetry slo <root>``
renders the same judgment offline, including against a bundle dir. The
``slo-burning`` doctor rule re-runs ``evaluate`` over gathered
evidence, so doctor verdicts reproduce bit-for-bit from a relocated
bundle with the original root gone.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

from .. import knobs
from . import names

logger = logging.getLogger(__name__)

# One sample: (unix_ts, observed value in the objective's unit).
Sample = Tuple[float, float]


def _num(value: Any) -> Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value)


def _ledger_samples(
    event: str, field: str
) -> Callable[[Sequence[Dict[str, Any]], Sequence[Dict[str, Any]]], List[Sample]]:
    """Extractor for objectives whose samples are one numeric field of
    one typed ledger event (the common case)."""

    def extract(
        ledger_records: Sequence[Dict[str, Any]],
        history_records: Sequence[Dict[str, Any]],
    ) -> List[Sample]:
        out: List[Sample] = []
        for rec in ledger_records:
            if rec.get("event") != event:
                continue
            value = _num(rec.get(field))
            ts = _num(rec.get("unix_ts"))
            if value is None or ts is None:
                continue
            out.append((ts, value))
        out.sort(key=lambda s: s[0])
        return out

    return extract


def _overhead_samples(
    ledger_records: Sequence[Dict[str, Any]],
    history_records: Sequence[Dict[str, Any]],
) -> List[Sample]:
    """Per-commit-interval overhead fraction: the visible stall +
    restore wall paid between consecutive step commits, over the
    interval's wall clock. Resets at run-start so a restart's gap is
    not charged as overhead."""
    out: List[Sample] = []
    prev_ts: Optional[float] = None
    overhead = 0.0
    for rec in sorted(
        ledger_records, key=lambda r: _num(r.get("unix_ts")) or 0.0
    ):
        event = rec.get("event")
        ts = _num(rec.get("unix_ts"))
        if ts is None:
            continue
        if event == names.EVENT_RUN_START:
            prev_ts = ts
            overhead = 0.0
        elif event == names.EVENT_VISIBLE_STALL:
            overhead += _num(rec.get("visible_s")) or 0.0
        elif event == names.EVENT_RESTORE_SERVED:
            overhead += _num(rec.get("restore_s")) or 0.0
        elif event == names.EVENT_STEP_COMMITTED:
            if prev_ts is not None and ts > prev_ts:
                out.append((ts, min(1.0, overhead / (ts - prev_ts))))
            prev_ts = ts
            overhead = 0.0
    return out


def _coordination_samples(
    ledger_records: Sequence[Dict[str, Any]],
    history_records: Sequence[Dict[str, Any]],
) -> List[Sample]:
    """Coordination's share of each take's wall, from the step-history
    summaries (the only place the coordination split is recorded)."""
    out: List[Sample] = []
    for rec in history_records:
        if rec.get("kind") not in ("take", "async_take"):
            continue
        take_s = _num(rec.get("take_s"))
        coord_s = _num(rec.get("coordination_s"))
        ts = _num(rec.get("unix_ts"))
        if take_s is None or coord_s is None or ts is None or take_s <= 0:
            continue
        out.append((ts, min(1.0, coord_s / take_s)))
    out.sort(key=lambda s: s[0])
    return out


@dataclass(frozen=True)
class Objective:
    """One declared promise: a target over a sample stream. ``slo_id``
    must be a ``names.SLO_*`` constant (snaplint's ``slo-ids`` rule
    checks every construction site)."""

    slo_id: str
    description: str
    unit: str
    target: Callable[[], float]
    samples: Callable[
        [Sequence[Dict[str, Any]], Sequence[Dict[str, Any]]], List[Sample]
    ]


OBJECTIVES: Tuple[Objective, ...] = (
    Objective(
        names.SLO_TAKE_VISIBLE_STALL,
        "visible training stall per take/async_take",
        "s",
        knobs.get_async_visible_budget_seconds,
        _ledger_samples(names.EVENT_VISIBLE_STALL, "visible_s"),
    ),
    Objective(
        names.SLO_RESTORE_WALL,
        "restore/async_restore serve wall",
        "s",
        knobs.get_slo_restore_seconds,
        _ledger_samples(names.EVENT_RESTORE_SERVED, "restore_s"),
    ),
    Objective(
        names.SLO_MIRROR_LAG,
        "fast-tier-only exposure per mirrored step",
        "s",
        knobs.get_slo_mirror_lag_seconds,
        _ledger_samples(names.EVENT_MIRROR_SETTLED, "lag_s"),
    ),
    Objective(
        names.SLO_CDN_STALENESS,
        "CDN publish-to-swap staleness per subscriber swap",
        "s",
        knobs.get_cdn_staleness_budget_seconds,
        _ledger_samples(names.EVENT_CDN_SWAPPED, "staleness_s"),
    ),
    Objective(
        names.SLO_GOODPUT_OVERHEAD,
        "checkpoint overhead fraction per commit interval",
        "frac",
        knobs.get_slo_overhead_fraction,
        _overhead_samples,
    ),
    Objective(
        names.SLO_COORDINATION_FRACTION,
        "coordination fraction of take wall",
        "frac",
        knobs.get_slo_coordination_fraction,
        _coordination_samples,
    ),
)


def _window_burn(
    bad_flags: Sequence[bool], window: int, threshold: float, budget: float
) -> Optional[Dict[str, Any]]:
    """Burn over the newest ``window`` samples. None when the window is
    disabled (<= 0); an empty stream reports zero burn rather than
    firing on no evidence."""
    if window <= 0:
        return None
    tail = list(bad_flags[-window:])
    bad = sum(1 for f in tail if f)
    burn = (bad / len(tail)) / budget if tail else 0.0
    return {
        "window": window,
        "samples": len(tail),
        "bad": bad,
        "burn": round(burn, 4),
        "threshold": threshold,
    }


def _window_fires(win: Optional[Dict[str, Any]]) -> bool:
    return (
        win is not None
        and win["samples"] > 0
        and win["burn"] >= win["threshold"]
    )


def evaluate(
    ledger_records: Sequence[Dict[str, Any]],
    history_records: Sequence[Dict[str, Any]] = (),
) -> List[Dict[str, Any]]:
    """Judge every declared objective against the given evidence. Pure
    over its inputs plus the knob vector — the doctor re-runs it over a
    bundle's records and gets the live run's verdicts back."""
    budget = knobs.get_slo_error_budget_fraction()
    fast_window = knobs.get_slo_fast_window()
    slow_window = knobs.get_slo_slow_window()
    fast_threshold = knobs.get_slo_fast_burn_threshold()
    slow_threshold = knobs.get_slo_slow_burn_threshold()
    out: List[Dict[str, Any]] = []
    for objective in OBJECTIVES:
        target = objective.target()
        entry: Dict[str, Any] = {
            "objective": objective.slo_id,
            "description": objective.description,
            "unit": objective.unit,
            "target": target,
            "disabled": target <= 0 or budget <= 0,
            "samples": 0,
            "last_value": None,
            "fast": None,
            "slow": None,
            "burn_rate": 0.0,
            "breaching": False,
        }
        if not entry["disabled"]:
            samples = objective.samples(ledger_records, history_records)
            bad_flags = [value > target for _, value in samples]
            fast = _window_burn(bad_flags, fast_window, fast_threshold, budget)
            slow = _window_burn(bad_flags, slow_window, slow_threshold, budget)
            entry.update(
                samples=len(samples),
                last_value=samples[-1][1] if samples else None,
                fast=fast,
                slow=slow,
                burn_rate=max(
                    fast["burn"] if fast else 0.0,
                    slow["burn"] if slow else 0.0,
                ),
                breaching=_window_fires(fast) or _window_fires(slow),
            )
        out.append(entry)
    return out


def evaluate_root(root: str) -> Optional[Dict[str, Any]]:
    """Judge the objectives over a root's (or bundle's) recorded
    evidence. None when no run ledger is reachable from ``root``."""
    from .history import history_path_for, load_history
    from .ledger import find_ledger_for, load_ledger

    ledger_file = find_ledger_for(root)
    if ledger_file is None:
        return None
    ledger_records = load_ledger(ledger_file)
    history_records: List[Dict[str, Any]] = []
    try:
        hist_path = history_path_for(root)
        if hist_path is not None and os.path.exists(hist_path):
            history_records = load_history(hist_path)
    except Exception as e:  # noqa: BLE001 - history is optional evidence
        logger.warning("slo: could not load step history at %r: %r", root, e)
    objectives = evaluate(ledger_records, history_records)
    return {
        "root": root,
        "ledger_file": ledger_file,
        "objectives": objectives,
        "breaching": [o["objective"] for o in objectives if o["breaching"]],
    }


# Edge-trigger and fleet-plane state: per (root, objective) breach flags
# and each root's last max burn. Process-local, guarded: async-save commit
# threads and the training loop both evaluate.
_STATE_LOCK = threading.Lock()
_BREACHING: Dict[Tuple[str, str], bool] = {}
_LAST_BURN: Dict[str, float] = {}


def reset_slo_state() -> None:
    """Drop breach edges and burn caches (tests)."""
    with _STATE_LOCK:
        _BREACHING.clear()
        _LAST_BURN.clear()


def current_burn() -> Optional[float]:
    """The largest burn rate across this process's evaluated roots at
    their latest evaluation: what the fleet plane publishes as the
    ``slo_burn`` extra. None before any evaluation."""
    with _STATE_LOCK:
        if not _LAST_BURN:
            return None
        return max(_LAST_BURN.values())


def evaluate_step(root: str, step: int) -> Optional[Dict[str, Any]]:
    """The manager's rank-0 post-commit hook: re-judge, export gauges,
    post edge-triggered breach events, and capture one incident bundle
    per evaluation that saw a fresh breach. Best-effort: never raises
    into the commit path."""
    from . import metrics
    from .ledger import post_event

    result = evaluate_root(root)
    if result is None:
        return None
    registry = metrics()
    root_key = os.path.abspath(root)
    fresh: List[str] = []
    max_burn = 0.0
    with _STATE_LOCK:
        for obj in result["objectives"]:
            if obj["disabled"]:
                _BREACHING.pop((root_key, obj["objective"]), None)
                continue
            registry.gauge_set(
                names.OBJECTIVE_BURN_RATE,
                obj["burn_rate"],
                objective=obj["objective"],
            )
            max_burn = max(max_burn, obj["burn_rate"])
            key = (root_key, obj["objective"])
            was_breaching = _BREACHING.get(key, False)
            if obj["breaching"] and not was_breaching:
                fresh.append(obj["objective"])
            _BREACHING[key] = obj["breaching"]
        _LAST_BURN[root_key] = max_burn
    for slo_id in fresh:
        obj = next(
            o for o in result["objectives"] if o["objective"] == slo_id
        )
        fast = obj["fast"] or {}
        slow = obj["slow"] or {}
        post_event(
            root,
            names.EVENT_SLO_BREACH,
            step=step,
            objective=slo_id,
            target=obj["target"],
            last_value=obj["last_value"],
            fast_burn=fast.get("burn"),
            fast_window=fast.get("window"),
            fast_bad=fast.get("bad"),
            slow_burn=slow.get("burn"),
            slow_window=slow.get("window"),
            slow_bad=slow.get("bad"),
        )
        registry.counter_inc(
            names.OBJECTIVE_BREACHES_TOTAL, objective=slo_id
        )
        logger.warning(
            "slo: objective %r breached at step %d (burn %.2f, target %s%s)",
            slo_id,
            step,
            obj["burn_rate"],
            obj["target"],
            obj["unit"],
        )
    if fresh:
        from . import bundle

        bundle.capture_bundle(
            root,
            trigger="slo-breach",
            reason=", ".join(fresh),
            step=step,
        )
    return result


def render(result: Dict[str, Any]) -> str:
    lines = [
        f"slo: {result['root']}",
        f"  ledger: {result['ledger_file']}",
    ]
    for obj in result["objectives"]:
        if obj["disabled"]:
            status = "disabled"
        elif obj["breaching"]:
            status = "BURNING"
        else:
            status = "ok"
        detail = ""
        if not obj["disabled"]:
            windows = []
            for label in ("fast", "slow"):
                win = obj[label]
                if win is not None:
                    windows.append(
                        f"{label} {win['bad']}/{win['samples']} "
                        f"burn {win['burn']:.2f}"
                    )
            detail = (
                f" target {obj['target']}{obj['unit']}"
                f" samples {obj['samples']}"
                + (" " + ", ".join(windows) if windows else "")
            )
        lines.append(f"  {obj['objective']:<24} {status:<8}{detail}")
    if result["breaching"]:
        lines.append(f"  breaching: {', '.join(result['breaching'])}")
    return "\n".join(lines)


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchsnapshot_tpu_torch.telemetry slo",
        description=(
            "Judge the declared checkpoint SLOs over a snapshot root's "
            "(or incident bundle's) run ledger and step history."
        ),
    )
    parser.add_argument(
        "root", help="snapshot root, manager root, or bundle directory"
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(list(argv) if argv is not None else None)
    result = evaluate_root(args.root)
    if result is None:
        print(f"no run ledger found at {args.root}")
        return 1
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        print(render(result))
    return 2 if result["breaching"] else 0
