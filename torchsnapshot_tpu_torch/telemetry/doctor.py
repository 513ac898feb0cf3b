"""The checkpoint doctor: rule-based diagnosis over checkpoint telemetry.

Copy of ``torchsnapshot_tpu/telemetry/doctor.py``, with the same rules,
thresholds and verdict ids: either package's doctor reads a snapshot or a
root the other wrote and gives the same verdicts. The three fleet-scope
rules judge the wire observatory's ``__obs/`` metrics plane
(:func:`diagnose_fleet`, ``doctor --fleet <host:port | root>`` and the
``telemetry fleet`` table).

The doctor answers "why was that take slow?": a declared registry of rules, each
consuming a completed (or live) operation's artifacts — SnapshotReport
JSONL, merged trace spans, progress heartbeats, mirror state, fsck
results — and emitting ranked, evidence-cited :class:`Verdict`\\ s.

Every verdict id is declared exactly once in ``telemetry/names.py``
(``RULE_`` constants, kebab-case), so the id namespace stays stable
enough for alerting to key off.

Entry points:

- ``python -m torchsnapshot_tpu_torch.telemetry doctor <snapshot>`` — diagnose
  one snapshot's recorded artifacts;
- ``... doctor --trend <manager-root>`` — flag per-step regressions
  against a rolling median ± MAD baseline (telemetry/history.py);
- library: :func:`diagnose_snapshot`, :func:`diagnose_reports`,
  :func:`diagnose_take_trial` (a bracketed take trial's stall and
  efficiency verdicts).

Thresholds are module constants (documented in docs/observability.md);
rules cite the exact metric values that triggered them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import names
from .. import knobs
from .history import detect_trend_regressions

logger: logging.Logger = logging.getLogger(__name__)

# -- thresholds (each rule cites the one it used) ---------------------------

# d2h-bound: staging consumed at least this fraction of the take wall.
D2H_BOUND_STAGING_FRAC = 0.7
# storage-tier-slow: the post-staging write drain is at least this
# multiple of staging AND at least this many seconds.
STORAGE_SLOW_DRAIN_FACTOR = 2.0
STORAGE_SLOW_MIN_S = 0.25
# budget-starved: cumulative budget wait at least this fraction of the
# pipeline wall clock.
BUDGET_STARVED_WAIT_FRAC = 0.25
# straggler-rank: a rank's phase time at least this multiple of the
# cross-rank median AND at least this many seconds beyond it.
STRAGGLER_FACTOR = 2.0
STRAGGLER_MIN_DELTA_S = 1.0
# mirror-lagging: durability lag beyond this, or this many snapshots
# queued behind the mirror.
MIRROR_LAG_S = 60.0
MIRROR_QUEUE_DEPTH = 2
# write-tail-stall: one storage-write span at least this fraction of
# the op's longest span AND at least this many ms.
TAIL_SPAN_FRAC = 0.5
TAIL_SPAN_MIN_MS = 1000.0
# retry-storm: at least this many retry attempts inside one op window.
RETRY_STORM_ATTEMPTS = 3
# interrupted-take: a non-terminal heartbeat only counts as a crash
# once it is stale — this many missed writer intervals (with an
# absolute floor, below) — so diagnosing a snapshot DURING a healthy
# take never raises a false critical.
INTERRUPTED_STALE_INTERVALS = 10.0
INTERRUPTED_STALE_MIN_S = 30.0
# restore-read-amplified: the restore's per-plugin/storage read bytes
# exceed the manifest-needed bytes by this factor.
READ_AMPLIFIED_FACTOR = 1.5
# restore-cold-start-slow: the restore's recorded ``cold_start_s``
# (event-loop spin-up + plugin open + native-module load) exceeds the
# knob'd fraction of the op wall
# (TORCHSNAPSHOT_TPU_COLD_START_BUDGET_FRACTION, <= 0 disables), over
# an absolute floor so ms-scale test restores never flag.
COLD_START_MIN_S = 1.0
# tuner-thrashing: an A -> B -> A value cycle for one tunable within
# this many trailing decision-log entries (aligned with the trend
# window: oscillation slower than the regression baseline can see is
# indistinguishable from adaptation).
TUNER_THRASH_WINDOW = 8
# goodput-degraded: the run spent at least this fraction of its
# ledger-measured wall time on checkpoint overhead (visible stalls +
# restores + lost work), over at least this much wall (short runs'
# fixed costs — a cold restore, one take — are not a trend).
GOODPUT_DEGRADED_FRAC = 0.15
GOODPUT_MIN_WALL_S = 30.0
# recovery-cost-high: one interruption's checkpoint-attributable price
# (work replayed since the last committed step + the restore that
# recovered it) reached this many seconds.
RECOVERY_COST_S = 60.0
# dedup-ineffective: over at least this many trailing CAS step-committed
# ledger records, the realized chunk-reuse ratio stayed below the floor
# while the on-device digests said at least the unchanged fraction of
# the state did not change — unchanged bytes being re-stored means the
# dedup path is broken in practice.
DEDUP_WINDOW_STEPS = 3
DEDUP_REUSE_FLOOR = 0.05
DEDUP_UNCHANGED_FRAC = 0.5
# coordination-bound: barrier waits + store round trips + the fan-out
# exchange ate at least this fraction of the op's wall (pipeline wall
# plus the coordination time itself — barriers run outside the
# pipeline's phase spans), over an absolute floor so ms-scale test ops
# polling a local store never flag.
COORD_BOUND_FRACTION = 0.3
COORD_MIN_S = 0.05
# cdn-staleness-high: the median publish-to-swap latency across the
# trailing window of cdn-swapped ledger records exceeds the budget knob
# (TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS) — the serving fleet
# is lagging the training job. A minimum sample count keeps one slow
# cold-start swap from convicting the whole fleet.
CDN_STALENESS_WINDOW = 20
CDN_STALENESS_MIN_SAMPLES = 5
# wire-dial-stalled: a fleet member's recent dial latencies cluster on
# whole seconds — the SYN-retransmit signature of a listen backlog
# overflowing. The quantization thresholds themselves (minimum latency,
# whole-second tolerance, sample and fraction floors) live in wire.py
# beside the dial ring they describe.
# wire-hot-endpoint: one endpoint carries at least this multiple of the
# mean per-endpoint byte volume (folded across every fleet member's
# view), with at least this many endpoints in play — a 2-endpoint
# topology always has a lopsided one — and a byte floor so test-scale
# traffic never flags.
WIRE_HOT_ENDPOINT_FACTOR = 4.0
WIRE_HOT_MIN_ENDPOINTS = 3
WIRE_HOT_MIN_BYTES = float(1 << 20)
# store-hot-shard: one coordination-store shard serves at least this
# multiple of the mean per-shard request count (summed across the
# fleet's reports), over a request floor so short runs never flag.
STORE_HOT_SHARD_FACTOR = 4.0
STORE_HOT_MIN_REQUESTS = 512.0
# Bench-trial epistemics:
# adjacent probes disagreeing beyond this factor = unstable link;
# achieved/bracket below this ratio on a stable bracket = in-take stall.
UNSTABLE_BRACKET_FACTOR = 1.5
STALL_EFFICIENCY_RATIO = 0.5

_SEVERITY_ORDER = {"critical": 0, "warning": 1, "info": 2}


@dataclasses.dataclass
class Verdict:
    """One diagnosis: a declared rule id, a one-line summary, and the
    metric values that triggered it (``evidence``) with the artifact
    they came from (``source``)."""

    rule: str
    summary: str
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)
    severity: str = "warning"
    source: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def format(self) -> str:
        ev = ", ".join(f"{k}={v}" for k, v in sorted(self.evidence.items()))
        src = f" [{self.source}]" if self.source else ""
        return f"{self.severity.upper():>8} {self.rule}: {self.summary} ({ev}){src}"


class _DoctorRule:
    __slots__ = ("rule_id", "fn")

    def __init__(self, rule_id: str, fn: Callable) -> None:
        self.rule_id = rule_id
        self.fn = fn


_REPORT_RULES: List[_DoctorRule] = []
_EVIDENCE_RULES: List[_DoctorRule] = []

_FLEET_RULES: List[_DoctorRule] = []

_RULE_BUCKETS = {
    "report": _REPORT_RULES,
    "evidence": _EVIDENCE_RULES,
    "fleet": _FLEET_RULES,
}


def doctor_rule(
    rule_id: str, scope: str = "report"
) -> Callable[[Callable], Callable]:
    """Register a diagnosis rule under a declared id. ``scope`` is
    "report" (called once per SnapshotReport dict), "evidence" (called
    once with the full artifact bundle), or "fleet" (called once with
    the list of decoded ``__obs/`` metrics-plane entries). The
    decorated function returns a verdict-shaped dict
    (summary/evidence/severity/source), a list of them, or None; the
    engine stamps the registered id so no literal id ever appears at an
    emit site."""

    def deco(fn: Callable) -> Callable:
        _RULE_BUCKETS[scope].append(_DoctorRule(rule_id, fn))
        return fn

    return deco


def registered_rule_ids() -> List[str]:
    """Every registered verdict id (the rule catalogue), sorted."""
    static = [
        names.RULE_IN_TAKE_STALL,
        names.RULE_LINK_UNSTABLE,
        names.RULE_TREND_REGRESSION,
        names.RULE_CRITICAL_PATH_SHIFTED,
        names.RULE_BENCH_REGRESSION,
    ]
    return sorted(
        {r.rule_id for r in _REPORT_RULES + _EVIDENCE_RULES + _FLEET_RULES}
        | set(static)
    )


def _as_verdicts(rule_id: str, raw: Any) -> List[Verdict]:
    if raw is None:
        return []
    items = raw if isinstance(raw, list) else [raw]
    out = []
    for item in items:
        out.append(
            Verdict(
                rule=rule_id,
                summary=item.get("summary", rule_id),
                evidence=dict(item.get("evidence", {})),
                severity=item.get("severity", "warning"),
                source=item.get("source", ""),
            )
        )
    return out


def rank_verdicts(verdicts: List[Verdict]) -> List[Verdict]:
    """Severity first, then the rule id for a stable order."""
    return sorted(
        verdicts,
        key=lambda v: (_SEVERITY_ORDER.get(v.severity, 9), v.rule, v.source),
    )


# ---------------------------------------------------------------------------
# Evidence bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Evidence:
    """Everything the doctor reads about one snapshot: recorded reports,
    trace-span summaries, progress heartbeats (live or leftover), and
    the process mirror's state (None when unavailable)."""

    path: str
    reports: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    trace_spans: Dict[str, List[Dict[str, Any]]] = dataclasses.field(
        default_factory=dict
    )
    # Trace files that exist but could not be parsed (file -> error):
    # an audit surface must list a corrupt artifact, not drop it.
    trace_unreadable: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    trace_stalls: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    progress: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    progress_files: List[str] = dataclasses.field(default_factory=list)
    mirror_state: Optional[Dict[str, Any]] = None
    fsck_problems: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    # The write-path autotuner's decision log (.tuner-state.json at the
    # snapshot dir or its manager root), when one exists.
    tuner_state: Optional[Dict[str, Any]] = None
    tuner_state_file: str = ""
    # The run ledger (.ledger.jsonl at the manager root that owns this
    # snapshot), when one exists: the goodput rules' evidence.
    ledger_records: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    ledger_file: str = ""
    # The manager root's step-history summaries
    # (.telemetry-history.jsonl): the coordination-fraction samples the
    # SLO engine judges, gathered here so ``doctor --bundle`` re-judges
    # from a bundle's copy with the original root gone.
    history_records: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    history_file: str = ""


def gather_evidence(snapshot_path: str) -> Evidence:
    """Collect one snapshot's on-disk artifacts. Every source is
    optional — the doctor diagnoses from whatever was recorded."""
    from .stats import find_events_for
    from .trace import find_trace_files, longest_spans_from_doc
    from .progress import find_progress_files, load_progress_file

    ev = Evidence(path=snapshot_path)
    try:
        ev.reports = find_events_for(snapshot_path)
    except Exception as e:  # noqa: BLE001 - diagnose from what exists
        logger.warning("doctor: could not load events: %r", e)
    try:
        import json as _json

        for tf in find_trace_files(snapshot_path):
            # One parse per trace file: the span summary and the
            # watchdog-stall scan both read the same loaded doc.
            try:
                with open(tf, "r", encoding="utf-8") as f:
                    doc = _json.load(f)
            except (OSError, ValueError) as e:
                ev.trace_unreadable[tf] = repr(e)
                continue
            try:
                ev.trace_spans[tf] = longest_spans_from_doc(doc, 10)
            except Exception as e:  # noqa: BLE001
                ev.trace_unreadable[tf] = repr(e)
                continue
            for event in doc.get("traceEvents", []):
                if (
                    event.get("ph") == "i"
                    and event.get("name") == names.INSTANT_WATCHDOG_STALL
                ):
                    ev.trace_stalls.append(
                        {"file": tf, **(event.get("args") or {})}
                    )
    except Exception as e:  # noqa: BLE001
        logger.warning("doctor: could not scan traces: %r", e)
    try:
        for pf in find_progress_files(snapshot_path):
            ev.progress_files.append(pf)
            doc = load_progress_file(pf)
            if doc is not None:
                doc["file"] = pf
                ev.progress.append(doc)
    except Exception as e:  # noqa: BLE001
        logger.warning("doctor: could not load progress files: %r", e)
    try:
        from ..tiered.mirror import mirror_state_for_path

        ev.mirror_state = mirror_state_for_path(snapshot_path)
    except Exception:  # noqa: BLE001 - mirror state is optional evidence
        pass
    try:
        import json as _json

        from ..tuner.state import TUNER_STATE_BASENAME
        from .sink import local_fs_root

        local = local_fs_root(snapshot_path)
        if local is not None:
            # A manager step dir's tuner state lives at the manager
            # ROOT (the parent); a root diagnosed directly carries it
            # adjacent. Check both, nearest first.
            parent = os.path.dirname(os.path.abspath(local))
            for cand_dir in (local, parent):
                cand = os.path.join(cand_dir, TUNER_STATE_BASENAME)
                if os.path.exists(cand):
                    with open(cand, "r", encoding="utf-8") as f:
                        ev.tuner_state = _json.load(f)
                    ev.tuner_state_file = cand
                    break
    except Exception as e:  # noqa: BLE001
        logger.warning("doctor: could not load tuner state: %r", e)
    try:
        from .ledger import find_ledger_for, load_ledger

        lf = find_ledger_for(snapshot_path)
        if lf is not None:
            ev.ledger_records = load_ledger(lf)
            ev.ledger_file = lf
    except Exception as e:  # noqa: BLE001
        logger.warning("doctor: could not load run ledger: %r", e)
    try:
        from .history import HISTORY_BASENAME, load_history
        from .sink import local_fs_root

        local = local_fs_root(snapshot_path)
        if local is not None:
            # Same two-dir probe as the tuner state above: a step dir's
            # history lives at the manager root, a root's (or bundle's)
            # sits adjacent.
            parent = os.path.dirname(os.path.abspath(local))
            for cand_dir in (local, parent):
                cand = os.path.join(cand_dir, HISTORY_BASENAME)
                if os.path.exists(cand):
                    ev.history_records = load_history(cand)
                    ev.history_file = cand
                    break
    except Exception as e:  # noqa: BLE001
        logger.warning("doctor: could not load step history: %r", e)
    return ev


# ---------------------------------------------------------------------------
# Report-scope rules
# ---------------------------------------------------------------------------


def _take_phases(report: Dict[str, Any]):
    """(staging_s, wall_s) for a write-pipeline report; None for reads.
    Phases are completion offsets, so ``writing`` includes staging and
    the max is the pipeline's wall clock."""
    phases = report.get("phases") or {}
    if "staging" not in phases:
        return None
    staging = float(phases["staging"])
    wall = max(float(v) for v in phases.values())
    return staging, wall


@doctor_rule(names.RULE_D2H_BOUND)
def _d2h_bound(report: Dict[str, Any]):
    tp = _take_phases(report)
    if tp is None:
        return None
    staging, wall = tp
    if wall <= 0 or staging / wall < D2H_BOUND_STAGING_FRAC:
        return None
    return {
        "summary": (
            "staging (D2H + serialize) consumed most of the take; the "
            "device link, not storage, bounds this checkpoint"
        ),
        "evidence": {
            "staging_s": staging,
            "wall_s": wall,
            "staging_frac": round(staging / wall, 3),
            "threshold_frac": D2H_BOUND_STAGING_FRAC,
        },
    }


@doctor_rule(names.RULE_STORAGE_TIER_SLOW)
def _storage_tier_slow(report: Dict[str, Any]):
    tp = _take_phases(report)
    if tp is None:
        return None
    staging, wall = tp
    drain = wall - staging
    if drain < STORAGE_SLOW_MIN_S or drain < STORAGE_SLOW_DRAIN_FACTOR * max(
        staging, 1e-9
    ):
        return None
    from . import safe_rate_mb_s

    return {
        "summary": (
            "the write drain after staging dominates the take: the "
            "storage tier (or its link) is the bottleneck"
        ),
        "evidence": {
            "staging_s": staging,
            "write_drain_s": round(drain, 3),
            "wall_s": wall,
            "write_mb_s": round(
                safe_rate_mb_s(report.get("bytes_moved", 0), drain), 3
            ),
            "threshold_factor": STORAGE_SLOW_DRAIN_FACTOR,
        },
    }


@doctor_rule(names.RULE_BUDGET_STARVED)
def _budget_starved(report: Dict[str, Any]):
    phases = report.get("phases") or {}
    wall = max((float(v) for v in phases.values()), default=0.0)
    wait = float(report.get("budget_wait_s", 0.0))
    if wall <= 0 or wait / wall < BUDGET_STARVED_WAIT_FRAC:
        return None
    return {
        "summary": (
            "requests spent a large fraction of the op blocked on the "
            "host-memory budget; raise "
            "TORCHSNAPSHOT_TPU_PER_RANK_MEMORY_BUDGET_BYTES or reduce "
            "concurrency"
        ),
        "evidence": {
            "budget_wait_s": wait,
            "wall_s": wall,
            "wait_frac": round(wait / wall, 3),
            "peak_staged_bytes": report.get("peak_staged_bytes", 0),
            "threshold_frac": BUDGET_STARVED_WAIT_FRAC,
        },
    }


@doctor_rule(names.RULE_STRAGGLER_RANK)
def _straggler_rank(report: Dict[str, Any]):
    agg = report.get("aggregated") or {}
    out = []
    for metric, spread in sorted(agg.items()):
        if not metric.startswith("phase_"):
            continue
        median = float(spread.get("median", 0.0))
        mx = float(spread.get("max", 0.0))
        if (
            mx >= STRAGGLER_FACTOR * max(median, 1e-9)
            and mx - median >= STRAGGLER_MIN_DELTA_S
        ):
            out.append(
                {
                    "summary": (
                        f"rank {spread.get('straggler')} is a straggler "
                        f"for {metric}: {mx}s against a {median}s median"
                    ),
                    "evidence": {
                        "metric": metric,
                        "straggler_rank": spread.get("straggler"),
                        "max_s": mx,
                        "median_s": median,
                        "threshold_factor": STRAGGLER_FACTOR,
                    },
                }
            )
    return out or None


@doctor_rule(names.RULE_MIRROR_LAGGING)
def _mirror_lagging(report: Dict[str, Any]):
    mirror = report.get("mirror") or {}
    lag = float(mirror.get("upload_lag_s", mirror.get("lag_s", 0.0)) or 0.0)
    depth = int(mirror.get("snapshots_pending", 0) or 0)
    if lag < MIRROR_LAG_S and depth < MIRROR_QUEUE_DEPTH:
        return None
    return {
        "summary": (
            "the durable-tier mirror is falling behind the take "
            "cadence; durability trails the fast-tier commit"
        ),
        "evidence": {
            "upload_lag_s": lag,
            "snapshots_pending": depth,
            "blobs_pending": mirror.get("blobs_pending", 0),
            "threshold_lag_s": MIRROR_LAG_S,
            "threshold_depth": MIRROR_QUEUE_DEPTH,
        },
    }


@doctor_rule(names.RULE_ASYNC_VISIBLE_STALL)
def _async_visible_stall(report: Dict[str, Any]):
    """An async take blocked its caller beyond the visible-time budget
    (TORCHSNAPSHOT_TPU_ASYNC_VISIBLE_BUDGET_SECONDS): with device
    snapshotting on, the visible span is plan + capture dispatch and
    must not scale with checkpoint size — a breach means staging leaked
    back into the training thread (knob off, a capture fallback paying
    D2H eagerly, or a regression in the deferral path). Cites the
    stage-span evidence: where the drain's staging actually happened
    relative to the visible span."""
    if report.get("kind") != "async_take":
        return None
    visible = report.get("visible_s")
    if visible is None:
        return None
    budget = knobs.get_async_visible_budget_seconds()
    if budget <= 0 or float(visible) <= budget:
        return None
    phases = report.get("phases") or {}
    return {
        "summary": (
            "async_take blocked training beyond the visible budget: "
            "staging ran in the caller's span instead of the "
            "background drain"
        ),
        "evidence": {
            "visible_s": float(visible),
            "budget_s": budget,
            "staged_s": report.get("staged_s"),
            "staging_s": phases.get("staging"),
            "wall_s": max((float(v) for v in phases.values()), default=0.0),
        },
        "severity": "warning",
    }


@doctor_rule(names.RULE_RESTORE_READ_AMPLIFIED)
def _restore_read_amplified(report: Dict[str, Any]):
    """The restore pulled far more bytes from storage than its read plan
    needed (``bytes_fetched`` vs ``bytes_needed`` report fields; older
    reports fall back to the per-plugin read-byte counters): whole-shard
    reads serving partial destinations, fan-out disabled in a wide
    fleet (every rank fetching every shard), or retry-driven re-reads.
    docs/restore.md documents the metric and the fan-out fix."""
    if report.get("kind") not in ("restore", "async_restore"):
        return None
    needed = report.get("bytes_needed")
    if not needed:
        return None
    if report.get("bytes_received"):
        # A fan-out restore ran: an owner rank legitimately fetches its
        # peers' windows on top of its own needs, so the per-rank
        # fetched/needed ratio pages on healthy skew. Fan-out restores
        # are judged at fleet level (total fetched / unique checkpoint
        # bytes).
        return None
    fetched = report.get("bytes_fetched")
    source = "report"
    if fetched is None:
        fetched = sum(
            float(p.get("read_bytes", 0.0))
            for p in (report.get("plugins") or {}).values()
        )
        source = "plugin-counters"
    fetched = float(fetched)
    needed = float(needed)
    if fetched <= READ_AMPLIFIED_FACTOR * needed:
        return None
    return {
        "summary": (
            "the restore read more bytes from storage than its plan "
            "needed: partial destinations are paying whole-shard (or "
            "every-rank) reads — fan-out restore / ranged reads would "
            "cut this to ~1x"
        ),
        "evidence": {
            "bytes_fetched": int(fetched),
            "bytes_needed": int(needed),
            "bytes_received": report.get("bytes_received"),
            "amplification": round(fetched / needed, 3),
            "threshold_factor": READ_AMPLIFIED_FACTOR,
            "fetched_from": source,
        },
    }


@doctor_rule(names.RULE_PEER_TIER_DEGRADED)
def _peer_tier_degraded(report: Dict[str, Any]):
    """A restore that had an eligible peer-RAM copy was (partly) served
    from storage: peer transfers failed (dead peer, timeout, checksum
    mismatch) or pushed copies were missing, so recovery paid storage
    latency the peer tier existed to avoid. Evidence cites the
    transfer-failure count and the per-tier byte split the report's
    ``tier_split``/``peer`` fields carry (docs/peer.md's degradation
    matrix names the failure modes)."""
    if report.get("kind") not in ("restore", "async_restore"):
        return None
    peer = report.get("peer") or {}
    if not peer:
        return None
    failures = int(peer.get("failures", 0))
    fallthrough = int(peer.get("fallthrough_bytes", 0))
    if failures == 0 and fallthrough == 0:
        return None
    tier_split = report.get("tier_split") or {}
    return {
        "summary": (
            "the restore had eligible peer-RAM copies but fell through "
            "to storage for part of its bytes: peer transfers failed "
            "or cached copies were missing/corrupt — recovery paid "
            "storage latency the peer tier exists to avoid"
        ),
        "evidence": {
            "peer_failures": failures,
            "fallthrough_bytes": fallthrough,
            "eligible_blobs": int(peer.get("eligible_blobs", 0)),
            "served_blobs": int(peer.get("served_blobs", 0)),
            "peer_bytes": int(tier_split.get("peer", 0)),
            "fast_bytes": int(tier_split.get("fast", 0)),
            "durable_bytes": int(tier_split.get("durable", 0)),
        },
    }


@doctor_rule(names.RULE_RESTORE_COLD_START_SLOW)
def _restore_cold_start_slow(report: Dict[str, Any]):
    """The restore spent most of its wall on process cold start —
    event-loop spin-up, storage-plugin opens, native-module load — not
    on moving bytes (the r06 soft spot: first-trial restores 10-28x
    their warm cost). A warm pool / pre-opened plugin fixes this class;
    faster storage does not. Evidence cites the recorded
    ``{event_loop_s, plugin_open_s, native_load_s}`` split."""
    if report.get("kind") not in ("restore", "async_restore"):
        return None
    budget = knobs.get_cold_start_budget_fraction()
    if budget <= 0:
        return None
    cold = report.get("cold_start_s")
    if not cold or float(cold) < COLD_START_MIN_S:
        return None
    cold = float(cold)
    phases = report.get("phases") or {}
    wall = max((float(v) for v in phases.values()), default=0.0)
    # cold_start_s is measured before the phase clocks start: the op's
    # true wall is the pipeline wall plus the cold start itself.
    wall = max(wall, 0.0) + cold
    fraction = cold / wall
    if fraction <= budget:
        return None
    split = report.get("cold_start") or {}
    return {
        "summary": (
            "the restore's wall is dominated by cold start (event-loop "
            "spin-up + plugin open + native-module load), not data "
            "movement — a warm process pool or pre-opened plugins "
            "would cut it; faster storage would not"
        ),
        "evidence": {
            "cold_start_s": round(cold, 3),
            "wall_s": round(wall, 3),
            "cold_fraction": round(fraction, 3),
            "budget_fraction": budget,
            "event_loop_s": split.get("event_loop_s"),
            "plugin_open_s": split.get("plugin_open_s"),
            "native_load_s": split.get("native_load_s"),
        },
    }


@doctor_rule(names.RULE_STORAGE_CORRUPTION)
def _storage_corruption_report(report: Dict[str, Any]):
    """A restore's bytes failed digest verification on their first tier
    and were re-served through the healing ladder (docs/chaos.md): the
    op succeeded, but a stored copy is rotting. Evidence cites the
    rerouted blob/byte counts and the tiers that finally vouched."""
    degraded = report.get("degraded_reads") or {}
    if not int(degraded.get("blobs", 0)):
        return None
    tier_split = report.get("tier_split") or {}
    return {
        "summary": (
            "stored bytes failed checksum verification and restore "
            "rerouted around the corrupt copies — the data survived, "
            "the medium did not; run fsck --repair on the root and "
            "audit the tier the reroutes avoided"
        ),
        "evidence": {
            "degraded_blobs": int(degraded.get("blobs", 0)),
            "degraded_bytes": int(degraded.get("bytes", 0)),
            **{
                f"{tier}_bytes": int(nbytes)
                for tier, nbytes in sorted(tier_split.items())
            },
        },
    }


@doctor_rule(names.RULE_STORAGE_CORRUPTION, scope="evidence")
def _storage_corruption_repairs(ev: Evidence):
    """``fsck --repair`` recorded repair-performed ledger events for
    this root: chunks/blobs were rewritten from a verifying tier, or
    quarantined when no tier verified. Quarantines are critical — a
    referenced blob is now unrestorable by design (never served
    corrupt); rewrites are the medium-rot warning."""
    repairs = [
        r
        for r in ev.ledger_records
        if r.get("event") == names.EVENT_REPAIR_PERFORMED
    ]
    if not repairs:
        return None
    rewritten = sum(int(r.get("rewritten", 0)) for r in repairs)
    quarantined = sum(int(r.get("quarantined", 0)) for r in repairs)
    return {
        "summary": (
            "fsck --repair acted on corrupt stored bytes: "
            f"{rewritten} location(s) rewritten from a verifying tier, "
            f"{quarantined} quarantined (no tier verified — restores "
            "of those blobs now fail loudly instead of serving rot)"
        ),
        "severity": "critical" if quarantined else "warning",
        "evidence": {
            "repair_events": len(repairs),
            "rewritten": rewritten,
            "quarantined": quarantined,
            "last_unix_ts": repairs[-1].get("unix_ts"),
        },
        "source": ev.ledger_file,
    }


@doctor_rule(names.RULE_RETRY_STORM)
def _retry_storm(report: Dict[str, Any]):
    retries = report.get("retries") or {}
    attempts = float(retries.get("attempts", 0.0)) + float(
        retries.get("gcs_recover_attempts", 0.0)
    )
    if attempts < RETRY_STORM_ATTEMPTS:
        return None
    return {
        "summary": (
            "storage retries clustered inside this op: the backend was "
            "throwing transient errors while the checkpoint ran"
        ),
        "evidence": {
            "attempts": attempts,
            "backoff_s": retries.get("backoff_s", 0.0),
            "exhausted": retries.get("exhausted", 0.0),
            "threshold_attempts": RETRY_STORM_ATTEMPTS,
        },
    }


@doctor_rule(names.RULE_COORDINATION_BOUND)
def _coordination_bound(report: Dict[str, Any]):
    """Barrier waits + store round trips + the fan-out exchange ate a
    large fraction of the op: the world size outgrew the coordination
    topology (docs/scaling.md names the levers — tree-barrier fanout,
    store shards, batched store ops)."""
    coord = report.get("coordination") or {}
    if not coord:
        return None
    barrier_s = float(coord.get("barrier_wait_s", 0.0))
    store_s = float(coord.get("store_s", 0.0))
    exchange_s = float(coord.get("exchange_s", 0.0))
    # The exchange's own store round trips are inside exchange_s too;
    # take the max of the two views rather than double-charging.
    coord_s = barrier_s + max(store_s, exchange_s)
    phases = report.get("phases") or {}
    pipeline_wall_s = max((float(v) for v in phases.values()), default=0.0)
    # Barriers and the exchange run OUTSIDE the pipeline's phase spans,
    # so the op wall is at least pipeline + coordination.
    wall_s = pipeline_wall_s + coord_s
    if coord_s < COORD_MIN_S or wall_s <= 0.0:
        return None
    fraction = coord_s / wall_s
    if fraction < COORD_BOUND_FRACTION:
        return None
    return {
        "summary": (
            "coordination (barrier waits + store round-trips + fan-out "
            "exchange), not data movement, dominated this op: the world "
            "size outgrew the coordination topology (see docs/scaling.md "
            "for the barrier-fanout / store-shard levers)"
        ),
        "evidence": {
            "coordination_s": round(coord_s, 3),
            "coordination_fraction": round(fraction, 3),
            "barrier_wait_s": round(barrier_s, 3),
            "store_s": round(store_s, 3),
            "exchange_s": round(exchange_s, 3),
            "store_ops": coord.get("store_ops", 0.0),
            "pipeline_wall_s": round(pipeline_wall_s, 3),
            "spans": [names.SPAN_BARRIER_ARRIVE, names.SPAN_BARRIER_DEPART],
            "threshold_fraction": COORD_BOUND_FRACTION,
            "world_size": report.get("world_size"),
        },
    }


# ---------------------------------------------------------------------------
# Evidence-scope rules
# ---------------------------------------------------------------------------


@doctor_rule(names.RULE_WRITE_TAIL_STALL, scope="evidence")
def _write_tail_stall(ev: Evidence):
    out = []
    for tf, spans in sorted(ev.trace_spans.items()):
        if not spans:
            continue
        op_ms = max(float(s.get("dur_ms", 0.0)) for s in spans)
        writes = [
            s
            for s in spans
            if s.get("name")
            in (names.SPAN_STORAGE_WRITE, names.SPAN_MIRROR_BLOB)
        ]
        if not writes:
            continue
        worst = max(writes, key=lambda s: float(s.get("dur_ms", 0.0)))
        worst_ms = float(worst.get("dur_ms", 0.0))
        if worst_ms < TAIL_SPAN_MIN_MS or worst_ms < TAIL_SPAN_FRAC * op_ms:
            continue
        out.append(
            {
                "summary": (
                    "a single blob write dominated the op: a stuck/slow "
                    "write tail, not uniform slowness"
                ),
                "evidence": {
                    "span": worst.get("name"),
                    "blob": worst.get("blob", "?"),
                    "span_ms": worst_ms,
                    "op_ms": op_ms,
                    "threshold_frac": TAIL_SPAN_FRAC,
                },
                "source": os.path.basename(tf),
            }
        )
    return out or None


@doctor_rule(names.RULE_WATCHDOG_STALLED, scope="evidence")
def _watchdog_stalled(ev: Evidence):
    out = []
    for stall in ev.trace_stalls:
        out.append(
            {
                "summary": (
                    "the stall watchdog fired during this op; the trace "
                    "names the culprit span"
                ),
                "evidence": {
                    "span": stall.get("span"),
                    "age_s": stall.get("age_s"),
                    "idle_s": stall.get("idle_s"),
                },
                "source": os.path.basename(stall.get("file", "")),
                "severity": "critical",
            }
        )
    return out or None


@doctor_rule(names.RULE_INTERRUPTED_TAKE, scope="evidence")
def _interrupted_take(ev: Evidence):
    import time as _time

    out = []
    for doc in ev.progress:
        terminal = doc.get("terminal")
        if terminal == "done":
            continue
        if terminal is None:
            # Non-terminal heartbeat: a crash leftover only once it is
            # STALE relative to the writer's own recorded cadence — a
            # fresh one is a healthy op running right now (the live
            # case the heartbeat exists to serve, not a finding). A
            # heartbeat with no timestamp at all is treated as stale
            # (nothing can refresh it).
            updated = doc.get("updated_unix_ts")
            if updated is not None:
                interval = float(doc.get("interval_s") or 0.0)
                stale_after = max(
                    INTERRUPTED_STALE_INTERVALS * interval,
                    INTERRUPTED_STALE_MIN_S,
                )
                if _time.time() - float(updated) < stale_after:
                    continue
        severity = "critical" if terminal is None else "warning"
        what = (
            "died mid-flight without settling (crash or preemption)"
            if terminal is None
            else f"ended {terminal}: {doc.get('error')}"
        )
        out.append(
            {
                "summary": (
                    f"a {doc.get('kind', '?')} on rank "
                    f"{doc.get('rank', '?')} {what}; its heartbeat shows "
                    f"how far it got"
                ),
                "evidence": {
                    "phase": doc.get("phase"),
                    "written_bytes": doc.get("written_bytes"),
                    "planned_bytes": doc.get("planned_bytes"),
                    "items_done": doc.get("items_done"),
                    "planned_items": doc.get("planned_items"),
                },
                "source": os.path.basename(doc.get("file", "")),
                "severity": severity,
            }
        )
    return out or None


@doctor_rule(names.RULE_TUNER_THRASHING, scope="evidence")
def _tuner_thrashing(ev: Evidence):
    """The autotuner's decision log shows a tunable cycling A -> B -> A
    inside the thrash window: the policy is applying and undoing the
    same move (verdict flapping, or a knob whose effect straddles the
    regression threshold) instead of converging. Evidence cites the
    concrete decision-log entries (steps, values, actions) so the
    operator can pin the oscillating tunable with an env var — env
    always wins — or widen the knob's cooldown."""
    st = ev.tuner_state
    if not st:
        return None
    decisions = list(st.get("decisions") or [])[-TUNER_THRASH_WINDOW:]
    if len(decisions) < 3:
        return None
    tunable_names = sorted(
        {name for d in decisions for name in (d.get("vector") or {})}
    )
    out = []
    for name in tunable_names:
        series = [
            (
                d.get("step"),
                (d.get("vector") or {}).get(name),
                (d.get("decision") or {}).get("action"),
            )
            for d in decisions
        ]
        # Every A -> B -> A value cycle in the window. A SINGLE cycle
        # closed by a "revert" is the revert-on-regression guard rail
        # doing its one job (and the move then cools down) — not a
        # finding; thrashing is a cycle closed by ADJUST decisions
        # (verdict flapping pushing the knob both ways), or the same
        # cycle recurring.
        cycles = []
        for i in range(len(series) - 2):
            (s0, a, _), (s1, b, act1), (s2, c, act2) = series[i : i + 3]
            if a is None or b is None or c is None:
                continue
            if a != b and b != c and a == c:
                cycles.append(
                    {"steps": [s0, s1, s2], "values": [a, b, c],
                     "actions": [act1, act2]}
                )
        flagged = [c for c in cycles if "revert" not in c["actions"]]
        if not flagged and len(cycles) >= 2:
            flagged = cycles
        if flagged:
            cyc = flagged[0]
            a, b, _ = cyc["values"]
            out.append(
                {
                    "summary": (
                        f"the autotuner is oscillating on {name}: "
                        f"{a} -> {b} -> {a} within the last "
                        f"{len(decisions)} decisions"
                    ),
                    "evidence": {
                        "tunable": name,
                        "steps": cyc["steps"],
                        "values": cyc["values"],
                        "actions": cyc["actions"],
                        "cycles_in_window": len(cycles),
                        "window": TUNER_THRASH_WINDOW,
                    },
                    "source": os.path.basename(ev.tuner_state_file),
                }
            )
    return out or None


@doctor_rule(names.RULE_DEDUP_INEFFECTIVE, scope="evidence")
def _dedup_ineffective(ev: Evidence):
    """The content-addressed store is on (step-committed records carry
    ``cas: true`` with exact per-chunk accounting) but the trailing
    window realized ~zero reuse while the on-device digests recorded
    that most of the state was unchanged between steps. When dedup
    works, a digest-unchanged byte is *always* a reused byte (an
    incremental ref, or a chunk the store already held) — so this gap
    means the path is broken in practice: the chunks dir was wiped or
    relocated between steps, serialization stopped being deterministic,
    or chunk geometry churned. Evidence cites the ledger records the
    goodput storage curve is built from."""
    cas_steps = [
        r
        for r in ev.ledger_records
        if r.get("event") == names.EVENT_STEP_COMMITTED and r.get("cas")
    ]
    window = cas_steps[-max(DEDUP_WINDOW_STEPS, 1) :]
    if len(window) < DEDUP_WINDOW_STEPS:
        return None
    total = sum(int(r.get("bytes_total", 0)) for r in window)
    reused = sum(int(r.get("bytes_reused", 0)) for r in window)
    unchanged = sum(
        int(r.get("bytes_digest_unchanged", 0)) for r in window
    )
    covered = sum(int(r.get("bytes_digest_covered", 0)) for r in window)
    if total <= 0 or covered <= 0:
        return None  # no digest evidence: cannot say the state was static
    reuse_frac = reused / total
    unchanged_frac = unchanged / covered
    if (
        reuse_frac >= DEDUP_REUSE_FLOOR
        or unchanged_frac < DEDUP_UNCHANGED_FRAC
    ):
        return None
    return {
        "summary": (
            "the content-addressed store reused almost nothing across "
            "recent steps even though the on-device digests say the "
            "state was mostly unchanged — check that the root's chunks/ "
            "directory persists between steps and that serialization "
            "is deterministic (fsck --cas audits the store)"
        ),
        "severity": "warning",
        "evidence": {
            "steps": [r.get("step") for r in window],
            "reuse_fraction": round(reuse_frac, 4),
            "digest_unchanged_fraction": round(unchanged_frac, 4),
            "bytes_total": total,
            "bytes_reused": reused,
            "window": DEDUP_WINDOW_STEPS,
            "reuse_floor": DEDUP_REUSE_FLOOR,
            "unchanged_threshold": DEDUP_UNCHANGED_FRAC,
        },
        "source": os.path.basename(ev.ledger_file),
    }


@doctor_rule(names.RULE_CDN_STALENESS_HIGH, scope="evidence")
def _cdn_staleness_high(ev: Evidence):
    """The serving fleet is lagging the training job: the median
    publish-to-swap latency over the trailing ``cdn-swapped`` ledger
    records exceeds the staleness budget knob. Evidence cites the
    publish/swap event counts and the per-subscriber staleness spread —
    a uniformly slow fleet points at the announce path or durable
    reads; a long tail points at individual subscribers (dead owner
    endpoints forcing pull-timeout durable fallbacks)."""
    swaps = [
        r
        for r in ev.ledger_records
        if r.get("event") == names.EVENT_CDN_SWAPPED
        and r.get("staleness_s") is not None
    ]
    window = swaps[-max(CDN_STALENESS_WINDOW, 1) :]
    if len(window) < CDN_STALENESS_MIN_SAMPLES:
        return None
    from .. import knobs as _knobs

    budget = _knobs.get_cdn_staleness_budget_seconds()
    if budget <= 0:
        return None
    samples = sorted(float(r["staleness_s"]) for r in window)
    median = samples[len(samples) // 2]
    if median <= budget:
        return None
    publishes = sum(
        1
        for r in ev.ledger_records
        if r.get("event") == names.EVENT_CDN_PUBLISHED
    )
    return {
        "summary": (
            "the serving fleet's median publish-to-swap staleness "
            "exceeds the budget — subscribers are applying steps late; "
            "check owner endpoint health (pull-timeout fallbacks), "
            "announce cadence, and durable-read latency"
        ),
        "evidence": {
            "median_staleness_s": round(median, 4),
            "p90_staleness_s": round(
                samples[min(len(samples) - 1, (len(samples) * 9) // 10)], 4
            ),
            "budget_s": budget,
            "swaps_observed": len(window),
            "publishes_observed": publishes,
            "subscribers": len(
                {r.get("subscriber") for r in window}
            ),
        },
        "source": os.path.basename(ev.ledger_file),
    }


@doctor_rule(names.RULE_SLO_BURNING, scope="evidence")
def _slo_burning(ev: Evidence):
    """A declared SLO objective is burning its error budget
    (telemetry/slo.py): the fast window caught a cliff or the slow
    window caught drift. One verdict per breaching objective, citing
    the per-window burn/bad-sample counts and any ``slo-breach``
    ledger events the live evaluation already posted. Re-judged from
    the gathered evidence (not the live engine's state), so a bundle's
    relocated copy reproduces the live run's verdicts exactly."""
    if not ev.ledger_records:
        return None
    from . import slo

    out = []
    for obj in slo.evaluate(ev.ledger_records, ev.history_records):
        if not obj["breaching"]:
            continue
        breach_events = sum(
            1
            for r in ev.ledger_records
            if r.get("event") == names.EVENT_SLO_BREACH
            and r.get("objective") == obj["objective"]
        )
        fast = obj["fast"] or {}
        slow = obj["slow"] or {}
        out.append(
            {
                "summary": (
                    f"SLO objective {obj['objective']!r} "
                    f"({obj['description']}) is burning its error "
                    f"budget: target {obj['target']}{obj['unit']}, "
                    f"burn rate {obj['burn_rate']:.2f}"
                ),
                "evidence": {
                    "objective": obj["objective"],
                    "target": obj["target"],
                    "unit": obj["unit"],
                    "last_value": obj["last_value"],
                    "samples": obj["samples"],
                    "fast_bad": fast.get("bad"),
                    "fast_window": fast.get("window"),
                    "fast_burn": fast.get("burn"),
                    "slow_bad": slow.get("bad"),
                    "slow_window": slow.get("window"),
                    "slow_burn": slow.get("burn"),
                    "breach_events": breach_events,
                },
                "source": os.path.basename(ev.ledger_file),
            }
        )
    return out or None


@doctor_rule(names.RULE_GOODPUT_DEGRADED, scope="evidence")
def _goodput_degraded(ev: Evidence):
    """The run ledger shows checkpointing eating more than the overhead
    budget of this run's wall time. Per-op telemetry cannot see this —
    every individual take can be within its own thresholds while the
    cadence/latency product still swallows the run; the run-level
    fraction is what decides checkpoint interval and tiering policy
    (docs/goodput.md)."""
    if not ev.ledger_records:
        return None
    from .goodput import analyze, latest_run

    run = latest_run(analyze(ev.ledger_records))
    if run is None or run["wall_s"] < GOODPUT_MIN_WALL_S:
        return None
    if run["overhead_fraction"] < GOODPUT_DEGRADED_FRAC:
        return None
    return {
        "summary": (
            "checkpointing consumed a large fraction of this run's wall "
            "time (visible stalls + restores + lost work against the "
            "run ledger); raise the save interval, move to async/tiered "
            "takes, or cut recovery cost"
        ),
        "evidence": {
            "run_id": run["run_id"],
            "overhead_fraction": run["overhead_fraction"],
            "wall_s": run["wall_s"],
            "visible_stall_s": run["visible_stall_s"],
            "restore_s": run["restore_s"],
            "lost_work_s": run["lost_work_s"],
            "steps_committed": run["steps_committed"],
            "ledger_events": len(ev.ledger_records),
            "threshold_frac": GOODPUT_DEGRADED_FRAC,
        },
        "source": os.path.basename(ev.ledger_file),
    }


@doctor_rule(names.RULE_RECOVERY_COST_HIGH, scope="evidence")
def _recovery_cost_high(ev: Evidence):
    """An interruption recorded in the run ledger cost more than the
    recovery budget: the work replayed since the last committed step
    plus the restore that recovered it. Evidence cites the ledger's
    preemption/step-committed/restore-served records — the fix is a
    tighter checkpoint interval (or peer-redundant hot checkpoints),
    not a faster individual save."""
    if not ev.ledger_records:
        return None
    from .goodput import analyze

    out = []
    for run in analyze(ev.ledger_records)["runs"]:
        for itr in run["interruptions"]:
            if itr["recovery_cost_s"] < RECOVERY_COST_S:
                continue
            where = (
                f"preemption at step {itr['preemption_step']}"
                if itr["preemption_step"] is not None
                else f"segment {itr['segment']}'s interruption"
            )
            lost_steps = (
                f" ({itr['lost_steps']} step(s) replayed)"
                if itr["lost_steps"] is not None
                else ""
            )
            out.append(
                {
                    "summary": (
                        f"{where} cost "
                        f"{itr['recovery_cost_s']:.1f}s to recover: "
                        f"{itr['lost_work_s']:.1f}s of lost work"
                        f"{lost_steps} + {itr['restore_s']:.1f}s of "
                        f"restore"
                    ),
                    "evidence": {
                        "run_id": run["run_id"],
                        "segment": itr["segment"],
                        "recovery_cost_s": itr["recovery_cost_s"],
                        "lost_work_s": itr["lost_work_s"],
                        "lost_steps": itr["lost_steps"],
                        "restore_s": itr["restore_s"],
                        "restart_gap_s": itr["restart_gap_s"],
                        "preemption_step": itr["preemption_step"],
                        "last_committed_step": itr["last_committed_step"],
                        "threshold_s": RECOVERY_COST_S,
                    },
                    "source": os.path.basename(ev.ledger_file),
                    "severity": "warning",
                }
            )
    return out or None


@doctor_rule(names.RULE_MIRROR_LAGGING, scope="evidence")
def _mirror_lagging_live(ev: Evidence):
    m = ev.mirror_state
    if m is None:
        return None
    lag = float(m.get("upload_lag_s", 0.0))
    depth = int(m.get("snapshots_pending", 0))
    if lag < MIRROR_LAG_S and depth < MIRROR_QUEUE_DEPTH:
        return None
    return {
        "summary": (
            "the live process mirror is behind right now (queue state "
            "at diagnosis time, not from a recorded report)"
        ),
        "evidence": {
            "upload_lag_s": lag,
            "snapshots_pending": depth,
            "blobs_pending": m.get("blobs_pending", 0),
            "threshold_lag_s": MIRROR_LAG_S,
            "threshold_depth": MIRROR_QUEUE_DEPTH,
        },
        "source": "live-mirror",
    }


# ---------------------------------------------------------------------------
# Fleet rules (over decoded __obs/ metrics-plane entries — wire.py)
# ---------------------------------------------------------------------------


def _fleet_source(entry: Dict[str, Any]) -> str:
    return f"{entry.get('role', '?')}/{entry.get('id', '?')}"


@doctor_rule(names.RULE_WIRE_DIAL_STALLED, scope="fleet")
def _wire_dial_stalled(entries: Sequence[Dict[str, Any]]):
    """Whole-second-quantized dial latencies on one fleet member: SYNs
    are being retransmitted because the server's listen backlog is
    overflowing — raise its ``request_queue_size``."""
    from .wire import (
        DIAL_STALL_MIN_FRACTION,
        DIAL_STALL_MIN_SAMPLES,
        quantized_dial_fraction,
    )

    out = []
    for entry in entries:
        wire_summary = entry.get("wire") or {}
        dials = [float(s) for s in (wire_summary.get("dials_s") or [])]
        slow, frac = quantized_dial_fraction(dials)
        if slow < DIAL_STALL_MIN_SAMPLES or frac < DIAL_STALL_MIN_FRACTION:
            continue
        out.append(
            {
                "summary": (
                    "dial latencies quantize to whole seconds — the "
                    "SYN-retransmit signature of an overflowing listen "
                    "backlog (raise the server's request_queue_size)"
                ),
                "evidence": {
                    "slow_dials": slow,
                    "quantized_fraction": round(frac, 3),
                    "dial_p95_s": wire_summary.get("dial_p95_s"),
                    "threshold_fraction": DIAL_STALL_MIN_FRACTION,
                },
                "severity": "critical",
                "source": _fleet_source(entry),
            }
        )
    return out


@doctor_rule(names.RULE_WIRE_HOT_ENDPOINT, scope="fleet")
def _wire_hot_endpoint(entries: Sequence[Dict[str, Any]]):
    """One endpoint soaking up a disproportionate share of the fleet's
    wire bytes (every subscriber pulling from the same serving peer, a
    skewed owner map): fold per-endpoint bytes across every member's
    view and flag the outlier against the mean."""
    bytes_by_endpoint: Dict[str, float] = {}
    for entry in entries:
        endpoints = (entry.get("wire") or {}).get("endpoints") or {}
        for endpoint, fields in endpoints.items():
            bytes_by_endpoint[endpoint] = bytes_by_endpoint.get(
                endpoint, 0.0
            ) + float(fields.get("bytes", 0.0))
    if len(bytes_by_endpoint) < WIRE_HOT_MIN_ENDPOINTS:
        return None
    hot, hot_bytes = max(bytes_by_endpoint.items(), key=lambda kv: kv[1])
    mean = sum(bytes_by_endpoint.values()) / len(bytes_by_endpoint)
    if (
        hot_bytes < WIRE_HOT_MIN_BYTES
        or hot_bytes < WIRE_HOT_ENDPOINT_FACTOR * mean
    ):
        return None
    return {
        "summary": (
            "one endpoint is carrying a disproportionate share of the "
            "fleet's wire bytes (skewed owner map or a single serving "
            "peer soaking the whole subscriber fleet)"
        ),
        "evidence": {
            "endpoint": hot,
            "endpoint_mb": round(hot_bytes / 1024**2, 2),
            "fleet_mean_mb": round(mean / 1024**2, 2),
            "endpoints": len(bytes_by_endpoint),
            "threshold_factor": WIRE_HOT_ENDPOINT_FACTOR,
        },
        "source": "fleet",
    }


@doctor_rule(names.RULE_STORE_HOT_SHARD, scope="fleet")
def _store_hot_shard(entries: Sequence[Dict[str, Any]]):
    """One coordination-store shard serving far more requests than its
    siblings (a key-hashing skew or a hot prefix): fold the per-shard
    request counts every member reports and flag max-vs-mean skew."""
    requests_by_shard: Dict[str, float] = {}
    for entry in entries:
        shards = (entry.get("wire") or {}).get("store_shards") or {}
        for shard, count in shards.items():
            requests_by_shard[shard] = requests_by_shard.get(
                shard, 0.0
            ) + float(count)
    if len(requests_by_shard) < 2:
        return None
    total = sum(requests_by_shard.values())
    if total < STORE_HOT_MIN_REQUESTS:
        return None
    hot, hot_requests = max(requests_by_shard.items(), key=lambda kv: kv[1])
    mean = total / len(requests_by_shard)
    if hot_requests < STORE_HOT_SHARD_FACTOR * mean:
        return None
    return {
        "summary": (
            "one coordination-store shard is serving a disproportionate "
            "share of the fleet's requests (hot key prefix or hashing "
            "skew — rebalance the shard map)"
        ),
        "evidence": {
            "shard": hot,
            "shard_requests": round(hot_requests),
            "mean_requests": round(mean, 1),
            "shards": len(requests_by_shard),
            "threshold_factor": STORE_HOT_SHARD_FACTOR,
        },
        "source": "fleet",
    }


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def diagnose_fleet(entries: Sequence[Dict[str, Any]]) -> List[Verdict]:
    """Fleet-scope rules over the decoded ``__obs/`` metrics-plane
    entries: what ``telemetry fleet`` appends under its live table."""
    verdicts: List[Verdict] = []
    for rule in _FLEET_RULES:
        try:
            raw = rule.fn(list(entries))
        except Exception as e:  # noqa: BLE001 - a broken rule must not
            # take down the diagnosis
            logger.warning("doctor: rule %s failed: %r", rule.rule_id, e)
            continue
        verdicts.extend(_as_verdicts(rule.rule_id, raw))
    return rank_verdicts(verdicts)


def diagnose_reports(reports: Sequence[Dict[str, Any]]) -> List[Verdict]:
    """Run every report-scope rule over each report dict."""
    verdicts: List[Verdict] = []
    for report in reports:
        src = f"{report.get('kind', '?')}@rank{report.get('rank', 0)}"
        for rule in _REPORT_RULES:
            try:
                raw = rule.fn(report)
            except Exception as e:  # noqa: BLE001 - a broken rule must not
                # take down the diagnosis
                logger.warning(
                    "doctor: rule %s failed: %r", rule.rule_id, e
                )
                continue
            for v in _as_verdicts(rule.rule_id, raw):
                if not v.source:
                    v.source = src
                verdicts.append(v)
    return verdicts


def diagnose_evidence(ev: Evidence) -> List[Verdict]:
    """Report-scope rules over the recorded reports plus evidence-scope
    rules over the whole bundle, ranked most-severe first."""
    verdicts = diagnose_reports(ev.reports)
    for rule in _EVIDENCE_RULES:
        try:
            raw = rule.fn(ev)
        except Exception as e:  # noqa: BLE001
            logger.warning("doctor: rule %s failed: %r", rule.rule_id, e)
            continue
        verdicts.extend(_as_verdicts(rule.rule_id, raw))
    return rank_verdicts(verdicts)


def diagnose_snapshot(snapshot_path: str) -> List[Verdict]:
    """The library entry point ``fsck``/operators use: gather the
    snapshot's artifacts, run every rule, return ranked verdicts."""
    return diagnose_evidence(gather_evidence(snapshot_path))


def diagnose_ledger(root: str) -> List[Verdict]:
    """Run-level diagnosis from the ledger alone (the goodput rules):
    what ``doctor --trend`` appends so trend regressions speak in run
    cost, not just per-op latency. [] when no ledger exists."""
    from .ledger import find_ledger_for, load_ledger

    lf = find_ledger_for(root)
    if lf is None:
        return []
    ev = Evidence(path=root, ledger_records=load_ledger(lf), ledger_file=lf)
    verdicts: List[Verdict] = []
    for rule in _EVIDENCE_RULES:
        if rule.rule_id not in (
            names.RULE_GOODPUT_DEGRADED,
            names.RULE_RECOVERY_COST_HIGH,
        ):
            continue
        try:
            verdicts.extend(_as_verdicts(rule.rule_id, rule.fn(ev)))
        except Exception as e:  # noqa: BLE001
            logger.warning("doctor: rule %s failed: %r", rule.rule_id, e)
    return rank_verdicts(verdicts)


# ---------------------------------------------------------------------------
# Bench-trial epistemics
# ---------------------------------------------------------------------------


def bracket_stable(probe_a: float, probe_b: float) -> bool:
    """Two temporally-adjacent link probes agree within the stability
    factor (both positive). An unstable bracket means the link itself
    moved; efficiency ratios over it carry no blame signal."""
    lo, hi = min(probe_a, probe_b), max(probe_a, probe_b)
    return lo > 0 and hi / lo <= UNSTABLE_BRACKET_FACTOR


def probes_unstable(probes: Sequence[float]) -> bool:
    """Any adjacent probe pair in the series disagrees beyond the
    stability factor — the series-level ``link_unstable`` flag."""
    return any(
        not bracket_stable(a, b)
        for a, b in zip(probes, probes[1:])
        if min(a, b) > 0
    )


def diagnose_take_trial(
    take_s: float,
    gib: float,
    probe_before_gbps: float,
    probe_after_gbps: float,
    phases: Optional[Dict[str, float]] = None,
) -> List[Verdict]:
    """Diagnose one bracketed take trial (``in-take-stall`` /
    ``link-unstable``). The bracket's max
    is the tightest attainable-bandwidth estimate covering the trial's
    window; a *stable* bracket with achieved/bracket below the stall
    ratio means the slowdown happened inside the take."""
    verdicts: List[Verdict] = []
    bracket = max(probe_before_gbps, probe_after_gbps)
    achieved = gib / take_s if take_s > 0 else 0.0
    ratio = achieved / bracket if bracket > 0 else None
    stable = bracket_stable(probe_before_gbps, probe_after_gbps)
    if not stable:
        verdicts.append(
            Verdict(
                rule=names.RULE_LINK_UNSTABLE,
                summary=(
                    "the bracketing probes disagree beyond the stability "
                    "factor; the link moved during the trial window"
                ),
                evidence={
                    "probe_before_gbps": round(probe_before_gbps, 3),
                    "probe_after_gbps": round(probe_after_gbps, 3),
                    "threshold_factor": UNSTABLE_BRACKET_FACTOR,
                },
                severity="info",
            )
        )
    if stable and ratio is not None and ratio < STALL_EFFICIENCY_RATIO:
        evidence: Dict[str, Any] = {
            "take_s": round(take_s, 2),
            "achieved_gbps": round(achieved, 3),
            "bracket_gbps": round(bracket, 3),
            "ratio": round(ratio, 3),
            "threshold_ratio": STALL_EFFICIENCY_RATIO,
        }
        for phase in ("staging", "writing"):
            if phases and phases.get(phase) is not None:
                evidence[f"{phase}_done_s"] = phases[phase]
        verdicts.append(
            Verdict(
                rule=names.RULE_IN_TAKE_STALL,
                summary=(
                    "achieved throughput fell below half of a stable "
                    "attainable-bandwidth bracket: the slowdown happened "
                    "inside the take"
                ),
                evidence=evidence,
            )
        )
    return verdicts


# ---------------------------------------------------------------------------
# Trend diagnosis (history.py consumer)
# ---------------------------------------------------------------------------


def diagnose_trend(
    records: List[Dict[str, Any]], window: int = 0
) -> List[Verdict]:
    """Trend verdicts over a manager's step history (oldest first)."""
    from .history import TREND_WINDOW

    rows = detect_trend_regressions(
        records, window=window or TREND_WINDOW
    )
    verdicts = []
    for row in rows:
        step = row.get("step")
        where = f"step {step}" if step is not None else f"record {row['index']}"
        verdicts.append(
            Verdict(
                rule=names.RULE_TREND_REGRESSION,
                summary=(
                    f"{where} regressed on {row['metric']}: "
                    f"{row['value']} against a rolling baseline median "
                    f"of {row['baseline_median']}"
                ),
                evidence={
                    k: v for k, v in row.items() if k not in ("path",)
                },
                source=str(row.get("path") or ""),
            )
        )
    # Dominant-segment shifts (telemetry/critpath.py): the bottleneck
    # MOVED against the rolling window's modal dominant — a regression
    # class magnitude thresholds cannot see when the wall barely
    # changes (e.g. write drain shrank exactly as coordination grew).
    from .critpath import detect_critical_path_shifts

    for row in detect_critical_path_shifts(records, window=window):
        step = row.get("step")
        where = f"step {step}" if step is not None else f"record {row['index']}"
        verdicts.append(
            Verdict(
                rule=names.RULE_CRITICAL_PATH_SHIFTED,
                summary=(
                    f"{where} critical path shifted to "
                    f"{row['dominant']} (window dominant: "
                    f"{row['previous_dominant']})"
                ),
                evidence={
                    k: v for k, v in row.items() if k not in ("path",)
                },
                source=str(row.get("path") or ""),
            )
        )
    return rank_verdicts(verdicts)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _resolve_history_path(target: str) -> Optional[str]:
    from .history import HISTORY_BASENAME, history_path_for

    if os.path.isfile(target):
        return target
    if target.endswith(HISTORY_BASENAME):
        return target
    return history_path_for(target)


def _main_fleet(target: str, as_json: bool) -> int:
    """``doctor --fleet <target>``: the fleet rules over the live entries."""
    import json as _json

    from .wire import collect_fleet, open_fleet_store

    store = open_fleet_store(target)
    try:
        entries = collect_fleet(store)
    finally:
        store.close()
    verdicts = diagnose_fleet(entries)
    if as_json:
        print(_json.dumps([v.to_dict() for v in verdicts], indent=1))
    else:
        print(f"doctor fleet: {target} ({len(entries)} live publisher(s))")
        if not verdicts:
            print("no findings")
        for v in verdicts:
            print(v.format())
    return 0 if not verdicts else 2


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json as _json

    p = argparse.ArgumentParser(
        prog="torchsnapshot_tpu_torch.telemetry doctor",
        description=(
            "Diagnose a snapshot's recorded telemetry (reports, traces, "
            "progress heartbeats) or a manager's step-history trend."
        ),
    )
    p.add_argument(
        "target",
        nargs="?",
        default=None,
        help="snapshot path, or (with --trend) a manager root / "
        ".telemetry-history.jsonl file",
    )
    p.add_argument(
        "--bundle",
        default=None,
        metavar="PATH",
        help="diagnose a captured incident bundle (telemetry/bundle.py) "
        "— the full offline analysis against the bundle's frozen "
        "artifacts, with the original root gone",
    )
    p.add_argument(
        "--trend",
        action="store_true",
        help="trend mode: flag per-step regressions against a rolling "
        "median +/- MAD baseline",
    )
    p.add_argument(
        "--window",
        type=int,
        default=0,
        help="trend baseline window (default: history.TREND_WINDOW)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable verdict list instead of the text report",
    )
    p.add_argument(
        "--fleet",
        action="store_true",
        help="fleet mode: the target is a coordination store (host:port) "
        "or a root holding .fleet-endpoint; run the fleet-scope rules over "
        "its live __obs/ metrics-plane entries",
    )
    args = p.parse_args(list(argv) if argv is not None else None)
    if args.fleet:
        if args.target is None:
            p.error("--fleet needs a target (host:port or a root)")
        return _main_fleet(args.target, args.json)

    if args.bundle is not None:
        from .bundle import is_bundle, load_manifest

        if not is_bundle(args.bundle):
            print(
                f"doctor: {args.bundle!r} is not an incident bundle "
                f"(no manifest.json); capture one with "
                f"`telemetry bundle <root> --capture`"
            )
            return 1
        manifest = load_manifest(args.bundle) or {}
        if not args.json:
            print(
                f"doctor bundle: {args.bundle} "
                f"(trigger {manifest.get('trigger')!r}"
                + (
                    f", reason {manifest.get('reason')!r}"
                    if manifest.get("reason")
                    else ""
                )
                + f", captured from {manifest.get('root')!r})"
            )
        # The bundle dir mimics a snapshot dir's layout, so the normal
        # gather/diagnose path below reads it unchanged.
        args.target = args.bundle
    if args.target is None:
        p.error("a target (or --bundle PATH) is required")

    if args.trend:
        from .history import HISTORY_BASENAME, load_history

        path = _resolve_history_path(args.target)
        if path is None or not os.path.exists(path):
            print(
                f"doctor: no step history found for {args.target!r} "
                f"(history records at <root>/{HISTORY_BASENAME}; "
                f"enable with TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS > 0)"
            )
            return 1
        records = load_history(path)
        verdicts = diagnose_trend(records, window=args.window)
        # Run-level context rides along: a manager root with a ledger
        # gets the goodput verdicts appended, so a per-step regression
        # and its run-level cost appear in one report.
        verdicts = rank_verdicts(
            [*verdicts, *diagnose_ledger(args.target)]
        )
        if args.json:
            print(_json.dumps([v.to_dict() for v in verdicts], indent=1))
        else:
            print(
                f"doctor trend: {len(records)} step record(s) in {path}"
            )
            if not verdicts:
                print("no regressions against the rolling baseline")
            for v in verdicts:
                print(v.format())
        return 0 if not verdicts else 2

    verdicts = diagnose_snapshot(args.target)
    if args.json:
        print(_json.dumps([v.to_dict() for v in verdicts], indent=1))
        return 0 if not verdicts else 2
    print(f"doctor: {args.target}")
    if not verdicts:
        print(
            "no findings (nothing recorded, or everything within "
            "thresholds); record artifacts with "
            "TORCHSNAPSHOT_TPU_TELEMETRY=1 / TORCHSNAPSHOT_TPU_TRACE=1"
        )
        return 0
    for v in verdicts:
        print(v.format())
    return 2
