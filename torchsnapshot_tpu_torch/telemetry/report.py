"""SnapshotReport: one JSON-serializable record per checkpoint operation.

Copy of ``torchsnapshot_tpu/telemetry/report.py``, in the same schema, so
that either package's readers parse the other's reports.
``critical_path`` is filled by ``telemetry/critpath.py`` for every take,
restore and mirror job; ``wire`` is the wire observatory's split of the
op's window (``wire_from_deltas``: frames, bytes, dials and RPC seconds,
with a per-op table), None when the op put nothing on a socket;
``tunables`` holds ``knobs.tunable_snapshot()``, the vector the op ran
under, under the JAX names.

Every ``Snapshot.take`` / ``async_take`` / ``restore`` /
``async_restore`` and every tiered mirror job produces one of these.
The record is assembled from two sources:

- the **pipeline telemetry** the scheduler hands back per run (per-phase
  wall-clock durations, bytes/blob counts, memory-budget wait time, peak
  staged bytes) — exact for the operation;
- **registry counter deltas** over the operation's window (per-plugin
  byte/op counts, retry/recover attempts) — process-global, so
  concurrent work (e.g. a mirror draining during the next take) lands
  in the same window; the exact scheduler numbers are authoritative
  where they overlap.

Cross-rank: each rank builds its own report; rank 0 gathers the per-rank
dicts over ``dist_store.Store.gather`` and attaches min/median/max and
the straggler rank per phase (``aggregate_across_ranks``), which is what
FastPersist-style stall hunting actually needs — a single wall-clock
number per phase cannot show one slow rank.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Dict, List, Optional

from . import names
from .registry import parse_series_key

SCHEMA_VERSION = 1

# Registry counter names folded into the report's per-plugin table.
_PLUGIN_COUNTERS = {
    names.STORAGE_WRITE_BYTES_TOTAL: "write_bytes",
    names.STORAGE_WRITE_OPS_TOTAL: "write_ops",
    names.STORAGE_READ_BYTES_TOTAL: "read_bytes",
    names.STORAGE_READ_OPS_TOTAL: "read_ops",
}
# ...and into the retry table (summed across scopes/labels).
_RETRY_COUNTERS = {
    names.STORAGE_RETRY_ATTEMPTS_TOTAL: "attempts",
    names.STORAGE_RETRY_BACKOFF_SECONDS_TOTAL: "backoff_s",
    names.STORAGE_RETRIES_EXHAUSTED_TOTAL: "exhausted",
    names.GCS_RECOVER_ATTEMPTS_TOTAL: "gcs_recover_attempts",
}
# ...and into the coordination split (summed across op/phase/impl
# labels): what the op spent on cross-rank coordination — store wire
# round trips, barrier arrive/depart waits, the fan-out exchange, and
# endpoint resolution. The ``coordination-bound`` doctor rule reads
# this against the op's wall time.
_COORD_COUNTERS = {
    names.COORD_STORE_REQUESTS_TOTAL: "store_ops",
    names.COORD_STORE_SECONDS_TOTAL: "store_s",
    names.COORD_BARRIER_WAIT_SECONDS_TOTAL: "barrier_wait_s",
    names.COORD_EXCHANGE_SECONDS_TOTAL: "exchange_s",
    names.COORD_ENDPOINT_SECONDS_TOTAL: "endpoint_s",
}
# ...and into the wire split (summed across endpoint/direction labels,
# with a per-op RPC table kept separately): what the op put on actual
# sockets — frames, bytes, dials, request/reply round trips, and
# context-header degradations. Subsumed by ``coordination`` for store
# traffic but endpoint-true (peer-tier and CDN frames never touch the
# coordination counters).
_WIRE_COUNTERS = {
    names.WIRE_FRAMES_TOTAL: "frames",
    names.WIRE_BYTES_TOTAL: "bytes",
    names.WIRE_DIALS_TOTAL: "dials",
    names.WIRE_DIAL_SECONDS_TOTAL: "dial_s",
    names.WIRE_RPCS_TOTAL: "rpcs",
    names.WIRE_RPC_SECONDS_TOTAL: "rpc_s",
    names.WIRE_CONTEXT_DEGRADED_TOTAL: "context_degraded",
}


@dataclasses.dataclass
class SnapshotReport:
    """Schema (all fields JSON-serializable; see docs/observability.md):

    - ``kind``: take | async_take | restore | async_restore | mirror
    - ``phases``: phase -> seconds (pipeline wall-clock at completion)
    - ``plugins``: plugin -> {write_bytes, write_ops, read_bytes,
      read_ops} counter deltas over the operation
    - ``retries``: {attempts, backoff_s, exhausted,
      gcs_recover_attempts} deltas — always present, zero-filled
    - ``mirror``: tiered operations only — the process mirror's state at
      assembly (upload lag, queue depth); mirror-kind reports carry the
      finished job's own numbers instead
    - ``aggregated``: rank 0 only, world > 1 — per-phase
      {min, median, max, straggler (rank)} across the gathered reports
    - ``clock_offsets_s``: rank 0 only, world > 1 — each rank's
      wall-clock at gather entry minus rank 0's (rank order). Every
      rank reaches the gather within moments of the same commit
      barrier, so this approximates per-rank clock skew; the trace
      merge (telemetry/trace.py) subtracts it to align per-rank
      timelines. Includes barrier-exit jitter — see
      docs/observability.md for the caveat.
    """

    kind: str
    path: str
    rank: int = 0
    world_size: int = 1
    unix_ts: float = 0.0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    plugins: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    bytes_moved: int = 0
    blobs: int = 0
    budget_wait_s: float = 0.0
    peak_staged_bytes: int = 0
    # Async takes only (None elsewhere): the training-visible span
    # (async_take return-to-caller) and the op-relative time at which
    # background staging (D2H + serialize) completed — the
    # visible / staged / committed phase split docs/async.md describes.
    visible_s: Optional[float] = None
    staged_s: Optional[float] = None
    # Device-snapshot drains only: the StagingPool geometry
    # ({capacity_bytes, slab_bytes, slabs}) that bounded this
    # pipeline's host staging — the context an operator needs to read
    # peak_staged_bytes / budget_wait_s on a pool-bounded drain.
    staging_pool: Optional[Dict[str, int]] = None
    # Restore pipelines only (None elsewhere): the read-amplification
    # triple. ``bytes_needed`` is what this rank's read plan had to fill
    # (pre-batching consuming costs); ``bytes_fetched`` is what it
    # actually pulled from the storage plugin (fan-out owners fetch each
    # unique saved shard once); ``bytes_received`` is what arrived from
    # peer owners over the coordination store instead. Fan-out restores
    # record bytes_fetched < bytes_needed on non-owner ranks; a fallback
    # restore reads its own bytes, so fetched ~= needed. The doctor's
    # ``restore-read-amplified`` rule keys off these fields.
    bytes_fetched: Optional[int] = None
    bytes_received: Optional[int] = None
    bytes_needed: Optional[int] = None
    # Peer-tier restores only (None/empty elsewhere): bytes served per
    # tier of the peer RAM -> local fast -> durable ladder
    # (``{"peer": b, "fast": b, "durable": b}``), and the degradation
    # evidence — eligible/served blob counts, transfer failures, and
    # the bytes that fell through to storage despite an eligible peer
    # copy. The ``peer-tier-degraded`` doctor rule keys off these.
    tier_split: Optional[Dict[str, int]] = None
    peer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Self-healing restores only (None elsewhere): reads whose first
    # copy failed digest verification and were re-served from an
    # alternate tier (``{"blobs": n, "bytes": n}``; the serving tiers
    # land in ``tier_split``). The ``storage-corruption`` doctor rule
    # keys off this — a restore that healed still rode rotting media.
    degraded_reads: Optional[Dict[str, int]] = None
    # Write pipelines only (None elsewhere): bytes served per write-path
    # variant (``{"vectorized": b, "direct": b, "fused": b,
    # "buffered": b}``), as stamped by the storage plugin per write —
    # which path actually served this take, so a ``doctor --trend``
    # efficiency move can be correlated with the write-path knob flip
    # that caused it (the ``tunables`` field below carries the knobs).
    write_path: Optional[Dict[str, int]] = None
    # The *effective* tunable-knob values the operation ran under
    # (knobs.tunable_snapshot(), captured at op start): env > tuner
    # override > default, already resolved. Recorded whether or not the
    # autotuner is on — a history row / doctor --trend regression can
    # then always be correlated with the knob change that caused it.
    tunables: Optional[Dict[str, Any]] = None
    # Restores only (None elsewhere): the cold-start envelope — time
    # spent before the first storage byte moved, attributed to its
    # causes (``{"plugin_open_s": s, "event_loop_s": s,
    # "native_load_s": s}``), and the total. A first-trial restore that
    # is 10-30x slower than warm trials convicts itself here instead of
    # leaving the gap a guess (the cold_restore bench's soft spot).
    cold_start_s: Optional[float] = None
    cold_start: Optional[Dict[str, float]] = None
    # Multi-rank ops only (None when the op issued no coordination
    # traffic): the coordination split over the op's window —
    # ``{store_ops, store_s, barrier_wait_s, exchange_s, endpoint_s}``
    # registry counter deltas (process-global, like the plugin table).
    # The ``coordination-bound`` doctor rule keys off this.
    coordination: Optional[Dict[str, float]] = None
    # Ops whose window put frames on actual sockets (None otherwise):
    # the wire split — ``{frames, bytes, dials, dial_s, rpcs, rpc_s,
    # context_degraded}`` totals plus ``ops`` (per declared RPC op id:
    # {rpcs, rpc_s}). The ``wire-dial-stalled`` / ``wire-hot-endpoint``
    # doctor rules and the history's ``wire_s`` trend key off this.
    wire: Optional[Dict[str, Any]] = None
    # Blocking-chain attribution over the op's flight-recorder window
    # (telemetry/critpath.py; None when no envelope span landed in the
    # window): ``{wall_s, coverage, segments: {segment: seconds},
    # dominant, chain: [{span, segment, gated_s, blob?}]}``. The
    # segments partition the op's wall — each microsecond charged to
    # the innermost open span's path segment — so ``coverage`` sits at
    # ~1.0 and the dominant segment names the op's actual bottleneck.
    # Feeds the history's ``critpath`` rows, ``doctor --trend``'s
    # dominant-shift rule, and the ``telemetry diff`` CLI.
    critical_path: Optional[Dict[str, Any]] = None
    retries: Dict[str, float] = dataclasses.field(default_factory=dict)
    mirror: Dict[str, Any] = dataclasses.field(default_factory=dict)
    aggregated: Optional[Dict[str, Dict[str, float]]] = None
    clock_offsets_s: Optional[List[float]] = None
    error: Optional[str] = None
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SnapshotReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def merge_pipeline_telemetry(
    pipelines: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """Fold several pipeline-telemetry dicts (a restore runs one read
    pipeline per stateful) into one: bytes/blobs/wait sum, per-phase
    durations sum (each pipeline's phase is its own wall-clock span),
    peak staged bytes max."""
    out: Dict[str, Any] = {
        "phases": {},
        "bytes_moved": 0,
        "blobs": 0,
        "budget_wait_s": 0.0,
        "peak_staged_bytes": 0,
    }
    for p in pipelines:
        for phase, s in p.get("phases", {}).items():
            out["phases"][phase] = round(
                out["phases"].get(phase, 0.0) + s, 3
            )
        out["bytes_moved"] += p.get("bytes_moved", 0)
        out["blobs"] += p.get("blobs", 0)
        out["budget_wait_s"] += p.get("budget_wait_s", 0.0)
        out["peak_staged_bytes"] = max(
            out["peak_staged_bytes"], p.get("peak_staged_bytes", 0)
        )
        # Read-amplification accounting (read pipelines only): present
        # in the fold exactly when some pipeline carried it.
        for key in ("bytes_fetched", "bytes_received", "bytes_needed"):
            if key in p:
                out[key] = out.get(key, 0) + int(p[key])
        # Write-path variant split (write pipelines only): per-variant
        # byte sums fold across pipelines.
        if p.get("write_path"):
            wp = out.setdefault("write_path", {})
            for variant, nbytes in p["write_path"].items():
                wp[variant] = wp.get(variant, 0) + int(nbytes)
        # Self-healing accounting (read pipelines with corruption
        # reroutes only): per-tier rerouted bytes and the blob/byte
        # summary both sum across pipelines.
        if p.get("tier_split"):
            ts = out.setdefault("tier_split", {})
            for tier, nbytes in p["tier_split"].items():
                ts[tier] = ts.get(tier, 0) + int(nbytes)
        if p.get("degraded_reads"):
            dr = out.setdefault("degraded_reads", {})
            for key, n in p["degraded_reads"].items():
                dr[key] = dr.get(key, 0) + int(n)
    out["budget_wait_s"] = round(out["budget_wait_s"], 6)
    return out


def plugins_from_deltas(
    deltas: Dict[str, float]
) -> Dict[str, Dict[str, float]]:
    """Per-plugin table from flattened registry counter deltas."""
    out: Dict[str, Dict[str, float]] = {}
    for series, value in deltas.items():
        name, labels = parse_series_key(series)
        field = _PLUGIN_COUNTERS.get(name)
        if field is None:
            continue
        plugin = labels.get("plugin", "unknown")
        out.setdefault(plugin, {})[field] = value
    return out


def coordination_from_deltas(
    deltas: Dict[str, float]
) -> Optional[Dict[str, float]]:
    """Coordination split from counter deltas, summed across labels
    (op/phase/impl); None when the window saw no coordination traffic
    at all (single-process ops stay schema-light)."""
    out = {field: 0.0 for field in _COORD_COUNTERS.values()}
    seen = False
    for series, value in deltas.items():
        name, _ = parse_series_key(series)
        field = _COORD_COUNTERS.get(name)
        if field is not None:
            out[field] += value
            seen = True
    if not seen:
        return None
    return {k: round(v, 6) for k, v in out.items()}


def wire_from_deltas(deltas: Dict[str, float]) -> Optional[Dict[str, Any]]:
    """Wire split from counter deltas: scalar totals summed across
    endpoint/direction/outcome labels, plus a per-op RPC table keyed by
    the declared ``RPC_*`` op ids; None when the window put nothing on
    the wire (single-process ops stay schema-light)."""
    out = {field: 0.0 for field in _WIRE_COUNTERS.values()}
    ops: Dict[str, Dict[str, float]] = {}
    seen = False
    for series, value in deltas.items():
        name, labels = parse_series_key(series)
        field = _WIRE_COUNTERS.get(name)
        if field is None:
            continue
        out[field] += value
        seen = True
        if name in (names.WIRE_RPCS_TOTAL, names.WIRE_RPC_SECONDS_TOTAL):
            op = labels.get("op", "?")
            table = ops.setdefault(op, {"rpcs": 0.0, "rpc_s": 0.0})
            key = "rpcs" if name == names.WIRE_RPCS_TOTAL else "rpc_s"
            table[key] += value
    if not seen:
        return None
    result: Dict[str, Any] = {k: round(v, 6) for k, v in out.items()}
    if ops:
        result["ops"] = {
            op: {k: round(v, 6) for k, v in t.items()}
            for op, t in sorted(ops.items())
        }
    return result


def retries_from_deltas(deltas: Dict[str, float]) -> Dict[str, float]:
    """Retry table from counter deltas; every key present (zero-filled)
    so report consumers never need existence checks."""
    out = {field: 0.0 for field in _RETRY_COUNTERS.values()}
    for series, value in deltas.items():
        name, _ = parse_series_key(series)
        field = _RETRY_COUNTERS.get(name)
        if field is not None:
            out[field] += value
    return out


def build_report(
    kind: str,
    path: str,
    rank: int,
    world_size: int,
    pipeline: Optional[Dict[str, Any]],
    counter_deltas: Dict[str, float],
    mirror: Optional[Dict[str, Any]] = None,
    error: Optional[str] = None,
    tunables: Optional[Dict[str, Any]] = None,
) -> SnapshotReport:
    pipeline = pipeline or {}
    return SnapshotReport(
        kind=kind,
        path=path,
        rank=rank,
        world_size=world_size,
        unix_ts=time.time(),
        phases=dict(pipeline.get("phases", {})),
        plugins=plugins_from_deltas(counter_deltas),
        bytes_moved=int(pipeline.get("bytes_moved", 0)),
        blobs=int(pipeline.get("blobs", 0)),
        budget_wait_s=float(pipeline.get("budget_wait_s", 0.0)),
        peak_staged_bytes=int(pipeline.get("peak_staged_bytes", 0)),
        visible_s=(
            float(pipeline["visible_s"])
            if pipeline.get("visible_s") is not None
            else None
        ),
        staged_s=(
            float(pipeline["staged_s"])
            if pipeline.get("staged_s") is not None
            else None
        ),
        staging_pool=(
            dict(pipeline["staging_pool"])
            if pipeline.get("staging_pool")
            else None
        ),
        bytes_fetched=(
            int(pipeline["bytes_fetched"])
            if pipeline.get("bytes_fetched") is not None
            else None
        ),
        bytes_received=(
            int(pipeline["bytes_received"])
            if pipeline.get("bytes_received") is not None
            else None
        ),
        bytes_needed=(
            int(pipeline["bytes_needed"])
            if pipeline.get("bytes_needed") is not None
            else None
        ),
        tier_split=(
            {k: int(v) for k, v in pipeline["tier_split"].items()}
            if pipeline.get("tier_split")
            else None
        ),
        write_path=(
            {k: int(v) for k, v in pipeline["write_path"].items()}
            if pipeline.get("write_path")
            else None
        ),
        peer=dict(pipeline.get("peer") or {}),
        degraded_reads=(
            {k: int(v) for k, v in pipeline["degraded_reads"].items()}
            if pipeline.get("degraded_reads")
            else None
        ),
        cold_start_s=(
            float(pipeline["cold_start_s"])
            if pipeline.get("cold_start_s") is not None
            else None
        ),
        cold_start=(
            {k: round(float(v), 6) for k, v in pipeline["cold_start"].items()}
            if pipeline.get("cold_start")
            else None
        ),
        tunables=dict(tunables) if tunables is not None else None,
        coordination=coordination_from_deltas(counter_deltas),
        wire=wire_from_deltas(counter_deltas),
        retries=retries_from_deltas(counter_deltas),
        mirror=dict(mirror or {}),
        error=error,
    )


def clock_offsets_from_gather(
    rank_reports: List[Dict[str, Any]]
) -> Optional[List[float]]:
    """Per-rank clock offsets against rank 0 (rank order), from the
    ``gather_unix_ts`` each rank stamps into its gathered report dict
    moments after the shared commit barrier. None when the stamps are
    missing (older-schema peers). A rank with no stamp reports 0.0."""
    if not rank_reports:
        return None
    base = rank_reports[0].get("gather_unix_ts")
    if base is None:
        return None
    out: List[float] = []
    for r in rank_reports:
        ts = r.get("gather_unix_ts")
        out.append(round(float(ts) - float(base), 6) if ts is not None else 0.0)
    return out


def aggregate_across_ranks(
    rank_reports: List[Dict[str, Any]]
) -> Dict[str, Dict[str, float]]:
    """Per-phase min/median/max/straggler across gathered report dicts
    (rank order), plus the same spread for total bytes and budget wait.
    The straggler is the *rank index* of the max — the number an
    operator pages on."""
    out: Dict[str, Dict[str, float]] = {}

    def spread(metric: str, values: List[float]) -> None:
        if not values:
            return
        out[metric] = {
            "min": round(min(values), 3),
            "median": round(statistics.median(values), 3),
            "max": round(max(values), 3),
            "straggler": values.index(max(values)),
        }

    phase_names = sorted(
        {p for r in rank_reports for p in r.get("phases", {})}
    )
    for phase in phase_names:
        spread(
            f"phase_{phase}_s",
            [float(r.get("phases", {}).get(phase, 0.0)) for r in rank_reports],
        )
    spread(
        "bytes_moved", [float(r.get("bytes_moved", 0)) for r in rank_reports]
    )
    spread(
        "budget_wait_s",
        [float(r.get("budget_wait_s", 0.0)) for r in rank_reports],
    )
    # Wire fold: per-rank wire totals spread the same way, so one rank
    # paying disproportionate socket time (a hot owner, a stalled
    # dialer) surfaces as the straggler here without reading N reports.
    if any(r.get("wire") for r in rank_reports):
        for metric, field in (
            ("wire_bytes", "bytes"),
            ("wire_rpc_s", "rpc_s"),
            ("wire_dial_s", "dial_s"),
        ):
            spread(
                metric,
                [
                    float((r.get("wire") or {}).get(field, 0.0))
                    for r in rank_reports
                ],
            )
    # Critical-path fold: per-segment gated seconds spread across ranks
    # (union of segments any rank attributed), so "which rank's write
    # drain gated the step" is one straggler lookup, not N report reads.
    if any(r.get("critical_path") for r in rank_reports):
        segments = sorted(
            {
                seg
                for r in rank_reports
                for seg in (r.get("critical_path") or {}).get(
                    "segments", {}
                )
            }
        )
        for seg in segments:
            spread(
                f"critpath_{seg}_s",
                [
                    float(
                        (r.get("critical_path") or {})
                        .get("segments", {})
                        .get(seg, 0.0)
                    )
                    for r in rank_reports
                ],
            )
    return out
