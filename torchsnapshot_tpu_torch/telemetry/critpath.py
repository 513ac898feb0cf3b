"""Critical-path engine + differential regression analysis.

Copy of ``torchsnapshot_tpu/telemetry/critpath.py``: the same recorder
events give the same ``critical_path`` in either package, and the port's
spans carry the JAX package's names, so the segment map applies as is,
the ``wire:rpc`` / ``wire:handler`` spans of the peer tier included.

The flight recorder (trace.py) answers "which spans ran"; the
SnapshotReport's phases answer "how long each stage's wall clock was".
Neither answers the question a steady-state stall actually poses:
**which span chain gated the op's commit** — staging overlaps the write
drain, barriers overlap the mirror, and summing phase walls
double-charges every overlapped second. This module closes that gap:

- **Blocking-chain attribution.** For one take/restore op, a sweep over
  the op envelope's span window partitions every microsecond of wall
  into named path segments (device capture -> budget wait -> staging ->
  write drain -> coordination/barrier -> wire RPC -> mirror ...). Each
  elementary interval is charged to the *most recently begun* span
  still open — the innermost frame of the blocking chain, i.e. what the
  process was actually inside while the wall clock advanced. The
  partition is exhaustive by construction (envelope-only time lands in
  ``other``), so the segment sums cover >= 95% of op wall — the
  per-stage attribution ByteCheckpoint-style pipeline tuning needs.
- **Cross-process descent.** The same sweep over a *merged* Chrome
  trace (trace.merge_traces) descends through the wire observatory's
  stitched client->handler pairs: an interval gated by a ``wire:rpc``
  span is re-attributed to whatever the serving peer's handler was
  inside at that moment, so a "slow RPC" resolves to the peer's disk,
  not the socket.
- **Differential layer.** ``python -m torchsnapshot_tpu_torch.telemetry diff``
  compares two ops (snapshot dirs / events files) or two parsed
  ``BENCH_r*.json`` records and names the regressed path segment / bench
  leg with evidence citations; the ``critical-path-shifted`` and
  ``bench-regression`` doctor rules (doctor.py) make the same checks
  fleet-automatic.

The per-op result rides every SnapshotReport as the ``critical_path``
field (computed in-process from the recorder window at report time),
folds across ranks in ``report.aggregate_across_ranks``, lands in
history rows (``history.summarize_report``), and trends via ``doctor
--trend``. See docs/observability.md ("Critical path & differential
analysis").
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import names

# ---------------------------------------------------------------------------
# Segment taxonomy
# ---------------------------------------------------------------------------

# Path-segment vocabulary (stable identifiers: history rows, the
# cross-rank fold, and the diff CLI all key on these).
SEG_DEVICE_CAPTURE = "device_capture"
SEG_BUDGET_WAIT = "budget_wait"
SEG_STAGING = "staging"
SEG_WRITE_DRAIN = "write_drain"
SEG_READ_DRAIN = "read_drain"
SEG_COORDINATION = "coordination"
SEG_WIRE = "wire"
SEG_MIRROR = "mirror"
SEG_PEER = "peer"
SEG_CDN = "cdn"
# Envelope-only time: the op span was open but no instrumented child
# was — scheduling gaps, uninstrumented Python. A named segment (it
# counts toward coverage); a LARGE ``other`` share is itself a finding
# (instrument the gap).
SEG_OTHER = "other"

# span name -> path segment. Spans absent here (new layers, envelope
# spans gating nothing) attribute to ``other`` rather than erroring:
# the engine must survive spans younger than itself.
_SEGMENT_BY_SPAN: Dict[str, str] = {
    names.SPAN_DEVICE_CAPTURE: SEG_DEVICE_CAPTURE,
    names.SPAN_PIPELINE_BUDGET_ACQUIRE: SEG_BUDGET_WAIT,
    names.SPAN_PIPELINE_STAGE: SEG_STAGING,
    names.SPAN_LEAF_STAGE: SEG_STAGING,
    names.SPAN_BATCHER_STAGE_SLAB: SEG_STAGING,
    names.SPAN_BATCHER_STAGE_SLAB_VECTORIZED: SEG_STAGING,
    names.SPAN_PIPELINE_WRITE_DRAIN: SEG_WRITE_DRAIN,
    names.SPAN_STORAGE_WRITE: SEG_WRITE_DRAIN,
    names.SPAN_FS_NATIVE_WRITE: SEG_WRITE_DRAIN,
    names.SPAN_FS_NATIVE_PWRITEV: SEG_WRITE_DRAIN,
    names.SPAN_FS_NATIVE_DIRECT_WRITE: SEG_WRITE_DRAIN,
    names.SPAN_PIPELINE_CONSUME: SEG_READ_DRAIN,
    names.SPAN_LEAF_CONSUME: SEG_READ_DRAIN,
    names.SPAN_BATCHER_CONSUME_SPANNING: SEG_READ_DRAIN,
    names.SPAN_STORAGE_READ: SEG_READ_DRAIN,
    names.SPAN_FS_NATIVE_READ: SEG_READ_DRAIN,
    # The port's placement batches: host-to-device copies of landed leaves,
    # which the JAX package makes inside its consume spans.
    names.SPAN_RESTORE_PLACE: SEG_READ_DRAIN,
    names.SPAN_BARRIER_ARRIVE: SEG_COORDINATION,
    names.SPAN_BARRIER_DEPART: SEG_COORDINATION,
    names.SPAN_FANOUT_EXCHANGE: SEG_COORDINATION,
    names.SPAN_WIRE_RPC: SEG_WIRE,
    names.SPAN_WIRE_HANDLER: SEG_WIRE,
    names.SPAN_MIRROR_JOB: SEG_MIRROR,
    names.SPAN_MIRROR_BLOB: SEG_MIRROR,
    names.SPAN_PEER_JOB: SEG_PEER,
    names.SPAN_PEER_PUSH: SEG_PEER,
    names.SPAN_PEER_PULL: SEG_PEER,
    names.SPAN_CDN_PUBLISH: SEG_CDN,
    names.SPAN_CDN_SYNC: SEG_CDN,
    names.SPAN_CDN_SWAP: SEG_CDN,
}

# Per-kind op envelope span names: the window(s) whose wall the sweep
# partitions. Async takes have TWO envelopes (the training-visible
# stage span and the background commit span); the sweep attributes over
# their union.
_ENVELOPES_BY_KIND: Dict[str, Tuple[str, ...]] = {
    "take": (names.SPAN_TAKE,),
    "restore": (names.SPAN_RESTORE,),
    "async_take": (
        names.SPAN_ASYNC_TAKE_STAGE,
        names.SPAN_ASYNC_TAKE_COMMIT,
    ),
    "async_restore": (names.SPAN_ASYNC_RESTORE_READS,),
    "mirror": (names.SPAN_MIRROR_JOB,),
}
_ALL_ENVELOPE_NAMES = frozenset(
    n for ns in _ENVELOPES_BY_KIND.values() for n in ns
)

# Evidence spans cited per critical_path result (the blocking chain's
# heaviest members), and the coverage the acceptance bar requires.
EVIDENCE_TOP_N = 5
MIN_COVERAGE = 0.95


def segment_for(span_name: str) -> str:
    """The path segment a span attributes to (``other`` for envelope /
    unknown spans) — also the watchdog's gating-segment label."""
    return _SEGMENT_BY_SPAN.get(span_name, SEG_OTHER)


# ---------------------------------------------------------------------------
# Sweep-line attribution
# ---------------------------------------------------------------------------


def _merge_intervals(
    intervals: List[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """Sorted, non-overlapping union of [begin, end) interval list."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _overlap_us(lo: int, hi: int, windows: List[Tuple[int, int]]) -> int:
    """Length of [lo, hi)'s intersection with the merged window list."""
    total = 0
    for wlo, whi in windows:
        total += max(0, min(hi, whi) - max(lo, wlo))
    return total


def _sweep(
    spans: List[Dict[str, Any]],
    windows: List[Tuple[int, int]],
    descend: Optional[Any] = None,
) -> Tuple[Dict[str, float], Dict[Tuple[str, str], Dict[str, Any]]]:
    """Partition the window wall across the candidate spans.

    ``spans``: ``{"name", "ts", "dur", "order", "args"}`` with ts/dur in
    microseconds and ``order`` a begin-order tiebreak (bseq). Every
    elementary interval between span boundaries is charged to the most
    recently begun span still open there — the innermost frame of the
    blocking chain. ``descend(name, args, lo, hi)``, when given, may
    re-attribute one gated interval (the merged-trace wire descent);
    it returns ``(segment, evidence_key)`` or None.

    Returns ``(segment -> seconds, (segment, span name) -> evidence)``
    where evidence carries the gated seconds and a representative arg
    set (heaviest single contributor).
    """
    segments: Dict[str, float] = {}
    evidence: Dict[Tuple[str, str], Dict[str, Any]] = {}
    if not windows:
        return segments, evidence
    begins = sorted(
        (s for s in spans if s["dur"] > 0),
        key=lambda s: (s["ts"], s["order"]),
    )
    ends = sorted(begins, key=lambda s: s["ts"] + s["dur"])
    bounds = sorted(
        {b for s in begins for b in (s["ts"], s["ts"] + s["dur"])}
        | {b for w in windows for b in w}
    )
    active: Dict[int, Dict[str, Any]] = {}
    bi = ei = 0
    for i, lo in enumerate(bounds[:-1]):
        hi = bounds[i + 1]
        while ei < len(ends) and ends[ei]["ts"] + ends[ei]["dur"] <= lo:
            active.pop(id(ends[ei]), None)
            ei += 1
        while bi < len(begins) and begins[bi]["ts"] <= lo:
            active[id(begins[bi])] = begins[bi]
            bi += 1
        overlap = _overlap_us(lo, hi, windows)
        if overlap <= 0:
            continue
        gating = None
        for s in active.values():
            if gating is None or (s["ts"], s["order"]) > (
                gating["ts"],
                gating["order"],
            ):
                gating = s
        if gating is None:
            seg, name, args = SEG_OTHER, "", {}
        else:
            name, args = gating["name"], gating.get("args") or {}
            seg = segment_for(name)
            if descend is not None:
                deeper = descend(name, args, lo, hi)
                if deeper is not None:
                    seg, name, args = deeper
        seconds = overlap / 1e6
        segments[seg] = segments.get(seg, 0.0) + seconds
        if name:
            slot = evidence.setdefault(
                (seg, name), {"gated_s": 0.0, "peak_s": 0.0, "args": {}}
            )
            slot["gated_s"] += seconds
            if seconds > slot["peak_s"]:
                slot["peak_s"] = seconds
                slot["args"] = args
    return segments, evidence


def _assemble(
    segments: Dict[str, float],
    evidence: Dict[Tuple[str, str], Dict[str, Any]],
    wall_us: int,
) -> Optional[Dict[str, Any]]:
    """Shape the sweep output into the ``critical_path`` dict."""
    if wall_us <= 0:
        return None
    wall_s = wall_us / 1e6
    attributed = sum(segments.values())
    chain: List[Dict[str, Any]] = []
    for (seg, name), slot in sorted(
        evidence.items(), key=lambda kv: -kv[1]["gated_s"]
    )[:EVIDENCE_TOP_N]:
        entry: Dict[str, Any] = {
            "span": name,
            "segment": seg,
            "gated_s": round(slot["gated_s"], 6),
        }
        blob = (slot.get("args") or {}).get("blob")
        if blob:
            entry["blob"] = blob
        chain.append(entry)
    ordered = sorted(segments.items(), key=lambda kv: -kv[1])
    return {
        "wall_s": round(wall_s, 6),
        "coverage": round(min(1.0, attributed / wall_s), 4),
        "segments": {k: round(v, 6) for k, v in ordered},
        "dominant": ordered[0][0] if ordered else SEG_OTHER,
        "chain": chain,
    }


def critical_path_from_events(
    events: Sequence[Dict[str, Any]], kind: str
) -> Optional[Dict[str, Any]]:
    """The ``critical_path`` field for one op, from the flight
    recorder's window (``recorder.events_since(mark)`` — completed "X"
    events, ts/dur in unix-epoch us, begin order in ``bseq``). None
    when the window holds no envelope span for ``kind`` (trace ring
    overrun, or an op that never opened its envelope)."""
    env_names = _ENVELOPES_BY_KIND.get(kind)
    if not env_names:
        return None
    envelopes: List[Tuple[int, int]] = []
    candidates: List[Dict[str, Any]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e["name"]
        if name in env_names:
            envelopes.append((e["ts"], e["ts"] + e["dur"]))
            continue
        if name in _ALL_ENVELOPE_NAMES:
            # Another op's envelope overlapping this window (async
            # commit draining into the next take): an envelope never
            # gates, it only bounds.
            continue
        candidates.append(
            {
                "name": name,
                "ts": e["ts"],
                "dur": e["dur"],
                "order": e.get("bseq", 0),
                "args": e.get("args") or {},
            }
        )
    windows = _merge_intervals(envelopes)
    wall_us = sum(hi - lo for lo, hi in windows)
    segments, evidence = _sweep(candidates, windows)
    # The remainder of the envelope wall — no instrumented span open —
    # is ``other``: the partition always sums to the wall.
    gap = wall_us / 1e6 - sum(segments.values())
    if gap > 1e-9:
        segments[SEG_OTHER] = segments.get(SEG_OTHER, 0.0) + gap
    return _assemble(segments, evidence, wall_us)


def critical_path_from_doc(
    doc: Dict[str, Any],
    kind: str = "take",
    pid: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """The same attribution over a (merged) Chrome trace document, with
    cross-process descent: an interval gated by a ``wire:rpc`` span is
    re-attributed to whatever the serving peer's stitched handler was
    inside at that moment. ``pid`` selects the op's own process in a
    merged doc (default: the pid owning the longest envelope span)."""
    from .trace import spans_from_chrome, stitched_wire_pairs

    spans = spans_from_chrome(doc)
    env_names = _ENVELOPES_BY_KIND.get(kind)
    if not env_names or not spans:
        return None
    env_spans = [s for s in spans if s["name"] in env_names]
    if pid is not None:
        env_spans = [s for s in env_spans if s["pid"] == pid]
    if not env_spans:
        return None
    if pid is None:
        pid = max(env_spans, key=lambda s: s["dur_us"])["pid"]
        env_spans = [s for s in env_spans if s["pid"] == pid]
    windows = _merge_intervals(
        [(s["ts"], s["ts"] + s["dur_us"]) for s in env_spans]
    )
    wall_us = sum(hi - lo for lo, hi in windows)

    def to_cand(s: Dict[str, Any], order: int) -> Dict[str, Any]:
        return {
            "name": s["name"],
            "ts": s["ts"],
            "dur": s["dur_us"],
            # Chrome reconstruction has no bseq; begin ts + closing
            # order approximates it (later begin = deeper frame).
            "order": order,
            "args": s.get("args") or {},
        }

    candidates = [
        to_cand(s, i)
        for i, s in enumerate(spans)
        if s["pid"] == pid and s["name"] not in _ALL_ENVELOPE_NAMES
    ]

    # Wire descent: client span_id -> the handler's (pid, tid) spans,
    # so a gated RPC interval resolves to the peer's own frames.
    handler_tracks: Dict[str, List[Dict[str, Any]]] = {}
    for client, handler in stitched_wire_pairs(doc):
        span_id = str(client.get("args", {}).get("span_id"))
        track = [
            to_cand(s, i)
            for i, s in enumerate(spans)
            if s["pid"] == handler["pid"]
            and s["tid"] == handler["tid"]
            and s["name"] != names.SPAN_WIRE_HANDLER
            and s["ts"] < handler["ts"] + handler["dur_us"]
            and s["ts"] + s["dur_us"] > handler["ts"]
        ]
        handler_tracks[span_id] = track

    def descend(
        name: str, args: Dict[str, Any], lo: int, hi: int
    ) -> Optional[Tuple[str, str, Dict[str, Any]]]:
        if name != names.SPAN_WIRE_RPC:
            return None
        track = handler_tracks.get(str(args.get("span_id")))
        if not track:
            return None
        inner = None
        for s in track:
            if s["ts"] < hi and s["ts"] + s["dur"] > lo:
                if inner is None or (s["ts"], s["order"]) > (
                    inner["ts"],
                    inner["order"],
                ):
                    inner = s
        if inner is None:
            return None
        return (
            segment_for(inner["name"]),
            inner["name"],
            inner.get("args") or {},
        )

    segments, evidence = _sweep(candidates, windows, descend=descend)
    gap = wall_us / 1e6 - sum(segments.values())
    if gap > 1e-9:
        segments[SEG_OTHER] = segments.get(SEG_OTHER, 0.0) + gap
    return _assemble(segments, evidence, wall_us)


# ---------------------------------------------------------------------------
# Trend integration: dominant-segment shift detection
# ---------------------------------------------------------------------------


def detect_critical_path_shifts(
    records: List[Dict[str, Any]], window: int = 0
) -> List[Dict[str, Any]]:
    """Evidence rows for steps whose dominant critical-path segment
    differs from the *modal* dominant of the preceding rolling window
    (same-kind records only, like the magnitude trend): the bottleneck
    moved even if the wall barely did. Requires a consistent baseline —
    the modal segment must hold a strict majority of the window — so an
    already-oscillating history never flags."""
    from .history import TREND_MIN_BASELINE, TREND_WINDOW

    window = window or TREND_WINDOW
    out: List[Dict[str, Any]] = []
    by_kind: Dict[str, List[int]] = {}
    for i, rec in enumerate(records):
        if (rec.get("critpath") or {}).get("dominant"):
            by_kind.setdefault(str(rec.get("kind") or "take"), []).append(i)
    for kind in sorted(by_kind):
        indices = by_kind[kind]
        doms = [
            str(records[i]["critpath"]["dominant"]) for i in indices
        ]
        for j in range(TREND_MIN_BASELINE, len(doms)):
            baseline = doms[max(0, j - window) : j]
            if len(baseline) < TREND_MIN_BASELINE:
                continue
            modal = max(set(baseline), key=baseline.count)
            share = baseline.count(modal) / len(baseline)
            if share <= 0.5 or doms[j] == modal:
                continue
            rec = records[indices[j]]
            cp = rec.get("critpath") or {}
            out.append(
                {
                    "index": indices[j],
                    "step": rec.get("step"),
                    "kind": kind,
                    "path": rec.get("path"),
                    "dominant": doms[j],
                    "previous_dominant": modal,
                    "baseline_share": round(share, 3),
                    "window": len(baseline),
                    "dominant_s": (cp.get("segments") or {}).get(
                        doms[j]
                    ),
                }
            )
    out.sort(key=lambda row: row["index"])
    return out


# ---------------------------------------------------------------------------
# Bench-record differential (BENCH_r*.json)
# ---------------------------------------------------------------------------

# Signal-of-record legs with DECLARED per-leg direction and tolerance
# floors: leg key in the parsed record -> (label, direction, abs
# floor). Direction +1 flags increases (walls), -1 decreases
# (throughput / efficiency). The relative floor below is sized to the
# measured round-to-round link drift of the BENCH_r* series (r06 vs r07
# moves legs ~35% with no code change), so only beyond-drift moves
# convict.
BENCH_LEGS: Dict[str, Tuple[str, int, float]] = {
    "value": ("headline take throughput (GB/s)", -1, 0.02),
    "restore_gbps": ("restore throughput (GB/s)", -1, 0.02),
    "cold_restore_gbps": ("cold restore throughput (GB/s)", -1, 0.02),
    "async_visible_s": ("async take visible stall (s)", 1, 0.1),
    "cold_start_sync_s": ("restore cold start (s)", 1, 0.1),
    "fanout_restore_s": ("fan-out restore wall (s)", 1, 0.1),
    "fallback_restore_s": ("fallback restore wall (s)", 1, 0.1),
    "peer_recovery_wall_s": ("peer recovery wall (s)", 1, 0.1),
    "pipeline_efficiency": ("pipeline efficiency", -1, 0.05),
    "steady_state_final_efficiency": (
        "steady-state final efficiency",
        -1,
        0.05,
    ),
    "write_path_zero_pack_speedup": ("zero-pack speedup", -1, 0.2),
    "incremental_speedup": ("incremental-save speedup", -1, 0.2),
}
BENCH_MAD_K = 4.0
BENCH_MIN_REL = 0.5


def bench_regressions(
    records: Sequence[Tuple[str, Dict[str, Any]]],
    window: int = 6,
    legs: Optional[Dict[str, Tuple[str, int, float]]] = None,
) -> List[Dict[str, Any]]:
    """Regression rows for the NEWEST parsed bench record against the
    rolling baseline of its predecessors (``records`` oldest first,
    each ``(label, parsed)``). Per leg: baseline = the up-to-``window``
    preceding records that carry the leg; a value regresses when its
    signed deviation from the baseline median exceeds
    max(k * MAD, rel_floor * |median|, the leg's declared absolute
    floor). With a single predecessor (a pair diff) the MAD term is
    zero and the relative floor alone judges — sized so r06 vs r07
    (pure link drift) stays quiet while a doctored 5x slowdown fires."""
    if len(records) < 2:
        return []
    legs = legs if legs is not None else BENCH_LEGS
    newest_label, newest = records[-1]
    out: List[Dict[str, Any]] = []
    for leg, (label, sign, abs_floor) in legs.items():
        value = newest.get(leg)
        # Every signal leg is strictly positive when it actually ran; a
        # recorded 0.0 (or null) is a skipped/failed leg, not a
        # measurement — judging it would convict budget gating.
        if not isinstance(value, (int, float)) or value <= 0:
            continue
        carrying = [
            (lbl, float(p[leg]))
            for lbl, p in records[:-1]
            if isinstance(p.get(leg), (int, float)) and p[leg] > 0
        ][-window:]
        if not carrying:
            continue
        baseline = [v for _, v in carrying]
        med = statistics.median(baseline)
        mad = statistics.median(abs(v - med) for v in baseline)
        threshold = max(
            BENCH_MAD_K * mad, BENCH_MIN_REL * abs(med), abs_floor
        )
        deviation = sign * (float(value) - med)
        if deviation > threshold:
            out.append(
                {
                    "leg": leg,
                    "label": label,
                    "record": newest_label,
                    "value": round(float(value), 4),
                    "baseline_median": round(med, 4),
                    "baseline_mad": round(mad, 4),
                    "threshold": round(threshold, 4),
                    "window": len(baseline),
                    "baseline_records": [lbl for lbl, _ in carrying],
                }
            )
    out.sort(key=lambda r: -(abs(r["value"] - r["baseline_median"])))
    return out


def bench_verdicts(rows: List[Dict[str, Any]]) -> List[Any]:
    """``bench-regression`` doctor verdicts from regression rows."""
    from .doctor import Verdict

    out = []
    for row in rows:
        out.append(
            Verdict(
                rule=names.RULE_BENCH_REGRESSION,
                summary=(
                    f"{row['label']} regressed to {row['value']} against "
                    f"a baseline median of {row['baseline_median']} "
                    f"(tolerance {row['threshold']})"
                ),
                evidence={
                    k: v
                    for k, v in row.items()
                    if k not in ("label", "record")
                },
                severity="warning",
                source=str(row.get("record") or ""),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Report differential (two ops' critical paths)
# ---------------------------------------------------------------------------

# A segment's wall regressed when it grew by more than
# max(rel * before, abs floor) — the same epistemics as the trend
# detector, collapsed to a pair.
DIFF_MIN_REL = 0.3
DIFF_MIN_ABS_S = 0.05


def diff_reports(
    before: Dict[str, Any], after: Dict[str, Any]
) -> Dict[str, Any]:
    """Segment-level differential of two report dicts carrying
    ``critical_path``: per-segment before/after/delta, the regressed
    segments (delta beyond tolerance, largest first), and the AFTER
    op's evidence chain filtered to the top regressed segment — the
    span-level citation for "what got slower"."""
    cp_a = before.get("critical_path") or {}
    cp_b = after.get("critical_path") or {}
    segs_a = cp_a.get("segments") or {}
    segs_b = cp_b.get("segments") or {}
    table: Dict[str, Dict[str, float]] = {}
    regressed: List[Dict[str, Any]] = []
    for seg in sorted(set(segs_a) | set(segs_b)):
        a = float(segs_a.get(seg, 0.0))
        b = float(segs_b.get(seg, 0.0))
        delta = b - a
        table[seg] = {
            "before_s": round(a, 6),
            "after_s": round(b, 6),
            "delta_s": round(delta, 6),
        }
        if delta > max(DIFF_MIN_REL * a, DIFF_MIN_ABS_S):
            regressed.append({"segment": seg, "delta_s": round(delta, 6)})
    regressed.sort(key=lambda r: -r["delta_s"])
    evidence: List[Dict[str, Any]] = []
    if regressed:
        top = regressed[0]["segment"]
        evidence = [
            e
            for e in cp_b.get("chain") or []
            if e.get("segment") == top
        ]
    return {
        "before": {
            "path": before.get("path"),
            "kind": before.get("kind"),
            "wall_s": cp_a.get("wall_s"),
            "dominant": cp_a.get("dominant"),
        },
        "after": {
            "path": after.get("path"),
            "kind": after.get("kind"),
            "wall_s": cp_b.get("wall_s"),
            "dominant": cp_b.get("dominant"),
        },
        "segments": table,
        "regressed": regressed,
        "evidence": evidence,
        "dominant_shifted": (
            cp_a.get("dominant") is not None
            and cp_b.get("dominant") is not None
            and cp_a.get("dominant") != cp_b.get("dominant")
        ),
    }


# ---------------------------------------------------------------------------
# diff CLI
# ---------------------------------------------------------------------------


def _looks_like_bench_record(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    if os.path.basename(path).startswith("BENCH") and path.endswith(
        ".json"
    ):
        return True
    try:
        with open(path, "r", encoding="utf-8") as f:
            head = json.load(f)
        return isinstance(head, dict) and "parsed" in head
    except Exception:  # noqa: BLE001 - not a bench record then
        return False


def _load_bench_parsed(path: str) -> Optional[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    parsed = doc.get("parsed") if isinstance(doc, dict) else None
    return parsed if isinstance(parsed, dict) else None


def _load_report(path: str, kind: Optional[str]) -> Optional[Dict[str, Any]]:
    """Newest report dict for one diff operand: a snapshot dir (its
    ``.telemetry.jsonl``), an events file, or a single-report JSON."""
    from .sink import SNAPSHOT_EVENTS_BASENAME, load_events

    if os.path.isdir(path):
        path = os.path.join(path, SNAPSHOT_EVENTS_BASENAME)
    if not os.path.isfile(path):
        return None
    if path.endswith(".jsonl"):
        events = load_events(path)
    else:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            events = [doc] if isinstance(doc, dict) else []
        except ValueError:
            events = load_events(path)
    if kind:
        events = [e for e in events if e.get("kind") == kind]
    else:
        events = [e for e in events if e.get("kind") != "mirror"]
    events = [e for e in events if e.get("critical_path")] or events
    return events[-1] if events else None


def _print_bench_diff(
    rows: List[Dict[str, Any]],
    old_label: str,
    new_label: str,
    old: Dict[str, Any],
    new: Dict[str, Any],
) -> None:
    print(f"bench diff: {old_label} -> {new_label}")
    header = (
        f"  {'leg':<34} {'before':>10} {'after':>10} {'tolerance':>10}"
    )
    print(header)
    print("  " + "-" * (len(header) - 2))
    flagged = {r["leg"] for r in rows}
    for leg, (label, _sign, _floor) in BENCH_LEGS.items():
        a, b = old.get(leg), new.get(leg)
        if a is None and b is None:
            continue
        mark = "  << REGRESSED" if leg in flagged else ""
        fmt = lambda v: "-" if not isinstance(v, (int, float)) else f"{v:.3f}"  # noqa: E731
        print(f"  {label:<34} {fmt(a):>10} {fmt(b):>10}{mark}")
    for v in bench_verdicts(rows):
        print(v.format())


def _print_report_diff(diff: Dict[str, Any]) -> None:
    a, b = diff["before"], diff["after"]
    print(
        f"critical-path diff: {a.get('path')} ({a.get('kind')}, "
        f"wall {a.get('wall_s')}s, dominant {a.get('dominant')})"
    )
    print(
        f"                 -> {b.get('path')} ({b.get('kind')}, "
        f"wall {b.get('wall_s')}s, dominant {b.get('dominant')})"
    )
    header = f"  {'segment':<16} {'before_s':>10} {'after_s':>10} {'delta_s':>10}"
    print(header)
    print("  " + "-" * (len(header) - 2))
    flagged = {r["segment"] for r in diff["regressed"]}
    for seg, row in sorted(
        diff["segments"].items(), key=lambda kv: -kv[1]["after_s"]
    ):
        mark = "  << REGRESSED" if seg in flagged else ""
        print(
            f"  {seg:<16} {row['before_s']:>10.3f} "
            f"{row['after_s']:>10.3f} {row['delta_s']:>+10.3f}{mark}"
        )
    if diff["dominant_shifted"]:
        print(
            f"dominant segment shifted: {a.get('dominant')} -> "
            f"{b.get('dominant')}"
        )
    if diff["regressed"]:
        top = diff["regressed"][0]
        print(
            f"regressed: {top['segment']} (+{top['delta_s']:.3f}s); "
            f"gating spans:"
        )
        for e in diff["evidence"]:
            blob = f" blob={e['blob']}" if e.get("blob") else ""
            print(
                f"  span {e['span']} gated {e['gated_s']:.3f}s{blob}"
            )
    else:
        print("no segment regressed beyond tolerance")


def diff_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m torchsnapshot_tpu_torch.telemetry diff <A> <B>``: compare
    two steps (snapshot dirs / events files, via their recorded
    ``critical_path``) or two ``BENCH_r*.json`` records (declared
    per-leg tolerances). Incident bundle dirs (telemetry/bundle.py)
    work as operands unchanged — they carry a ``.telemetry.jsonl`` —
    so two black boxes diff offline with both original roots gone.
    Exit 0 = no regression, 2 = regression, 1 = operands unusable."""
    import argparse

    p = argparse.ArgumentParser(
        prog="torchsnapshot_tpu_torch.telemetry diff",
        description=(
            "Differential critical-path / bench-record analysis: which "
            "path segment (or signal-of-record leg) regressed between "
            "two recorded operations, with span evidence citations."
        ),
    )
    p.add_argument(
        "before",
        help="snapshot dir, events file, incident bundle dir, or "
        "BENCH_r*.json",
    )
    p.add_argument("after", help="same (compared against `before`)")
    p.add_argument(
        "--kind",
        default=None,
        help="report kind to compare (default: newest non-mirror record)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable diff instead of the text report",
    )
    args = p.parse_args(list(argv) if argv is not None else None)

    bench_a = _looks_like_bench_record(args.before)
    bench_b = _looks_like_bench_record(args.after)
    if bench_a and bench_b:
        old = _load_bench_parsed(args.before)
        new = _load_bench_parsed(args.after)
        if old is None or new is None:
            print("diff: bench record(s) carry no parsed block")
            return 1
        rows = bench_regressions(
            [
                (os.path.basename(args.before), old),
                (os.path.basename(args.after), new),
            ]
        )
        if args.json:
            print(json.dumps({"bench_regressions": rows}, indent=1))
        else:
            _print_bench_diff(
                rows,
                os.path.basename(args.before),
                os.path.basename(args.after),
                old,
                new,
            )
        return 2 if rows else 0

    before = _load_report(args.before, args.kind)
    after = _load_report(args.after, args.kind)
    if before is None or after is None:
        missing = args.before if before is None else args.after
        print(
            f"diff: no report found for {missing!r} (need a snapshot "
            f"dir with .telemetry.jsonl, an events file, or a pair of "
            f"BENCH_r*.json records; record with "
            f"TORCHSNAPSHOT_TPU_TELEMETRY=1)"
        )
        return 1
    if not (before.get("critical_path") and after.get("critical_path")):
        print(
            "diff: report(s) carry no critical_path field (recorded "
            "by a pre-critpath build, or the trace ring overran the "
            "op window)"
        )
        return 1
    diff = diff_reports(before, after)
    if args.json:
        print(json.dumps(diff, indent=1))
    else:
        _print_report_diff(diff)
    return 2 if diff["regressed"] else 0
