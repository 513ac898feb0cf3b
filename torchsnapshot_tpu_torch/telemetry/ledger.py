"""The run ledger: crash-safe, append-only record of a training run's
checkpoint economy.

Copy of ``torchsnapshot_tpu/telemetry/ledger.py``, in the same file and
event schema: a root that both packages' managers extended holds one
ledger, and a run id opened by one package resumes in the other. The
owned-root registry is per package: each registers the roots its own
managers opened.

Every telemetry surface before this one is per-op — one SnapshotReport,
trace, and heartbeat per take or restore — so nobody could answer the
question a training fleet actually asks: *what fraction of this run's
wall time did checkpointing eat, what did the last preemption cost in
lost work, and what does retention cost in bytes per step?* The ledger
is the substrate for that answer: one ``<root>/.ledger.jsonl`` per
manager root, to which the manager, the snapshot take/restore
envelopes, the tiered mirror, the preemption saver, and retention GC
post small typed events (the ``EVENT_`` constants in
``telemetry/names.py`` — snaplint's ``ledger-event-ids`` rule keeps
literal event strings out of post sites). ``telemetry/goodput.py``
folds the records into a run-level attribution; ``python -m
torchsnapshot_tpu_torch.telemetry.goodput <root>`` renders it.

Properties:

- **Crash-safe**: records append as ONE short write each; a kill
  mid-append leaves at most one torn final line, which
  :func:`load_ledger` skips. Trimming (the rolling bound) rewrites
  atomically (tmp + rename), so a reader never sees a torn document.
- **Resumable**: a restarted manager resumes the previous run id and
  increments the segment counter (:func:`open_run`), so one training
  run's identity survives preemptions and restarts.
- **Rank-0-only**: only the process whose manager opened the run (rank
  0) ever appends — post sites in rank-agnostic layers (snapshot
  envelopes, the mirror) route through :func:`post_event_for_snapshot`,
  which posts only for roots *this process* opened. A 2-process job
  writes exactly one stream of records.
- **Bounded**: the newest ``TORCHSNAPSHOT_TPU_LEDGER_MAX_RECORDS``
  records are kept (default 4096); the newest run-start always
  survives a trim so the active run's attribution keeps its anchor.
- **Best-effort**: a ledger write must never fail a checkpoint;
  failures log a warning and the operation proceeds.

Knobs: ``TORCHSNAPSHOT_TPU_LEDGER`` (default on; ``0`` disables) and
``TORCHSNAPSHOT_TPU_LEDGER_MAX_RECORDS``. The test conftest pins the
ledger off so tier-1 manager dirs stay deterministic. See
docs/goodput.md for the event schema and the attribution model.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Set

from .. import knobs
from . import names

logger: logging.Logger = logging.getLogger(__name__)

LEDGER_BASENAME = ".ledger.jsonl"

# Appends are short single writes; the bound is enforced by a trim pass
# every this-many appends per path (cheap against reading the whole
# file back on every post, tight enough that the file can only overrun
# the bound by a sliver).
TRIM_CHECK_EVERY = 64

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")

# Serializes appends/trims within the process (async-save commit
# threads, the mirror worker, and the training thread all post).
# Re-entrant: the trim/prune paths load the ledger while holding it.
_LOCK = threading.RLock()
# Per-ledger-path append counter since the last trim check.
_APPENDS_SINCE_TRIM: Dict[str, int] = {}
# Parsed-record cache, path -> (file size, records). This process is
# the ledger's sole writer (the owned-root gate), so the per-step
# goodput refresh must not re-read and re-parse up to max-records
# lines of JSON on every save: appends extend the cached list in
# place, rewrites (trim/prune) replace it, and an out-of-band size
# mismatch (another writer, a test wiping the file) invalidates it.
_READ_CACHE: Dict[str, tuple] = {}
# Ledger paths THIS process opened a run for (rank 0's manager):
# the rank-0-only gate every snapshot-path post site routes through.
_OWNED: Set[str] = set()


def ledger_path_for(root: str) -> Optional[str]:
    """Where a manager root's run ledger lives, or None for object-store
    roots (no local append primitive — the ledger is a local operator
    aid, not a durability artifact; tiered roots use their fast tier,
    like the step history)."""
    from .sink import local_fs_root

    local = local_fs_root(root)
    if local is None:
        return None
    return os.path.join(local, LEDGER_BASENAME)


def step_from_path(snapshot_path: str) -> Optional[int]:
    """The manager step number a snapshot path encodes (its basename is
    ``step_<n>`` under a manager root), or None for free-form paths."""
    base = os.path.basename(snapshot_path.rstrip("/"))
    m = _STEP_DIR_RE.match(base)
    return int(m.group(1)) if m else None


def _ledger_path_for_snapshot(snapshot_path: str) -> Optional[str]:
    """Resolve a snapshot path to the ledger of the manager root that
    owns it: a ``step_<n>`` dir posts to its parent's ledger; anything
    else to its own directory's (covers diagnosing a root directly)."""
    from .sink import local_fs_root

    local = local_fs_root(snapshot_path)
    if local is None:
        return None
    local = local.rstrip("/") or local
    if _STEP_DIR_RE.match(os.path.basename(local)):
        local = os.path.dirname(local)
    if not local:
        return None
    return os.path.join(local, LEDGER_BASENAME)


def find_ledger_for(path: str) -> Optional[str]:
    """Read-side resolution (doctor, fsck, CLI): the existing ledger
    file a snapshot path or manager root maps to, or None. Probes the
    path's own directory first, then the step-dir parent."""
    from .sink import local_fs_root

    local = local_fs_root(path)
    if local is None:
        if os.path.isfile(path) and path.endswith(LEDGER_BASENAME):
            return path
        return None
    own = os.path.join(local, LEDGER_BASENAME)
    if os.path.exists(own):
        return own
    resolved = _ledger_path_for_snapshot(path)
    if resolved is not None and os.path.exists(resolved):
        return resolved
    return None


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _append(path: str, record: Dict[str, Any]) -> Optional[str]:
    line = json.dumps(record, sort_keys=True) + "\n"
    with _LOCK:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # One write of one line in append mode: a kill mid-append
        # leaves at most one torn final line (skipped on load), never
        # an unparseable file. A previous crash's torn tail has no
        # newline — heal it with a leading one so the torn fragment
        # stays its own (skipped) line instead of corrupting ours.
        needs_newline = False
        size_before = 0
        try:
            size_before = os.path.getsize(path)
            if size_before > 0:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    needs_newline = rf.read(1) != b"\n"
        except OSError:
            pass  # fresh file
        with open(path, "a", encoding="utf-8") as f:
            f.write(("\n" if needs_newline else "") + line)
        cached = _READ_CACHE.get(path)
        if cached is not None:
            if cached[0] == size_before:
                cached[1].append(record)
                _READ_CACHE[path] = (
                    size_before
                    + len(line.encode("utf-8"))
                    + (1 if needs_newline else 0),
                    cached[1],
                )
            else:
                # The file moved under us (external rewrite): reparse
                # on the next load rather than serve stale records.
                _READ_CACHE.pop(path, None)
        n = _APPENDS_SINCE_TRIM.get(path, 0) + 1
        if n >= TRIM_CHECK_EVERY:
            _trim_locked(path, knobs.get_ledger_max_records())
            n = 0
        _APPENDS_SINCE_TRIM[path] = n
    return path


def _rewrite_locked(path: str, records: List[Dict[str, Any]]) -> None:
    """Atomic full rewrite (caller holds _LOCK), keeping the read
    cache coherent with what just landed on disk."""
    from .sink import atomic_write_text

    atomic_write_text(
        path, "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    )
    try:
        _READ_CACHE[path] = (os.path.getsize(path), list(records))
    except OSError:
        _READ_CACHE.pop(path, None)


def _trim_locked(path: str, max_records: int) -> None:
    """Enforce the rolling bound (caller holds _LOCK): keep the newest
    ``max_records``, re-anchoring the newest run-start at the front if
    the cut would drop it — goodput attribution needs the active
    segment's start to exist."""
    records = load_ledger(path)
    if len(records) <= max_records:
        return
    kept = records[-max_records:]
    if not any(r.get("event") == names.EVENT_RUN_START for r in kept):
        starts = [
            r
            for r in records[: -max_records or None]
            if r.get("event") == names.EVENT_RUN_START
        ]
        if starts:
            kept = [starts[-1], *kept[1:]]
    _rewrite_locked(path, kept)


def post_event(
    root: str, event: str, create: bool = False, **fields: Any
) -> Optional[str]:
    """Append one typed event to ``root``'s ledger; returns the ledger
    path, or None when disabled / non-local / (without ``create``) no
    ledger exists yet. ``event`` must be a ``names.EVENT_*`` constant
    (lint-enforced). ``unix_ts`` is stamped unless the caller provides
    one (injection tests, backfills). Best-effort: never raises."""
    if not knobs.is_ledger_enabled():
        return None
    path = ledger_path_for(root)
    if path is None:
        return None
    if not create and not os.path.exists(path):
        # Only roots a manager opened a run for carry a ledger; posting
        # elsewhere would scatter orphan files next to ad-hoc snapshots.
        return None
    record = {"event": event, "unix_ts": round(time.time(), 6), **fields}
    try:
        return _append(path, record)
    except Exception as e:  # noqa: BLE001 - the ledger must never fail an op
        logger.warning("ledger: could not append %r to %r: %r", event, path, e)
        return None


def post_event_for_snapshot(
    snapshot_path: str, event: str, **fields: Any
) -> Optional[str]:
    """Post an event about a snapshot path to its manager root's ledger
    — ONLY when this process opened the run (the rank-0-only gate for
    rank-agnostic layers: snapshot envelopes, the mirror). The step
    number is derived from the path and stamped unless provided."""
    if not knobs.is_ledger_enabled():
        return None
    path = _ledger_path_for_snapshot(snapshot_path)
    if path is None or os.path.abspath(path) not in _OWNED:
        return None
    step = step_from_path(snapshot_path)
    if step is not None:
        fields.setdefault("step", step)
    record = {"event": event, "unix_ts": round(time.time(), 6), **fields}
    try:
        return _append(path, record)
    except Exception as e:  # noqa: BLE001
        logger.warning("ledger: could not append %r to %r: %r", event, path, e)
        return None


def open_run(root: str, world_size: int = 1) -> Optional[str]:
    """Open (or resume) a run at ``root``: reuse the newest recorded
    run id with an incremented segment counter, or mint a fresh id for
    a first-ever run; post the run-start event and register this
    process as the root's ledger owner (subsequent snapshot-path posts
    from this process land; other ranks' never do). Rank-0 callers
    only — the manager gates. Returns the run id, or None when the
    ledger is disabled / the root is non-local. Best-effort."""
    if not knobs.is_ledger_enabled():
        return None
    path = ledger_path_for(root)
    if path is None:
        return None
    try:
        run_id: Optional[str] = None
        segment = 1
        for rec in load_ledger(path):
            if rec.get("event") == names.EVENT_RUN_START:
                run_id = rec.get("run_id")
                segment = int(rec.get("segment", 0)) + 1
        if run_id is None:
            run_id = uuid.uuid4().hex[:12]
            segment = 1
        post_event(
            root,
            names.EVENT_RUN_START,
            create=True,
            run_id=run_id,
            segment=segment,
            world_size=world_size,
        )
        _OWNED.add(os.path.abspath(path))
        return run_id
    except Exception as e:  # noqa: BLE001
        logger.warning("ledger: could not open run at %r: %r", root, e)
        return None


def reset_owned_roots() -> None:
    """Drop ownership registrations and the read cache (tests
    simulating a fresh process)."""
    with _LOCK:
        _OWNED.clear()
        _READ_CACHE.clear()


def owned_roots() -> List[str]:
    """Ledger paths this process opened runs for (abspaths). Rootless
    layers needing a capture target — the stall watchdog's incident
    bundle — resolve one here: owning the ledger is what makes this
    process the root's rank 0."""
    with _LOCK:
        return sorted(_OWNED)


def prune_steps(root: str, steps: Iterable[int]) -> Optional[str]:
    """Drop deleted steps' ``step-committed`` storage records (atomic
    rewrite) so the ledger's storage-cost view tracks what retention
    actually keeps. Time-attribution events (visible-stall, restores,
    drains) survive — that wall time was spent regardless of whether
    the bytes still exist. Called by the manager's GC; best-effort."""
    if not knobs.is_ledger_enabled():
        return None
    path = ledger_path_for(root)
    if path is None or not os.path.exists(path):
        return None
    dropped = {int(s) for s in steps}
    try:
        with _LOCK:
            records = load_ledger(path)
            kept = [
                r
                for r in records
                if not (
                    r.get("event") == names.EVENT_STEP_COMMITTED
                    and r.get("step") in dropped
                )
            ]
            if len(kept) == len(records):
                return path
            _rewrite_locked(path, kept)
        return path
    except Exception as e:  # noqa: BLE001 - GC must not fail a save
        logger.warning("ledger: could not prune steps at %r: %r", path, e)
        return None


# ---------------------------------------------------------------------------
# Typed post helpers (the event-shaping lives here, not at call sites)
# ---------------------------------------------------------------------------


def post_op_event(
    kind: str,
    path: str,
    report: Any,
    world_tier_split: Optional[Dict[str, int]] = None,
) -> None:
    """Ledger events for one completed snapshot operation, shaped from
    its SnapshotReport: takes post their training-visible stall (the
    whole wall for sync takes, return-to-caller for async ones) plus
    the overlapped background drain; restores post the recovery time
    served — with a ``tier`` field naming which tier of the peer RAM ->
    fast -> durable ladder dominated, and the full ``tier_split`` byte
    map when the restore ran the ladder (``world_tier_split``, summed
    across ranks by the report gather, wins over the rank-local split).
    Routed through the owned-root gate (rank 0 only)."""
    phases = report.phases or {}
    wall = max((float(v) for v in phases.values()), default=0.0)
    if kind in ("take", "async_take"):
        visible = (
            float(report.visible_s)
            if report.visible_s is not None
            else wall
        )
        post_event_for_snapshot(
            path,
            names.EVENT_VISIBLE_STALL,
            kind=kind,
            visible_s=round(visible, 6),
            wall_s=round(wall, 6),
            nbytes=int(report.bytes_moved),
        )
        if kind == "async_take" and report.staged_s is not None:
            staged = float(report.staged_s)
            post_event_for_snapshot(
                path,
                names.EVENT_STAGED_DRAIN,
                staged_s=round(staged, 6),
                drain_s=round(max(0.0, staged - visible), 6),
                nbytes=int(report.bytes_moved),
            )
    elif kind in ("restore", "async_restore"):
        fields: Dict[str, Any] = {
            "kind": kind,
            "restore_s": round(wall, 6),
            "nbytes": int(report.bytes_moved),
        }
        tier_split = world_tier_split or getattr(
            report, "tier_split", None
        )
        if tier_split:
            fields["tier_split"] = {
                k: int(v) for k, v in tier_split.items()
            }
            fields["tier"] = max(tier_split, key=lambda t: tier_split[t])
        peer = getattr(report, "peer", None) or {}
        if peer:
            fields["peer_failures"] = int(peer.get("failures", 0))
        post_event_for_snapshot(
            path, names.EVENT_RESTORE_SERVED, **fields
        )


def post_mirror_settled(
    fast_url: str,
    lag_s: float,
    nbytes: int,
    blobs: int,
    error: Optional[BaseException] = None,
) -> None:
    """One tiered mirror job settled: durability lag and bytes moved,
    posted to the manager root that owns the fast step dir (owned-root
    gate — co-hosted non-leader ranks' mirrors never post)."""
    post_event_for_snapshot(
        fast_url,
        names.EVENT_MIRROR_SETTLED,
        lag_s=round(float(lag_s), 3),
        nbytes=int(nbytes),
        blobs=int(blobs),
        error=repr(error) if error is not None else None,
    )


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def load_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a ledger file, oldest first; [] when absent. A torn final
    line (kill mid-append) or corrupt line is skipped. Served from the
    in-process cache when this process's own appends are the only
    thing that changed the file (size-validated), so the per-step
    goodput refresh costs a list copy, not a reparse."""
    if not os.path.exists(path):
        return []
    try:
        size = os.path.getsize(path)
    except OSError:
        size = -1
    with _LOCK:
        cached = _READ_CACHE.get(path)
        if cached is not None and size >= 0 and cached[0] == size:
            return list(cached[1])
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                logger.warning("ledger: skipping corrupt record line")
                continue
            if isinstance(rec, dict):
                records.append(rec)
    if size >= 0:
        with _LOCK:
            # Only when the file still matches what we parsed — a
            # concurrent append invalidates rather than caches a
            # half-view.
            try:
                if os.path.getsize(path) == size:
                    _READ_CACHE[path] = (size, list(records))
            except OSError:
                pass
    return records


def describe(records: List[Dict[str, Any]]) -> List[str]:
    """Human-readable summary lines for ``fsck --stats``: event counts,
    run/segment structure with spans, and interrupted (unclosed)
    segments — a run whose segment was followed by another run-start,
    or whose trail ends at a preemption notice, never settled cleanly."""
    if not records:
        return ["empty ledger"]
    counts: Dict[str, int] = {}
    for r in records:
        counts[str(r.get("event", "?"))] = (
            counts.get(str(r.get("event", "?")), 0) + 1
        )
    lines = [
        f"{len(records)} event(s): "
        + ", ".join(f"{k}={counts[k]}" for k in sorted(counts))
    ]
    from .goodput import analyze

    analysis = analyze(records)
    for run in analysis["runs"]:
        interrupted = [s for s in run["segments"] if s["interrupted"]]
        lines.append(
            f"run {run['run_id']}: {len(run['segments'])} segment(s), "
            f"span {run['wall_s']:.1f}s, "
            f"{run['steps_committed']} step(s) committed, "
            f"{len(interrupted)} interrupted"
        )
        for seg in interrupted:
            what = (
                f"preempted at step {seg['preemption_step']}"
                if seg.get("preemption_step") is not None
                else "ended without settling (crash or kill)"
            )
            lines.append(
                f"  segment {seg['segment']}: {what}; "
                f"{seg['lost_work_s']:.1f}s of work after the last "
                f"committed step was lost"
            )
    last = analysis["runs"][-1] if analysis["runs"] else None
    if last is not None and last["segments"]:
        tail = last["segments"][-1]
        if not tail["interrupted"]:
            lines.append(
                f"last segment open or clean (segment "
                f"{tail['segment']}, last event "
                f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(tail['end_ts']))})"
            )
    return lines
