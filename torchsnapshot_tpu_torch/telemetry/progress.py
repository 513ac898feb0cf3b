"""Live per-operation progress heartbeats.

Copy of ``torchsnapshot_tpu/telemetry/progress.py``, in the same file
names and schema: either package's ``load_progress_file`` reads the
other's heartbeats.

PRs 2–3 made a *finished* checkpoint explainable (SnapshotReport,
flight-recorder traces); nothing showed a take *while it runs*. This
module publishes each live operation's state two ways:

- **In-memory, always on**: :func:`current_progress` returns a snapshot
  of every active operation's counters — the watchdog attaches it to
  stall reports ("how far did the op get"), and in-process pollers
  (notebooks, sidecar threads) read it for free.
- **Heartbeat file, knob-gated**: every
  ``TORCHSNAPSHOT_TPU_PROGRESS_SECONDS`` (default 1 s; <= 0 disables)
  the tracker atomically rewrites ``<snapshot>/.progress-rank<r>.json``
  (or, for object-store snapshots,
  ``TORCHSNAPSHOT_TPU_PROGRESS_DIR/progress-<digest>-<kind>-rank<r>.json``
  — digest = first 8 hex chars of sha1(snapshot path), so ops on
  different snapshots sharing the dir never clobber each other) so an
  *external* poller — a babysitter script, another host — can see a
  stuck rank before the in-process watchdog fires. Atomic tmp+rename: a concurrent reader never sees a
  torn document, and ``written_bytes`` is monotonically non-decreasing
  across reads of one operation.

Heartbeat schema (all fields always present; see docs/observability.md):

``kind, path, rank, phase, planned_items, planned_bytes, staged_bytes,
written_bytes, items_pending, items_staging, items_inflight,
items_done, budget_wait_s, budget_wait_frac, throughput_mb_s, eta_s,
elapsed_s, updated_unix_ts, terminal, error, mirror, pid,
schema_version``

``terminal`` is null while the op is live, ``"done"`` / ``"failed"``
once it settles. A successful op *removes* its heartbeat file; a failed
op leaves a terminal document behind; a crashed op leaves a non-terminal
one — which ``fsck --stats`` lists and the checkpoint doctor flags as
``interrupted-take`` evidence.

The scheduler's pipelines feed the tracker from their live counters
(``_PipelineStats`` + ``MemoryBudget``); a restore's several read
pipelines fold into one tracker via ``begin_pipeline`` offsets so the
published totals only ever grow.
"""

from __future__ import annotations

import collections
import glob
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .. import knobs

logger: logging.Logger = logging.getLogger(__name__)

PROGRESS_SCHEMA_VERSION = 1
SNAPSHOT_PROGRESS_PREFIX = ".progress-rank"

# Rolling throughput window: ETA is computed over the last N published
# (time, written_bytes) points, so it tracks the *current* rate, not
# the lifetime average a long budget wait would poison.
_RATE_WINDOW_POINTS = 16


def _path_digest(snapshot_path: Optional[str]) -> str:
    import hashlib

    return hashlib.sha1((snapshot_path or "").encode("utf-8")).hexdigest()[:8]


def progress_path_for(
    snapshot_path: Optional[str], rank: int, kind: str = ""
) -> Optional[str]:
    """Where this rank's heartbeat file goes, or None when the file
    heartbeat is disabled (interval knob <= 0) or the snapshot path has
    no local root and no progress dir is configured. Resolution order
    matches the report/trace sinks: explicit dir knob first, then the
    snapshot-adjacent file for local paths.

    The shared-dir form is disambiguated by a snapshot-path digest and
    the op kind: a dir serving several snapshots (or a take of step N+1
    overlapping step N's async commit) must never have ops clobbering —
    or, worse, ``finish()``-deleting — each other's heartbeats. The
    snapshot-adjacent form needs neither: the directory IS the snapshot,
    and one snapshot never runs two same-rank ops concurrently."""
    if knobs.get_progress_interval_seconds() <= 0:
        return None
    progress_dir = knobs.get_progress_dir()
    if progress_dir:
        disambig = f"{_path_digest(snapshot_path)}-{kind}-" if kind else ""
        return os.path.join(
            progress_dir, f"progress-{disambig}rank{rank}.json"
        )
    from .sink import local_fs_root

    root = local_fs_root(snapshot_path)
    if root is None:
        return None
    return os.path.join(root, f"{SNAPSHOT_PROGRESS_PREFIX}{rank}.json")


def find_progress_files(snapshot_path: str) -> List[str]:
    """Heartbeat files recorded for one snapshot (crash leftovers
    included): the snapshot-adjacent ``.progress-rank*.json`` plus, when
    a progress dir is configured, its files for THIS snapshot — matched
    by the path digest every dir-mode filename embeds, so a shared dir
    serving many snapshots is filtered by one glob, no per-file parse,
    and snapshot A's diagnosis never cites snapshot B's heartbeat."""
    out: List[str] = []
    from .sink import local_fs_root

    root = local_fs_root(snapshot_path)
    if root is not None:
        out.extend(
            sorted(
                glob.glob(
                    os.path.join(root, f"{SNAPSHOT_PROGRESS_PREFIX}*.json")
                )
            )
        )
    progress_dir = knobs.get_progress_dir()
    if progress_dir:
        out.extend(
            sorted(
                glob.glob(
                    os.path.join(
                        progress_dir,
                        f"progress-{_path_digest(snapshot_path)}-*.json",
                    )
                )
            )
        )
    return out


def remove_dir_heartbeats(snapshot_path: str) -> None:
    """Drop the shared progress dir's heartbeats for one snapshot —
    the manager-GC hook. The snapshot-adjacent heartbeats die with the
    step directory, but dir-mode leftovers (a crashed op's) have no
    other reaper and would otherwise accumulate across job restarts,
    each a standing interrupted-take verdict for a snapshot that no
    longer exists."""
    progress_dir = knobs.get_progress_dir()
    if not progress_dir:
        return
    digest = _path_digest(snapshot_path)
    for leftover in glob.glob(
        os.path.join(progress_dir, f"progress-{digest}-*.json")
    ):
        try:
            os.remove(leftover)
        except OSError:
            pass


def load_progress_file(path: str) -> Optional[Dict[str, Any]]:
    """Parse one heartbeat file; None when unreadable (a reader must
    never crash on a file being replaced under it)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class ProgressTracker:
    """One live checkpoint operation's progress state.

    Thread-safe: the scheduler's event-loop thread updates counters,
    the watchdog/current_progress read from other threads, and an
    async take's drain updates from the background commit thread.
    File publishing is interval-gated (``tick``); the in-memory state
    updates on every call regardless.
    """

    def __init__(self, kind: str, path: str, rank: int) -> None:
        self.kind = kind
        self.path = path
        self.rank = rank
        self._lock = threading.Lock()
        self._begin = time.monotonic()
        self._phase = "starting"
        self._terminal: Optional[str] = None
        self._error: Optional[str] = None
        # Totals folded in from pipelines that already finished; the
        # current pipeline's live counters add on top (a restore runs
        # one read pipeline per stateful).
        self._base = {
            "planned_items": 0,
            "planned_bytes": 0,
            "staged_bytes": 0,
            "written_bytes": 0,
            "items_done": 0,
            "budget_wait_s": 0.0,
        }
        self._cur = dict(self._base)
        self._cur_live = {"pending": 0, "staging": 0, "inflight": 0}
        self._rate_window: "collections.deque" = collections.deque(
            maxlen=_RATE_WINDOW_POINTS
        )
        self._file = progress_path_for(path, rank, kind=kind)
        self._min_interval = knobs.get_progress_interval_seconds()
        self._last_publish = 0.0
        # Serializes file publishes against each other AND against
        # finish(): the pipeline thread and the background refresher
        # share one pid-suffixed tmp file, so concurrent writers would
        # tear it — and a refresher publish racing finish()'s removal
        # must not resurrect the just-deleted heartbeat.
        self._publish_lock = threading.Lock()
        _register(self)
        # First heartbeat immediately: an external poller learns the op
        # exists (and its plan, once known) without waiting an interval.
        self._publish()

    # -- pipeline feed ---------------------------------------------------

    def begin_pipeline(
        self, items: int, planned_bytes: int, phase: Optional[str] = None
    ) -> None:
        """A new scheduler pipeline joins this op: fold the previous
        pipeline's final counters into the base and add the new plan."""
        with self._lock:
            for k in self._base:
                self._base[k] = self._cur[k]
            self._base["planned_items"] += items
            self._base["planned_bytes"] += planned_bytes
            self._cur = dict(self._base)
            self._cur_live = {"pending": items, "staging": 0, "inflight": 0}
            if phase is not None:
                self._phase = phase
        self._publish()

    def update_pipeline(
        self,
        pending: int,
        staging: int,
        inflight: int,
        done: int,
        staged_bytes: int,
        done_bytes: int,
        budget_wait_s: float,
    ) -> None:
        """Absolute counters from the *current* pipeline's stats; the
        published totals are base + these. Cheap (a lock and a few dict
        stores); the file write underneath is interval-gated."""
        with self._lock:
            self._cur["items_done"] = self._base["items_done"] + done
            self._cur["staged_bytes"] = self._base["staged_bytes"] + staged_bytes
            self._cur["written_bytes"] = (
                self._base["written_bytes"] + done_bytes
            )
            self._cur["budget_wait_s"] = (
                self._base["budget_wait_s"] + budget_wait_s
            )
            self._cur_live = {
                "pending": pending,
                "staging": staging,
                "inflight": inflight,
            }
            # The ETA window advances only when BYTES advanced: reads
            # must not shrink the window (rate-as-a-function-of-polling)
            # and a staging-only burst must not evict every
            # write-progress point and flap the published rate to zero
            # mid-drain.
            if (
                not self._rate_window
                or self._rate_window[-1][1] != self._cur["written_bytes"]
            ):
                self._rate_window.append(
                    (time.monotonic(), self._cur["written_bytes"])
                )
        self.tick()

    def set_phase(self, phase: str) -> None:
        with self._lock:
            self._phase = phase
        self._publish()

    # -- publishing ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The heartbeat document (also the current_progress() row).
        Read-only: polling must not perturb the rate window."""
        with self._lock:
            now = time.monotonic()
            written = self._cur["written_bytes"]
            rate_bps = 0.0
            if len(self._rate_window) >= 2:
                (t0, b0), (t1, b1) = self._rate_window[0], self._rate_window[-1]
                if t1 - t0 > 1e-6 and b1 > b0:
                    rate_bps = (b1 - b0) / (t1 - t0)
            remaining = max(0, self._cur["planned_bytes"] - written)
            eta_s = round(remaining / rate_bps, 1) if rate_bps > 0 else None
            elapsed = now - self._begin
            wait = self._cur["budget_wait_s"]
            doc = {
                "schema_version": PROGRESS_SCHEMA_VERSION,
                "kind": self.kind,
                "path": self.path,
                "rank": self.rank,
                "pid": os.getpid(),
                "phase": self._phase,
                "planned_items": self._cur["planned_items"],
                "planned_bytes": self._cur["planned_bytes"],
                "staged_bytes": self._cur["staged_bytes"],
                "written_bytes": written,
                "items_pending": self._cur_live["pending"],
                "items_staging": self._cur_live["staging"],
                "items_inflight": self._cur_live["inflight"],
                "items_done": self._cur["items_done"],
                "budget_wait_s": round(wait, 6),
                "budget_wait_frac": (
                    round(wait / elapsed, 4) if elapsed > 1e-6 else 0.0
                ),
                "throughput_mb_s": round(rate_bps / 1024**2, 3),
                "eta_s": eta_s,
                "elapsed_s": round(elapsed, 3),
                "updated_unix_ts": time.time(),
                # The writer's own heartbeat cadence: readers in OTHER
                # processes (the doctor's staleness check) must judge
                # freshness against the interval the writer used, not
                # their own knob value.
                "interval_s": self._min_interval,
                "terminal": self._terminal,
                "error": self._error,
            }
        doc["mirror"] = self._mirror_depth()
        return doc

    def _mirror_depth(self) -> Optional[Dict[str, Any]]:
        """The process mirror's queue depth for tiered paths (part of
        the heartbeat: durability backlog is live state too)."""
        try:
            from ..tiered.mirror import mirror_state_for_path

            m = mirror_state_for_path(self.path)
            if m is None:
                return None
            return {
                "blobs_pending": m["blobs_pending"],
                "snapshots_pending": m["snapshots_pending"],
                "upload_lag_s": m["upload_lag_s"],
            }
        except Exception:  # noqa: BLE001 - heartbeat must not fail the op
            return None

    def tick(self) -> None:
        """Interval-gated heartbeat rewrite; no-op when the file sink is
        disabled, the op settled, or the interval hasn't lapsed."""
        if self._file is None or self._terminal is not None:
            return
        now = time.monotonic()
        if now - self._last_publish < self._min_interval:
            return
        self._publish()

    def _publish(self, final: bool = False) -> None:
        if self._file is None:
            return
        with self._publish_lock:
            # Re-checked under the publish lock: a refresher tick that
            # lost the race with finish() must not rewrite (resurrect)
            # a heartbeat the settled op already removed.
            if self._terminal is not None and not final:
                return
            self._last_publish = time.monotonic()
            try:
                from .sink import atomic_write_text

                # Atomic replace: a concurrent reader never observes a
                # torn document.
                atomic_write_text(
                    self._file,
                    json.dumps(self.snapshot(), separators=(",", ":")),
                )
            except Exception as e:  # noqa: BLE001 - heartbeat must not
                # fail the op
                logger.warning("progress: heartbeat write failed: %r", e)

    def finish(self, error: Optional[BaseException] = None) -> None:
        """Settle the op: unregister from current_progress, and either
        remove the heartbeat file (success — a completed op leaves no
        leftovers) or rewrite it terminal with the error (failure — the
        doctor's evidence that the op *ended*, distinguishing a clean
        failure from a crash's non-terminal leftover)."""
        with self._lock:
            if self._terminal is not None:
                return
            self._terminal = "failed" if error is not None else "done"
            self._error = repr(error) if error is not None else None
        _unregister(self)
        if self._file is None:
            return
        try:
            if error is None:
                # Under the publish lock: an in-flight publish settles
                # first, so the removal is the last word on the file.
                with self._publish_lock:
                    try:
                        os.remove(self._file)
                    except FileNotFoundError:
                        pass
            else:
                self._publish(final=True)
        except Exception as e:  # noqa: BLE001
            logger.warning("progress: heartbeat finish failed: %r", e)


# ---------------------------------------------------------------------------
# Process-wide active-op table + heartbeat refresher
# ---------------------------------------------------------------------------

_ACTIVE: Dict[int, ProgressTracker] = {}
_ACTIVE_LOCK = threading.Lock()
_REFRESHER: Optional[threading.Thread] = None


def _refresh_loop() -> None:
    """Keep heartbeat files fresh while their ops are BLOCKED: pipeline
    events drive publishes normally, but a multi-minute storage write
    (or budget wait) produces none — and an external reader judges
    liveness by ``updated_unix_ts`` against the recorded ``interval_s``,
    so a silent writer looks exactly like a crash. The loop exits (and
    clears its slot under the table lock, so registration can never
    race a dying thread) once no file-publishing tracker remains."""
    global _REFRESHER
    while True:
        with _ACTIVE_LOCK:
            trackers = [t for t in _ACTIVE.values() if t._file is not None]
            if not trackers:
                _REFRESHER = None
                return
        for tracker in trackers:
            try:
                tracker.tick()
            except Exception:  # noqa: BLE001 - refresh must not die
                pass
        time.sleep(max(0.05, min(t._min_interval for t in trackers)))


def _register(tracker: ProgressTracker) -> None:
    global _REFRESHER
    with _ACTIVE_LOCK:
        _ACTIVE[id(tracker)] = tracker
        if tracker._file is not None and _REFRESHER is None:
            _REFRESHER = threading.Thread(
                target=_refresh_loop, name="ts-progress", daemon=True
            )
            _REFRESHER.start()


def _unregister(tracker: ProgressTracker) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE.pop(id(tracker), None)


def track(kind: str, path: str, rank: int) -> ProgressTracker:
    """Start tracking one operation; callers must pair with
    ``finish()`` (success or failure) so current_progress never leaks
    settled ops."""
    return ProgressTracker(kind, path, rank)


def current_progress() -> List[Dict[str, Any]]:
    """Live snapshot of every active operation in this process — the
    always-on in-memory view (no knobs). Ordered by op start."""
    with _ACTIVE_LOCK:
        trackers = list(_ACTIVE.values())
    trackers.sort(key=lambda t: t._begin)
    return [t.snapshot() for t in trackers]


def reset_progress() -> None:
    """Drop the active-op table (tests simulating a fresh process)."""
    with _ACTIVE_LOCK:
        _ACTIVE.clear()
