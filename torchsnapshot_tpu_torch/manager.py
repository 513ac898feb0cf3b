"""CheckpointManager: step-numbered snapshots with retention and
latest-step resume.

Counterpart of ``torchsnapshot_tpu/manager.py``, in the same on-disk
format: either package's manager reads, restores, retains and
incrementally extends a root the other wrote. It packages the loop a
training job runs around ``Snapshot.take``:

    mgr = CheckpointManager(root, keep_last_n=3)
    start = mgr.restore_latest(app_state)          # None on a fresh run
    for step in range(start or 0, total_steps):
        ...
        if step % save_every == 0:
            mgr.save(step, app_state)              # or async_save

Steps live at ``{root}/step_{step:010d}`` and the committed-step list is
a ``.manager_index`` JSON blob (storage plugins have no directory
listing, so the index is the source of truth; a step whose take crashed
before commit never enters it and is invisible to restore). Retention
deletes every blob named by the dropped step's manifest, the commit
marker first, so a half-deleted step can never be mistaken for a valid
one.

Incremental mode (``incremental=True``, or per save): each save records
digests on the card and references the previous committed step's
unchanged chunks instead of rewriting them (incremental.py). The index
also records which origin steps each step's manifest references;
retention *pins* a dropped step whose blobs a retained step still
references (blobs stay, the step leaves the visible list) and deletes it
as soon as no retained step references it.

Across ranks (``pg=``, as ``Snapshot`` takes it), rank 0 reads the index
and broadcasts the step to restore or to diff against, every rank takes
the step, and rank 0 alone writes the index and runs retention, after the
take's commit barrier.

Content-addressed chunk store (``cas/``): a root whose steps reference
``../chunks/<key>`` blobs keeps a refcount journal there. Rank 0 pins a
committing step's chunks before the index write, then, on every commit,
unpins the steps retention deleted and reclaims the chunks no pinned step
names once they are older than the grace window (younger ones wait as
journaled orphans; chunks in no record at all are swept the same way).
Construction reconciles the journal against the index and manifests,
which heals a crash between a chunk write and its pin. GC is driven by
what the root holds, not by the knob: a root with CAS steps keeps
refcounted GC with ``TORCHSNAPSHOT_TPU_CAS`` off.

Tiered roots (``tiered://<fast>|<durable>``): every step commits on the
fast tier and the mirror copies it to the durable tier in the background;
the index itself is mirrored after the step's blobs. ``keep_fast_last_n``
drops the fast copy of retained steps older than the newest N once they
are durable (never before: eviction waits for the durable commit marker),
and records them in the index's ``evicted`` list; they restore through
the per-blob durable fallback. ``wait_durable(step)`` blocks until the
durable tier alone could serve the step (its commit marker, and an index
that names it), bounded by ``TORCHSNAPSHOT_TPU_WAIT_DURABLE_TIMEOUT_SECONDS``;
``resume_mirrors()`` re-enqueues the mirrors a restart interrupted. On a
plain root both are no-ops, as in the JAX manager.

With a multi-rank ``pg`` the manager brings the peer-RAM tier up
(``tiered/peer.py``; ``TORCHSNAPSHOT_TPU_PEER_TIER``, on by default): this
process's cache server starts and its endpoint is published, each commit
pushes the rank's blobs into its ring neighbour's RAM, and a restore reads
through the peer -> fast -> durable ladder. ``keep_peer_last_n`` bounds
the steps a cache keeps; a step that retention drops is evicted from
every peer cache (best-effort, on a background thread).

Checkpoint CDN (``cdn/``): with ``TORCHSNAPSHOT_TPU_CDN=1`` and a
``cdn_topic``, rank 0 announces every committed step's chunk-store keys to
the topic on the coordination store (``cdn_store``, else the ``pg``'s),
after the commit, so that a serving fleet can track the run. A step with
no chunk-store chunks is not announced, and a failed publish is logged and
never fails the save.

Telemetry, as in the JAX manager: rank 0 opens (or resumes) the run in
the root's ``.ledger.jsonl`` at construction, and after each commit posts
``step-committed`` with the step's new and reused bytes, refreshes the
``goodput_*`` gauges and appends the step's report summary to
``.telemetry-history.jsonl``; each manager restore appends its own
summary; GC posts ``gc-reclaimed``, prunes the dropped step's
``step-committed`` record and reaps its shared-dir heartbeats.

Closed-loop control, as in the JAX manager, after each commit (sync and
async saves alike; an async save's runs on its commit thread): rank 0
judges the declared SLOs (``telemetry/slo.py``: the ``slo_burn_rate``
gauges, an edge-triggered ``slo-breach`` ledger event and an incident
bundle per episode), and, with ``TORCHSNAPSHOT_TPU_AUTOTUNE`` on, the
write-path autotuner (``tuner/``) decides the next knob vector on rank 0
and every rank applies it, broadcast over the coordination store. A
failure of either is logged and never fails the save.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import re
import threading
from typing import Any, Dict, List, Optional, Set

from . import knobs, telemetry
from .cas import CASStore, chunk_refs, local_chunks_dir
from .chaos import crashpoint
from .event_loop import run_in_fresh_event_loop
from .integrity import table_path
from .io_types import ReadIO, StoragePlugin, WriteIO
from .manifest import (
    ChunkedArrayEntry,
    Manifest,
    ShardedArrayEntry,
    SnapshotMetadata,
    entry_locations,
)
from .pg_wrapper import PGWrapper
from .snapshot import SNAPSHOT_METADATA_FNAME, PendingRestore, PendingSnapshot, Snapshot
from .stateful import AppState
from .storage_plugin import join_path, split_tiered_url, url_to_storage_plugin
from .telemetry import names as metric_names

logger: logging.Logger = logging.getLogger(__name__)

INDEX_BLOB = ".manager_index"
INDEX_BACKUP_BLOB = ".manager_index.backup"

# Files a step directory may hold that its manifest does not name (the
# JAX package's telemetry event log; per rank: its progress heartbeat and
# peer placement doc, and either package's CAS chunk map). GC removes
# them too, so that retention leaves nothing behind.
_STEP_EVENTS_BLOB = ".telemetry.jsonl"
_RANK_SIDE_BLOBS = (".progress-rank{}.json", ".peer_placement-rank{}.json", "cas/{}")


def _manifest_chunk_refs(manifest: Manifest) -> Dict[str, int]:
    """The chunk-store chunks a manifest references (digest key ->
    nbytes); empty for a legacy-layout snapshot."""
    return chunk_refs(manifest)


def _manifest_digest_map(manifest: Manifest) -> Dict[Any, Any]:
    """Every on-device digest a manifest records, keyed by structural
    position ``(manifest path, offsets, sizes)``, with the bytes it
    covers: comparing two consecutive steps' maps measures how much of the
    state the digests say was unchanged (the ledger's
    ``bytes_digest_unchanged``). Empty for digest-less takes."""
    from .serialization import array_size_bytes

    out: Dict[Any, Any] = {}
    for path, entry in manifest.items():
        if isinstance(entry, (ShardedArrayEntry, ChunkedArrayEntry)):
            pieces = entry.shards if isinstance(entry, ShardedArrayEntry) else entry.chunks
            for piece in pieces:
                if piece.array.digest:
                    out[(path, tuple(piece.offsets), tuple(piece.sizes))] = (
                        piece.array.digest,
                        array_size_bytes(piece.array.shape, piece.array.dtype),
                    )
        else:
            digest = getattr(entry, "digest", None)
            if digest:
                out[(path, (), ())] = (digest, array_size_bytes(entry.shape, entry.dtype))
    return out


def _step_dirname(step: int) -> str:
    return f"step_{step:010d}"


_REF_LOCATION_RE = re.compile(r"^\.\./step_(\d+)/")


def referenced_steps(manifest: Manifest) -> Set[int]:
    """Origin steps an (incremental) snapshot's manifest references.
    Chained refs collapse at take time (incremental.py), so locations
    always name the originating step directly."""
    out: Set[int] = set()
    for entry in manifest.values():
        for location in entry_locations(entry):
            m = _REF_LOCATION_RE.match(location)
            if m:
                out.add(int(m.group(1)))
    return out


async def read_index_full_async(storage: StoragePlugin) -> Dict[str, Any]:
    """Primary slot, falling back to the backup slot: the index is
    rewritten on every save (backup slot first), so a crash mid-write
    must not brick the manager; whichever slot survives is valid, at
    worst one save stale. Returns ``{"steps": [...], "refs": {step:
    [origin steps]}, "pinned": [...], "metrics": {step: score},
    "evicted": [...], "refs_complete": bool}`` (``evicted``: steps whose
    fast-tier copy retention dropped, on a tiered root)."""
    io_failed: List[str] = []
    corrupt: List[str] = []
    for slot in (INDEX_BLOB, INDEX_BACKUP_BLOB):
        read_io = ReadIO(path=slot)
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            continue
        except Exception as e:  # noqa: BLE001
            logger.warning("Could not read index slot %s: %r", slot, e)
            io_failed.append(slot)
            continue
        if read_io.buf is None:
            continue
        try:
            raw = json.loads(bytes(read_io.buf))
            return {
                "steps": sorted(int(s) for s in raw["steps"]),
                "refs": {
                    str(int(k)): sorted(int(v) for v in vs)
                    for k, vs in raw.get("refs", {}).items()
                },
                "pinned": sorted(int(p) for p in raw.get("pinned", [])),
                "metrics": {
                    str(int(k)): float(v) for k, v in raw.get("metrics", {}).items()
                },
                "evicted": sorted(int(s) for s in raw.get("evicted", [])),
                # Indexes with committed steps but without the marker may
                # predate incremental-ref recording: a missing refs entry
                # there means "unknown", and GC must verify before
                # deleting. A fresh (empty) index is trivially complete.
                "refs_complete": bool(raw.get("refs_complete", not raw["steps"])),
            }
        except (ValueError, KeyError, TypeError) as e:
            logger.warning("Index slot %s is corrupt (%r); trying the other slot", slot, e)
            corrupt.append(slot)
    # Both slots absent (a fresh root) is an empty index. One corrupt slot
    # with the other absent is too: writes go backup then primary, so that
    # state can only be a torn first-ever index write. Anything else (I/O
    # errors, or both slots corrupt) must not read as empty: the next index
    # write would orphan every committed step. Fail loudly instead; a
    # transient storage error heals on retry.
    if io_failed or len(corrupt) > 1:
        raise RuntimeError(
            "checkpoint index unreadable "
            f"(io_failed={io_failed!r}, corrupt={corrupt!r}); "
            "refusing to treat the step list as empty"
        )
    return {
        "steps": [], "refs": {}, "pinned": [], "metrics": {}, "evicted": [], "refs_complete": True,
    }


class _PendingManagedSnapshot:
    """Wraps a PendingSnapshot so that the index update and retention run
    once the background commit succeeds."""

    def __init__(
        self,
        manager: "CheckpointManager",
        step: int,
        pending: PendingSnapshot,
        metric: Optional[float] = None,
    ):
        self._manager = manager
        self._step = step
        self._pending = pending
        self._metric = metric
        self._committed = False
        self._commit_lock = threading.Lock()

    def wait(self, phase: str = "committed") -> Optional[Snapshot]:
        """Passes ``phase`` through to :meth:`PendingSnapshot.wait`. The
        index update and retention run only on the ``"committed"`` wait:
        a ``"staged"`` wait observes the end of the device-to-host copies
        without making the step visible to ``restore_latest``."""
        if phase not in ("staged", "committed"):
            raise ValueError(f'phase must be "staged" or "committed", got {phase!r}')
        if phase == "staged":
            self._pending.wait(phase="staged")
            return None
        snapshot = self._pending.wait()  # raises on a failed take: no index entry
        # wait() may be called from more than one place and thread; the
        # step commits exactly once.
        with self._commit_lock:
            if not self._committed:
                self._manager._commit_step(
                    self._step,
                    refs=lambda: referenced_steps(snapshot.metadata.manifest),
                    metric=self._metric,
                    chunk_refs=lambda: _manifest_chunk_refs(snapshot.metadata.manifest),
                )
                telemetry.metrics().counter_inc(metric_names.MANAGER_SAVES_TOTAL)
                self._manager._record_step_history(self._step)
                self._manager._post_step_ledger(self._step, snapshot)
                self._manager._evaluate_slos(self._step)
                self._manager._publish_cdn_step(self._step, snapshot)
                self._manager._autotune_step(self._step)
                self._committed = True
        return snapshot

    def done(self) -> bool:
        return self._pending.done()

    def staged(self) -> bool:
        return self._pending.staged()

    def __getattr__(self, name: str) -> Any:
        # The wrapped handle's phase times (visible_s, staged_s, committed_s).
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._pending, name)


class _ManagedPendingRestore:
    """Wraps a PendingRestore so that the restore's summary lands in the
    manager's step history once the apply succeeds (the async restore's
    report is emitted at ``wait()``). Delegates everything else to the
    wrapped handle."""

    def __init__(self, manager: "CheckpointManager", step: int, pending: PendingRestore):
        self._manager = manager
        self._step = step
        self._pending = pending
        self._recorded = False

    def wait(self) -> None:
        self._pending.wait()
        if not self._recorded:
            self._recorded = True
            self._manager._record_restore_history(self._step)

    def done(self) -> bool:
        return self._pending.done()

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._pending, name)


class CheckpointManager:
    def __init__(
        self,
        root: str,
        keep_last_n: Optional[int] = None,
        pg: Optional[Any] = None,
        incremental: bool = False,
        keep_best_n: Optional[int] = None,
        best_mode: str = "min",
        keep_fast_last_n: Optional[int] = None,
        keep_peer_last_n: Optional[int] = None,
        cdn_topic: Optional[str] = None,
        cdn_store: Optional[Any] = None,
    ) -> None:
        for name, value in (
            ("keep_last_n", keep_last_n),
            ("keep_best_n", keep_best_n),
            ("keep_peer_last_n", keep_peer_last_n),
            ("keep_fast_last_n", keep_fast_last_n),
        ):
            if value is not None and value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        tiered = split_tiered_url(root) is not None
        if keep_fast_last_n is not None and not tiered:
            raise ValueError(
                "keep_fast_last_n requires a tiered:// root (fast-tier "
                "eviction needs a durable tier to fall back to)"
            )
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode}")
        self.root = root
        self.keep_last_n = keep_last_n
        # Tiered roots: retained steps older than the newest
        # keep_fast_last_n lose their fast-tier copy once durable.
        self.keep_fast_last_n = keep_fast_last_n
        # Metric-driven retention: steps saved with a ``metric=`` keep the
        # best ``keep_best_n`` scores (``best_mode``: lower or higher is
        # better) in addition to the newest ``keep_last_n``. With only
        # keep_best_n set, unscored steps are never GC'd (see _retained).
        self.keep_best_n = keep_best_n
        self.best_mode = best_mode
        # Default for save()/async_save(): digest-enabled takes that
        # reference the previous committed step's unchanged chunks.
        self.incremental = incremental
        self._pg_arg = pg
        self._pg = PGWrapper(pg)
        self.keep_peer_last_n = keep_peer_last_n
        # ``Snapshot.restore_telemetry`` of this manager's last sync restore.
        self.restore_telemetry: Optional[Dict[str, Any]] = None
        # The peer tier: start this process's cache server and publish its
        # endpoint. Inert for one process, under the kill switch, or with
        # no store; a failure degrades (the tier is recovery insurance,
        # never a reason a manager cannot be built).
        try:
            from .tiered import peer as peer_tier

            peer_tier.maybe_configure(self._pg, keep_last_n=keep_peer_last_n)
        except Exception as e:  # noqa: BLE001 - the peer tier is best-effort
            logger.warning("peer tier: configure failed: %r", e)
        # The CDN publish side: with the CDN knob on and a topic named,
        # rank 0 announces every committed step's chunk set. ``cdn_store``
        # overrides the pg's store. The publisher is built at the first
        # commit: constructing a manager touches no store.
        self.cdn_topic = cdn_topic
        self._cdn_store_arg = cdn_store
        self._cdn_publisher: Any = None
        # The root's chunk store, resolved on first use (rank 0 only):
        # False unresolved, None for a root with no local filesystem.
        self._cas_store: Any = False
        # The last commit's chunk accounting (chunks and bytes new to the
        # store against those already pinned), from _cas_pin_step.
        self._last_cas_accounting: Optional[Dict[str, Any]] = None
        # The previous committed manifest's digest map, for the ledger's
        # bytes_digest_unchanged.
        self._prev_digest_map: Dict[Any, Any] = {}
        if self._pg.get_rank() == 0:
            try:
                self._reconcile_cas()
            except Exception as e:  # noqa: BLE001 - healing is best-effort
                logger.warning("CAS refcount reconcile failed: %r", e)
        # The write-path autotuner, built at the first commit it tunes
        # after; None while the kill switch is set (no state file, no
        # broadcast).
        self._autotuner: Optional[Any] = None
        # The run ledger: rank 0 opens the run, or resumes the root's run id
        # (whichever package opened it) with the next segment, and becomes
        # the root's only ledger writer. None with the ledger off.
        self._ledger_run_id: Optional[str] = None
        if knobs.is_ledger_enabled() and self._pg.get_rank() == 0:
            from .telemetry import ledger as run_ledger

            self._ledger_run_id = run_ledger.open_run(
                self.root, world_size=self._pg.get_world_size()
            )

    # ------------------------------------------------------------------
    # saving
    # ------------------------------------------------------------------

    def step_path(self, step: int) -> str:
        return join_path(self.root, _step_dirname(step))

    def _incremental_take_kwargs(
        self, incremental: Optional[bool], take_kwargs: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Resolve the per-save incremental setting and, when on, point the
        take at the latest committed step. Rank 0 resolves the base and
        everyone follows: ranks must never diff against different bases."""
        if incremental is None:
            incremental = self.incremental
        if not incremental:
            return take_kwargs
        if "incremental_base" in take_kwargs:
            return {**take_kwargs, "record_digests": True}
        base_step = self.latest_step() if self._pg.get_rank() == 0 else None
        base_step = self._pg.broadcast_object(base_step)
        out = {**take_kwargs, "record_digests": True}
        if base_step is not None:
            out["incremental_base"] = self.step_path(base_step)
        return out

    def save(
        self,
        step: int,
        app_state: AppState,
        incremental: Optional[bool] = None,
        metric: Optional[float] = None,
        **take_kwargs: Any,
    ) -> Snapshot:
        """Synchronous checkpoint of ``step``; updates the index and
        applies retention after the commit. ``incremental`` overrides the
        manager's default for this save; ``metric`` records this step's
        score for ``keep_best_n`` retention and ``best_step()``."""
        self._validate_metric(metric)
        take_kwargs = self._incremental_take_kwargs(incremental, take_kwargs)
        snapshot = Snapshot.take(self.step_path(step), app_state, pg=self._pg_arg, **take_kwargs)
        self._commit_step(
            step, refs=lambda: referenced_steps(snapshot.metadata.manifest), metric=metric,
            chunk_refs=lambda: _manifest_chunk_refs(snapshot.metadata.manifest),
        )
        telemetry.metrics().counter_inc(metric_names.MANAGER_SAVES_TOTAL)
        self._record_step_history(step)
        self._post_step_ledger(step, snapshot)
        self._evaluate_slos(step)
        self._publish_cdn_step(step, snapshot)
        self._autotune_step(step)
        return snapshot

    @staticmethod
    def _validate_metric(metric: Optional[float]) -> None:
        """NaN and inf poison min()/sort comparisons, silently selecting a
        diverged checkpoint as 'best': reject them at the API boundary."""
        if metric is not None and not math.isfinite(float(metric)):
            raise ValueError(
                f"metric must be finite, got {metric!r} (a diverged "
                f"eval score must not enter best-checkpoint retention)"
            )

    def async_save(
        self,
        step: int,
        app_state: AppState,
        incremental: Optional[bool] = None,
        metric: Optional[float] = None,
        **take_kwargs: Any,
    ) -> _PendingManagedSnapshot:
        """Pipelined checkpoint; the index entry and retention pass happen
        in ``wait()`` after the background commit succeeds."""
        self._validate_metric(metric)
        take_kwargs = self._incremental_take_kwargs(incremental, take_kwargs)
        pending = Snapshot.async_take(self.step_path(step), app_state, pg=self._pg_arg, **take_kwargs)
        return _PendingManagedSnapshot(self, step, pending, metric=metric)

    def _record_step_history(self, step: int) -> None:
        """Append the committed step's report summary to the root's
        rolling history (``.telemetry-history.jsonl``). Rank 0 only;
        best-effort; bounded by TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS (<= 0
        disables it)."""
        self._append_history(step, "take", "async_take")

    def _record_restore_history(self, step: int) -> None:
        """Append a served restore's summary to the same history (the
        history's trend baselines are per kind)."""
        self._append_history(step, "restore", "async_restore")

    def _append_history(self, step: int, *kinds: str) -> None:
        if self._pg.get_rank() != 0:
            return
        try:
            from .telemetry import history, last_report

            # Keyed by path: overlapping async saves each find their own
            # step's report.
            report = last_report(*kinds, path=self.step_path(step))
            if report is not None:
                history.append_summary(self.root, history.summarize_report(report, step=step))
        except Exception as e:  # noqa: BLE001 - history is best-effort
            logger.warning("could not record step %d %s history: %r", step, kinds[0], e)

    def _evaluate_slos(self, step: int) -> None:
        """Re-judge the declared SLOs against the run's recorded evidence
        (``telemetry/slo.py``): the burn-rate gauges, one ``slo-breach``
        ledger event per objective episode and one incident bundle per
        evaluation that saw a fresh breach. Rank 0 only, with the ledger
        on; best-effort."""
        if (
            self._pg.get_rank() != 0
            or not knobs.is_slo_enabled()
            or not knobs.is_ledger_enabled()
        ):
            return
        try:
            from .telemetry import slo

            slo.evaluate_step(self.root, step)
        except Exception as e:  # noqa: BLE001 - the SLO engine is best-effort
            logger.warning("could not evaluate SLOs at step %d: %r", step, e)

    def _autotune_step(self, step: int) -> None:
        """One tuning pass after ``step`` committed: rank 0 reads the
        step's report and decides the next knob vector, and every rank
        applies the decision it broadcasts over the store
        (``tuner/autotuner.py``). The kill switch must be set alike on
        every rank. Best-effort: tuning never fails a save."""
        if not knobs.is_autotune_enabled():
            return
        try:
            if self._autotuner is None:
                from .tuner import Autotuner

                self._autotuner = Autotuner(self.root)
            report = None
            if self._pg.get_rank() == 0:
                from .telemetry import last_report

                report = last_report("take", "async_take", path=self.step_path(step))
            self._autotuner.tune_after_step(step, report, self._pg)
        except Exception as e:  # noqa: BLE001 - tuning is best-effort
            logger.warning("autotuner: skipped tuning after step %d: %r", step, e)

    def _post_step_ledger(self, step: int, snapshot: Snapshot) -> None:
        """Post the committed step to the run ledger with its storage
        accounting (bytes newly written against bytes referenced from a
        base or already in the chunk store), then refresh the run's
        ``goodput_*`` gauges. Rank 0 only; best-effort."""
        if self._pg.get_rank() != 0 or not knobs.is_ledger_enabled():
            return
        try:
            from .fsck import blob_requirements
            from .telemetry import last_report
            from .telemetry import ledger as run_ledger
            from .telemetry.goodput import publish_gauges

            need = blob_requirements(snapshot.metadata.manifest)
            bytes_new = sum(n for loc, n in need.items() if not loc.startswith("../"))
            bytes_reused = sum(n for loc, n in need.items() if loc.startswith("../"))
            fields: Dict[str, Any] = {
                "step": step,
                "bytes_new": int(bytes_new),
                "bytes_reused": int(bytes_reused),
                "bytes_total": int(bytes_new + bytes_reused),
                "blobs": len(need),
            }
            # A CAS step's data locations are all ``../chunks/`` refs: the
            # exact split is the commit's pin accounting (chunks already
            # pinned are reused).
            acct = self._last_cas_accounting
            if acct is not None and acct.get("step") == step:
                fields.update(
                    cas=True,
                    bytes_new=acct["bytes_new"],
                    bytes_reused=acct["bytes_reused"],
                    bytes_total=acct["bytes_total"],
                    chunks_new=acct["chunks_new"],
                    chunks_reused=acct["chunks_reused"],
                )
            cur_digests = _manifest_digest_map(snapshot.metadata.manifest)
            if cur_digests:
                prev = self._prev_digest_map
                fields["bytes_digest_unchanged"] = int(
                    sum(n for k, (d, n) in cur_digests.items() if prev.get(k, (None, 0))[0] == d)
                )
                fields["bytes_digest_covered"] = int(sum(n for _, n in cur_digests.values()))
            self._prev_digest_map = cur_digests
            report = last_report("take", "async_take", path=self.step_path(step))
            if report is not None:
                fields["kind"] = report.kind
                fields["take_s"] = round(max(report.phases.values(), default=0.0), 6)
            run_ledger.post_event(self.root, metric_names.EVENT_STEP_COMMITTED, **fields)
            publish_gauges(self.root)
        except Exception as e:  # noqa: BLE001 - the ledger is best-effort
            logger.warning("could not post step %d to the run ledger: %r", step, e)

    # ------------------------------------------------------------------
    # resuming
    # ------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        return self._read_index()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The committed step with the best recorded metric (``best_mode``
        ordering; the newest wins ties), or None when no step has one."""
        index = self._with_root_storage(read_index_full_async)
        scored = [s for s in index["steps"] if str(s) in index["metrics"]]
        if not scored:
            return None
        return min(scored, key=lambda s: self._metric_sort_key(s, index["metrics"]))

    def restore_best(self, app_state: AppState) -> Optional[int]:
        """Restore the best-metric committed step; returns it, or None if
        no step carries a metric."""
        step = self.best_step() if self._pg.get_rank() == 0 else None
        step = self._pg.broadcast_object(step)
        if step is None:
            return None
        self.restore(step, app_state)
        return step

    def restore(self, step: int, app_state: AppState) -> None:
        snapshot = Snapshot(self.step_path(step), pg=self._pg_arg)
        snapshot.restore(app_state)
        # This rank's byte accounting of the restore (its tiers among them).
        self.restore_telemetry = snapshot.restore_telemetry
        telemetry.metrics().counter_inc(metric_names.MANAGER_RESTORES_TOTAL)
        self._record_restore_history(step)

    def restore_latest(self, app_state: AppState) -> Optional[int]:
        """Restore the newest committed step into ``app_state``; returns
        its step number, or None when no checkpoint exists (fresh run)."""
        step = self.latest_step() if self._pg.get_rank() == 0 else None
        step = self._pg.broadcast_object(step)
        if step is None:
            return None
        self.restore(step, app_state)
        return step

    def async_restore(self, step: int, app_state: AppState) -> _ManagedPendingRestore:
        """Pipelined restore of ``step`` (Snapshot.async_restore): reads
        run in the background; call ``.wait()`` to apply."""
        pending = Snapshot(self.step_path(step), pg=self._pg_arg).async_restore(app_state)
        # Counted at initiation: async resumes move the same counter as
        # sync ones.
        telemetry.metrics().counter_inc(metric_names.MANAGER_RESTORES_TOTAL)
        return _ManagedPendingRestore(self, step, pending)

    def async_restore_latest(self, app_state: AppState):
        """Start a pipelined restore of the newest committed step; returns
        ``(step, PendingRestore)``, or None on a fresh run."""
        step = self.latest_step() if self._pg.get_rank() == 0 else None
        step = self._pg.broadcast_object(step)
        if step is None:
            return None
        return step, self.async_restore(step, app_state)

    def wait_durable(self, step: int, timeout: Optional[float] = None) -> None:
        """Durability barrier: block until ``step`` is mirrored to the
        durable tier and the durable tier's index names it, that is until
        the durable tier alone could serve ``restore_latest``. A no-op on
        a plain root (its commit was the durable write). Raises
        ``TimeoutError`` at the deadline, and re-raises a failed mirror's
        error (the fast tier stays restorable; the journal resumes the
        upload). ``timeout=None`` is the
        ``TORCHSNAPSHOT_TPU_WAIT_DURABLE_TIMEOUT_SECONDS`` knob (30 min by
        default; <= 0 waits without a bound)."""
        import time

        from .tiered.mirror import get_mirror, wait_durable as _wait_durable

        if timeout is None:
            default_timeout = knobs.get_wait_durable_timeout_seconds()
            timeout = default_timeout if default_timeout > 0 else None
        tiers = split_tiered_url(self.root)
        deadline = time.monotonic() + timeout if timeout is not None else None
        _wait_durable(self.step_path(step), timeout=timeout)
        if tiers is None:
            return
        fast_root, durable_root = tiers
        mirror = get_mirror()
        resumed_root = False
        while True:

            async def _read_durable_index(url: str = durable_root) -> Dict[str, Any]:
                storage = url_to_storage_plugin(url)
                try:
                    return await read_index_full_async(storage)
                finally:
                    await storage.close()

            try:
                if step in run_in_fresh_event_loop(_read_durable_index())["steps"]:
                    return
            except (FileNotFoundError, RuntimeError):
                pass  # the index is not mirrored yet
            # The index trails through the root's own mirror jobs: if the
            # newest failed and nothing is in flight, polling would never
            # progress. Resume it once, then surface its error.
            root_jobs = mirror.jobs_for(fast_root)
            if root_jobs and all(j.done_evt.is_set() for j in root_jobs):
                if root_jobs[-1].error is not None:
                    if not resumed_root:
                        resumed_root = True
                        mirror.resume(self.root)
                    else:
                        raise RuntimeError(
                            f"step {step} is durable, but mirroring the manager index "
                            f"keeps failing; the fast tier remains authoritative and "
                            f"resume_mirrors() retries the upload"
                        ) from root_jobs[-1].error
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"step {step} durable, but the durable index does not name it "
                    f"within {timeout}s"
                )
            time.sleep(0.05)

    def resume_mirrors(self) -> List[int]:
        """Re-enqueue the durable-tier mirrors a restart interrupted: each
        committed step without a durable commit marker resumes from its
        journal (completed blobs are skipped) or, with no journal, from
        its fast-tier manifest. Returns the resumed steps. Rank 0 only;
        a no-op on a plain root."""
        if split_tiered_url(self.root) is None or self._pg.get_rank() != 0:
            return []
        from .tiered.mirror import get_mirror, is_durable

        mirror = get_mirror()
        resumed: List[int] = []
        for step in self.all_steps():
            path = self.step_path(step)
            if not is_durable(path) and mirror.resume(path) is not None:
                resumed.append(step)
        # The root's own blobs (the index slots) may have a journal too.
        mirror.resume(self.root)
        return resumed

    # ------------------------------------------------------------------
    # index and retention (rank 0 only)
    # ------------------------------------------------------------------

    def _with_root_storage(self, coro_fn):
        """Run ``coro_fn(storage)`` against the manager root in a fresh
        event loop, closing the plugin on every path."""

        async def body():
            storage = url_to_storage_plugin(self.root)
            try:
                return await coro_fn(storage)
            finally:
                await storage.close()

        return run_in_fresh_event_loop(body())

    def _commit_step(
        self,
        step: int,
        refs: Optional[Any] = None,
        metric: Optional[float] = None,
        chunk_refs: Optional[Any] = None,
    ) -> None:
        """``refs`` and ``chunk_refs`` may be values or zero-arg callables
        (evaluated only on rank 0, which alone holds the manifest)."""
        if self._pg.get_rank() != 0:
            return
        if callable(refs):
            refs = refs()
        if callable(chunk_refs):
            chunk_refs = chunk_refs()
        self._with_root_storage(
            lambda storage: self._commit_step_async(
                step, storage, refs or set(), metric, chunk_refs or {}
            )
        )

    def _retained(
        self, steps: List[int], just_saved: int, metrics: Dict[str, float]
    ) -> List[int]:
        """Retention policy: newest ``keep_last_n`` ∪ best ``keep_best_n``
        (by recorded metric) ∪ the just-saved step (never GC'd in its own
        commit: a rollback may produce a numerically old step).

        With ``keep_best_n`` alone (``keep_last_n=None``), only *scored*
        steps compete for deletion: unscored steps are all retained."""
        if self.keep_last_n is None and self.keep_best_n is None:
            return list(steps)
        keep: Set[int] = set()
        if self.keep_last_n is not None:
            keep.update(steps[-self.keep_last_n :])
        if self.keep_best_n is not None:
            scored = [s for s in steps if str(s) in metrics]
            scored.sort(key=lambda s: self._metric_sort_key(s, metrics))
            keep.update(scored[: self.keep_best_n])
            if self.keep_last_n is None:
                keep.update(s for s in steps if str(s) not in metrics)
        if just_saved not in keep:
            logger.warning(
                "Just-saved step %d falls outside the retention policy "
                "(retained: %s); keeping it anyway: the just-saved "
                "checkpoint is never deleted",
                just_saved,
                sorted(keep),
            )
            keep.add(just_saved)
        return [s for s in steps if s in keep]

    def _metric_sort_key(self, step: int, metrics: Dict[str, float]):
        """One ordering for retention and best_step()/restore_best(): best
        metric first (mode-signed), the newest step wins ties."""
        sign = 1.0 if self.best_mode == "min" else -1.0
        return (sign * metrics[str(step)], -step)

    async def _commit_step_async(
        self,
        step: int,
        storage: StoragePlugin,
        refs: Set[int],
        metric: Optional[float] = None,
        chunk_refs: Optional[Dict[str, int]] = None,
    ) -> None:
        index = await read_index_full_async(storage)
        steps = sorted({*index["steps"], step})
        refs_map: Dict[str, List[int]] = dict(index["refs"])
        if refs:
            refs_map[str(step)] = sorted(refs)
        else:
            refs_map.pop(str(step), None)
        # Chunks are pinned before the index write: a crash between the
        # two leaves a pinned but unindexed step (reconcile unpins it),
        # never an indexed step whose chunks a GC could reclaim.
        self._last_cas_accounting = self._cas_pin_step(step, chunk_refs or {})
        metrics: Dict[str, float] = dict(index["metrics"])
        if metric is not None:
            metrics[str(step)] = float(metric)
        else:
            metrics.pop(str(step), None)
        pinned: Set[int] = set(index["pinned"])
        evicted: Set[int] = set(index["evicted"])
        evicted.discard(step)  # a re-saved step is on the fast tier again

        steps = self._retained(steps, step, metrics)
        dropped = [s for s in index["steps"] if s not in steps]

        # The orphaned-base guard: in an index not marked ``refs_complete``
        # (written before incremental refs existed) a retained step's
        # missing refs entry means "unknown", not "none". Re-derive refs
        # from each such step's own manifest, once: every index this code
        # writes carries the marker.
        if not index["refs_complete"]:
            for s in steps:
                if str(s) not in refs_map:
                    derived = await self._derive_refs_async(storage, s)
                    if derived:
                        refs_map[str(s)] = sorted(derived)

        # Pin or delete: a dropped (or previously pinned) step whose blobs a
        # retained step's manifest still references keeps its blobs. Refs
        # name origin steps directly (chained refs collapse at take time),
        # so one pass over the retained steps' refs is the whole liveness
        # set: pins don't propagate.
        needed: Set[int] = set()
        for s in steps:
            needed.update(refs_map.get(str(s), ()))
        to_delete: List[int] = []
        for old in dropped:
            if old in needed:
                pinned.add(old)
            else:
                to_delete.append(old)
        for p in sorted(pinned):
            if p not in needed:
                pinned.discard(p)
                to_delete.append(p)
        for gone in to_delete:
            refs_map.pop(str(gone), None)
            metrics.pop(str(gone), None)
            evicted.discard(gone)

        # Fast-tier eviction (tiered roots with keep_fast_last_n): the
        # surviving steps beyond the newest N, pinned origins included,
        # lose their fast copies once durable. It runs before the index
        # write, so the recorded evicted set never names a step this pass
        # failed to evict.
        if self.keep_fast_last_n is not None:
            hot = set(steps[-self.keep_fast_last_n :]) | {step}
            for old in sorted(set(steps) | pinned):
                if old in hot or old in evicted:
                    continue
                try:
                    if await self._evict_fast_async(old):
                        evicted.add(old)
                except Exception as e:  # noqa: BLE001 - must not fail a save
                    logger.warning("Failed to evict step %d from the fast tier: %r", old, e)

        await self._write_index_async(
            steps, storage, refs=refs_map, pinned=sorted(pinned), metrics=metrics,
            evicted=sorted(evicted),
        )
        registry = telemetry.metrics()
        registry.gauge_set(metric_names.MANAGER_RETAINED_STEPS, len(steps))
        if to_delete:
            registry.counter_inc(metric_names.MANAGER_GC_STEPS_TOTAL, len(to_delete))
        for old in to_delete:
            try:
                await self._delete_step_async(old)
            except Exception as e:  # noqa: BLE001 - GC must not fail a save
                logger.warning("Failed to GC step %d: %r", old, e)
        # Chunk GC after the step deletes (an interrupted pass errs toward
        # keeping chunks), on every commit: grace-deferred orphans and the
        # strays of crashed takes must age out even when retention drops
        # nothing.
        try:
            await self._cas_collect_async(storage, step, to_delete)
        except Exception as e:  # noqa: BLE001 - GC must not fail a save
            logger.warning("CAS chunk GC failed: %r", e)

    def _publish_cdn_step(self, step: int, snapshot: Snapshot) -> None:
        """Announce the just-committed step's chunk set on the CDN topic.
        Rank 0 only, after the commit: the announced chunks are durable. A
        step without chunk-store chunks (CAS off) has nothing a fleet can
        pull by key, so it is skipped, not half-announced. Best-effort: a
        publish failure degrades serving freshness, never the save."""
        if self.cdn_topic is None or self._pg.get_rank() != 0 or not knobs.is_cdn_enabled():
            return
        try:
            chunks = _manifest_chunk_refs(snapshot.metadata.manifest)
            if not chunks:
                logger.debug("cdn: step %d carries no chunk-store chunks; not published", step)
                return
            if self._cdn_publisher is None:
                store = self._cdn_store_arg if self._cdn_store_arg is not None else self._pg.store
                if store is None:
                    logger.warning(
                        "cdn: topic %r configured but no coordination store is reachable; "
                        "steps will not be published", self.cdn_topic,
                    )
                    self.cdn_topic = None
                    return
                from .cdn import CdnPublisher

                self._cdn_publisher = CdnPublisher(
                    store, self.cdn_topic, publisher_id=f"rank0@{self.root}", root=self.root
                )
            self._cdn_publisher.publish(step, chunks)
        except Exception as e:  # noqa: BLE001 - publishing is best-effort
            logger.warning("cdn: could not publish step %d: %r", step, e)

    # ------------------------------------------------------------------
    # the content-addressed chunk store (rank 0 only)
    # ------------------------------------------------------------------

    def _get_cas_store(self) -> Optional[CASStore]:
        """The root's chunk store, or None for a root with no local
        filesystem. Resolved once; for a legacy root the journal load is
        one failed open."""
        if self._cas_store is False:
            self._cas_store = CASStore(self.root) if local_chunks_dir(self.root) else None
        return self._cas_store

    def _cas_pin_step(self, step: int, refs: Dict[str, int]) -> Optional[Dict[str, Any]]:
        """Pin a committing step's chunks and return its accounting: the
        chunks and bytes new to the store against those another pinned
        step already held. None for a legacy step (no chunk refs): the
        journal is never created for it."""
        store = self._get_cas_store()
        if store is None or not refs:
            return None
        pins, orphans = store.load()
        pinned_before: Set[str] = set()
        for s, chunks in pins.items():
            if s != step:
                pinned_before.update(chunks)
        new = {k: n for k, n in refs.items() if k not in pinned_before}
        store.pin(step, refs)
        # Pinned but not yet indexed: reconcile unpins it after a crash.
        crashpoint(metric_names.CRASH_REFCOUNT_PINNED)
        # Chunks revived from the orphan list are live again.
        revived = set(refs) & set(orphans)
        if revived:
            store.clear_orphans(revived)
        return {
            "step": step,
            "chunks_new": len(new),
            "chunks_reused": len(refs) - len(new),
            "bytes_new": int(sum(new.values())),
            "bytes_reused": int(sum(refs.values()) - sum(new.values())),
            "bytes_total": int(sum(refs.values())),
        }

    async def _cas_collect_async(
        self, storage: StoragePlugin, trigger_step: int, deleted_steps: List[int]
    ) -> None:
        """Unpin GC'd steps and reclaim refcount-dead chunks. A dead chunk
        younger than the grace window (a concurrent, not yet pinned take
        may have just deduped against it and touched it) is journaled as
        an orphan and retried by a later pass. Reclaimed bytes are posted
        to the run ledger against the committing ``trigger_step``."""
        from .cas import CHUNKS_DIRNAME

        store = self._get_cas_store()
        if store is None:
            return
        pins, orphans, leases = store.load_full()
        candidates: Dict[str, int] = dict(orphans)
        unpinned = False
        for old in deleted_steps:
            chunks = pins.pop(old, None)
            if chunks is not None:
                store.unpin(old)
                unpinned = True
                candidates.update(chunks)
        if unpinned:
            crashpoint(metric_names.CRASH_GC_UNPINNED)
        # Leases (CDN subscribers of either package) count as live.
        live = store.live_chunks(pins, leases)
        # Stray sweep: chunks on disk in no pin and no orphan record (a
        # take that crashed before its commit pinned them) become
        # candidates too; a concurrent take's fresh ones wait out the
        # grace window, and its pin revives them.
        for key, nbytes in store.list_chunks().items():
            if key not in live and key not in candidates:
                candidates[key] = nbytes
        if not candidates:
            if unpinned:
                store.maybe_compact()
            return
        grace = knobs.get_cas_gc_grace_seconds()
        reclaimed: Dict[str, int] = {}
        cleared: Set[str] = set()
        deferred: Dict[str, int] = {}
        for key, nbytes in candidates.items():
            if key in live:
                cleared.add(key)  # pinned again since it was orphaned
                continue
            age = store.chunk_age_seconds(key)
            if age is None:
                cleared.add(key)  # already gone
                continue
            if grace > 0 and age < grace:
                deferred[key] = nbytes
                continue
            try:
                await storage.delete(f"{CHUNKS_DIRNAME}/{key}")
            except FileNotFoundError:
                pass
            reclaimed[key] = nbytes
        store.clear_orphans((cleared | set(reclaimed)) & set(orphans))
        store.record_orphans({k: n for k, n in deferred.items() if k not in orphans})
        store.maybe_compact()
        if reclaimed:
            registry = telemetry.metrics()
            registry.counter_inc(metric_names.CAS_CHUNKS_RECLAIMED_TOTAL, len(reclaimed))
            registry.counter_inc(metric_names.CAS_BYTES_RECLAIMED_TOTAL, sum(reclaimed.values()))
            # Reclaimed chunk bytes, so that the goodput storage curve
            # tracks what retention keeps.
            from .telemetry import ledger as run_ledger

            run_ledger.post_event(
                self.root, metric_names.EVENT_GC_RECLAIMED,
                step=trigger_step,
                bytes_reclaimed=int(sum(reclaimed.values())), blobs=len(reclaimed), chunks=True,
            )
        if deferred:
            logger.info(
                "CAS GC deferred %d dead but fresh chunk(s) inside the %.0f s grace window",
                len(deferred), grace,
            )

    def _reconcile_cas(self) -> None:
        """Construction-time healing (rank 0): bring the refcount journal
        in line with the index and manifests. Heals a journal lost or torn
        after steps committed (wholly, or one step's pin while others
        survived) and drops the pins of steps that left the index. Reads
        no manifest when the store is empty or every indexed step's pin
        state already matches."""
        store = self._get_cas_store()
        if store is None or not os.path.isdir(store.local_dir):
            return
        pins, _ = store.load()
        if not pins and not store.list_chunks():
            return
        index = self._with_root_storage(read_index_full_async)
        expected = set(index["steps"]) | set(index["pinned"])
        stale_pins = set(pins) - expected
        # An indexed step with no pin is a legacy step (canonically absent
        # from the journal) or a CAS step whose pin was lost: only its
        # manifest tells, and a wrong guess would let the stray sweep
        # reclaim a committed step's chunks.
        missing_pins = expected - set(pins)
        if not stale_pins and not missing_pins:
            return

        async def _refs_of_missing(storage: StoragePlugin) -> Dict[int, Dict[str, int]]:
            mapping: Dict[int, Dict[str, int]] = {}
            for s in sorted(missing_pins):
                read_io = ReadIO(path=f"{_step_dirname(s)}/{SNAPSHOT_METADATA_FNAME}")
                try:
                    await storage.read(read_io)
                except FileNotFoundError:
                    mapping[s] = {}
                    continue
                metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode())
                mapping[s] = chunk_refs(metadata.manifest)
            return mapping

        mapping = self._with_root_storage(_refs_of_missing)
        for s in expected & set(pins):
            mapping[s] = pins[s]
        if store.reconcile(mapping):
            logger.info(
                "CAS refcount journal reconciled against the index (%d committed or pinned steps)",
                len(expected),
            )

    async def _derive_refs_async(self, storage: StoragePlugin, step: int) -> Set[int]:
        """A step's origin-step refs, re-derived from its committed
        manifest. An unreadable manifest raises to the caller."""
        read_io = ReadIO(path=f"{_step_dirname(step)}/{SNAPSHOT_METADATA_FNAME}")
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            return set()
        metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode())
        return referenced_steps(metadata.manifest)

    async def _write_index_async(
        self,
        steps: List[int],
        storage: StoragePlugin,
        refs: Optional[Dict[str, List[int]]] = None,
        pinned: Optional[List[int]] = None,
        metrics: Optional[Dict[str, float]] = None,
        evicted: Optional[List[int]] = None,
    ) -> None:
        payload_obj: Dict[str, Any] = {"steps": steps}
        if steps:
            # Under this marker a step's absent refs entry soundly means
            # verified-empty.
            payload_obj["refs_complete"] = True
        if refs:
            payload_obj["refs"] = refs
        if pinned:
            payload_obj["pinned"] = pinned
        if metrics:
            payload_obj["metrics"] = metrics
        if evicted:
            payload_obj["evicted"] = evicted
        payload = json.dumps(payload_obj).encode()
        # Backup first, primary second: a torn primary write leaves a valid
        # new backup behind it, and a torn backup write leaves the previous
        # (valid, one save stale) primary. "Corrupt primary + absent
        # backup" is then only a torn first-ever write, which is what the
        # read side's recovery rule assumes.
        await storage.write(WriteIO(path=INDEX_BACKUP_BLOB, buf=payload))
        crashpoint(metric_names.CRASH_INDEX_BACKUP_WRITTEN)
        await storage.write(WriteIO(path=INDEX_BLOB, buf=payload))
        crashpoint(metric_names.CRASH_INDEX_WRITTEN)

    def _read_index(self) -> List[int]:
        return self._with_root_storage(read_index_full_async)["steps"]

    async def _evict_fast_async(self, step: int) -> bool:
        """Drop one step's fast-tier copy (tiered roots); the step stays
        committed and restorable through the durable fallback. Returns
        False, evicting nothing, while the durable commit marker is absent
        (the mirror is still working, or failed and will resume)."""
        from .cas import chunk_map_path
        from .tiered.journal import MirrorJournal
        from .tiered.mirror import is_durable_async
        from .tiered.plugin import TieredStoragePlugin

        path = self.step_path(step)
        if not await is_durable_async(path):
            return False
        storage = url_to_storage_plugin(path)
        try:
            if not isinstance(storage, TieredStoragePlugin):
                return False
            # The durable manifest says what to remove (the fast copy may
            # be partial already).
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            await storage.durable.read(read_io)
            metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode())
            locations = {
                loc
                for entry in metadata.manifest.values()
                for loc in entry_locations(entry)
                if not loc.startswith("../")
            }
            for rank in range(metadata.world_size):
                locations.add(table_path(rank))
                locations.add(chunk_map_path(rank))

            async def _drop(location: str) -> None:
                try:
                    await storage.fast.delete(location)
                except FileNotFoundError:
                    pass

            # The commit marker first (as in _delete_step_async), then the
            # side files and the data, then the journal.
            await _drop(SNAPSHOT_METADATA_FNAME)
            await _drop(_STEP_EVENTS_BLOB)
            for rank in range(metadata.world_size):
                for name in _RANK_SIDE_BLOBS:
                    await _drop(name.format(rank))
            slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())

            async def _drop_slotted(location: str) -> None:
                async with slots:
                    await _drop(location)

            results = await asyncio.gather(
                *(_drop_slotted(loc) for loc in sorted(locations)), return_exceptions=True
            )
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            await MirrorJournal(blobs={}).delete(storage.fast)
        finally:
            await storage.close()
        logger.info("Evicted step %d from the fast tier", step)
        return True

    async def _delete_step_async(self, step: int) -> None:
        """Delete a step's blobs, driven by its manifest (plugins cannot
        list). The commit marker goes first: once it is gone the step is
        simply uncommitted, so a crash mid-deletion leaves garbage bytes
        but never a valid-looking damaged snapshot."""
        from .tiered.journal import MirrorJournal
        from .tiered.plugin import TieredStoragePlugin

        storage = url_to_storage_plugin(self.step_path(step))
        tiered = isinstance(storage, TieredStoragePlugin)
        try:
            if tiered and storage.fast_url:
                # The step leaves both tiers: stop its in-flight mirror
                # first (its fast-tier sources are about to vanish).
                from .tiered.mirror import get_mirror

                get_mirror().cancel_path(storage.fast_url)
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            try:
                await storage.read(read_io)
            except FileNotFoundError:
                return  # never committed; nothing authoritative to walk
            metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode())
            await storage.delete(SNAPSHOT_METADATA_FNAME)
            crashpoint(metric_names.CRASH_GC_MARKER_DELETED)
            if tiered:
                await MirrorJournal(blobs={}).delete(storage.fast)
            # Heartbeats in a shared progress dir have no other reaper
            # (the snapshot-adjacent ones go with the side files below).
            from .telemetry.progress import remove_dir_heartbeats

            remove_dir_heartbeats(self.step_path(step))
            # Parent-relative locations are another step's blobs (this step
            # was incremental): never delete outside the step directory.
            locations = {
                loc
                for entry in metadata.manifest.values()
                for loc in entry_locations(entry)
                if not loc.startswith("../")
            }
            locations.add(_STEP_EVENTS_BLOB)
            for rank in range(metadata.world_size):
                locations.add(table_path(rank))
                locations.update(name.format(rank) for name in _RANK_SIDE_BLOBS)
            slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())

            async def _delete_one(location: str) -> None:
                async with slots:
                    try:
                        await storage.delete(location)
                    except FileNotFoundError:
                        pass  # checksum tables and side files are optional

            # Let every delete settle before the plugin closes, then surface
            # the first failure.
            results = await asyncio.gather(
                *(_delete_one(loc) for loc in sorted(locations)), return_exceptions=True
            )
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        finally:
            await storage.close()
        # The dropped step's peer-RAM copies: evicted from every advertised
        # cache in the background (the caches bound themselves anyway).
        try:
            from .tiered.peer import maybe_evict_step

            maybe_evict_step(self.step_path(step))
        except Exception as e:  # noqa: BLE001 - GC must not fail a save
            logger.warning("peer tier: evicting step %d peer copies failed: %r", step, e)
        self._post_gc_ledger(step, metadata.manifest)
        logger.info("Retention dropped step %d", step)

    def _post_gc_ledger(self, step: int, manifest: Manifest) -> None:
        """Record the GC'd step in the run ledger (its own bytes; those it
        referenced belong to other steps) and prune its ``step-committed``
        record, so that the goodput storage curve tracks what retention
        keeps. Rank 0 (GC is rank-0 work); best-effort."""
        if not knobs.is_ledger_enabled():
            return
        try:
            from .fsck import blob_requirements
            from .telemetry import ledger as run_ledger

            own = {
                loc: n for loc, n in blob_requirements(manifest).items() if not loc.startswith("../")
            }
            run_ledger.post_event(
                self.root, metric_names.EVENT_GC_RECLAIMED, step=step,
                bytes_reclaimed=int(sum(own.values())), blobs=len(own),
            )
            run_ledger.prune_steps(self.root, {step})
        except Exception as e:  # noqa: BLE001 - GC must not fail a save
            logger.warning("could not record GC of step %d in the run ledger: %r", step, e)
