"""The Snapshot user API: take / async_take / restore / async_restore /
read_object, in one process or across the ranks of a process group.

Counterpart of ``torchsnapshot_tpu/snapshot.py``. Same protocol:

- ``take``: flatten every stateful's state dict (the RNG state captured
  first), plan write requests, stage and write them under the host-memory
  budget, write the per-rank checksum table, then commit
  ``.snapshot_metadata`` (JSON). A snapshot without the metadata file
  never happened, which is what makes an interrupted take safe.
  ``incremental_base=`` references the base's blobs for chunks whose
  digest did not change (``incremental.py``); ``record_digests=`` records
  digests so that the snapshot can serve as a base.
- Across ranks (``pg=``: a :class:`~torchsnapshot_tpu_torch.dist_store.ProcessGroup`,
  a ``(store, rank, world_size)`` object or :func:`torch_process_group`'s
  result): rank 0's path and a commit nonce are broadcast; the statefuls
  are captured in the globally sorted key order; the ``replicated=`` globs
  that every rank declared, and that match on every rank, mark replicated
  leaves, whose writes are spread over the ranks (``partitioner.py``); the
  per-rank manifests gather to rank 0; every rank writes its blobs and its
  checksum table, and rank 0 commits after an error-propagating barrier,
  so a rank that fails leaves no commit marker and its peers abandon in
  seconds. Replicated entries sit under rank 0 in the manifest and are
  visible to every rank at restore; per-rank entries only to their rank
  (or to ``read_object`` of their ``{rank}/`` path).
- ``async_take``: returns a :class:`PendingSnapshot` once a consistent copy
  of the state is pinned: on-device clones of the CUDA leaves, dispatched
  on the caller's current stream and not awaited, host copies of CPU
  leaves and pickles of objects. The collectives all run on the calling
  thread; the device-to-host copies, writes and the commit (through the
  store barrier, which is safe off the main thread) run on a background
  thread. ``wait(phase="staged")`` returns when the bytes have left the
  card, ``wait()`` when the snapshot is committed.
- ``restore``: in place, like torch's ``load_state_dict``, one stateful
  at a time in the sorted key order, with an error-propagating barrier
  after each. A CUDA leaf is read into a pinned host buffer and copied
  into the live tensor with ``copy_(non_blocking=True)`` on a side
  stream; leaves whose reads landed are placed together in rolling
  batches of ``TORCHSNAPSHOT_TPU_RESTORE_PLACEMENT_FLUSH_BYTES`` while the
  other reads are still in flight (streaming placement). A CPU leaf is
  read into directly. The RNG state is restored last.
- ``async_restore``: plans on the calling thread, reads and places on a
  background thread into fresh buffers (host and card), and applies the
  state dicts only in :meth:`PendingRestore.wait`: until then the live
  leaves are untouched, and a failed read leaves them as they were.
- ``read_object``: random access to one manifest path, of any rank;
  ``sharding=`` (a ``(DeviceMesh, placements)`` pair or a ``DTensor``
  template) places an array entry as a ``DTensor`` under any layout.
- Sharded state: a ``DTensor`` sharded over its mesh is written as the
  JAX package's ``ShardedArray`` entry, each distinct box once
  (``sharded_io_preparer.py``), and restores into ``DTensor``s of any
  placements and world size, or into plain tensors (elastic resharding:
  each rank reads only the saved boxes that overlap its own). A
  fully-replicated ``DTensor`` spanning more than one device is inferred
  replicated, as the JAX package infers a fully-replicated ``jax.Array``.
- ``TORCHSNAPSHOT_TPU_ENABLE_BATCHING``: small writes coalesce into slabs,
  and ranged reads of one slab merge (``batcher.py``).
- ``TORCHSNAPSHOT_TPU_CAS=1`` (rank 0's reading, broadcast with the
  path): data blobs go once into the root's content-addressed
  ``chunks/`` store (``cas/``); each rank writes its ``path -> digest``
  map before the commit barrier and rank 0 rewrites the manifest onto
  ``../chunks/<key>`` before the commit marker.
- Single-reader fan-out restore (on by default; rank 0's
  ``TORCHSNAPSHOT_TPU_FANOUT_RESTORE`` decides): in a multi-rank restore
  each unique saved shard blob is read once, by its owner rank, and
  shipped to the ranks that need it over the coordination store
  (``fanout.py``), one exchange round per stateful key, or one for all
  plans in ``async_restore``. ``restore_telemetry`` then holds the
  rank's byte accounting.

- ``tiered://<fast>|<durable>`` paths (``tiered/``): a take writes and
  commits on the fast tier, and closing its plugin after the commit hands
  the written blobs to the background mirror, commit marker last. A
  restore reads each blob fast first with a durable fallback; a blob that
  fails verification heals from the other tier (the scheduler's ladder)
  before any byte of it reaches a consumer or the card.
- Crash points (``chaos/``): the take and commit paths call the JAX
  package's kill points at the same moments (``take-writes-done``,
  ``checksum-table-written``, ``cas-map-written``, ``pre-commit-marker``,
  ``commit-marker``, ``peer-enqueued``); each is a no-op unless a chaos
  engine is armed.

- The peer-RAM tier (``tiered/peer.py``): after the commit every rank
  queues its written blobs for its ring neighbour's host RAM (a no-op
  unless a multi-rank manager configured the tier); a restore wraps its
  plugin in the peer -> fast -> durable ladder before fan-out is built,
  as the JAX package does, and ``restore_telemetry`` then carries the
  ladder's ``tier_split`` and ``peer`` fields, with ``bytes_fetched``
  counting only the bytes storage served.

- Telemetry (``telemetry/``): every take, async take, restore and async
  restore tracks its live progress (``.progress-rank<r>.json`` beside a
  local snapshot, removed on success), builds a ``SnapshotReport``
  gathered across ranks under ``__telemetry/{kind}/{nonce}`` (rank 0's
  carries the per-metric spread and the straggler), hands it to the
  knob-gated sinks, posts its run-ledger events on rank 0 when this
  process's manager owns the root, and exports its span window as a
  Chrome trace when the trace sink is on. Telemetry never fails an op.

The snapshot format is the JAX package's: either package reads what the
other writes, digests and chunk stores included, and a snapshot taken by
N ranks of one restores through N ranks of the other; so are the
telemetry records.
"""

from __future__ import annotations

import asyncio
import contextlib
import fnmatch
import logging
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import knobs, telemetry
from .dist_store import StoreBarrier, make_barrier
from .flatten import _encode, flatten, inflate
from .incremental import IncrementalTakeContext
from .integrity import _alg_available, load_checksum_tables, sync_write_checksum_table
from .io_preparer import DeviceCopier, capture_write_reqs, prepare_read, prepare_write
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    get_manifest_for_rank,
    is_container_entry,
    is_replicated,
)
from .pg_wrapper import PGWrapper
from .rng_state import RngState
from .scheduler import (
    DeferredIOWork,
    PendingIOWork,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
    sync_execute_write_reqs,
)
from .serialization import (
    DTYPE_TO_STRING,
    dtype_to_string,
    empty_tensor,
    tensor_from_numpy,
)
from .sharded_io_preparer import (
    ShardedArrayIOPreparer,
    is_dtensor,
    is_sharded_dtensor,
    placement_spec,
)
from .stateful import AppState, Stateful
from .chaos import crashpoint
from .storage_plugin import url_to_storage_plugin
from .telemetry import names as metric_names
from .telemetry import progress as _progress
from .telemetry.trace import TraceMark, export_op_trace
from .telemetry.trace import get_recorder as _trace_recorder
from .version import __version__

logger: logging.Logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


def _nonce_barrier(prefix: str, pg_wrapper: PGWrapper) -> Optional[StoreBarrier]:
    """The error-propagating rendezvous of every distributed phase (take
    commit, restore keys, async plan and apply); None in one process."""
    if pg_wrapper.get_world_size() <= 1:
        return None
    assert pg_wrapper.store is not None
    return make_barrier(
        prefix, pg_wrapper.store, pg_wrapper.get_rank(), pg_wrapper.get_world_size()
    )


@contextlib.contextmanager
def _reporting_to(barrier: Optional[StoreBarrier], what: str):
    """An error raised inside the block is reported into ``barrier``
    (best-effort) before it propagates, so that peers waiting there
    abandon within seconds instead of at the store timeout."""
    try:
        yield
    except BaseException as e:
        if barrier is not None:
            try:
                barrier.report_error(e)
            except Exception as report_exc:  # noqa: BLE001 - already failing
                logger.error(
                    "failed to report %s error to peers (%r); they will abandon at the "
                    "barrier timeout",
                    what, report_exc,
                )
        raise


def _maybe_cas_storage(storage: StoragePlugin, path: str, cas_on: bool) -> StoragePlugin:
    """Wrap a take's plugin in the content-addressed write interceptor
    when the broadcast decision says so (rank 0 decides, so ranks never
    diverge on where data bytes land)."""
    if not cas_on:
        return storage
    from .cas import CASStoragePlugin

    return CASStoragePlugin(storage, path)


def _maybe_write_cas_map(
    storage: StoragePlugin, rank: int, event_loop: asyncio.AbstractEventLoop
) -> None:
    """This rank's CAS ``path -> digest`` map (``cas/{rank}``), before the
    commit barrier like the checksum table. A no-op for legacy takes."""
    from .cas import CASStoragePlugin

    if isinstance(storage, CASStoragePlugin):
        event_loop.run_until_complete(storage.write_chunk_map(rank))


def _restore_telemetry(pipelines: List[dict], fanout_ctx, peer_ctx=None) -> Dict[str, Any]:
    """A restore's byte accounting on this rank (the fields of the JAX
    package's restore report, folded as its ``_merge_fanout_telemetry``
    does): the bytes its read pipelines consumed; those it fetched from
    storage (the pipelines' reads that the fan-out cache did not serve,
    plus the owner's union-window reads); the bytes fan-out shipped in
    from peers and out to them; and, when a read healed from another copy
    (here or in the fan-out owner's fetch), ``degraded_reads`` (blobs,
    bytes) and ``tier_split`` (healed bytes by serving tier).

    With the peer ladder (``peer_ctx``), its fields fold in as the JAX
    package's ``_merge_peer_telemetry`` does: its ``tier_split`` (bytes
    served per tier of the ladder, corruption reroutes included)
    supersedes the healed split, and ``peer`` holds its degradation
    evidence. Bytes served from peer RAM are not storage reads:
    ``bytes_fetched`` leaves them out, and ``verified_by_plugin`` counts
    the pulled reads that the pipeline did not verify again."""
    bytes_read = sum(int(p["bytes_moved"]) for p in pipelines)
    out: Dict[str, Any] = {
        "bytes_read": bytes_read, "bytes_fetched": bytes_read, "bytes_received": 0, "bytes_published": 0,
    }
    blobs = sum(p.get("degraded_reads", {}).get("blobs", 0) for p in pipelines)
    nbytes = sum(p.get("degraded_reads", {}).get("bytes", 0) for p in pipelines)
    split: Dict[str, int] = {}
    for tiers in [p.get("tier_split", {}) for p in pipelines]:
        for tier, n in tiers.items():
            split[tier] = split.get(tier, 0) + n
    if fanout_ctx is not None:
        out["bytes_fetched"] += fanout_ctx.bytes_fetched - fanout_ctx.bytes_served
        out["bytes_received"] = fanout_ctx.bytes_received
        out["bytes_published"] = fanout_ctx.bytes_published
        heal = fanout_ctx.heal_stats
        blobs += heal.degraded_reads
        nbytes += heal.degraded_bytes
        for tier, n in heal.degraded_tier_bytes.items():
            split[tier] = split.get(tier, 0) + n
    if blobs:
        out["degraded_reads"] = {"blobs": blobs, "bytes": nbytes}
        out["tier_split"] = split
    verified = sum(p.get("verified_by_plugin", 0) for p in pipelines)
    if verified:
        out["verified_by_plugin"] = verified
    if peer_ctx is not None:
        out.update(peer_ctx.pipeline_fields())
        out["bytes_fetched"] = max(0, out["bytes_fetched"] - out["tier_split"]["peer"])
    return out


def _restore_pipeline(pipelines: List[dict], restore_telemetry: Dict[str, Any], bytes_needed: int) -> dict:
    """A restore's pipeline telemetry for its report: the read pipelines
    folded together, with the byte fields and the tier split of
    ``restore_telemetry`` (the JAX package's fetched / received / needed
    triple, and the peer ladder's or the healed reads' split)."""
    pipeline = telemetry.merge_pipeline_telemetry(pipelines)
    pipeline["bytes_needed"] = bytes_needed
    pipeline["bytes_fetched"] = restore_telemetry["bytes_fetched"]
    pipeline["bytes_received"] = restore_telemetry["bytes_received"]
    for key in ("tier_split", "degraded_reads", "peer"):
        if key in restore_telemetry:
            pipeline[key] = restore_telemetry[key]
    return pipeline


def _needed_bytes(read_reqs: List[ReadReq]) -> int:
    """The destination bytes a read plan fills, before batching: the
    denominator of the read-amplification fields."""
    return sum(int(r.buffer_consumer.get_consuming_cost_bytes()) for r in read_reqs)


def _mirror_state_for(path: str) -> Dict[str, Any]:
    """The process mirror's queue and lag state for a tiered path ({}
    otherwise): at report time a take's mirror job was just enqueued, so
    this is the durability backlog the take added to."""
    from .tiered.mirror import mirror_state_for_path

    return dict(mirror_state_for_path(path) or {})


def _emit_snapshot_report(
    kind: str,
    path: str,
    pg_wrapper: PGWrapper,
    pipeline: Optional[dict],
    counter_baseline: Dict[str, float],
    nonce: Optional[str],
    trace_mark: Optional[TraceMark] = None,
    tunables: Optional[Dict[str, Any]] = None,
) -> None:
    """Build this rank's SnapshotReport, aggregate it across ranks, and
    hand it to the sinks; post the op's run-ledger events (rank 0, an
    owned root only) and export its trace window (``trace_mark``, taken
    at the op's start). Best-effort, except that the cross-rank gather is
    symmetric: every rank that reaches this call joins it, whatever its
    sink knobs say. The gather is store-based, not a collective, so it is
    safe on the async take's commit thread, and it has its own 60 s
    timeout: a rank dying after the commit barrier costs rank 0 at most
    that, and only the aggregation."""
    try:
        registry = telemetry.metrics()
        report = telemetry.build_report(
            kind=kind,
            path=path,
            rank=pg_wrapper.get_rank(),
            world_size=pg_wrapper.get_world_size(),
            pipeline=pipeline,
            counter_deltas=registry.counters_delta_since(counter_baseline),
            mirror=_mirror_state_for(path),
            # The knob values the op ran under, captured at its start.
            tunables=tunables if tunables is not None else knobs.tunable_snapshot(),
        )
        # Blocking-chain attribution over the op's recorder window,
        # before the gather, so that every rank's dict carries its
        # segments into the cross-rank fold. The envelope span closed
        # before this call, so the window holds the op's whole extent.
        if trace_mark is not None:
            try:
                from .telemetry import critpath

                report.critical_path = critpath.critical_path_from_events(
                    _trace_recorder().events_since(trace_mark), kind
                )
            except Exception as e:  # noqa: BLE001 - attribution is best-effort
                logger.warning("telemetry: critical-path attribution failed: %r", e)
        gathered = None
        if nonce and pg_wrapper.get_world_size() > 1 and pg_wrapper.store is not None:
            try:
                # Each rank stamps its wall clock at the gather's entry,
                # moments after the same barrier: the per-rank deltas are
                # the trace merge's clock offsets.
                own = report.to_dict()
                own["gather_unix_ts"] = time.time()
                gathered = pg_wrapper.store.gather(
                    f"__telemetry/{kind}/{nonce}",
                    pg_wrapper.get_rank(),
                    pg_wrapper.get_world_size(),
                    own,
                    timeout=60.0,
                )
            except Exception as e:  # noqa: BLE001 - emit the rank-local report
                logger.warning(
                    "telemetry: cross-rank gather for %s failed (%r); emitting the "
                    "unaggregated rank-local report",
                    kind, e,
                )
                gathered = None
            if gathered is not None:
                report.aggregated = telemetry.aggregate_across_ranks(gathered)
                report.clock_offsets_s = telemetry.clock_offsets_from_gather(gathered)
        telemetry.emit_report(report, registry)
        if pg_wrapper.get_rank() == 0:
            from .telemetry import ledger as run_ledger

            # A restore's tier split summed over the gathered ranks: the
            # ledger records the world's recovery, not rank 0's alone.
            splits = [r["tier_split"] for r in gathered or [] if r.get("tier_split")]
            world_tier_split = {} if splits else None
            for split in splits:
                for tier, n in split.items():
                    world_tier_split[tier] = world_tier_split.get(tier, 0) + int(n)
            run_ledger.post_op_event(kind, path, report, world_tier_split=world_tier_split)
        if trace_mark is not None:
            export_op_trace(kind, path, pg_wrapper.get_rank(), trace_mark)
    except Exception as e:  # noqa: BLE001 - telemetry must not fail the op
        logger.warning("telemetry: %s report emission failed: %r", kind, e)


def _build_fanout(manifest: Manifest, pg_wrapper: PGWrapper):
    """The restore's fan-out context, or None when the manifest holds no
    shard blob to fan out."""
    from .fanout import FanoutRestoreContext

    ctx = FanoutRestoreContext.build(manifest, pg_wrapper)
    return ctx if ctx.owners else None


class Snapshot:
    """A reference to an existing or to-be-created snapshot at ``path``.
    ``pg`` is the process group that restores it (None: one process)."""

    def __init__(self, path: str, pg: Optional[Any] = None) -> None:
        self.path = path
        self._pg_arg = pg
        self._metadata: Optional[SnapshotMetadata] = None
        # This rank's byte accounting of the last restore() (see
        # _restore_telemetry); None before one ran.
        self.restore_telemetry: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    # take
    # ------------------------------------------------------------------

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[Any] = None,
        replicated: Optional[List[str]] = None,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
    ) -> "Snapshot":
        """Synchronous checkpoint of ``app_state`` to ``path``. Returns once
        every byte is in storage and the snapshot is committed; the caller
        must not mutate the state's tensors while it runs.

        ``replicated`` lists globs of logical paths (``"model/**"``) whose
        leaves are equal on every rank: each is written once, by one rank.
        ``incremental_base`` (a snapshot path or Snapshot, the same on
        every rank) makes the take incremental: chunks whose digest
        matches the base's recorded one are neither copied to the host nor
        written, and the manifest references the base's blob.
        ``record_digests`` records digests without a base, so that this
        snapshot can serve as one."""
        from .cas import cas_eligible

        pg_wrapper = PGWrapper(pg)
        rank = pg_wrapper.get_rank()
        # Rank 0's path wins; the CAS layout decision rides the same
        # broadcast, so ranks never diverge on where data bytes land.
        path, cas_on = pg_wrapper.broadcast_object((path, cas_eligible(path)))
        # The nonce keeps the commit barrier's keys from aliasing any
        # earlier take to the same path.
        barrier = None
        commit_nonce = ""
        if pg_wrapper.get_world_size() > 1:
            commit_nonce = pg_wrapper.broadcast_object(uuid.uuid4().hex)
            barrier = _nonce_barrier(f"__snapshot_commit/{commit_nonce}", pg_wrapper)
        counter_baseline = telemetry.metrics().counters_snapshot()
        tunables = knobs.tunable_snapshot()
        recorder = _trace_recorder()
        trace_mark = recorder.mark()
        take_span = recorder.begin(telemetry.names.SPAN_TAKE, path=path, rank=rank)
        # The op's live-progress heartbeat: success removes its file, a
        # failure leaves a terminal document.
        tracker = _progress.track("take", path, rank)
        op_error: Optional[BaseException] = None
        event_loop = asyncio.new_event_loop()
        try:
            storage = _maybe_cas_storage(url_to_storage_plugin(path), path, cas_on)
            with _reporting_to(barrier, "take"):
                pending, metadata = cls._take_impl(
                    path, app_state, pg_wrapper, replicated or [], storage, event_loop,
                    is_async_snapshot=False, incremental_base=incremental_base,
                    record_digests=record_digests, progress_tracker=tracker,
                )
                pending.sync_complete(event_loop)
                crashpoint(metric_names.CRASH_TAKE_WRITES_DONE)
                _write_checksum_table(pending, rank, storage, event_loop)
                crashpoint(metric_names.CRASH_CHECKSUM_TABLE_WRITTEN)
                _maybe_write_cas_map(storage, rank, event_loop)
                crashpoint(metric_names.CRASH_CAS_MAP_WRITTEN)
            # Every rank's writes are durable before the commit marker
            # exists anywhere. The commit window stays under
            # _reporting_to: a failed metadata write on rank 0 releases
            # the peers waiting at depart().
            with _reporting_to(barrier, "commit"):
                if barrier is not None:
                    barrier.arrive()
                if rank == 0:
                    _write_snapshot_metadata(metadata, storage, event_loop)
                if barrier is not None:
                    barrier.depart()
            _post_commit(path, pending)
            # After the commit: closing a tiered plugin enqueues the
            # take's blobs to the mirror.
            event_loop.run_until_complete(storage.close())
            # The envelope closes first, so that the exported trace holds
            # the take's whole extent; the report follows the close, so
            # that a tiered take's report sees its mirror job.
            recorder.end(take_span)
            _emit_snapshot_report(
                "take", path, pg_wrapper, pending.pipeline_telemetry(), counter_baseline,
                commit_nonce, trace_mark=trace_mark, tunables=tunables,
            )
        except BaseException as e:
            op_error = e
            raise
        finally:
            tracker.finish(op_error)
            recorder.end(take_span)  # a no-op once closed
            event_loop.close()
        snapshot = cls(path=path, pg=pg)
        snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[Any] = None,
        replicated: Optional[List[str]] = None,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
    ) -> "PendingSnapshot":
        """Checkpoint whose visible span does not grow with the state's
        size: returns once the plan's collectives ran and a consistent copy
        is pinned (on-device clones of the CUDA leaves dispatched on the
        caller's current stream, host copies of CPU leaves, pickles of
        objects); the device-to-host copies, the writes and the commit run
        on a background thread through a pinned staging pool of a few
        slabs. The caller may mutate or free the live tensors as soon as
        this returns.

        ``TORCHSNAPSHOT_TPU_ASYNC_DEVICE_SNAPSHOT=0`` stages before
        returning instead (no device clone, no extra device memory).
        ``pg``, ``replicated``, ``incremental_base`` and
        ``record_digests`` as in :meth:`take`."""
        from .cas import cas_eligible

        op_begin = time.monotonic()
        pg_wrapper = PGWrapper(pg)
        path, cas_on = pg_wrapper.broadcast_object((path, cas_eligible(path)))
        commit_nonce = pg_wrapper.broadcast_object(uuid.uuid4().hex)
        # Error-reporting handle on the same barrier the background commit
        # waits at: a rank that fails while staging must poison it, or
        # peers whose commit threads wait at arrive() block out the store
        # timeout.
        barrier = _nonce_barrier(f"__snapshot_commit/{commit_nonce}", pg_wrapper)
        counter_baseline = telemetry.metrics().counters_snapshot()
        tunables = knobs.tunable_snapshot()
        recorder = _trace_recorder()
        trace_mark = recorder.mark()
        storage = _maybe_cas_storage(url_to_storage_plugin(path), path, cas_on)
        tracker = _progress.track("async_take", path, pg_wrapper.get_rank())
        event_loop = asyncio.new_event_loop()
        try:
            with recorder.span(
                telemetry.names.SPAN_ASYNC_TAKE_STAGE, path=path, rank=pg_wrapper.get_rank()
            ), _reporting_to(barrier, "async take staging"):
                pending, metadata = cls._take_impl(
                    path, app_state, pg_wrapper, replicated or [], storage, event_loop,
                    is_async_snapshot=True, incremental_base=incremental_base,
                    record_digests=record_digests,
                    defer_staging=knobs.is_async_device_snapshot_enabled(),
                    progress_tracker=tracker,
                )
        except BaseException as e:
            # No background thread will settle or close them.
            tracker.finish(e)
            try:
                event_loop.run_until_complete(storage.close())
            except Exception:  # noqa: BLE001 - already failing
                pass
            event_loop.close()
            raise
        return PendingSnapshot(
            path, pending, pg_wrapper, metadata, storage, event_loop, op_begin, commit_nonce,
            counter_baseline=counter_baseline, trace_mark=trace_mark, progress_tracker=tracker,
            tunables=tunables,
        )

    @classmethod
    def _take_impl(
        cls,
        path: str,
        app_state: AppState,
        pg_wrapper: PGWrapper,
        replicated: List[str],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        is_async_snapshot: bool,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
        defer_staging: bool = False,
        progress_tracker: Optional[_progress.ProgressTracker] = None,
    ) -> Tuple["PendingIOWork | DeferredIOWork", Optional[SnapshotMetadata]]:
        """The take's plan and its staging; every collective of the take
        before the commit runs here, on the calling thread. The returned
        metadata is None on every rank but 0 (the manifests gather there).
        With ``defer_staging`` no staging runs here: the write plan's
        sources are captured and the returned :class:`DeferredIOWork` runs
        the whole pipeline later."""
        _validate_app_state(app_state)
        rank = pg_wrapper.get_rank()
        world_size = pg_wrapper.get_world_size()
        replicated_patterns = _coalesce_replicated(replicated, pg_wrapper)

        # The RNG state is captured first: capturing the other statefuls
        # must not perturb what is saved as the RNG state. Its key keeps
        # its sorted slot in the loop below, whose barriers every rank must
        # run in the same order.
        rng = _pop_rng_state(app_state)
        rng_capture = flatten(rng[1].state_dict(), prefix=rng[0]) if rng is not None else None
        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        for key in _gather_keys(app_state, pg_wrapper):
            if rng is not None and key == rng[0]:
                entries, leaves = rng_capture
            elif key in app_state:
                # state_dict() may itself run collectives: every rank
                # captures in the same order, a barrier apart.
                entries, leaves = flatten(app_state[key].state_dict(), prefix=key)
            else:
                entries, leaves = {}, {}
            pg_wrapper.barrier()
            manifest.update(entries)
            flattened.update(leaves)

        replicated_paths = _calculate_replicated_entries(
            flattened, replicated_patterns, pg_wrapper,
            inferred=_infer_replicated_paths(flattened),
        )

        incr_ctx = None
        if incremental_base is not None or record_digests:
            incr_ctx = IncrementalTakeContext.build(path, incremental_base, rank)
            # Digests launch before any stager exists: skip decisions
            # precede the copies to the host.
            incr_ctx.launch(flattened)
            incr_ctx.synchronize(pg_wrapper, replicated_paths)
        copier = DeviceCopier()
        write_reqs: List[WriteReq] = []
        for logical_path, leaf in flattened.items():
            entry, reqs = prepare_write(
                obj=leaf, logical_path=logical_path, rank=rank, copier=copier,
                replicated=logical_path in replicated_paths,
                is_async_snapshot=is_async_snapshot,
                incremental=incr_ctx.plan_for(logical_path) if incr_ctx else None,
            )
            manifest[logical_path] = entry
            write_reqs.extend(reqs)
        if world_size > 1:
            from .partitioner import partition_write_reqs

            manifest, write_reqs = partition_write_reqs(manifest, write_reqs, pg_wrapper)
        if knobs.is_batching_enabled():
            from .batcher import batch_write_requests

            entry_list, write_reqs = batch_write_requests(list(manifest.values()), write_reqs)
            manifest = dict(zip(manifest.keys(), entry_list))

        # The budget's collective runs before the manifest gather: the
        # gather's consolidation is the last rank-0-only failure point of
        # the plan, and a peer must have no collective left between its
        # gather send and the error-propagating commit barrier.
        budget = get_process_memory_budget_bytes(pg_wrapper)
        global_manifest = _gather_manifest(manifest, pg_wrapper)
        metadata = (
            SnapshotMetadata(version=__version__, world_size=world_size, manifest=global_manifest)
            if global_manifest is not None
            else None
        )
        if defer_staging:
            with _trace_recorder().span(
                telemetry.names.SPAN_DEVICE_CAPTURE, rank=rank, reqs=len(write_reqs)
            ):
                capture_write_reqs(write_reqs)
            if progress_tracker is not None:
                progress_tracker.set_phase("captured")
            pending: "PendingIOWork | DeferredIOWork" = DeferredIOWork(
                write_reqs, storage, budget, rank=rank, progress=progress_tracker
            )
        else:
            pending = sync_execute_write_reqs(
                write_reqs=write_reqs, storage=storage, memory_budget_bytes=budget,
                rank=rank, event_loop=event_loop, progress=progress_tracker,
            )
        if incr_ctx is not None:
            # Referenced blobs were not rewritten: their checksums come from
            # the base's table, read once the writes are done.
            pending.checksum_finalizer = lambda: incr_ctx.inherit_checksums(pending.checksums)
        from .cas import CASStoragePlugin

        if isinstance(storage, CASStoragePlugin):
            # CAS takes also re-home the table's entries from the write
            # paths to the chunk locations the rewritten manifest names,
            # after the incremental inherit (whose refs into a CAS base
            # are chunk locations already).
            inherit = pending.checksum_finalizer

            def _cas_finalize() -> None:
                if inherit is not None:
                    inherit()
                storage.rekey_checksums(pending.checksums)

            pending.checksum_finalizer = _cas_finalize
        return pending, metadata

    # ------------------------------------------------------------------
    # metadata / manifest
    # ------------------------------------------------------------------

    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata is None:
            event_loop = asyncio.new_event_loop()
            try:
                storage = url_to_storage_plugin(self.path)
                read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                event_loop.run_until_complete(storage.read(read_io))
                self._metadata = SnapshotMetadata.from_yaml(
                    bytes(read_io.buf).decode("utf-8")
                )
                event_loop.run_until_complete(storage.close())
            finally:
                event_loop.close()
        return self._metadata

    def get_manifest(self) -> Manifest:
        import copy

        return copy.deepcopy(self.metadata.manifest)

    def _checksum_table(self, storage: StoragePlugin, event_loop):
        if knobs.is_checksums_disabled():
            return None
        return load_checksum_tables(self.metadata.world_size, storage, event_loop)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------

    def restore(self, app_state: AppState) -> None:
        """In-place restore of every stateful in ``app_state``. Each rank
        sees the replicated entries and its own per-rank ones; a
        snapshot taken by another number of ranks restores as long as
        every per-rank entry a rank asks for exists under its rank."""
        _validate_app_state(app_state)
        pg_wrapper = PGWrapper(self._pg_arg)
        rank = pg_wrapper.get_rank()
        restore_nonce = None
        fanout_agreed = False
        if pg_wrapper.get_world_size() > 1:
            # One agreement before any failure point: the nonce of the
            # error-propagating key barriers, and rank 0's fan-out knob.
            restore_nonce, fanout_agreed = pg_wrapper.broadcast_object(
                (uuid.uuid4().hex, knobs.is_fanout_restore_enabled())
            )

        def key_barrier(i: int) -> Optional[StoreBarrier]:
            if restore_nonce is None:
                return None
            return _nonce_barrier(f"__restore/{restore_nonce}/{i}", pg_wrapper)

        counter_baseline = telemetry.metrics().counters_snapshot()
        tunables = knobs.tunable_snapshot()
        recorder = _trace_recorder()
        trace_mark = recorder.mark()
        restore_span = recorder.begin(telemetry.names.SPAN_RESTORE, path=self.path, rank=rank)
        tracker = _progress.track("restore", self.path, rank)
        op_error: Optional[BaseException] = None
        # The cold start: the envelope's work before the first storage
        # byte can move, by cause (the report's ``cold_start``).
        cold_start: Dict[str, float] = {}
        cold_t = time.monotonic()
        event_loop = asyncio.new_event_loop()
        cold_start["event_loop_s"] = time.monotonic() - cold_t
        peer_ctx = None
        try:
            cold_t = time.monotonic()
            storage = url_to_storage_plugin(self.path)
            cold_start["plugin_open_s"] = time.monotonic() - cold_t
            cold_t = time.monotonic()
            _alg_available("crc32c")  # the first call loads the native library
            cold_start["native_load_s"] = time.monotonic() - cold_t
            # The peer ladder wraps the plugin before fan-out is built
            # (the JAX order): a fan-out owner's reads go through it too.
            # Its build is rank-local (inventory RPCs, no collective), so
            # ranks that build it or not cannot diverge the schedule.
            from .tiered import peer as peer_tier

            peer_ctx = peer_tier.build_restore_context(self.path)
            if peer_ctx is not None:
                storage = peer_ctx.wrap(storage)
            # Collectives first, storage reads second: a rank failing in
            # its setup reads reports into key barrier 0, where the peers
            # wait next.
            rng = _pop_rng_state(app_state)
            keys = _gather_keys(app_state, pg_wrapper)
            budget = get_process_memory_budget_bytes(pg_wrapper)
            fanout_ctx = None
            pipelines: List[dict] = []
            bytes_needed = 0
            with _reporting_to(key_barrier(0) if keys else None, "restore setup"):
                available = get_manifest_for_rank(self.metadata, rank)
                checksum_table = self._checksum_table(storage, event_loop)
                # The owner table comes from the committed manifest, the
                # same bytes on every rank: no collective.
                if fanout_agreed:
                    fanout_ctx = _build_fanout(self.metadata.manifest, pg_wrapper)
                    if fanout_ctx is not None:
                        fanout_ctx.checksum_table = checksum_table
            for i, key in enumerate(keys):
                barrier = key_barrier(i)
                with _reporting_to(barrier, "restore"):
                    # Plan first, so that the fan-out round (which every
                    # rank runs, plan or no plan, in the key order) knows
                    # this rank's byte windows. Its waits poll this key
                    # barrier's error key. The RNG state is restored
                    # last, below.
                    plan = None
                    if key in app_state and (rng is None or key != rng[0]):
                        plan = _plan_stateful_load(
                            key, app_state[key], available, DeviceCopier(), budget=budget
                        )
                    round_locs: List[str] = []
                    if fanout_ctx is not None:
                        round_locs = fanout_ctx.exchange(
                            plan.read_reqs if plan is not None else [], storage, event_loop,
                            rendezvous_prefix=f"__restore/{restore_nonce}/{i}",
                        )
                    try:
                        if plan is not None:
                            bytes_needed += _needed_bytes(plan.read_reqs)
                            pipelines.append(_execute_load_plan(
                                plan, fanout_ctx.wrap(storage) if fanout_ctx is not None else storage,
                                budget, rank, event_loop, checksum_table, tracker,
                            ))
                    finally:
                        if fanout_ctx is not None:
                            fanout_ctx.drop(round_locs)
                if barrier is not None:
                    barrier.arrive()
                    barrier.depart()
            if rng is not None:
                # Outside the key rounds: no fan-out.
                plan = _plan_stateful_load(rng[0], rng[1], available, DeviceCopier(), budget=budget)
                if plan is not None:
                    bytes_needed += _needed_bytes(plan.read_reqs)
                    pipelines.append(_execute_load_plan(
                        plan, storage, budget, rank, event_loop, checksum_table, tracker
                    ))
            event_loop.run_until_complete(storage.close())
            self.restore_telemetry = _restore_telemetry(pipelines, fanout_ctx, peer_ctx)
            recorder.end(restore_span)
            pipeline = _restore_pipeline(pipelines, self.restore_telemetry, bytes_needed)
            # Parts rounded before the sum, so that the total matches the
            # serialized parts.
            pipeline["cold_start"] = {k: round(v, 6) for k, v in cold_start.items()}
            pipeline["cold_start_s"] = round(sum(pipeline["cold_start"].values()), 6)
            _emit_snapshot_report(
                "restore", self.path, pg_wrapper, pipeline, counter_baseline, restore_nonce,
                trace_mark=trace_mark, tunables=tunables,
            )
        except BaseException as e:
            op_error = e
            raise
        finally:
            tracker.finish(op_error)
            if peer_ctx is not None:
                peer_ctx.close()
            recorder.end(restore_span)  # a no-op once closed
            event_loop.close()

    def async_restore(self, app_state: AppState) -> "PendingRestore":
        """Restore whose reads and host-to-device copies run on a
        background thread; :meth:`PendingRestore.wait` applies the state
        dicts. The state dicts are captured and the reads planned here, on
        the calling thread (with every collective), into fresh host
        buffers and fresh device tensors: until ``wait()`` returns the
        live leaves are untouched, and ``wait()`` re-raises a background
        failure before applying anything. Meanwhile the caller may
        compute, e.g. a forward pass::

            pending = Snapshot(path).async_restore(app_state)
            warm_up(model)    # overlaps the reads
            pending.wait()    # applies
        """
        _validate_app_state(app_state)
        pg_wrapper = PGWrapper(self._pg_arg)
        rank = pg_wrapper.get_rank()
        trace_mark = _trace_recorder().mark()
        budget = get_process_memory_budget_bytes(pg_wrapper)
        rng = _pop_rng_state(app_state)
        keys = _gather_keys(app_state, pg_wrapper)
        restore_nonce = None
        fanout_agreed = False
        if pg_wrapper.get_world_size() > 1:
            restore_nonce, fanout_agreed = pg_wrapper.broadcast_object(
                (uuid.uuid4().hex, knobs.is_fanout_restore_enabled())
            )

        def plan_barrier(i: int) -> Optional[StoreBarrier]:
            if restore_nonce is None:
                return None
            return _nonce_barrier(f"__restore/{restore_nonce}/plan{i}", pg_wrapper)

        with _reporting_to(plan_barrier(0) if keys else None, "async restore setup"):
            available = get_manifest_for_rank(self.metadata, rank)
        copier = DeviceCopier()
        plans: Dict[str, _StatefulLoadPlan] = {}
        for i, key in enumerate(keys):
            barrier = plan_barrier(i)
            with _reporting_to(barrier, "async restore planning"):
                if key in app_state:
                    plan = _plan_stateful_load(
                        key, app_state[key], available, copier, fresh=True, budget=budget
                    )
                    if plan is not None:
                        plans[key] = plan
            if barrier is not None:
                barrier.arrive()
                barrier.depart()
        fanout_ctx = None
        if fanout_agreed:
            # The exchange is a rendezvous, so it runs here, on the calling
            # thread, once every plan exists: one round for all plans. The
            # owners' reads land in this span; the background pipeline then
            # reads the exchanged blobs from the cache.
            exchange_prefix = f"__restore/{restore_nonce}/fanout"
            with _reporting_to(_nonce_barrier(exchange_prefix, pg_wrapper), "fan-out exchange"):
                fanout_ctx = _build_fanout(self.metadata.manifest, pg_wrapper)
                if fanout_ctx is not None:
                    exchange_loop = asyncio.new_event_loop()
                    try:
                        exchange_storage = url_to_storage_plugin(self.path)
                        try:
                            fanout_ctx.checksum_table = self._checksum_table(
                                exchange_storage, exchange_loop
                            )
                            fanout_ctx.exchange(
                                [r for plan in plans.values() for r in plan.read_reqs],
                                exchange_storage, exchange_loop,
                                rendezvous_prefix=exchange_prefix,
                            )
                        finally:
                            exchange_loop.run_until_complete(exchange_storage.close())
                    finally:
                        exchange_loop.close()
        # The peer ladder's owner table is built here, on the calling
        # thread (inventory RPCs only); the background pipeline pulls
        # through it, beneath the fan-out cache (the JAX order).
        from .tiered import peer as peer_tier

        return PendingRestore(
            self.path, keys, plans, copier, pg_wrapper, budget, self.metadata.world_size,
            rng[0] if rng is not None else None, restore_nonce, fanout_ctx,
            peer_tier.build_restore_context(self.path),
            counter_baseline=telemetry.metrics().counters_snapshot(),
            trace_mark=trace_mark,
            tunables=knobs.tunable_snapshot(),
        )

    # ------------------------------------------------------------------
    # read_object
    # ------------------------------------------------------------------

    def read_object(
        self,
        path: str,
        obj_out: Optional[Any] = None,
        memory_budget_bytes: Optional[int] = None,
        sharding: Optional[Any] = None,
    ) -> Any:
        """Random access to one object by manifest path
        ``"RANK/STATEFUL/KEY..."``, of any rank (no collective: any
        process may read any rank's entries, at any world size). An array
        entry (dense or sharded) comes back as a CPU tensor, or is restored
        in place into ``obj_out`` (a tensor on the CPU or the card, or a
        ``DTensor``) and returns it. ``sharding`` (a ``(DeviceMesh,
        placements)`` pair, or a ``DTensor`` whose mesh and placements
        serve as the template) returns a new ``DTensor`` under that layout,
        reading only the saved bytes that overlap this rank's box; it is
        exclusive with ``obj_out``."""
        if sharding is not None and obj_out is not None:
            raise ValueError(
                "read_object: pass either obj_out (in-place restore into your tensor) or "
                "sharding (a new DTensor under a target layout), not both"
            )
        rank_str, _, logical_path = path.partition("/")
        try:
            rank = int(rank_str)
        except ValueError:
            raise ValueError(f"read_object path must start with a rank (got {path!r})") from None
        available = get_manifest_for_rank(self.metadata, rank)
        if logical_path not in available:
            raise ValueError(
                f"{logical_path!r} is not a valid entry for rank {rank} "
                f"(candidates: {sorted(available)[:20]}...)"
            )
        entry = available[logical_path]
        if isinstance(entry, PrimitiveEntry):
            return entry.get_value()
        if is_container_entry(entry):
            raise ValueError(f"{logical_path!r} is a container; read leaf paths instead")

        result: Dict[str, Any] = {}
        copier = DeviceCopier()
        target: Optional[torch.Tensor] = None
        place: Optional[Callable[[_PlacementBatch], Any]] = None
        if isinstance(entry, ObjectEntry):
            read_reqs = prepare_read(entry, callback=lambda o: result.__setitem__("v", o))
        elif isinstance(entry, ShardedArrayEntry) or sharding is not None or is_dtensor(obj_out):
            sharded = ShardedArrayIOPreparer.prepare_read_into(
                entry, obj_out, buffer_size_limit_bytes=memory_budget_bytes, target=sharding
            )
            read_reqs, place = sharded.reqs, sharded.place
        else:
            dst, value, target, owned = _restore_destination(entry, obj_out)
            read_reqs = prepare_read(
                entry, obj_out=dst, buffer_size_limit_bytes=memory_budget_bytes,
                dest_owned=owned,
            )
            result["v"] = value
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(self.path)
            sync_execute_read_reqs(
                read_reqs=_batch_reads(read_reqs),
                storage=storage,
                memory_budget_bytes=memory_budget_bytes or get_process_memory_budget_bytes(),
                rank=rank,
                event_loop=event_loop,
                checksum_table=self._checksum_table(storage, event_loop),
            )
            event_loop.run_until_complete(storage.close())
        finally:
            event_loop.close()
        if target is not None:
            copier.to_device(target, dst)
            copier.synchronize()
        if place is not None:
            batch = _PlacementBatch(copier)
            result["v"] = place(batch)
            batch.run()
            copier.synchronize()
        return result["v"]


def _write_checksum_table(
    pending: "PendingIOWork | DeferredIOWork",
    rank: int,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    """After this rank's writes: its checksum table, before the commit
    barrier, so that a committed snapshot always has complete tables."""
    if pending.checksum_finalizer is not None:
        pending.checksum_finalizer()
    if pending.checksums:
        sync_write_checksum_table(pending.checksums, rank, storage, event_loop)


def _write_snapshot_metadata(
    metadata: SnapshotMetadata,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    """The commit marker (rank 0, after every rank's blobs are durable).
    A CAS take first folds every rank's chunk map into the manifest."""
    from .cas import maybe_rewrite_manifest

    event_loop.run_until_complete(maybe_rewrite_manifest(metadata, storage))
    # The kill points around the commit write: before it the step must
    # read as never taken, after it as committed (whether or not the
    # index, the mirror or the peer tier ever ran).
    crashpoint(metric_names.CRASH_PRE_COMMIT_MARKER)
    event_loop.run_until_complete(
        storage.write(
            WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=metadata.to_json().encode("utf-8"))
        )
    )
    crashpoint(metric_names.CRASH_COMMIT_MARKER)


def _post_commit(path: str, pending: "PendingIOWork | DeferredIOWork") -> None:
    """Every rank, after the commit: queue this rank's written blobs, with
    the checksum entries the pipeline computed, for its ring neighbour's
    host RAM (``tiered/peer.py``). Inert unless the tier is configured; a
    failure degrades the tier and never fails the take. The kill point
    fires after the enqueue, not after the push settles."""
    try:
        from .tiered import peer as peer_tier

        peer_tier.maybe_enqueue_push(path, pending.checksums or {})
    except Exception as e:  # noqa: BLE001 - the peer tier must never fail a take
        logger.warning("peer tier: post-commit push hook failed: %r", e)
    crashpoint(metric_names.CRASH_PEER_ENQUEUED)


def _gather_keys(app_state: AppState, pg_wrapper: PGWrapper) -> List[str]:
    """Sorted union of the app-state keys of every rank: the schedule of
    the per-key barriers, identical on every rank (never reordered by a
    rank-local fact such as which key holds the RNG state)."""
    gathered = pg_wrapper.all_gather_object(list(app_state.keys()))
    return sorted({k for ks in gathered for k in ks})


def _coalesce_replicated(replicated: List[str], pg_wrapper: PGWrapper) -> List[str]:
    """Intersection of the replication globs of every rank: a path is
    replicated only if every rank declared it."""
    if pg_wrapper.get_world_size() == 1:
        return list(replicated)
    gathered = pg_wrapper.all_gather_object(sorted(replicated))
    common = set(gathered[0])
    for patterns in gathered[1:]:
        common &= set(patterns)
    return sorted(common)


def _infer_replicated_paths(flattened: Dict[str, Any]) -> Set[str]:
    """Leaves replicated by their own declaration: ``DTensor``s fully
    replicated over a mesh of more than one device (the JAX package's rule
    for a ``jax.Array``). At world size 1 the snapshot holds one value, so
    marking it replicated only widens where it restores; at world size > 1
    the JAX rule asks that the devices span more than one process, which a
    torch mesh of more than one device always does (a rank is one device).
    A plain tensor declares nothing and is never inferred, as a
    single-device ``jax.Array`` is not. So, unlike the JAX rule, this one
    needs no world size."""
    inferred: Set[str] = set()
    for path, leaf in flattened.items():
        if not is_dtensor(leaf) or leaf.device_mesh.size() <= 1:
            continue
        spec = placement_spec(leaf.placements, leaf.ndim)
        if all(p[0] == "replicate" for p in spec):
            inferred.add(path)
    return inferred


def _calculate_replicated_entries(
    flattened: Dict[str, Any],
    patterns: List[str],
    pg_wrapper: PGWrapper,
    inferred: Optional[Set[str]] = None,
) -> Set[str]:
    """The paths the globs match, plus the ``inferred`` ones, on every
    rank; rank 0 decides and everyone follows. A sharded ``DTensor`` is
    written by its boxes whatever the globs say (its entry carries no
    replicated flag, as in the JAX package)."""
    matched = {
        path
        for path, leaf in flattened.items()
        if any(fnmatch.fnmatch(path, p) for p in patterns) and not is_sharded_dtensor(leaf)
    }
    if inferred:
        matched |= inferred & set(flattened)
    if pg_wrapper.get_world_size() == 1:
        return matched
    all_matched = pg_wrapper.gather_object(sorted(matched))
    common: List[str] = []
    if all_matched is not None:
        common_set: Set[str] = set(all_matched[0])
        for paths in all_matched[1:]:
            common_set &= set(paths)
        common = sorted(common_set)
    return set(pg_wrapper.broadcast_object(common))


def _gather_manifest(rank_manifest: Manifest, pg_wrapper: PGWrapper) -> Optional[Manifest]:
    """Gather the per-rank manifests to rank 0 and merge them into the
    global ``{rank}/{path}`` manifest there; None on every other rank.
    Replicated entries are consolidated across ranks and kept under rank
    0 only."""
    gathered = pg_wrapper.gather_object(rank_manifest)
    if gathered is None:
        return None
    merged_replicated: Manifest = {}
    if pg_wrapper.get_world_size() > 1:
        from .partitioner import consolidate_replicated_entries

        merged_replicated = consolidate_replicated_entries(gathered)
    global_manifest: Manifest = {}
    for rnk, manifest in enumerate(gathered):
        for logical_path, entry in manifest.items():
            if is_replicated(entry) and not is_container_entry(entry):
                if rnk > 0:
                    continue
                entry = merged_replicated.get(logical_path, entry)
            global_manifest[f"{rnk}/{logical_path}"] = entry
    return global_manifest


# ---------------------------------------------------------------------------
# Restore plans and streaming placement
# ---------------------------------------------------------------------------


class _PlacementBatch:
    """Placements of leaves whose reads landed, issued together: the
    host-to-device copy of each CUDA leaf on the copy streams (a CPU leaf's
    host buffer is its value and needs none). ``put`` registers one,
    ``run`` issues them."""

    def __init__(self, copier: DeviceCopier) -> None:
        self._copier = copier
        self._values: List[torch.Tensor] = []
        self._targets: List[Optional[torch.Tensor]] = []

    def put(self, host: torch.Tensor, target: Optional[torch.Tensor]) -> None:
        self._values.append(host)
        self._targets.append(target)

    def run(self) -> None:
        for host, target in zip(self._values, self._targets):
            if target is not None:
                self._copier.to_device(target, host)
        self._values, self._targets = [], []


class _LeafGroup:
    """One leaf's read requests and its placement; ``done`` once placed
    (streamed or in the final batch), so it never runs twice."""

    __slots__ = ("reqs", "fn", "nbytes", "remaining", "done")

    def __init__(self, reqs: List[ReadReq], fn: Callable[[_PlacementBatch], None]) -> None:
        self.reqs = reqs
        self.fn = fn
        self.nbytes = sum(r.buffer_consumer.get_consuming_cost_bytes() for r in reqs)
        self.remaining = len(reqs)
        self.done = False


class _StatefulLoadPlan:
    """Planned restore of one stateful: read requests, the leaves'
    placements, and what ``apply`` hands to ``load_state_dict``."""

    def __init__(
        self,
        key: str,
        stateful: Stateful,
        container_entries: Manifest,
        restored: Dict[str, Any],
        groups: List[_LeafGroup],
        read_reqs: List[ReadReq],
        copier: DeviceCopier,
    ) -> None:
        self.key = key
        self.stateful = stateful
        self.container_entries = container_entries
        self.restored = restored
        self.groups = groups
        self.read_reqs = read_reqs
        self.copier = copier

    def finish_reads(self, batch: Optional[_PlacementBatch] = None) -> None:
        """Place the leaves not already streamed. With a shared ``batch``
        the placements only register (the caller runs it); without one a
        local batch runs at once."""
        own = batch is None
        if batch is None:
            batch = _PlacementBatch(self.copier)
        for group in self.groups:
            if not group.done:
                group.fn(batch)
                group.done = True
        if own:
            batch.run()

    def apply(self) -> None:
        """Wait for the copies to the card, then hand the restored state
        dict to the stateful (user code: calling thread only)."""
        self.copier.synchronize()
        state_dict = inflate(dict(self.container_entries), self.restored, prefix=self.key)
        self.stateful.load_state_dict(state_dict)


class _StreamingPlacer:
    """Rolling placement: a leaf is placed as soon as all its reads
    landed, batched per ~``flush_bytes`` of restored data, so the copies of
    early leaves to the card hide behind the remaining reads.
    ``flush_bytes <= 0`` places everything in the caller's final batch.
    Runs on the read pipeline's event-loop thread."""

    def __init__(self, flush_bytes: Optional[int] = None) -> None:
        self.flush_bytes = (
            knobs.get_restore_placement_flush_bytes() if flush_bytes is None else flush_bytes
        )
        self._by_req: Dict[int, _LeafGroup] = {}
        self._pending: List[_LeafGroup] = []
        self._pending_bytes = 0
        self._copier: Optional[DeviceCopier] = None

    def register_plan(self, plan: _StatefulLoadPlan) -> None:
        if self.flush_bytes <= 0:
            return
        self._copier = plan.copier
        for group in plan.groups:
            if group.remaining == 0:
                self._ready(group)
            else:
                for req in group.reqs:
                    self._by_req[id(req)] = group

    def on_req_complete(self, req: ReadReq) -> None:
        group = self._by_req.pop(id(req), None)
        if group is None:
            return
        group.remaining -= 1
        if group.remaining == 0:
            self._ready(group)

    def _ready(self, group: _LeafGroup) -> None:
        self._pending.append(group)
        self._pending_bytes += group.nbytes
        if self._pending_bytes >= self.flush_bytes:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        batch = _PlacementBatch(self._copier)
        for group in self._pending:
            group.fn(batch)
            group.done = True
        self._pending = []
        self._pending_bytes = 0
        batch.run()


def _batch_reads(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Ranged reads of one slab merge into one spanning read when batching
    is on (``batcher.batch_read_requests``)."""
    if not knobs.is_batching_enabled():
        return read_reqs
    from .batcher import batch_read_requests

    return batch_read_requests(read_reqs)


def _execute_load_plan(
    plan: "_StatefulLoadPlan",
    storage: StoragePlugin,
    budget: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    checksum_table,
    progress_tracker: Optional[_progress.ProgressTracker] = None,
) -> dict:
    """Run one planned stateful load's read pipeline, placing leaves as
    their reads land, then apply it. Returns the pipeline's telemetry."""
    placer = _StreamingPlacer()
    placer.register_plan(plan)
    pipeline = sync_execute_read_reqs(
        read_reqs=_batch_reads(plan.read_reqs),
        storage=storage,
        memory_budget_bytes=budget,
        rank=rank,
        event_loop=event_loop,
        checksum_table=checksum_table,
        on_req_complete=placer.on_req_complete,
        progress=progress_tracker,
    )
    placer.flush()
    plan.finish_reads()
    plan.apply()
    return pipeline


def _plan_stateful_load(
    key: str,
    stateful: Stateful,
    available: Manifest,
    copier: DeviceCopier,
    fresh: bool = False,
    budget: Optional[int] = None,
) -> Optional[_StatefulLoadPlan]:
    """Plan one stateful's restore. Its current leaves are the read
    destinations (restore needs no second copy of the state), or with
    ``fresh`` the templates of new buffers that absorb the reads (async
    restore: the live leaves stay untouched until apply). A sharded entry,
    or any array entry restored into a ``DTensor``, reads the saved boxes
    that overlap this rank's box, in row bands of at most ``budget``
    bytes."""
    encoded_key = _encode(key)
    entries = {
        path: entry
        for path, entry in available.items()
        if path == encoded_key or path.startswith(encoded_key + "/")
    }
    if not entries:
        logger.warning("No entries found for stateful %r; skipping", key)
        return None
    _, current = flatten(stateful.state_dict(), prefix=key)
    restored: Dict[str, Any] = {}
    container_entries: Manifest = {}
    read_reqs: List[ReadReq] = []
    groups: List[_LeafGroup] = []
    for path, entry in entries.items():
        if is_container_entry(entry):
            container_entries[path] = entry
        elif isinstance(entry, PrimitiveEntry):
            restored[path] = entry.get_value()
        elif isinstance(entry, ObjectEntry):
            read_reqs.extend(
                prepare_read(entry, callback=lambda o, p=path: restored.__setitem__(p, o))
            )
        elif isinstance(entry, ShardedArrayEntry) or is_dtensor(current.get(path)):
            sharded = ShardedArrayIOPreparer.prepare_read_into(
                entry, current.get(path), buffer_size_limit_bytes=budget, fresh=fresh
            )
            read_reqs.extend(sharded.reqs)

            def _place_sharded(batch: _PlacementBatch, p=path, place=sharded.place) -> None:
                restored[p] = place(batch)

            groups.append(_LeafGroup(sharded.reqs, _place_sharded))
            if sharded.device_target is not None and fresh:
                copier.mark_ready(sharded.device_target.device)
        elif isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
            dst, value, target, owned = _restore_destination(entry, current.get(path), fresh)
            reqs = prepare_read(entry, obj_out=dst, dest_owned=owned)
            read_reqs.extend(reqs)

            def _place(batch: _PlacementBatch, p=path, dst=dst, value=value, target=target) -> None:
                batch.put(dst, target)
                restored[p] = value

            groups.append(_LeafGroup(reqs, _place))
            if target is not None and fresh:
                # The caching allocator handed out the fresh tensor on the
                # caller's stream, where kernels may still read its old
                # tenant: copies from the background thread wait for this
                # point of that stream.
                copier.mark_ready(target.device)
        else:
            read_reqs.extend(prepare_read(entry))  # raises: an unknown entry type
    return _StatefulLoadPlan(key, stateful, container_entries, restored, groups, read_reqs, copier)


def _restore_destination(
    entry: "ArrayEntry | ChunkedArrayEntry", current: Any, fresh: bool = False
) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor], bool]:
    """The host read destination of a dense entry: ``(dst, value, target,
    owned)``. ``value`` is what the restored state dict holds; ``target``
    (or None) the CUDA tensor that ``dst`` is copied into once its reads
    landed; ``owned`` whether ``dst`` is a fresh buffer that storage may
    read into directly (a live CPU tensor keeps copy-on-success semantics,
    so a failed read cannot tear it). ``fresh`` never reads into or copies
    into a live leaf."""
    shape = [int(d) for d in entry.shape]
    if isinstance(current, torch.Tensor) and current.layout == torch.strided:
        matches = list(current.shape) == shape and (
            current.dtype in DTYPE_TO_STRING and dtype_to_string(current.dtype) == entry.dtype
        )
        if matches and current.device.type == "cpu" and not fresh:
            return current.detach(), current, None, False
        if matches and current.device.type == "cuda":
            host = empty_tensor(shape, entry.dtype, pin_memory=True)
            if fresh:
                out = torch.empty(shape, dtype=host.dtype, device=current.device)
                return host, out, out, True
            return host, current, current.detach(), True
        if not matches:
            logger.warning(
                "Restoring %s %s over a current leaf of %s %s; the checkpointed "
                "value replaces the leaf",
                entry.dtype, shape, current.dtype, list(current.shape),
            )
        if current.device.type == "cuda":
            host = empty_tensor(shape, entry.dtype, pin_memory=True)
            out = torch.empty(shape, dtype=host.dtype, device=current.device)
            return host, out, out, True
    if (
        not fresh
        and isinstance(current, np.ndarray)
        and current.flags.c_contiguous
        and current.flags.writeable
        and current.dtype.name == entry.dtype
        and list(current.shape) == shape
    ):
        return tensor_from_numpy(current), current, None, False
    dst = empty_tensor(shape, entry.dtype)
    return dst, dst, None, True


# ---------------------------------------------------------------------------
# PendingSnapshot / PendingRestore
# ---------------------------------------------------------------------------


class PendingSnapshot:
    """Handle on an in-flight async snapshot. A background thread drains
    staging (for device-snapshot takes) and the writes, writes this rank's
    checksum table, and meets its peers at the store barrier, after which
    rank 0 writes the commit marker; a failure on any rank re-raises in
    every rank's ``wait()`` and leaves no commit marker.

    Phases, in seconds since ``async_take`` was called: ``visible_s``
    (the call's own span, over when this handle exists), ``staged_s``
    (the bytes left the card: ``wait(phase="staged")``) and
    ``committed_s`` (``wait()``), each None until reached."""

    def __init__(
        self,
        path: str,
        pending_io_work: "PendingIOWork | DeferredIOWork",
        pg_wrapper: PGWrapper,
        metadata: Optional[SnapshotMetadata],
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        op_begin: float,
        commit_nonce: str = "",
        counter_baseline: Optional[Dict[str, float]] = None,
        trace_mark: Optional[TraceMark] = None,
        progress_tracker: Optional[_progress.ProgressTracker] = None,
        tunables: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self.pg = pg_wrapper
        self.commit_nonce = commit_nonce
        self._counter_baseline = counter_baseline or {}
        self._trace_mark = trace_mark
        self._progress_tracker = progress_tracker
        self._tunables = tunables
        self._metadata = metadata
        self._storage = storage
        self._event_loop = event_loop
        self._pending_io_work = pending_io_work
        self._exc_info: Optional[BaseException] = None
        self._done = threading.Event()
        self._staged = threading.Event()
        self._op_begin = op_begin
        self.visible_s: float = time.monotonic() - op_begin
        self.staged_s: Optional[float] = None
        self.committed_s: Optional[float] = None
        if isinstance(pending_io_work, DeferredIOWork):
            # Wired before the thread starts: the drain may reach the
            # staged point at once.
            pending_io_work.on_staged = self._mark_staged
        else:
            self.staged_s = self.visible_s
            self._staged.set()
        self._thread = threading.Thread(
            target=self._complete_snapshot, name="snapshot-commit", daemon=True
        )
        self._thread.start()

    def _mark_staged(self) -> None:
        self.staged_s = time.monotonic() - self._op_begin
        self._staged.set()

    def _complete_snapshot(self) -> None:
        rank = self.pg.get_rank()
        barrier = None
        recorder = _trace_recorder()
        commit_span = recorder.begin(telemetry.names.SPAN_ASYNC_TAKE_COMMIT, path=self.path, rank=rank)
        try:
            barrier = _nonce_barrier(f"__snapshot_commit/{self.commit_nonce}", self.pg)
            self._pending_io_work.sync_complete(self._event_loop)
            crashpoint(metric_names.CRASH_TAKE_WRITES_DONE)
            _write_checksum_table(self._pending_io_work, rank, self._storage, self._event_loop)
            crashpoint(metric_names.CRASH_CHECKSUM_TABLE_WRITTEN)
            _maybe_write_cas_map(self._storage, rank, self._event_loop)
            crashpoint(metric_names.CRASH_CAS_MAP_WRITTEN)
            # The store barrier, not a collective: safe on this thread.
            if barrier is not None:
                barrier.arrive()
            if rank == 0:
                _write_snapshot_metadata(self._metadata, self._storage, self._event_loop)
            if barrier is not None:
                barrier.depart()
            # The enqueue is a queue put: the push runs on the peer
            # replicator's own worker, not on this commit thread.
            _post_commit(self.path, self._pending_io_work)
            self._event_loop.run_until_complete(self._storage.close())
            self.committed_s = time.monotonic() - self._op_begin
            recorder.end(commit_span)
            # Store gather and file appends only: safe on this thread. The
            # pipeline carries the visible / staged split.
            pipeline = dict(self._pending_io_work.pipeline_telemetry())
            pipeline["visible_s"] = round(self.visible_s, 6)
            if self.staged_s is not None:
                pipeline["staged_s"] = round(self.staged_s, 6)
            _emit_snapshot_report(
                "async_take", self.path, self.pg, pipeline, self._counter_baseline,
                self.commit_nonce, trace_mark=self._trace_mark, tunables=self._tunables,
            )
        except BaseException as e:  # noqa: BLE001 - must propagate via wait()
            # Recorded before the peers are told: report_error talks to the
            # store and may fail itself, but wait() must still raise.
            self._exc_info = e
            logger.error("Async snapshot failed: %r", e)
            if barrier is not None:
                try:
                    barrier.report_error(e)
                except Exception as report_exc:  # noqa: BLE001
                    logger.error("Failed to report snapshot error to peers: %r", report_exc)
        finally:
            # The heartbeat settles (terminal on a failure) and the error
            # is recorded before any waiter wakes.
            if self._progress_tracker is not None:
                self._progress_tracker.finish(self._exc_info)
            recorder.end(commit_span)  # a no-op once closed
            self._event_loop.close()
            self._staged.set()
            self._done.set()

    def wait(self, phase: str = "committed") -> Optional[Snapshot]:
        """Block until the snapshot reaches ``phase``:

        - ``"staged"``: the device-to-host copies and serialization
          finished; returns None (nothing is committed yet);
        - ``"committed"`` (default): every rank's writes are durable and
          the commit marker exists; returns the :class:`Snapshot` (with
          this take's process group).

        A background failure re-raises here, on every call that observes
        it, in either phase."""
        if phase not in ("staged", "committed"):
            raise ValueError(f'phase must be "staged" or "committed", got {phase!r}')
        if phase == "staged":
            self._staged.wait()
            if self._exc_info is not None:
                raise self._exc_info
            return None
        self._thread.join()
        if self._exc_info is not None:
            raise self._exc_info
        snapshot = Snapshot(path=self.path, pg=self.pg)
        snapshot._metadata = self._metadata
        return snapshot

    def done(self) -> bool:
        return self._done.is_set()

    def staged(self) -> bool:
        """True once staging finished (``wait(phase="staged")`` will not
        block); also after a failed drain, whose ``wait`` then raises."""
        return self._staged.is_set()


class PendingRestore:
    """Handle on an in-flight async restore. The background thread reads,
    verifies and places into fresh buffers, and runs no collective;
    ``wait()`` joins it, re-raises a failure before touching the
    application's state (reporting it to the peers), then applies the
    state dicts on the calling thread in the sorted key order, a barrier
    apart, and the RNG state last."""

    def __init__(
        self,
        path: str,
        keys: List[str],
        plans: Dict[str, _StatefulLoadPlan],
        copier: DeviceCopier,
        pg_wrapper: PGWrapper,
        memory_budget_bytes: int,
        world_size: int,
        rng_key: Optional[str] = None,
        restore_nonce: Optional[str] = None,
        fanout_ctx=None,
        peer_ctx=None,
        counter_baseline: Optional[Dict[str, float]] = None,
        trace_mark: Optional[TraceMark] = None,
        tunables: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self._keys = keys
        self._plans = plans
        self._copier = copier
        self._pg = pg_wrapper
        self._rank = pg_wrapper.get_rank()
        self._world_size = world_size
        self._memory_budget_bytes = memory_budget_bytes
        self._rng_key = rng_key
        self._restore_nonce = restore_nonce
        # Filled by the calling thread's exchange; the background pipeline
        # serves the exchanged shard blobs from it (no rendezvous off the
        # calling thread: the bytes already moved).
        self._fanout_ctx = fanout_ctx
        self._peer_ctx = peer_ctx
        # This rank's byte accounting, once the reads finished.
        self.restore_telemetry: Optional[Dict[str, Any]] = None
        self._counter_baseline = counter_baseline or {}
        self._trace_mark = trace_mark
        self._tunables = tunables
        # Created here, fed and settled by the background read thread.
        self._progress_tracker = _progress.track("async_restore", path, self._rank)
        self._pipeline: Optional[dict] = None
        self._exc_info: Optional[BaseException] = None
        self._applied = False
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run_reads, name="restore-reads", daemon=True)
        self._thread.start()

    def _run_reads(self) -> None:
        event_loop = asyncio.new_event_loop()
        reads_span = _trace_recorder().begin(
            telemetry.names.SPAN_ASYNC_RESTORE_READS, path=self.path, rank=self._rank
        )
        try:
            storage = url_to_storage_plugin(self.path)
            if self._peer_ctx is not None:
                storage = self._peer_ctx.wrap(storage)
            checksum_table = None
            if not knobs.is_checksums_disabled():
                checksum_table = load_checksum_tables(self._world_size, storage, event_loop)
            # Streaming placement across every plan.
            placer = _StreamingPlacer()
            for plan in self._plans.values():
                placer.register_plan(plan)
            fanout_ctx = self._fanout_ctx
            read_reqs = [r for plan in self._plans.values() for r in plan.read_reqs]
            bytes_needed = _needed_bytes(read_reqs)
            pipeline = sync_execute_read_reqs(
                read_reqs=_batch_reads(read_reqs),
                storage=fanout_ctx.wrap(storage) if fanout_ctx is not None else storage,
                memory_budget_bytes=self._memory_budget_bytes,
                rank=self._rank,
                event_loop=event_loop,
                checksum_table=checksum_table,
                on_req_complete=placer.on_req_complete,
                progress=self._progress_tracker,
            )
            self.restore_telemetry = _restore_telemetry([pipeline], fanout_ctx, self._peer_ctx)
            self._pipeline = _restore_pipeline([pipeline], self.restore_telemetry, bytes_needed)
            placer.flush()
            # What did not stream places in one final batch.
            batch = _PlacementBatch(self._copier)
            for plan in self._plans.values():
                plan.finish_reads(batch)
            batch.run()
            event_loop.run_until_complete(storage.close())
        except BaseException as e:  # noqa: BLE001 - must propagate via wait()
            self._exc_info = e
            logger.error("Async restore failed: %r", e)
        finally:
            # The exchanged bytes go whether or not the reads succeeded,
            # and so do the peer connections.
            if self._fanout_ctx is not None:
                self._fanout_ctx.clear()
            if self._peer_ctx is not None:
                self._peer_ctx.close()
            self._progress_tracker.finish(self._exc_info)
            _trace_recorder().end(reads_span)
            event_loop.close()
            self._done.set()

    def _key_barrier(self, i: int) -> Optional[StoreBarrier]:
        if self._restore_nonce is None:
            return None
        return _nonce_barrier(f"__restore/{self._restore_nonce}/{i}", self._pg)

    def wait(self) -> None:
        """Block until the reads finished, then apply the state dicts (once;
        a second call is a no-op). Call it from the thread that called
        ``async_restore``: it holds the apply barriers, in the key order
        that every rank shares."""
        self._thread.join()
        if self._exc_info is not None:
            # Nothing was applied; the read buffers are useless. Peers
            # whose reads succeeded wait at the first apply barrier.
            self._plans = {}
            with _reporting_to(self._key_barrier(0) if self._keys else None, "restore reads"):
                raise self._exc_info
        if self._applied:
            return
        # One barrier per gathered key, plan or no plan: ranks may hold
        # plans for different keys. The RNG state applies after them all.
        for i, key in enumerate(self._keys):
            barrier = self._key_barrier(i)
            with _reporting_to(barrier, "restore apply"):
                plan = self._plans.get(key)
                if plan is not None and key != self._rng_key:
                    plan.apply()
            if barrier is not None:
                barrier.arrive()
                barrier.depart()
        rng_plan = self._plans.get(self._rng_key) if self._rng_key is not None else None
        if rng_plan is not None:
            rng_plan.apply()
        self._applied = True
        # A rank-local report (no nonce, so no gather): wait() runs when
        # the application says, and must add no rendezvous of its own.
        _emit_snapshot_report(
            "async_restore", self.path, self._pg, self._pipeline, self._counter_baseline,
            None, trace_mark=self._trace_mark, tunables=self._tunables,
        )
        # Release the state-sized buffers; the handle may outlive the restore.
        self._plans = {}

    def done(self) -> bool:
        """True once the background reads finished (``wait()`` will not
        block on them)."""
        return self._done.is_set()


def _validate_app_state(app_state: AppState) -> None:
    if not isinstance(app_state, dict):
        raise TypeError(f"app_state must be a Dict[str, Stateful], got {type(app_state)}")
    for key, value in app_state.items():
        if not isinstance(key, str):
            raise TypeError(f"app_state keys must be str, got {type(key)}")
        if not (hasattr(value, "state_dict") and hasattr(value, "load_state_dict")):
            raise TypeError(
                f"app_state[{key!r}] ({type(value)}) does not implement the "
                f"Stateful protocol (state_dict/load_state_dict). Wrap plain "
                f"trees of tensors in TensorTreeState."
            )


def _pop_rng_state(app_state: AppState) -> Optional[Tuple[str, RngState]]:
    """The one RngState of ``app_state`` (at most one is allowed)."""
    rng_items = [(k, v) for k, v in app_state.items() if isinstance(v, RngState)]
    if len(rng_items) > 1:
        raise RuntimeError(
            f"At most one RngState is allowed in app_state (found {[k for k, _ in rng_items]})"
        )
    return rng_items[0] if rng_items else None

