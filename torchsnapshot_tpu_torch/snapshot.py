"""The Snapshot user API: take / async_take / restore / async_restore /
read_object, for one process.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for ``pg=None``. Same
protocol:

- ``take``: flatten every stateful's state dict (the RNG state first),
  plan write requests, stage and write them under the host-memory budget,
  write the per-rank checksum table, then commit ``.snapshot_metadata``
  (JSON). A snapshot without the metadata file never happened, which is
  what makes an interrupted take safe. ``incremental_base=`` references
  the base's blobs for chunks whose digest did not change
  (``incremental.py``); ``record_digests=`` records digests so that the
  snapshot can serve as a base.
- ``async_take``: returns a :class:`PendingSnapshot` once a consistent copy
  of the state is pinned: on-device clones of the CUDA leaves, dispatched
  on the caller's current stream and not awaited, host copies of CPU
  leaves and pickles of objects. The device-to-host copies, writes and the
  commit run on a background thread; the caller may mutate the live
  state at once. ``wait(phase="staged")`` returns when the bytes have left
  the card, ``wait()`` when the snapshot is committed.
- ``restore``: in place, like torch's ``load_state_dict``. A CUDA leaf is
  read into a pinned host buffer and copied into the live tensor with
  ``copy_(non_blocking=True)`` on a side stream; leaves whose reads landed
  are placed together in rolling batches of
  ``TORCHSNAPSHOT_TPU_RESTORE_PLACEMENT_FLUSH_BYTES`` while the other reads
  are still in flight (streaming placement). The streams are synchronized
  before the stateful's own ``load_state_dict`` runs. A CPU leaf is read
  into directly. The RNG state is restored last.
- ``async_restore``: plans on the calling thread, reads and places on a
  background thread into fresh buffers (host and card), and applies the
  state dicts only in :meth:`PendingRestore.wait`: until then the live
  leaves are untouched, and a failed read leaves them as they were.
- ``read_object``: random access to one manifest path.

The snapshot format is the JAX package's: either package reads what the
other writes, digests included. Multi-process takes and the CAS, tiered,
peer, fan-out and batched branches of the JAX package are not part of
this package yet.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, telemetry
from .flatten import _encode, flatten, inflate
from .incremental import IncrementalTakeContext
from .integrity import load_checksum_tables, sync_write_checksum_table
from .io_preparer import DeviceCopier, capture_write_reqs, prepare_read, prepare_write
from .io_types import ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    SnapshotMetadata,
    get_manifest_for_rank,
    is_container_entry,
)
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
from .stateful import AppState, Stateful
from .storage_plugin import url_to_storage_plugin
from .telemetry.trace import get_recorder as _trace_recorder
from .version import __version__

logger: logging.Logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"


def _check_pg(pg: Optional[Any]) -> None:
    if pg is not None:
        raise NotImplementedError(
            "torchsnapshot_tpu_torch takes and restores in one process (pg=None); "
            "multi-process snapshots are not ported yet"
        )


class Snapshot:
    """A reference to an existing or to-be-created snapshot at ``path``."""

    def __init__(self, path: str, pg: Optional[Any] = None) -> None:
        _check_pg(pg)
        self.path = path
        self._metadata: Optional[SnapshotMetadata] = None

    # ------------------------------------------------------------------
    # take
    # ------------------------------------------------------------------

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[Any] = None,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
    ) -> "Snapshot":
        """Synchronous checkpoint of ``app_state`` to ``path``. Returns once
        every byte is in storage and the snapshot is committed; the caller
        must not mutate the state's tensors while it runs.

        ``incremental_base`` (a snapshot path or Snapshot) makes the take
        incremental: chunks whose digest matches the base's recorded one
        are neither copied to the host nor written, and the manifest
        references the base's blob. ``record_digests`` records digests
        without a base, so that this snapshot can serve as one."""
        _check_pg(pg)
        recorder = _trace_recorder()
        take_span = recorder.begin(telemetry.names.SPAN_TAKE, path=path, rank=0)
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(path)
            pending, metadata = cls._take_impl(
                path, app_state, storage, event_loop, is_async_snapshot=False,
                incremental_base=incremental_base, record_digests=record_digests,
            )
            pending.sync_complete(event_loop)
            _commit(pending, metadata, storage, event_loop)
            event_loop.run_until_complete(storage.close())
        finally:
            recorder.end(take_span)
            event_loop.close()
        snapshot = cls(path=path)
        snapshot._metadata = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        pg: Optional[Any] = None,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
    ) -> "PendingSnapshot":
        """Checkpoint whose visible span does not grow with the state's
        size: returns once a consistent copy is pinned (on-device clones of
        the CUDA leaves dispatched on the caller's current stream, host
        copies of CPU leaves, pickles of objects); the device-to-host
        copies, the writes and the commit run on a background thread
        through a pinned staging pool of a few slabs. The caller may mutate
        or free the live tensors as soon as this returns.

        ``TORCHSNAPSHOT_TPU_ASYNC_DEVICE_SNAPSHOT=0`` stages before
        returning instead (no device clone, no extra device memory).
        ``incremental_base`` / ``record_digests`` as in :meth:`take`."""
        op_begin = time.monotonic()
        _check_pg(pg)
        storage = url_to_storage_plugin(path)
        event_loop = asyncio.new_event_loop()
        try:
            with _trace_recorder().span(telemetry.names.SPAN_ASYNC_TAKE_STAGE, path=path, rank=0):
                pending, metadata = cls._take_impl(
                    path, app_state, storage, event_loop, is_async_snapshot=True,
                    incremental_base=incremental_base, record_digests=record_digests,
                    defer_staging=knobs.is_async_device_snapshot_enabled(),
                )
        except BaseException:
            # No background thread will close them.
            try:
                event_loop.run_until_complete(storage.close())
            except Exception:  # noqa: BLE001 - already failing
                pass
            event_loop.close()
            raise
        return PendingSnapshot(path, pending, metadata, storage, event_loop, op_begin)

    @classmethod
    def _take_impl(
        cls,
        path: str,
        app_state: AppState,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        is_async_snapshot: bool,
        incremental_base: Optional[Any] = None,
        record_digests: bool = False,
        defer_staging: bool = False,
    ) -> Tuple["PendingIOWork | DeferredIOWork", SnapshotMetadata]:
        """The take's plan and its staging. With ``defer_staging`` no
        staging runs here: the write plan's sources are captured and the
        returned :class:`DeferredIOWork` runs the whole pipeline later."""
        _validate_app_state(app_state)
        manifest, flattened = _flatten_app_state(app_state)
        incr_ctx = None
        if incremental_base is not None or record_digests:
            incr_ctx = IncrementalTakeContext.build(path, incremental_base)
            # Digests launch before any stager exists: skip decisions
            # precede the copies to the host.
            incr_ctx.launch(flattened)
        copier = DeviceCopier()
        write_reqs: List[WriteReq] = []
        for logical_path, leaf in flattened.items():
            entry, reqs = prepare_write(
                obj=leaf, logical_path=logical_path, rank=0, copier=copier,
                is_async_snapshot=is_async_snapshot,
                incremental=incr_ctx.plan_for(logical_path) if incr_ctx else None,
            )
            manifest[logical_path] = entry
            write_reqs.extend(reqs)
        metadata = SnapshotMetadata(
            version=__version__,
            world_size=1,
            manifest={f"0/{path}": entry for path, entry in manifest.items()},
        )
        budget = get_process_memory_budget_bytes()
        if defer_staging:
            with _trace_recorder().span(
                telemetry.names.SPAN_DEVICE_CAPTURE, rank=0, reqs=len(write_reqs)
            ):
                capture_write_reqs(write_reqs)
            pending: "PendingIOWork | DeferredIOWork" = DeferredIOWork(
                write_reqs, storage, budget, rank=0
            )
        else:
            pending = sync_execute_write_reqs(
                write_reqs=write_reqs, storage=storage, memory_budget_bytes=budget,
                rank=0, event_loop=event_loop,
            )
        if incr_ctx is not None:
            # Referenced blobs were not rewritten: their checksums come from
            # the base's table, read once the writes are done.
            pending.checksum_finalizer = lambda: incr_ctx.inherit_checksums(pending.checksums)
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
        """In-place restore of every stateful in ``app_state``."""
        _validate_app_state(app_state)
        recorder = _trace_recorder()
        restore_span = recorder.begin(telemetry.names.SPAN_RESTORE, path=self.path, rank=0)
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(self.path)
            available = get_manifest_for_rank(self.metadata, 0)
            checksum_table = self._checksum_table(storage, event_loop)
            budget = get_process_memory_budget_bytes()
            for key in _restore_order(app_state):
                plan = _plan_stateful_load(key, app_state[key], available, DeviceCopier())
                if plan is None:
                    continue
                placer = _StreamingPlacer()
                placer.register_plan(plan)
                sync_execute_read_reqs(
                    read_reqs=plan.read_reqs,
                    storage=storage,
                    memory_budget_bytes=budget,
                    rank=0,
                    event_loop=event_loop,
                    checksum_table=checksum_table,
                    on_req_complete=placer.on_req_complete,
                )
                placer.flush()
                plan.finish_reads()
                plan.apply()
            event_loop.run_until_complete(storage.close())
        finally:
            recorder.end(restore_span)
            event_loop.close()

    def async_restore(self, app_state: AppState) -> "PendingRestore":
        """Restore whose reads and host-to-device copies run on a
        background thread; :meth:`PendingRestore.wait` applies the state
        dicts. The state dicts are captured and the reads planned here, on
        the calling thread, into fresh host buffers and fresh device
        tensors: until ``wait()`` returns the live leaves are untouched, and
        ``wait()`` re-raises a background failure before applying anything.
        Meanwhile the caller may compute, e.g. a forward pass::

            pending = Snapshot(path).async_restore(app_state)
            warm_up(model)    # overlaps the reads
            pending.wait()    # applies
        """
        _validate_app_state(app_state)
        available = get_manifest_for_rank(self.metadata, 0)
        copier = DeviceCopier()
        plans: Dict[str, _StatefulLoadPlan] = {}
        for key in _restore_order(app_state):
            plan = _plan_stateful_load(key, app_state[key], available, copier, fresh=True)
            if plan is not None:
                plans[key] = plan
        return PendingRestore(
            self.path, plans, copier, self.metadata.world_size, get_process_memory_budget_bytes()
        )

    # ------------------------------------------------------------------
    # read_object
    # ------------------------------------------------------------------

    def read_object(
        self,
        path: str,
        obj_out: Optional[Any] = None,
        memory_budget_bytes: Optional[int] = None,
    ) -> Any:
        """Random access to one object by manifest path
        ``"RANK/STATEFUL/KEY..."``. A dense entry comes back as a CPU tensor,
        or is restored in place into ``obj_out`` (a tensor on the CPU or the
        card) and returns it."""
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
        if isinstance(entry, ObjectEntry):
            read_reqs = prepare_read(entry, callback=lambda o: result.__setitem__("v", o))
        elif isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
            dst, value, target, owned = _restore_destination(entry, obj_out)
            read_reqs = prepare_read(
                entry, obj_out=dst, buffer_size_limit_bytes=memory_budget_bytes,
                dest_owned=owned,
            )
            result["v"] = value
        else:
            read_reqs = prepare_read(entry)  # raises: entry type not ported yet
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(self.path)
            sync_execute_read_reqs(
                read_reqs=read_reqs,
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
        return result["v"]


def _commit(
    pending: "PendingIOWork | DeferredIOWork",
    metadata: SnapshotMetadata,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    """After the writes: the checksum table, then the commit marker. Every
    blob is durable before the marker exists."""
    if pending.checksum_finalizer is not None:
        pending.checksum_finalizer()
    if pending.checksums:
        sync_write_checksum_table(pending.checksums, 0, storage, event_loop)
    event_loop.run_until_complete(
        storage.write(
            WriteIO(path=SNAPSHOT_METADATA_FNAME, buf=metadata.to_json().encode("utf-8"))
        )
    )


def _flatten_app_state(app_state: AppState) -> Tuple[Manifest, Dict[str, Any]]:
    """Container entries and leaves of every stateful. RNG first: capturing
    other statefuls must not perturb what gets saved as the RNG state."""
    rng = _pop_rng_state(app_state)
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    if rng is not None:
        entries, leaves = flatten(rng[1].state_dict(), prefix=rng[0])
        manifest.update(entries)
        flattened.update(leaves)
    for key in sorted(app_state):
        if rng is not None and key == rng[0]:
            continue
        entries, leaves = flatten(app_state[key].state_dict(), prefix=key)
        manifest.update(entries)
        flattened.update(leaves)
    return manifest, flattened


def _restore_order(app_state: AppState) -> List[str]:
    """Sorted keys, the RNG state last: the other statefuls'
    ``load_state_dict`` side effects cannot disturb it."""
    rng = _pop_rng_state(app_state)
    keys = [k for k in sorted(app_state) if rng is None or k != rng[0]]
    if rng is not None:
        keys.append(rng[0])
    return keys


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


def _plan_stateful_load(
    key: str,
    stateful: Stateful,
    available: Manifest,
    copier: DeviceCopier,
    fresh: bool = False,
) -> Optional[_StatefulLoadPlan]:
    """Plan one stateful's restore. Its current leaves are the read
    destinations (restore needs no second copy of the state), or with
    ``fresh`` the templates of new buffers that absorb the reads (async
    restore: the live leaves stay untouched until apply)."""
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
            read_reqs.extend(prepare_read(entry))  # raises: entry type not ported yet
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
    staging (for device-snapshot takes) and the writes, then writes the
    checksum table and the commit marker; a failure re-raises in
    ``wait()`` and leaves no commit marker.

    Phases, in seconds since ``async_take`` was called: ``visible_s``
    (the call's own span, over when this handle exists), ``staged_s``
    (the bytes left the card: ``wait(phase="staged")``) and
    ``committed_s`` (``wait()``), each None until reached."""

    def __init__(
        self,
        path: str,
        pending_io_work: "PendingIOWork | DeferredIOWork",
        metadata: SnapshotMetadata,
        storage: StoragePlugin,
        event_loop: asyncio.AbstractEventLoop,
        op_begin: float,
    ) -> None:
        self.path = path
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
        recorder = _trace_recorder()
        commit_span = recorder.begin(telemetry.names.SPAN_ASYNC_TAKE_COMMIT, path=self.path, rank=0)
        try:
            self._pending_io_work.sync_complete(self._event_loop)
            _commit(self._pending_io_work, self._metadata, self._storage, self._event_loop)
            self._event_loop.run_until_complete(self._storage.close())
            self.committed_s = time.monotonic() - self._op_begin
        except BaseException as e:  # noqa: BLE001 - must propagate via wait()
            self._exc_info = e
            logger.error("Async snapshot failed: %r", e)
        finally:
            recorder.end(commit_span)
            self._event_loop.close()
            # The error is recorded before any waiter wakes.
            self._staged.set()
            self._done.set()

    def wait(self, phase: str = "committed") -> Optional[Snapshot]:
        """Block until the snapshot reaches ``phase``:

        - ``"staged"``: the device-to-host copies and serialization
          finished; returns None (nothing is committed yet);
        - ``"committed"`` (default): the writes are durable and the commit
          marker exists; returns the :class:`Snapshot`.

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
        snapshot = Snapshot(path=self.path)
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
    verifies and places into fresh buffers; ``wait()`` joins it, re-raises
    a failure before touching the application's state, then applies the
    state dicts on the calling thread, the RNG state last."""

    def __init__(
        self,
        path: str,
        plans: Dict[str, _StatefulLoadPlan],
        copier: DeviceCopier,
        world_size: int,
        memory_budget_bytes: int,
    ) -> None:
        self.path = path
        self._plans = plans
        self._copier = copier
        self._world_size = world_size
        self._memory_budget_bytes = memory_budget_bytes
        self._exc_info: Optional[BaseException] = None
        self._applied = False
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run_reads, name="restore-reads", daemon=True)
        self._thread.start()

    def _run_reads(self) -> None:
        event_loop = asyncio.new_event_loop()
        reads_span = _trace_recorder().begin(
            telemetry.names.SPAN_ASYNC_RESTORE_READS, path=self.path, rank=0
        )
        try:
            storage = url_to_storage_plugin(self.path)
            checksum_table = None
            if not knobs.is_checksums_disabled():
                checksum_table = load_checksum_tables(self._world_size, storage, event_loop)
            # Streaming placement across every plan.
            placer = _StreamingPlacer()
            for plan in self._plans.values():
                placer.register_plan(plan)
            sync_execute_read_reqs(
                read_reqs=[r for plan in self._plans.values() for r in plan.read_reqs],
                storage=storage,
                memory_budget_bytes=self._memory_budget_bytes,
                rank=0,
                event_loop=event_loop,
                checksum_table=checksum_table,
                on_req_complete=placer.on_req_complete,
            )
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
            _trace_recorder().end(reads_span)
            event_loop.close()
            self._done.set()

    def wait(self) -> None:
        """Block until the reads finished, then apply the state dicts (once;
        a second call is a no-op). Call it from the thread that called
        ``async_restore``."""
        self._thread.join()
        if self._exc_info is not None:
            # Nothing was applied; the read buffers are useless.
            self._plans = {}
            raise self._exc_info
        if self._applied:
            return
        for plan in self._plans.values():  # in restore order: RNG last
            plan.apply()
        self._applied = True
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

