"""The Snapshot user API: take / restore / read_object, for one process.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for ``pg=None``. Same
protocol:

- ``take``: flatten every stateful's state dict (the RNG state first),
  plan write requests, stage and write them under the host-memory budget,
  write the per-rank checksum table, then commit ``.snapshot_metadata``
  (JSON). A snapshot without the metadata file never happened, which is
  what makes an interrupted take safe.
- ``restore``: in place, like torch's ``load_state_dict``. A CUDA leaf is
  read into a pinned host buffer, copied into the live tensor with
  ``copy_(non_blocking=True)`` on a side stream as soon as its reads
  complete, and the streams are synchronized before the stateful's own
  ``load_state_dict`` runs. A CPU leaf is read into directly. The RNG state
  is restored last.
- ``read_object``: random access to one manifest path.

The snapshot format is the JAX package's: either package reads what the
other writes. Multi-process takes, async take and restore, and the CAS,
tiered, peer, fan-out, batched and incremental branches of the JAX package
are not part of this package yet.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, telemetry
from .flatten import _encode, flatten, inflate
from .integrity import load_checksum_tables, sync_write_checksum_table
from .io_preparer import DeviceCopier, prepare_read, prepare_write
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
    ) -> "Snapshot":
        """Synchronous checkpoint of ``app_state`` to ``path``. Returns once
        every byte is in storage and the snapshot is committed; the caller
        must not mutate the state's tensors while it runs."""
        _check_pg(pg)
        _validate_app_state(app_state)
        recorder = _trace_recorder()
        take_span = recorder.begin(telemetry.names.SPAN_TAKE, path=path, rank=0)
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(path)
            copier = DeviceCopier()
            write_reqs, metadata = cls._plan_take(app_state, copier)
            pending = sync_execute_write_reqs(
                write_reqs=write_reqs,
                storage=storage,
                memory_budget_bytes=get_process_memory_budget_bytes(),
                rank=0,
                event_loop=event_loop,
            )
            pending.sync_complete(event_loop)
            if pending.checksums:
                sync_write_checksum_table(pending.checksums, 0, storage, event_loop)
            # Every blob is durable before the commit marker exists.
            event_loop.run_until_complete(
                storage.write(
                    WriteIO(
                        path=SNAPSHOT_METADATA_FNAME,
                        buf=metadata.to_json().encode("utf-8"),
                    )
                )
            )
            event_loop.run_until_complete(storage.close())
        finally:
            recorder.end(take_span)
            event_loop.close()
        snapshot = cls(path=path)
        snapshot._metadata = metadata
        return snapshot

    @staticmethod
    def _plan_take(
        app_state: AppState, copier: DeviceCopier
    ) -> Tuple[List[WriteReq], SnapshotMetadata]:
        # RNG first: capturing other statefuls must not perturb what gets
        # saved as the RNG state.
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

        write_reqs: List[WriteReq] = []
        for logical_path, leaf in flattened.items():
            entry, reqs = prepare_write(
                obj=leaf, logical_path=logical_path, rank=0, copier=copier
            )
            manifest[logical_path] = entry
            write_reqs.extend(reqs)
        metadata = SnapshotMetadata(
            version=__version__,
            world_size=1,
            manifest={f"0/{path}": entry for path, entry in manifest.items()},
        )
        return write_reqs, metadata

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
            rng = _pop_rng_state(app_state)
            # RNG state last, so that load_state_dict side effects of the
            # other statefuls cannot disturb it.
            keys = [k for k in sorted(app_state) if rng is None or k != rng[0]]
            if rng is not None:
                keys.append(rng[0])
            for key in keys:
                plan = _plan_stateful_load(key, app_state[key], available)
                if plan is None:
                    continue
                sync_execute_read_reqs(
                    read_reqs=plan.read_reqs,
                    storage=storage,
                    memory_budget_bytes=budget,
                    rank=0,
                    event_loop=event_loop,
                    checksum_table=checksum_table,
                    on_req_complete=plan.on_req_complete,
                )
                plan.apply()
            event_loop.run_until_complete(storage.close())
        finally:
            recorder.end(restore_span)
            event_loop.close()

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
        finish: Optional[Callable[[], None]] = None
        if isinstance(entry, ObjectEntry):
            read_reqs = prepare_read(entry, callback=lambda o: result.__setitem__("v", o))
        elif isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
            dst, value, finish, owned = _restore_destination(entry, obj_out, copier)
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
        if finish is not None:
            finish()
            copier.synchronize()
        return result["v"]


class _LeafLoad:
    """The reads of one dense leaf, and what to run once they all landed
    (the host-to-device copy of a CUDA leaf)."""

    def __init__(self, reqs: List[ReadReq], finish: Callable[[], None]) -> None:
        self.remaining = len(reqs)
        self.finish = finish


class _StatefulLoadPlan:
    def __init__(
        self,
        key: str,
        stateful: Stateful,
        container_entries: Manifest,
        restored: Dict[str, Any],
        read_reqs: List[ReadReq],
        leaf_of_req: Dict[int, _LeafLoad],
        copier: DeviceCopier,
    ) -> None:
        self.key = key
        self.stateful = stateful
        self.container_entries = container_entries
        self.restored = restored
        self.read_reqs = read_reqs
        self._leaf_of_req = leaf_of_req
        self._copier = copier

    def on_req_complete(self, req: ReadReq) -> None:
        """Issue a CUDA leaf's host-to-device copy as soon as its last read
        landed, while the other reads are still in flight."""
        leaf = self._leaf_of_req.pop(id(req), None)
        if leaf is None:
            return
        leaf.remaining -= 1
        if leaf.remaining == 0:
            leaf.finish()

    def apply(self) -> None:
        if self._leaf_of_req:
            raise RuntimeError(f"restore of {self.key!r} finished with reads outstanding")
        self._copier.synchronize()
        state_dict = inflate(dict(self.container_entries), self.restored, prefix=self.key)
        self.stateful.load_state_dict(state_dict)


def _plan_stateful_load(
    key: str, stateful: Stateful, available: Manifest
) -> Optional[_StatefulLoadPlan]:
    """Plan one stateful's restore: its current leaves are the read
    destinations, so restore needs no second copy of the state."""
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
    copier = DeviceCopier()
    restored: Dict[str, Any] = {}
    container_entries: Manifest = {}
    read_reqs: List[ReadReq] = []
    leaf_of_req: Dict[int, _LeafLoad] = {}
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
            dst, value, finish, owned = _restore_destination(entry, current.get(path), copier)
            reqs = prepare_read(entry, obj_out=dst, dest_owned=owned)
            read_reqs.extend(reqs)
            if finish is None:
                restored[path] = value
            else:

                def _finish(p=path, value=value, finish=finish) -> None:
                    finish()
                    restored[p] = value

                leaf = _LeafLoad(reqs, _finish)
                for r in reqs:
                    leaf_of_req[id(r)] = leaf
        else:
            read_reqs.extend(prepare_read(entry))  # raises: entry type not ported yet
    return _StatefulLoadPlan(
        key, stateful, container_entries, restored, read_reqs, leaf_of_req, copier
    )


def _restore_destination(
    entry: "ArrayEntry | ChunkedArrayEntry", current: Any, copier: DeviceCopier
) -> Tuple[torch.Tensor, Any, Optional[Callable[[], None]], bool]:
    """The host read destination for a dense entry: ``(dst, value, finish,
    owned)``. ``value`` is what the restored state dict holds; ``finish``
    (or None) runs once the reads landed; ``owned`` says whether ``dst`` is
    a fresh buffer that storage may read into directly (a live CPU tensor
    keeps copy-on-success semantics, so a failed read cannot tear it)."""
    shape = [int(d) for d in entry.shape]
    if isinstance(current, torch.Tensor) and current.layout == torch.strided:
        matches = list(current.shape) == shape and (
            current.dtype in DTYPE_TO_STRING and dtype_to_string(current.dtype) == entry.dtype
        )
        if matches and current.device.type == "cpu":
            return current.detach(), current, None, False
        if matches and current.device.type == "cuda":
            live = current.detach()
            host = empty_tensor(shape, entry.dtype, pin_memory=True)
            return host, current, lambda: copier.to_device(live, host), True
        logger.warning(
            "Restoring %s %s over a current leaf of %s %s; the checkpointed "
            "value replaces the leaf",
            entry.dtype, shape, current.dtype, list(current.shape),
        )
        if current.device.type == "cuda":
            host = empty_tensor(shape, entry.dtype, pin_memory=True)
            out = torch.empty(shape, dtype=host.dtype, device=current.device)
            return host, out, lambda: copier.to_device(out, host), True
    if (
        isinstance(current, np.ndarray)
        and current.flags.c_contiguous
        and current.flags.writeable
        and current.dtype.name == entry.dtype
        and list(current.shape) == shape
    ):
        return tensor_from_numpy(current), current, None, False
    dst = empty_tensor(shape, entry.dtype)
    return dst, dst, None, True


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

