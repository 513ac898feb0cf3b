"""Interop with ``torch.distributed.checkpoint`` (DCP): an interception
pair plus migration of checkpoint directories both ways.

Counterpart of ``torchsnapshot_tpu/tricks/orbax.py``. There the
incumbent checkpointer is orbax and its interception point a
``CheckpointHandler``; in torch the incumbent is DCP, whose interception
points are ``StorageWriter`` and ``StorageReader``. Both ship inside torch,
so nothing here is import-gated.

- :class:`SnapshotStorageWriter`: ``dcp.save(state_dict,
  storage_writer=SnapshotStorageWriter(path))`` (and ``dcp.async_save``)
  writes the native snapshot format, through this package's write
  requests, scheduler, plugins, checksums and batcher, so that every knob
  applies. A ``DTensor``'s DCP chunks become the shards of a
  ``ShardedArray`` entry; a plain tensor, which DCP writes once, a
  replicated entry under rank 0; a bytes item (a ``torch.save`` stream)
  the value it holds, flattened as a take flattens it. Each rank writes
  its blobs and its checksum table in ``write_data``; the coordinator
  writes the commit marker last, in ``finish``, which DCP runs only when
  every rank's writes succeeded.
- :class:`SnapshotStorageReader`: ``dcp.load(state_dict,
  storage_reader=SnapshotStorageReader(path))`` loads any native
  snapshot, this package's or the JAX package's. Dense entries are one
  DCP chunk, sharded entries one chunk per saved box; DCP reshards into
  the caller's layout. Reads go through this package's read pipeline:
  each saved blob once, as a ranged read where only rows of it are
  needed, verified against the checksum table.
- :func:`load_dcp_state_dict`, :func:`migrate_dcp_to_snapshot` and
  :func:`migrate_snapshot_to_dcp` convert directories written by DCP's
  own ``FileSystemWriter``.

Names: DCP flattens a state dict into dotted names whose own keys may
hold dots (an optimizer state keyed ``"0.weight"``), so names map to
manifest paths through object paths (tuples of keys and list indices),
never by splitting on ``"."``; a name that cannot be mapped both ways
raises and names the key. DCP names dict keys by their text: a key that
reads as a decimal integer is recorded as the integer (an optimizer's
parameter ids), so that a native restore hands ``load_state_dict`` the
keys the optimizer wrote. The reader presents a snapshot as DCP's own
flattening would: a list with no tensor and no dict below it is one
bytes item.

Usage::

    import torch.distributed.checkpoint as dcp
    from torchsnapshot_tpu_torch.tricks.dcp import (
        SnapshotStorageReader, SnapshotStorageWriter)

    dcp.save({"model": model.state_dict()}, storage_writer=SnapshotStorageWriter(path))
    Snapshot(path).restore({"model": StateDict(model.state_dict())})
    dcp.load(state, storage_reader=SnapshotStorageReader(path))
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import os
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.checkpoint import StorageReader, StorageWriter
from torch.distributed.checkpoint.metadata import (
    BytesStorageMetadata,
    ChunkStorageMetadata,
    Metadata,
    TensorProperties,
    TensorStorageMetadata,
)
from torch.distributed.checkpoint.planner import LoadItemType, WriteItemType
from torch.distributed.checkpoint.storage import WriteResult

from .. import knobs
from ..batcher import batch_read_requests, batch_write_requests
from ..flatten import _decode, _encode, flatten, inflate
from ..integrity import load_checksum_tables
from ..io_preparer import DeviceCopier, prepare_read, prepare_write
from ..manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    ObjectEntry,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    get_manifest_for_rank,
    is_container_entry,
    is_dict_entry,
    is_replicated,
)
from ..pg_wrapper import PGWrapper
from ..resharding import Box, box_overlap
from ..scheduler import get_process_memory_budget_bytes, sync_execute_read_reqs, sync_execute_write_reqs
from ..serialization import dtype_to_string, empty_tensor, string_to_dtype
from ..sharded_io_preparer import _reqs_for_saved_shard, as_sharded_entry, write_box
from ..storage_plugin import url_to_storage_plugin
from ..version import __version__

ObjPath = Tuple[Union[str, int], ...]
_ARRAY_ENTRIES = (ArrayEntry, ChunkedArrayEntry, ShardedArrayEntry)


def _run_outside_event_loop(fn):
    """Run ``fn`` off any running asyncio loop (``orbax.py``'s rule). The
    snapshot pipeline drives its own event loop with
    ``run_until_complete``, which asyncio forbids while another loop runs
    on the thread: a caller inside ``asyncio.run`` gets ``fn`` run on a
    fresh thread, and its loop is never touched."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return fn()
    result: list = []
    error: list = []

    def target() -> None:
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            error.append(e)

    thread = threading.Thread(target=target, name="ts-dcp", daemon=True)
    thread.start()
    thread.join()
    if error:
        raise error[0]
    return result[0]


def _future(fn) -> "torch.futures.Future":
    """A completed ``torch.futures.Future`` of ``fn()`` run off any event
    loop: DCP waits on it, which re-raises a failure."""
    fut: torch.futures.Future = torch.futures.Future()
    try:
        fut.set_result(_run_outside_event_loop(fn))
    except Exception as e:  # noqa: BLE001 - handed to DCP through the future
        fut.set_exception(e)
    return fut


def _rank(pg: Optional[Any], given: Optional[int] = None) -> int:
    if pg is not None:
        return PGWrapper(pg).get_rank()
    if given is not None:
        return int(given)
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _fqn(path: ObjPath) -> str:
    return ".".join(str(c) for c in path)


def _logical_path(path: ObjPath) -> str:
    return "/".join(_encode(str(c)) for c in path)


def _rebase(flat_path: str, prefix: str, logical: str) -> str:
    """``flatten(value, prefix)``'s path moved under ``logical``."""
    return logical + flat_path[len(prefix):]


def _dict_key(key: str) -> Union[str, int]:
    """A DCP dict key as the manifest records it: text that reads as a
    decimal integer is the integer."""
    body = key[1:] if key.startswith("-") else key
    if body.isdigit() and str(int(key)) == key:
        return int(key)
    return key


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _PlanData:
    """What the coordinator decides for every rank: the snapshot path
    (its own wins, as a take's broadcast makes it) and the chunk-store
    layout."""

    path: str
    cas: bool


@dataclasses.dataclass
class _ItemEntries:
    """One write item's part of a rank's manifest: its object path and
    the entries under it (a bytes item's value may flatten to several)."""

    path: ObjPath
    entries: Manifest


def _obj_path(fqn: str, mappings: Dict[str, ObjPath]) -> ObjPath:
    if not mappings:
        return (fqn,)
    path = mappings.get(fqn)
    if path is None or _fqn(path) != fqn:
        raise ValueError(
            f"DCP name {fqn!r} has no object path in the save planner's mappings; "
            f"it cannot be placed in the snapshot's manifest"
        )
    return tuple(path)


def _containers(paths: List[ObjPath]) -> Manifest:
    """The container entries above every leaf's object path: a list where
    the next key is an index, a dict otherwise. A path that is both a
    leaf and a container, or a container that is both, raises."""
    out: Manifest = {}
    for path in paths:
        for i in range(1, len(path)):
            parent, child = _logical_path(path[:i]), path[i]
            is_list = isinstance(child, int)
            entry = out.get(parent)
            if entry is None:
                entry = out[parent] = ListEntry() if is_list else DictEntry(keys=[])
            elif isinstance(entry, ListEntry) != is_list:
                raise ValueError(
                    f"DCP name {_fqn(path)!r}: {_fqn(path[:i])!r} is a list under one name "
                    f"and a dict under another"
                )
            if not is_list:
                key = _dict_key(child)
                if key not in entry.keys:
                    entry.keys.append(key)
    leaves = {_logical_path(p): p for p in paths}
    for logical in leaves.keys() & out.keys():
        raise ValueError(f"DCP name {_fqn(leaves[logical])!r} is both a value and a container")
    return out


class SnapshotStorageWriter(StorageWriter):
    """A DCP ``StorageWriter`` that writes the native snapshot format at
    ``path`` (module docstring). ``pg`` names this rank where DCP does
    not (a ``dist_store.ProcessGroup``); DCP's own collectives run on its
    process group."""

    def __init__(self, path: Union[str, os.PathLike], pg: Optional[Any] = None) -> None:
        super().__init__()
        self.path = os.fspath(path)
        self._pg = pg
        self._rank = 0
        self._plan_data: Optional[_PlanData] = None

    def reset(self, checkpoint_id: Union[str, os.PathLike, None] = None) -> None:
        if checkpoint_id is not None:
            self.path = os.fspath(checkpoint_id)
        self._plan_data = None

    @classmethod
    def validate_checkpoint_id(cls, checkpoint_id: Union[str, os.PathLike]) -> bool:
        return isinstance(checkpoint_id, (str, os.PathLike))

    def set_up_storage_writer(self, is_coordinator: bool, *args: Any, **kwargs: Any) -> None:
        self._rank = _rank(self._pg, kwargs.get("rank"))

    def prepare_local_plan(self, plan):
        return plan

    def prepare_global_plan(self, plans):
        from ..cas import cas_eligible

        self._plan_data = _PlanData(self.path, cas_eligible(self.path))
        return [dataclasses.replace(plan, storage_data=self._plan_data) for plan in plans]

    def write_data(self, plan, planner) -> "torch.futures.Future":
        return _future(lambda: self._write(plan, planner))

    def _write(self, plan, planner) -> List[WriteResult]:
        from ..snapshot import _maybe_cas_storage, _maybe_write_cas_map, _write_checksum_table

        data = plan.storage_data if isinstance(plan.storage_data, _PlanData) else _PlanData(self.path, False)
        mappings = getattr(planner, "mappings", None) or {}
        rank = self._rank
        copier = DeviceCopier()
        parts: List[Tuple[Any, _ItemEntries, int]] = []
        write_reqs = []
        for item in plan.items:
            path = _obj_path(item.index.fqn, mappings)
            logical = _logical_path(path)
            value = planner.resolve_data(item)
            entries: Manifest = {}
            if item.type == WriteItemType.BYTE_IO:
                value.seek(0)
                nbytes = len(value.getbuffer())
                containers, leaves = flatten(torch.load(value, weights_only=False), prefix="v")
                entries.update({_rebase(k, "v", logical): e for k, e in containers.items()})
                for k, leaf in leaves.items():
                    entry, reqs = prepare_write(leaf, _rebase(k, "v", logical), rank, copier, replicated=True)
                    entries[_rebase(k, "v", logical)] = entry
                    write_reqs.extend(reqs)
            elif item.type == WriteItemType.SHARD:
                local = value.detach()
                chunk = item.tensor_data.chunk
                shards, reqs = write_box(local, Box(tuple(chunk.offsets), tuple(chunk.sizes)), logical, copier)
                entries[logical] = ShardedArrayEntry(
                    dtype=dtype_to_string(local.dtype), shape=list(item.tensor_data.size), shards=shards
                )
                nbytes = local.numel() * local.element_size()
                write_reqs.extend(reqs)
            else:
                tensor = value.detach()
                entry, reqs = prepare_write(tensor, logical, rank, copier, replicated=True)
                entries[logical] = entry
                nbytes = tensor.numel() * tensor.element_size()
                write_reqs.extend(reqs)
            parts.append((item, _ItemEntries(path, entries), nbytes))
        if knobs.is_batching_enabled():
            # Rewrites the entries' locations in place: the results below
            # carry the same objects.
            flat = [e for _, part, _ in parts for e in part.entries.values()]
            _, write_reqs = batch_write_requests(flat, write_reqs)

        storage = _maybe_cas_storage(url_to_storage_plugin(data.path), data.path, data.cas)
        event_loop = asyncio.new_event_loop()
        try:
            pending = sync_execute_write_reqs(
                write_reqs=write_reqs, storage=storage, memory_budget_bytes=get_process_memory_budget_bytes(),
                rank=rank, event_loop=event_loop,
            )
            pending.sync_complete(event_loop)
            from ..cas import CASStoragePlugin

            if isinstance(storage, CASStoragePlugin):
                pending.checksum_finalizer = lambda: storage.rekey_checksums(pending.checksums)
            _write_checksum_table(pending, rank, storage, event_loop)
            _maybe_write_cas_map(storage, rank, event_loop)
            event_loop.run_until_complete(storage.close())
        finally:
            event_loop.close()
        return [WriteResult(index=item.index, size_in_bytes=n, storage_data=part) for item, part, n in parts]

    def finish(self, metadata: Metadata, results: List[List[WriteResult]]) -> None:
        """The coordinator, after every rank's writes: the global manifest
        (containers under every rank, as each rank's own take lists them;
        replicated entries under rank 0; each rank's shards under it),
        then the commit marker."""
        _run_outside_event_loop(lambda: self._commit(results))

    def _commit(self, results: List[List[WriteResult]]) -> None:
        from ..snapshot import _maybe_cas_storage, _write_snapshot_metadata

        world_size = len(results)
        leaves: Dict[str, Tuple[int, Entry]] = {}
        sharded: Dict[Tuple[int, str], ShardedArrayEntry] = {}
        containers: Manifest = {}
        paths: List[ObjPath] = []
        for rank, rank_results in enumerate(results):
            for result in rank_results:
                part: _ItemEntries = result.storage_data
                paths.append(part.path)
                for logical, entry in part.entries.items():
                    if is_container_entry(entry):
                        containers[logical] = entry
                    elif isinstance(entry, ShardedArrayEntry):
                        have = sharded.get((rank, logical))
                        if have is None:
                            sharded[(rank, logical)] = entry
                        else:
                            have.shards = sorted(have.shards + entry.shards, key=lambda s: s.offsets)
                    else:
                        leaves[logical] = (0 if is_replicated(entry) else rank, entry)
        for logical, entry in _containers(paths).items():
            containers.setdefault(logical, entry)
        manifest: Manifest = {}
        for rank in range(world_size):
            for logical, entry in containers.items():
                manifest[f"{rank}/{logical}"] = entry
        for logical, (rank, entry) in leaves.items():
            manifest[f"{rank}/{logical}"] = entry
        for (rank, logical), entry in sharded.items():
            manifest[f"{rank}/{logical}"] = entry
        data = self._plan_data or _PlanData(self.path, False)
        metadata = SnapshotMetadata(version=__version__, world_size=world_size, manifest=manifest)
        storage = _maybe_cas_storage(url_to_storage_plugin(data.path), data.path, data.cas)
        event_loop = asyncio.new_event_loop()
        try:
            _write_snapshot_metadata(metadata, storage, event_loop)
            event_loop.run_until_complete(storage.close())
        finally:
            event_loop.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _children(manifest: Manifest) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for path in manifest:
        parent, sep, _ = path.rpartition("/")
        out.setdefault(parent if sep else "", []).append(path)
    return out


def _dcp_view(
    manifest: Manifest, children: Dict[str, List[str]]
) -> Tuple[Dict[str, Tuple[str, Entry]], Dict[str, Any], Dict[str, ObjPath]]:
    """A rank's manifest (``children``: :func:`_children` of it) as DCP's
    flattening would name it: ``(sources, state_dict_metadata,
    planner_data)``, where ``sources`` maps each DCP name to the manifest
    path it reads from (a leaf, or a list read whole as one bytes item)."""
    sources: Dict[str, Tuple[str, Entry]] = {}
    sd_meta: Dict[str, Any] = {}
    planner_data: Dict[str, ObjPath] = {}
    terminal: Dict[str, bool] = {}

    def is_terminal(logical: str) -> bool:
        # DCP's rule: a list is one value unless a tensor or a dict lies
        # below it.
        if logical not in terminal:
            ok = True
            for child in children.get(logical, []):
                entry = manifest[child]
                if isinstance(entry, _ARRAY_ENTRIES) or is_dict_entry(entry):
                    ok = False
                elif isinstance(entry, ListEntry):
                    ok = is_terminal(child)
                if not ok:
                    break
            terminal[logical] = ok
        return terminal[logical]

    def emit(logical: str, path: ObjPath, entry: Entry, meta: Any) -> None:
        fqn = _fqn(path)
        if fqn in sources:
            raise ValueError(
                f"manifest paths {sources[fqn][0]!r} and {logical!r} both map to the DCP "
                f"name {fqn!r}"
            )
        sources[fqn] = (logical, entry)
        sd_meta[fqn] = meta
        planner_data[fqn] = path

    stack: List[Tuple[str, ObjPath]] = [(p, (_decode(p),)) for p in reversed(children.get("", []))]
    while stack:
        logical, path = stack.pop()
        entry = manifest[logical]
        if is_dict_entry(entry) or (isinstance(entry, ListEntry) and not is_terminal(logical)):
            kids = []
            for child in children.get(logical, []):
                segment = _decode(child.rpartition("/")[2])
                kids.append((child, path + ((int(segment),) if isinstance(entry, ListEntry) else (segment,))))
            if isinstance(entry, ListEntry):
                kids.sort(key=lambda kid: kid[1][-1])
            stack.extend(reversed(kids))
        elif isinstance(entry, _ARRAY_ENTRIES):
            size = torch.Size(int(d) for d in entry.shape)
            if isinstance(entry, ShardedArrayEntry):
                chunks = [
                    ChunkStorageMetadata(offsets=torch.Size(s.offsets), sizes=torch.Size(s.sizes))
                    for s in entry.shards
                ]
            else:
                chunks = [ChunkStorageMetadata(offsets=torch.Size([0] * len(size)), sizes=size)]
            meta = TensorStorageMetadata(
                properties=TensorProperties(dtype=string_to_dtype(entry.dtype)), size=size, chunks=chunks
            )
            emit(logical, path, entry, meta)
        else:
            emit(logical, path, entry, BytesStorageMetadata())
    return sources, sd_meta, planner_data


class SnapshotStorageReader(StorageReader):
    """A DCP ``StorageReader`` over a native snapshot at ``path`` (module
    docstring). A rank sees the entries a restore on it would see:
    replicated and sharded entries, and its own per-rank ones; ``pg``
    names the rank (else torch.distributed's, else 0)."""

    def __init__(self, path: Union[str, os.PathLike], pg: Optional[Any] = None) -> None:
        super().__init__()
        self.path = os.fspath(path)
        self._pg = pg
        self._sources: Dict[str, Tuple[str, Entry]] = {}
        self._manifest: Manifest = {}
        self._children: Dict[str, List[str]] = {}
        self._world_size = 1
        self._rank = 0

    def reset(self, checkpoint_id: Union[str, os.PathLike, None] = None) -> None:
        if checkpoint_id is not None:
            self.path = os.fspath(checkpoint_id)

    @classmethod
    def validate_checkpoint_id(cls, checkpoint_id: Union[str, os.PathLike]) -> bool:
        return isinstance(checkpoint_id, (str, os.PathLike))

    def read_metadata(self, *args: Any, **kwargs: Any) -> Metadata:
        from ..snapshot import Snapshot

        snapshot_metadata = _run_outside_event_loop(lambda: Snapshot(self.path).metadata)
        self._rank = _rank(self._pg, kwargs.get("rank"))
        self._world_size = snapshot_metadata.world_size
        self._manifest = get_manifest_for_rank(snapshot_metadata, self._rank)
        self._children = _children(self._manifest)
        self._sources, sd_meta, planner_data = _dcp_view(self._manifest, self._children)
        return Metadata(state_dict_metadata=sd_meta, planner_data=planner_data)

    def set_up_storage_reader(self, metadata: Metadata, is_coordinator: bool, *args: Any, **kwargs: Any) -> None:
        pass

    def prepare_local_plan(self, plan):
        return plan

    def prepare_global_plan(self, plans):
        return plans

    def read_data(self, plan, planner) -> "torch.futures.Future":
        return _future(lambda: self._read(plan, planner))

    def _source(self, fqn: str) -> Tuple[str, Entry]:
        try:
            return self._sources[fqn]
        except KeyError:
            raise KeyError(f"DCP name {fqn!r} is not in the snapshot at {self.path!r}") from None

    def _read(self, plan, planner) -> None:
        budget = get_process_memory_budget_bytes()
        # Saved shard -> every (destination view, overlap) it feeds: one
        # read of each blob, however many items it serves.
        feeds: Dict[int, Tuple[Any, list]] = {}
        tensors: List[Tuple[Any, torch.Tensor, torch.Tensor]] = []
        values: Dict[str, Any] = {}
        reqs = []
        byte_items = []
        for item in plan.items:
            logical, entry = self._source(item.storage_index.fqn)
            if item.type == LoadItemType.BYTE_IO:
                byte_items.append((item, logical))
                reqs.extend(self._value_reads(logical, values))
                continue
            target = planner.resolve_tensor(item).detach()
            lengths = tuple(int(n) for n in item.lengths)
            wanted = Box(
                tuple(int(a) + int(b) for a, b in zip(item.storage_index.offset, item.storage_offsets)), lengths
            )
            direct = target.device.type == "cpu" and target.is_contiguous() and dtype_to_string(target.dtype) == entry.dtype
            host = target if direct else empty_tensor(lengths, entry.dtype, pin_memory=target.is_cuda)
            for saved in as_sharded_entry(entry).shards:
                saved_box = Box(tuple(saved.offsets), tuple(saved.sizes))
                overlap = box_overlap(saved_box, wanted)
                if overlap is not None:
                    feeds.setdefault(id(saved.array), (saved, []))[1].append(
                        (host[overlap.dst_slices], overlap, direct)
                    )
            tensors.append((item, host, target))
        for saved, overlaps in feeds.values():
            owned = not any(direct for _, _, direct in overlaps)
            reqs.extend(
                _reqs_for_saved_shard(
                    saved, Box(tuple(saved.offsets), tuple(saved.sizes)),
                    [(view, overlap) for view, overlap, _ in overlaps], budget, owned,
                )
            )
        if knobs.is_batching_enabled():
            reqs = batch_read_requests(reqs)
        storage = url_to_storage_plugin(self.path)
        event_loop = asyncio.new_event_loop()
        try:
            checksum_table = (
                None if knobs.is_checksums_disabled()
                else load_checksum_tables(self._world_size, storage, event_loop)
            )
            sync_execute_read_reqs(
                read_reqs=reqs, storage=storage, memory_budget_bytes=budget, rank=self._rank,
                event_loop=event_loop, checksum_table=checksum_table,
            )
            event_loop.run_until_complete(storage.close())
        finally:
            event_loop.close()
        copier = DeviceCopier()
        for _, host, target in tensors:
            if host is target:
                continue
            if target.is_cuda:
                copier.to_device(target, host)
            else:
                target.copy_(host)
        copier.synchronize()
        for item, _, target in tensors:
            planner.commit_tensor(item, target)
        for item, logical in byte_items:
            stream = io.BytesIO()
            torch.save(self._value(logical, values), stream)
            stream.seek(0)
            planner.load_bytes(item, stream)

    def _subtree(self, logical: str) -> Manifest:
        out: Manifest = {}
        stack = [logical]
        while stack:
            path = stack.pop()
            out[path] = self._manifest[path]
            stack.extend(self._children.get(path, ()))
        return out

    def _value_reads(self, logical: str, values: Dict[str, Any]) -> list:
        """Reads of the object entries under a bytes item's path (a leaf,
        or a list read whole); their values land in ``values``."""
        reqs = []
        for path, entry in self._subtree(logical).items():
            if isinstance(entry, ObjectEntry):
                reqs.extend(prepare_read(entry, callback=lambda obj, p=path: values.__setitem__(p, obj)))
        return reqs

    def _value(self, logical: str, values: Dict[str, Any]) -> Any:
        containers: Manifest = {}
        leaves: Dict[str, Any] = {}
        for path, entry in self._subtree(logical).items():
            rebased = _rebase(path, logical, "v")
            if is_container_entry(entry):
                containers[rebased] = entry
            elif isinstance(entry, PrimitiveEntry):
                leaves[rebased] = entry.get_value()
            else:
                leaves[rebased] = values[path]
        return inflate(containers, leaves, prefix="v")


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------


def _with_dict_keys(tree: Any) -> Any:
    """``tree`` with every dict key as :func:`_dict_key` names it."""
    if isinstance(tree, dict):
        return {_dict_key(k) if isinstance(k, str) else k: _with_dict_keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_dict_keys(v) for v in tree]
    return tree


def _dist_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def load_dcp_state_dict(dcp_path: str, template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Load a checkpoint written by DCP's ``FileSystemWriter``. Without a
    template it loads raw (nested dicts and lists of CPU tensors and
    values, as DCP names them), on this process alone; with one it loads
    into the template in place (a ``DTensor`` leaf reads only this rank's
    piece, over torch.distributed's default group) and returns it."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(dcp_path)
    if template is None:
        from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner

        # dcp.load fills a dict of its own: the planner holds it.
        planner = _EmptyStateDictLoadPlanner()
        dcp.load({}, storage_reader=reader, planner=planner, no_dist=True)
        return planner.original_state_dict
    dcp.load(template, storage_reader=reader, no_dist=not _dist_initialized())
    return template


def migrate_dcp_to_snapshot(
    dcp_path: str,
    snapshot_path: str,
    template: Optional[Dict[str, Any]] = None,
    key: str = "state",
    pg: Optional[Any] = None,
) -> None:
    """Read a DCP checkpoint (raw, or into ``template``) and write it as a
    snapshot at ``snapshot_path`` under app-state key ``key``. Raw, dict
    keys are named as the writer names them (module docstring). Every
    leaf but a sharded ``DTensor`` is declared replicated: each rank
    loaded the same value, and a restore by any number of ranks finds it."""
    from ..snapshot import Snapshot
    from ..state_dict import TensorTreeState

    state = load_dcp_state_dict(dcp_path, template)
    if template is None:
        state = _with_dict_keys(state)
    _run_outside_event_loop(
        lambda: Snapshot.take(
            snapshot_path, {key: TensorTreeState(state)}, pg=pg, replicated=[_encode(key) + "/*"]
        )
    )


def migrate_snapshot_to_dcp(
    snapshot_path: str,
    dcp_path: str,
    template: Dict[str, Any],
    key: str = "state",
    pg: Optional[Any] = None,
) -> Dict[str, Any]:
    """Restore app-state ``key`` of a snapshot into ``template`` (in
    place: a ``DTensor`` leaf reads only this rank's piece) and save it
    with DCP's ``FileSystemWriter`` at ``dcp_path``. Returns the restored
    state."""
    import torch.distributed.checkpoint as dcp

    from ..snapshot import Snapshot
    from ..state_dict import TensorTreeState

    stateful = TensorTreeState(template)
    _run_outside_event_loop(lambda: Snapshot(snapshot_path, pg=pg).restore({key: stateful}))
    dcp.save(stateful.tree, storage_writer=dcp.FileSystemWriter(dcp_path), no_dist=not _dist_initialized())
    return stateful.tree
