"""CAS write interception and the rank-0 manifest rewrite.

Counterpart of ``torchsnapshot_tpu/cas/plugin.py``. ``CASStoragePlugin``
wraps a take's storage plugin. Data-blob writes (``{rank}/...``,
``sharded/...``, ``replicated/...``, ``batched/...``) are diverted: the
integrity entry is computed first (the port's native CRC32-C, one pass
over the bytes, and the same entry the checksum table records, so nothing
is hashed twice), the digest key derived, and the bytes written to
``../chunks/<key>`` only if the store does not hold that key already:
dedup across steps and across ranks (identical bytes from any writer
resolve to one stored blob; concurrent writers of one key write the same
bytes). Control blobs (``.snapshot_metadata``, ``checksums/``, the
``cas/`` maps, dotfiles) pass through untouched.

The manifest fix-up happens once, on rank 0, at commit: every writing
rank persists its ``path -> digest`` map as ``cas/{rank}`` before the
commit barrier (next to its checksum table), and rank 0 reads the maps
back and rewrites entry locations to ``../chunks/<key>``; after that the
snapshot reads like any snapshot with parent refs.

A partial chunk left by a kill mid-write never satisfies dedup: the key
embeds the byte length and the existence check wants an exact size match,
so the next writer of the same content overwrites it. A dedup hit touches
the chunk's mtime, which the manager GC's grace window keys off.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Dict, Tuple

from .. import telemetry
from ..chaos import crashpoint
from ..integrity import compute_checksum_entry
from ..io_types import ReadIO, StoragePlugin, WriteIO, payload_nbytes
from ..telemetry import names as metric_names
from .store import (
    CAS_MAP_DIR,
    CHUNKS_DIRNAME,
    chunk_location,
    digest_key,
    local_chunks_dir,
    root_url_of_snapshot,
)

logger: logging.Logger = logging.getLogger(__name__)

# Entries at or under this size are hashed on the event loop; larger ones
# go to an executor thread (the native CRC releases the GIL).
_INLINE_DIGEST_BYTES = 1 * 1024 * 1024

_CONTROL_TOP_SEGMENTS = frozenset(("checksums", CAS_MAP_DIR, CHUNKS_DIRNAME))


def is_data_path(path: str) -> bool:
    """Paths whose bytes belong in the chunk store: everything a take's
    write pipeline emits except control blobs (dotfiles, checksum tables,
    the cas maps themselves)."""
    if path.startswith("../"):
        return False
    first = path.split("/", 1)[0]
    if not first or first.startswith("."):
        return False
    return first not in _CONTROL_TOP_SEGMENTS


def chunk_map_path(rank: int) -> str:
    return f"{CAS_MAP_DIR}/{rank}"


class CASStoragePlugin(StoragePlugin):
    """Write-side CAS interception for one take. Reads, deletes and
    control writes go to the inner plugin unchanged. A failed chunk write
    raises out of the take's pipeline, so the take fails and leaves no
    commit marker."""

    def __init__(self, inner: StoragePlugin, snapshot_url: str) -> None:
        self.inner = inner
        self.snapshot_url = snapshot_url
        local = local_chunks_dir(root_url_of_snapshot(snapshot_url))
        if local is None:
            raise ValueError(f"{snapshot_url!r} has no local filesystem root for a chunk store")
        self._local_dir = local
        # original write path -> (digest key, nbytes, newly written?)
        self.records: Dict[str, Tuple[str, int, bool]] = {}
        self._written_keys: set = set()

    @property
    def supports_multibuffer(self) -> bool:  # type: ignore[override]
        return getattr(self.inner, "supports_multibuffer", False)

    # -- writes ----------------------------------------------------------

    async def _entry_of(self, buf) -> Tuple:
        if payload_nbytes(buf) <= _INLINE_DIGEST_BYTES:
            return compute_checksum_entry(buf)
        return await asyncio.get_running_loop().run_in_executor(None, compute_checksum_entry, buf)

    def _has(self, key: str, nbytes: int) -> bool:
        """Exact-size local existence check; a hit touches the chunk's
        mtime (the GC grace window's liveness signal)."""
        if key in self._written_keys:
            return True
        path = os.path.join(self._local_dir, key)
        try:
            if os.path.getsize(path) != nbytes:
                return False
        except OSError:
            return False
        try:
            os.utime(path)
        except OSError:
            pass  # best effort: the grace window dwarfs a take
        return True

    async def _divert(self, write_io: WriteIO, entry: Tuple) -> None:
        key = digest_key(entry)
        nbytes = payload_nbytes(write_io.buf)
        registry = telemetry.metrics()
        if self._has(key, nbytes):
            write_io.variant = "deduped"
            self.records[write_io.path] = (key, nbytes, False)
            # A tiered root: the dedup hit writes nothing, but this step's
            # durability covers the chunk, so the mirror gets it too (its
            # probe of the durable tier skips a chunk held there already).
            note = getattr(self.inner, "note_written", None)
            if note is not None:
                note(chunk_location(key), nbytes)
            registry.counter_inc(metric_names.CAS_CHUNKS_DEDUPED_TOTAL)
            registry.counter_inc(metric_names.CAS_BYTES_DEDUPED_TOTAL, nbytes)
            return
        # Claimed before the write, so that a blob of the same bytes in
        # flight beside it dedups instead of writing (and counting) the
        # chunk twice; the take commits only after every write landed, and
        # a failed write fails it. (The JAX package claims after the write.)
        self._written_keys.add(key)
        inner_io = WriteIO(path=chunk_location(key), buf=write_io.buf)
        try:
            await self.inner.write(inner_io)
        except BaseException:
            self._written_keys.discard(key)
            raise
        write_io.variant = inner_io.variant
        self.records[write_io.path] = (key, nbytes, True)
        registry.counter_inc(metric_names.CAS_CHUNKS_WRITTEN_TOTAL)
        registry.counter_inc(metric_names.CAS_BYTES_WRITTEN_TOTAL, nbytes)
        # The chunk's bytes exist; no map, manifest or pin names them yet.
        crashpoint(metric_names.CRASH_CAS_CHUNK_WRITTEN)

    async def write(self, write_io: WriteIO) -> None:
        if not is_data_path(write_io.path):
            await self.inner.write(write_io)
            return
        # Content addressing is a digest: computed even with checksums
        # disabled (the entry then stays out of the table).
        await self._divert(write_io, await self._entry_of(write_io.buf))

    async def write_with_checksum(self, write_io: WriteIO):
        if not is_data_path(write_io.path):
            return await self.inner.write_with_checksum(write_io)
        # The key must exist before the bytes can be addressed, so the
        # fused write + CRC pass cannot serve a CAS write; the entry
        # computed here is the table entry too (each byte hashed once).
        entry = await self._entry_of(write_io.buf)
        await self._divert(write_io, entry)
        return entry

    # -- reads / deletes / close: delegate -------------------------------

    async def read(self, read_io: ReadIO) -> None:
        await self.inner.read(read_io)

    async def read_with_checksum(self, read_io: ReadIO):
        return await self.inner.read_with_checksum(read_io)

    async def read_degraded(self, read_io: ReadIO) -> bool:
        return await self.inner.read_degraded(read_io)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)

    async def close(self) -> None:
        await self.inner.close()

    # -- take-commit plumbing --------------------------------------------

    def rekey_checksums(self, checksums: Dict[str, Tuple]) -> None:
        """Re-home this rank's checksum-table entries from the original
        write paths to the chunk locations the manifest will name, so
        that restore-time verification keys match read paths. Runs in the
        checksum finalizer, before the table is written."""
        for orig, (key, _nbytes, _new) in self.records.items():
            entry = checksums.pop(orig, None)
            if entry is not None:
                checksums[chunk_location(key)] = entry

    async def write_chunk_map(self, rank: int) -> None:
        """Persist this rank's ``path -> digest`` map (``cas/{rank}``),
        the input of rank 0's manifest rewrite, before the commit
        barrier."""
        if not self.records:
            return
        doc = {
            "paths": {
                path: {"k": key, "n": nbytes, "new": new}
                for path, (key, nbytes, new) in sorted(self.records.items())
            }
        }
        await self.inner.write(
            WriteIO(path=chunk_map_path(rank), buf=json.dumps(doc, sort_keys=True).encode())
        )


async def load_chunk_maps(storage: StoragePlugin, world_size: int) -> Dict[str, Tuple[str, int, bool]]:
    """Merge every rank's committed ``cas/{rank}`` map: ``original path ->
    (digest key, nbytes, newly written)``. A rank without a map (nothing
    diverted) contributes nothing."""
    merged: Dict[str, Tuple[str, int, bool]] = {}
    for rank in range(world_size):
        read_io = ReadIO(path=chunk_map_path(rank))
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            continue
        try:
            doc = json.loads(bytes(read_io.buf))
        except ValueError as e:
            # Its entries would point at step-local paths that hold no
            # bytes: fail the commit rather than commit a broken snapshot.
            raise RuntimeError(f"CAS chunk map {chunk_map_path(rank)} is unparseable") from e
        for path, rec in doc.get("paths", {}).items():
            prev = merged.get(path)
            new = bool(rec.get("new")) or bool(prev and prev[2])
            merged[path] = (str(rec["k"]), int(rec["n"]), new)
    return merged


def rewrite_manifest_locations(manifest, merged: Dict[str, Tuple[str, int, bool]]) -> int:
    """Point every manifest entry whose location appears in ``merged`` at
    its chunk (``../chunks/<key>``), keeping byte ranges (the members of a
    batched slab share one chunk and keep their windows). Returns the
    number of locations rewritten."""
    from ..manifest import ChunkedArrayEntry, ShardedArrayEntry

    rewritten = 0

    def _fix(dense) -> None:
        nonlocal rewritten
        hit = merged.get(dense.location)
        if hit is not None:
            dense.location = chunk_location(hit[0])
            rewritten += 1

    for entry in manifest.values():
        if isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                _fix(shard.array)
        elif isinstance(entry, ChunkedArrayEntry):
            for chunk in entry.chunks:
                _fix(chunk.array)
        elif getattr(entry, "location", None) is not None:
            _fix(entry)
    return rewritten


async def maybe_rewrite_manifest(metadata, storage: StoragePlugin) -> None:
    """Rank-0 commit hook: when the take ran through a CAS wrapper, fold
    every rank's chunk map into the global manifest before the metadata
    blob is written. A no-op for legacy takes."""
    if not isinstance(storage, CASStoragePlugin):
        return
    merged = await load_chunk_maps(storage, metadata.world_size)
    if merged:
        n = rewrite_manifest_locations(metadata.manifest, merged)
        logger.debug(
            "CAS commit: rewrote %d manifest locations onto %d chunks",
            n, len({k for k, _, _ in merged.values()}),
        )
