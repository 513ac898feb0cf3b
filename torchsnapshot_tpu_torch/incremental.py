"""Incremental takes: skip unchanged chunks through content digests.

Counterpart of ``torchsnapshot_tpu/incremental.py`` for one process. The
digest of every chunk of every CUDA leaf is computed on the card, in one
launch of the hand-written digest kernel per card
(``ops/device_digest.py``, ``csrc/device_digest.cu``), so only 8 bytes a
chunk cross to the host; CPU leaves are digested on the host. A chunk
whose digest, dtype and shape match the base snapshot's entry is neither
copied to the host nor written: the new manifest references the base's
blob through a ``../<base>/...`` location, which the filesystem plugin
resolves lexically. Chained references collapse to the snapshot that
wrote the bytes.

Granularity is the write granularity of the preparers: whole dense
tensors, or dim-0 chunks of large ones (tighter for digest-enabled takes:
``TORCHSNAPSHOT_TPU_INCREMENTAL_CHUNK_BYTES``). The referenced blobs'
checksum entries are inherited into the new snapshot's table, so restore
verifies them too.

Deliberate difference from the JAX package: it catches a failed digest
dispatch and writes the leaf in full (``incremental.py:288-312``,
``:433-444`` there). Here a CUDA leaf whose kernel fails to build or launch
raises, so a broken kernel cannot hide behind full takes. Only a base that
is missing, unreadable or not relatively addressable degrades to a full
take, as in the reference. Sharded (``DTensor``) leaves are not ported and
are refused.
"""

from __future__ import annotations

import asyncio
import logging
import os
import posixpath
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import knobs
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    ShardedArrayEntry,
    get_manifest_for_rank,
)
from .ops import device_digest as dd
from .serialization import DTYPE_TO_STRING, Serializer, dtype_to_string

logger: logging.Logger = logging.getLogger(__name__)

ChunkKey = Tuple[Tuple[int, ...], Tuple[int, ...]]  # (offsets, sizes)

# Schemes whose plugins resolve parent-relative (``../``) locations. The
# port has the filesystem plugin; ``memory://`` stores are flat per-name
# dicts, so refs into another store could never be read back.
_REF_CAPABLE_SCHEMES = ("fs", "s3", "gs")


def relative_ref_prefix(new_path: str, base_path: str) -> Optional[str]:
    """Relative prefix from the new snapshot root to the base's, or None
    when no resolvable lexical relation exists (another scheme, another
    bucket, a scheme whose plugin cannot resolve parent refs, or the same
    root). fs roots are made absolute first, so the prefix does not depend
    on the working directory at take time."""
    from .storage_plugin import _parse_url

    new_scheme, new_root = _parse_url(new_path)
    base_scheme, base_root = _parse_url(base_path)
    if new_scheme != base_scheme or new_scheme not in _REF_CAPABLE_SCHEMES:
        return None
    new_root = new_root.rstrip("/")
    base_root = base_root.rstrip("/")
    if not new_root or not base_root:
        return None
    if new_scheme == "fs":
        new_root = os.path.abspath(new_root)
        base_root = os.path.abspath(base_root)
    if new_root == base_root:
        return None
    if new_scheme in ("s3", "gs") and new_root.split("/", 1)[0] != base_root.split("/", 1)[0]:
        return None
    rel = posixpath.relpath(base_root, new_root)
    if rel.startswith(("/", "./")) or rel == ".":
        return None
    return rel


class LeafIncrementalPlan:
    """Digest-comparison results for one leaf, consumed by the array
    preparers chunk by chunk: ``ref_entry`` returns a base-referencing
    entry for an unchanged chunk (the preparer then makes no stager),
    ``digest_for`` the digest to record on a written chunk."""

    def __init__(
        self,
        refs: Dict[ChunkKey, Tuple[ArrayEntry, str]],
        digests: Dict[ChunkKey, str],
        on_ref_used: Callable[[str, str], None],
    ) -> None:
        # chunk key -> (ref entry template, base-manifest location)
        self._refs = refs
        self._digests = digests
        self._on_ref_used = on_ref_used

    def ref_entry(self, offsets, sizes, replicated: bool) -> Optional[ArrayEntry]:
        hit = self._refs.get((tuple(offsets), tuple(sizes)))
        if hit is None:
            return None
        template, base_location = hit
        clone = ArrayEntry(
            location=template.location,
            serializer=template.serializer,
            dtype=template.dtype,
            shape=list(template.shape),
            replicated=replicated,
            byte_range=template.byte_range,
            digest=template.digest,
        )
        self._on_ref_used(clone.location, base_location)
        return clone

    def digest_for(self, offsets, sizes) -> Optional[str]:
        return self._digests.get((tuple(offsets), tuple(sizes)))


class _DigestBatch:
    """The digest work of one card: one kernel launch for all its specs."""

    def __init__(self) -> None:
        self.specs: List[Tuple[torch.Tensor, Optional[Tuple[Tuple[int, int], ...]]]] = []
        # One (logical_path, chunk_key) per output row.
        self.rows: List[Tuple[str, ChunkKey]] = []


def _base_chunk_map(entry: Entry) -> Dict[ChunkKey, ArrayEntry]:
    """Every (offsets, sizes) box the base holds bytes for, with its dense
    entry, so a leaf that changed between dense and chunked still matches
    the boxes that survived."""
    out: Dict[ChunkKey, ArrayEntry] = {}
    if isinstance(entry, ArrayEntry):
        shape = tuple(entry.shape)
        out[(tuple(0 for _ in shape), shape)] = entry
    elif isinstance(entry, ChunkedArrayEntry):
        for chunk in entry.chunks:
            out[(tuple(chunk.offsets), tuple(chunk.sizes))] = chunk.array
    elif isinstance(entry, ShardedArrayEntry):  # written by the JAX package
        for shard in entry.shards:
            out[(tuple(shard.offsets), tuple(shard.sizes))] = shard.array
    return out


def _is_sharded(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and hasattr(leaf, "device_mesh") and hasattr(
        leaf, "placements"
    )


class IncrementalTakeContext:
    """Take-scoped digest state: the launched digests, the base's chunk
    map, and the refs actually used (for checksum inheritance)."""

    def __init__(
        self,
        base_available: Optional[Manifest],
        ref_prefix: Optional[str],
        base_path: Optional[str],
        base_world_size: int,
    ) -> None:
        self._base_available = base_available or {}
        self._ref_prefix = ref_prefix
        self._base_path = base_path
        self._base_world_size = base_world_size
        # logical_path -> ordered chunk keys (the leaf's digest layout)
        self._layouts: Dict[str, List[ChunkKey]] = {}
        # (logical_path, chunk_key) -> (d1, d2); host digests land at
        # launch, device digests at the first plan_for.
        self._results: Dict[Tuple[str, ChunkKey], Tuple[int, int]] = {}
        self._launched: List[Tuple[torch.Tensor, List[Tuple[str, ChunkKey]]]] = []
        self._current_leaves: Dict[str, Any] = {}
        # new (normalized) ref location -> base-manifest location
        self.used_refs: Dict[str, str] = {}

    @classmethod
    def build(cls, path: str, incremental_base: Optional[Any]) -> "IncrementalTakeContext":
        """``incremental_base`` is a snapshot path or Snapshot. None (or a
        base that cannot be read or referenced relatively) gives a context
        that records digests only: the take writes everything, and can
        serve as the next take's base."""
        if incremental_base is None:
            return cls(None, None, None, 0)
        from .snapshot import Snapshot

        base = (
            incremental_base
            if isinstance(incremental_base, Snapshot)
            else Snapshot(str(incremental_base))
        )
        try:
            metadata = base.metadata
        except Exception as e:  # noqa: BLE001 - base gone: full take
            logger.warning(
                "Incremental base %s unreadable (%r); taking a full snapshot", base.path, e
            )
            return cls(None, None, None, 0)
        ref_prefix = relative_ref_prefix(path, base.path)
        if ref_prefix is None:
            logger.warning(
                "Incremental base %s is not relatively addressable from %s; taking a "
                "full snapshot (digests still recorded)",
                base.path, path,
            )
            return cls(None, None, None, 0)
        return cls(get_manifest_for_rank(metadata, 0), ref_prefix, base.path, metadata.world_size)

    # ------------------------------------------------------------------
    # pass 1: launch digests
    # ------------------------------------------------------------------

    def launch(self, flattened: Dict[str, Any]) -> None:
        """Start the digests of every eligible leaf before any stager
        exists, so skip decisions precede device-to-host copies: one kernel
        launch per card (on its current stream), host digests inline."""
        for batch in self.collect(flattened).values():
            self._launched.append((dd.digest_many_async(batch.specs), batch.rows))

    def collect(self, flattened: Dict[str, Any]) -> Dict[torch.device, "_DigestBatch"]:
        """The digest layout of every eligible leaf: the CUDA leaves' work,
        one batch per card (returned, not launched); CPU leaves are
        digested here."""
        self._current_leaves = flattened
        batches: Dict[torch.device, _DigestBatch] = {}
        for logical_path, leaf in flattened.items():
            self._collect_leaf(logical_path, leaf, batches)
        return batches

    def _collect_leaf(
        self, logical_path: str, leaf: Any, batches: Dict[torch.device, _DigestBatch]
    ) -> None:
        from .io_preparer import (
            ChunkedArrayIOPreparer,
            PrimitivePreparer,
            as_tensor_leaf,
            chunk_shapes,
            effective_max_chunk_size_bytes,
        )

        if PrimitivePreparer.should_inline(leaf):
            return
        if _is_sharded(leaf):
            raise NotImplementedError(
                f"{logical_path!r} is a sharded tensor (DTensor): incremental takes of "
                f"sharded leaves are not ported to torchsnapshot_tpu_torch yet"
            )
        tensor = as_tensor_leaf(leaf)
        if tensor is None or not dd.digest_supported(tensor.dtype):
            return
        shape = tuple(int(d) for d in tensor.shape)
        if ChunkedArrayIOPreparer.should_chunk(tensor, incremental=True):
            ranges = chunk_shapes(
                list(shape), tensor.element_size(), effective_max_chunk_size_bytes(True)
            )
            keys = [((a,) + (0,) * (len(shape) - 1), (b - a,) + shape[1:]) for a, b in ranges]
            spec = (tensor, tuple(ranges))
        else:
            ranges = None
            keys = [((0,) * len(shape), shape)]
            spec = (tensor, None)
        if tensor.is_cuda:
            batch = batches.setdefault(tensor.device, _DigestBatch())
            batch.specs.append(spec)
            batch.rows.extend((logical_path, k) for k in keys)
        elif tensor.device.type == "cpu":
            pieces = [tensor] if ranges is None else [tensor[a:b] for a, b in ranges]
            for key, piece in zip(keys, pieces):
                self._results[(logical_path, key)] = dd.digest_host(piece)
        else:
            return
        self._layouts[logical_path] = keys

    def _materialize_all(self) -> None:
        """Read every card's digests (one 8-bytes-a-row copy each); the
        first ``plan_for`` blocks here."""
        for digests, rows in self._launched:
            for (path, key), row in zip(rows, dd.materialize_many(digests)):
                self._results[(path, key)] = (int(row[0]), int(row[1]))
        self._launched = []

    # ------------------------------------------------------------------
    # pass 2: compare
    # ------------------------------------------------------------------

    def plan_for(self, logical_path: str) -> Optional[LeafIncrementalPlan]:
        keys = self._layouts.get(logical_path)
        if keys is None:
            return None
        self._materialize_all()
        digests = {key: dd.format_digest(self._results[(logical_path, key)]) for key in keys}
        refs: Dict[ChunkKey, Tuple[ArrayEntry, str]] = {}
        base_entry = self._base_available.get(logical_path)
        current_dtype = self._current_dtype(logical_path)
        if base_entry is not None and self._ref_prefix is not None and current_dtype is not None:
            for key, base_chunk in _base_chunk_map(base_entry).items():
                # The digest covers bytes, not the type tag: the base chunk
                # must also match the leaf's dtype and the box's shape, and
                # be a per-rank (not replicated) entry as this take's are.
                if (
                    key in digests
                    and base_chunk.digest == digests[key]
                    and base_chunk.dtype == current_dtype
                    and base_chunk.serializer == Serializer.BUFFER_PROTOCOL.value
                    and list(base_chunk.shape) == list(key[1])
                    and not base_chunk.replicated
                ):
                    template = ArrayEntry(
                        location=posixpath.normpath(
                            posixpath.join(self._ref_prefix, base_chunk.location)
                        ),
                        serializer=base_chunk.serializer,
                        dtype=base_chunk.dtype,
                        shape=list(base_chunk.shape),
                        replicated=base_chunk.replicated,
                        byte_range=base_chunk.byte_range,
                        digest=base_chunk.digest,
                    )
                    # Second element: the location as the base manifest
                    # spells it, the key of its checksum table.
                    refs[key] = (template, base_chunk.location)

        def on_ref_used(ref_location: str, base_location: str) -> None:
            self.used_refs[ref_location] = base_location

        return LeafIncrementalPlan(refs, digests, on_ref_used)

    def _current_dtype(self, logical_path: str) -> Optional[str]:
        from .io_preparer import as_tensor_leaf

        tensor = as_tensor_leaf(self._current_leaves.get(logical_path))
        if tensor is None or tensor.dtype not in DTYPE_TO_STRING:
            return None
        return dtype_to_string(tensor.dtype)

    # ------------------------------------------------------------------
    # checksum inheritance
    # ------------------------------------------------------------------

    def inherit_checksums(self, checksums: Dict[str, tuple]) -> None:
        """Copy the base's checksum entries of every referenced blob into
        this take's table (keyed by the ref location), so restore verifies
        unwritten bytes too. Fail-soft: the data blobs are durable by now,
        and an unreadable base table leaves the refs unverified, with a
        warning, rather than failing the take."""
        if not self.used_refs or self._base_path is None or knobs.is_checksums_disabled():
            return
        from .integrity import load_checksum_tables
        from .storage_plugin import url_to_storage_plugin

        base_table = None
        event_loop = asyncio.new_event_loop()
        try:
            storage = url_to_storage_plugin(self._base_path)
            try:
                base_table = load_checksum_tables(self._base_world_size, storage, event_loop)
            finally:
                event_loop.run_until_complete(storage.close())
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "Could not inherit checksum tables from base %s (%r); referenced blobs "
                "will restore unverified",
                self._base_path, e,
            )
        finally:
            event_loop.close()
        if not base_table:
            return
        for ref_loc, base_loc in self.used_refs.items():
            entry = base_table.get(base_loc)
            if entry is not None:
                checksums[ref_loc] = entry
