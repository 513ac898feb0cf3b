"""Write-load balancing of replicated state across ranks.

Counterpart of ``torchsnapshot_tpu/partitioner.py``, and deterministic in
the same way, so that both packages give the same rank the same replicated
blob. Replicated state exists identically on every rank; writing it from
all of them wastes bandwidth, writing it all from rank 0 serializes the
save. So the write requests of replicated entries are spread over the
ranks with a greedy argmin bin-packing, seeded with each rank's own
(per-rank) write load. Chunked entries are sub-partitionable: their chunks
can land on different ranks; everything else is assigned whole.

Rank 0 computes the assignment and broadcasts it, so every rank agrees.
Entries are not trimmed to the owned chunks: every rank keeps complete
entries, and the manifest gather deduplicates them.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from . import knobs
from .io_types import WriteReq
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    is_container_entry,
    is_replicated,
)
from .pg_wrapper import PGWrapper

logger: logging.Logger = logging.getLogger(__name__)


def _estimate_write_req_size(req: WriteReq) -> int:
    """Staging cost is a faithful stand-in for bytes-on-storage for arrays
    and a best-effort one for pickled objects (reference
    _estimate_write_req_storage_size, partitioner.py:82-90)."""
    return max(1, req.buffer_stager.get_staging_cost_bytes())


def partition_write_reqs(
    entries: Manifest, write_reqs: List[WriteReq], pg_wrapper: PGWrapper
) -> Tuple[Manifest, List[WriteReq]]:
    """Drop this rank's replicated write requests that other ranks will
    write instead; returns (entries, kept_write_reqs).

    Reference parity: partition_write_reqs (partitioner.py:169-233).
    """
    if pg_wrapper.get_world_size() == 1:
        return entries, write_reqs
    if knobs.is_partitioner_disabled():
        raise NotImplementedError(
            "TORCHSNAPSHOT_TPU_DISABLE_PARTITIONER is set; the reference "
            "raises here too (partitioner.py:199-202)"
        )

    replicated_reqs: Dict[str, WriteReq] = {}
    kept: List[WriteReq] = []
    base_load = 0
    for req in write_reqs:
        if req.path.startswith("replicated/"):
            replicated_reqs[req.path] = req
        else:
            kept.append(req)
            base_load += _estimate_write_req_size(req)

    # (path -> size) for this rank's replicated write requests; identical
    # across ranks by construction (same state, same chunking knobs).
    local_items = {
        path: _estimate_write_req_size(req)
        for path, req in replicated_reqs.items()
    }

    # Gather-to-leader: only rank 0 consumes the per-rank item/load lists
    # (it computes the assignment and broadcasts it) — non-leaders must
    # not each pull O(world x items) through the coordinator.
    gathered_items = pg_wrapper.gather_object(sorted(local_items.items()))
    gathered_loads = pg_wrapper.gather_object(base_load)

    assignment: Dict[str, int] = {}
    if pg_wrapper.get_rank() == 0:
        assert gathered_items is not None and gathered_loads is not None
        # Union of items across ranks (a path replicated on a strict subset
        # of ranks was already rejected by replication verification, but be
        # permissive here); each item is assignable to any rank that has it.
        item_holders: Dict[str, List[int]] = {}
        item_sizes: Dict[str, int] = {}
        for rnk, items in enumerate(gathered_items):
            for path, size in items:
                item_holders.setdefault(path, []).append(rnk)
                item_sizes[path] = size
        loads = list(gathered_loads)
        for path in sorted(
            item_sizes, key=lambda p: item_sizes[p], reverse=True
        ):
            holders = item_holders[path]
            target = min(holders, key=lambda r: loads[r])
            assignment[path] = target
            loads[target] += item_sizes[path]
    assignment = pg_wrapper.broadcast_object(assignment)

    rank = pg_wrapper.get_rank()
    for path, req in replicated_reqs.items():
        if assignment.get(path, 0) == rank:
            kept.append(req)
    logger.debug(
        "Rank %d keeps %d/%d replicated write reqs after partitioning",
        rank,
        len(kept) + len(replicated_reqs) - len(write_reqs),
        len(replicated_reqs),
    )
    return entries, kept


def consolidate_replicated_entries(
    gathered_manifests: List[Manifest],
) -> Dict[str, Entry]:
    """Merge replicated entries across gathered rank manifests into one
    complete entry per logical path (reference partitioner.py:236-292).

    With untrimmed entries this is mostly an equality assertion; chunked
    entries are unioned by chunk offsets for safety.
    """
    merged: Dict[str, Entry] = {}
    for manifest in gathered_manifests:
        for path, entry in manifest.items():
            if not is_replicated(entry) or is_container_entry(entry):
                continue
            if path not in merged:
                merged[path] = entry
                continue
            existing = merged[path]
            if isinstance(entry, ChunkedArrayEntry) and isinstance(
                existing, ChunkedArrayEntry
            ):
                by_offsets = {tuple(c.offsets): c for c in existing.chunks}
                for chunk in entry.chunks:
                    key = tuple(chunk.offsets)
                    if key not in by_offsets or _prefer_rewritten(
                        chunk.array, by_offsets[key].array
                    ):
                        by_offsets[key] = chunk
                merged[path] = ChunkedArrayEntry(
                    dtype=entry.dtype,
                    shape=entry.shape,
                    chunks=[by_offsets[k] for k in sorted(by_offsets)],
                    replicated=True,
                )
            elif entry != existing:
                # Slab batching rewrites an entry's location/byte_range on
                # the one rank that owns the write; that rewritten entry is
                # the authoritative one (the original location was never
                # written by anybody).
                if _is_entry_rewritten(entry, existing):
                    merged[path] = entry
                elif _is_entry_rewritten(existing, entry):
                    pass  # existing already authoritative
                else:
                    raise AssertionError(
                        f"Replicated entry mismatch across ranks for {path!r}: "
                        f"{existing} != {entry}"
                    )
    return merged


def _prefer_rewritten(candidate: ArrayEntry, incumbent: ArrayEntry) -> bool:
    """True when ``candidate`` is the batch-rewritten flavor of
    ``incumbent`` (same logical payload, slab location)."""
    return candidate.location.startswith(
        "batched/"
    ) and not incumbent.location.startswith("batched/")


def _is_entry_rewritten(entry: Entry, other: Entry) -> bool:
    if not isinstance(entry, ArrayEntry) or not isinstance(other, ArrayEntry):
        return False
    if not _prefer_rewritten(entry, other):
        return False
    # Payload-identifying fields must still agree.
    return (
        entry.dtype == other.dtype
        and entry.shape == other.shape
        and entry.serializer == other.serializer
        and entry.replicated == other.replicated
    )
