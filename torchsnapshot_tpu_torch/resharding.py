"""Shared N-d resharding geometry: one home for the shard-overlap algebra.

Counterpart of ``torchsnapshot_tpu/resharding.py``, copied (the port does
not import the JAX package): which saved shard *boxes* overlap which
destination boxes (``Box`` / ``box_overlap`` from ``parallel/overlap.py``),
and which contiguous byte windows of a saved blob a set of overlaps needs
(row-slab planning), so a ranged read fetches only those bytes.

Row-major invariant: rows ``[row_lo, row_hi)`` of an N-d shard stored with
the buffer-protocol serializer are one contiguous byte range (``row_nbytes``
= itemsize x product of trailing dims). Overlaps that slice trailing dims
still ride a row-banded read; the consumer slices the columns out.

Where the JAX package asks a ``jax.sharding.Sharding`` for a process's
device boxes (``target_boxes_for_sharding``), the port asks a torch
``DeviceMesh`` and its placements (:func:`target_boxes_for_placements`).
:func:`placement_spec` is the one place that reads torch placement types:
``Shard`` and ``Replicate`` map to boxes; ``Partial`` (no value until it is
reduced) and ``_StridedShard`` (strided, not a box) are refused by name.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .parallel.overlap import (
    Box,
    Overlap,
    PlacementSpec,
    box_overlap,
    placements_box,
    subdivide_box,
    writes_box,
)

__all__ = [
    "Box",
    "Overlap",
    "box_overlap",
    "subdivide_box",
    "mesh_box",
    "placement_spec",
    "placements_box",
    "writes_box",
    "RowSlabCopy",
    "RowSlabRead",
    "plan_row_slab_reads",
    "row_slab_byte_window",
    "target_boxes_for_placements",
    "assign_shard_owners",
]


def placement_spec(placements: Sequence[Any], ndim: int) -> Tuple[PlacementSpec, ...]:
    """Torch placements as plain tuples: ``("shard", dim)`` with ``dim``
    normalized, or ``("replicate",)``. Raises on what has no box."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    out: List[PlacementSpec] = []
    for p in placements:
        if isinstance(p, _StridedShard):
            raise NotImplementedError(
                f"placement {p!r} (_StridedShard, e.g. FSDP2 over tensor parallel) shards a "
                f"dimension in strides, not boxes; torchsnapshot_tpu_torch takes Shard and "
                f"Replicate placements only: redistribute to them before the snapshot"
            )
        if isinstance(p, Partial):
            raise ValueError(
                f"placement {p!r} (Partial) holds a pending reduction: the tensor has no "
                f"value until it is reduced; redistribute to Shard or Replicate first"
            )
        if isinstance(p, Shard):
            dim = p.dim + ndim if p.dim < 0 else p.dim
            if not 0 <= dim < ndim:
                raise ValueError(f"placement {p!r} names no dimension of a {ndim}-d tensor")
            out.append(("shard", dim))
        elif isinstance(p, Replicate):
            out.append(("replicate",))
        else:
            raise NotImplementedError(f"placement {p!r} is not supported (Shard and Replicate are)")
    return tuple(out)


def mesh_box(
    mesh: Any, placements: Sequence[Any], shape: Sequence[int]
) -> Optional[Tuple[Box, Tuple[int, ...], Tuple[PlacementSpec, ...]]]:
    """This rank's ``(box, mesh coordinate, placement spec)`` of an array of
    ``shape`` placed on ``mesh`` by ``placements``; None when the rank is
    not in the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    coord = tuple(int(c) for c in coord)
    spec = placement_spec(placements, len(shape))
    return placements_box(tuple(int(d) for d in shape), tuple(mesh.shape), coord, spec), coord, spec


def target_boxes_for_placements(
    mesh: Any, placements: Sequence[Any], shape: Sequence[int]
) -> Dict[Box, List[Tuple[int, ...]]]:
    """Destination boxes of an array of ``shape`` placed on ``mesh`` by
    ``placements``, grouped as the JAX function groups replicas: box ->
    the mesh coordinates this process holds it at (one coordinate: a torch
    rank is one device; empty when the rank is not in the mesh)."""
    mine = mesh_box(mesh, placements, shape)
    if mine is None:
        return {}
    box, coord, _ = mine
    return {box: [coord]}


@dataclass(frozen=True)
class RowSlabCopy:
    """One copy out of a row-slab read buffer into a destination view.

    ``overlap_index`` names which input overlap this copy feeds;
    ``dst_rows`` slices dim 0 of that overlap's destination view (the
    rows of the overlap this slab covers); ``src_slices`` index the read
    buffer (shape ``(rows,) + shard_trailing_dims``)."""

    overlap_index: int
    dst_rows: slice
    src_slices: Tuple[slice, ...]


@dataclass(frozen=True)
class RowSlabRead:
    """One ranged read of rows ``[rows[0], rows[1])`` of a saved shard:
    the absolute ``byte_range`` within its blob, the buffer shape the
    bytes deserialize into, and every overlap copy it feeds."""

    rows: Tuple[int, int]
    byte_range: Tuple[int, int]
    buf_shape: Tuple[int, ...]
    copies: Tuple[RowSlabCopy, ...]


def plan_row_slab_reads(
    shard_sizes: Sequence[int],
    overlaps: Sequence[Overlap],
    row_nbytes: int,
    base: int = 0,
    buffer_limit_bytes: Optional[int] = None,
) -> Optional[List[RowSlabRead]]:
    """Plan ranged row-band reads of one saved shard feeding ``overlaps``.

    The band is the smallest row range ``[row_lo, row_hi)`` covering
    every overlap; under ``buffer_limit_bytes`` it splits into multiple
    reads so host memory stays bounded. Returns ``None`` when a single
    whole-shard read is already optimal (the band spans every row and
    fits the limit) or when the shard is 0-d: the caller then issues its
    ordinary whole-blob read. Only valid for raw row-major
    (buffer-protocol) payloads."""
    sizes = tuple(int(s) for s in shard_sizes)
    if not sizes or not overlaps:
        return None
    row_lo = min(ov.src_slices[0].start for ov in overlaps)
    row_hi = max(ov.src_slices[0].stop for ov in overlaps)
    total = (row_hi - row_lo) * row_nbytes
    rows_per_read = row_hi - row_lo
    if buffer_limit_bytes is not None and total > buffer_limit_bytes:
        rows_per_read = max(1, buffer_limit_bytes // max(1, row_nbytes))
    if row_lo == 0 and row_hi == sizes[0] and rows_per_read >= row_hi - row_lo:
        return None
    reads: List[RowSlabRead] = []
    for p0 in range(row_lo, row_hi, rows_per_read):
        p1 = min(p0 + rows_per_read, row_hi)
        copies: List[RowSlabCopy] = []
        for idx, ov in enumerate(overlaps):
            a, b = ov.src_slices[0].start, ov.src_slices[0].stop
            m0, m1 = max(a, p0), min(b, p1)
            if m1 <= m0:
                continue
            copies.append(
                RowSlabCopy(
                    overlap_index=idx,
                    dst_rows=slice(m0 - a, m1 - a),
                    src_slices=(slice(m0 - p0, m1 - p0),) + ov.src_slices[1:],
                )
            )
        reads.append(
            RowSlabRead(
                rows=(p0, p1),
                byte_range=(base + p0 * row_nbytes, base + p1 * row_nbytes),
                buf_shape=(p1 - p0,) + sizes[1:],
                copies=tuple(copies),
            )
        )
    return reads


def row_slab_byte_window(
    shard_sizes: Sequence[int],
    overlap: Overlap,
    row_nbytes: int,
    base: int = 0,
) -> Optional[Tuple[int, int]]:
    """The absolute byte window of ONE overlap's rows, when (and only
    when) the overlap spans the full extent of every trailing dim.
    ``None`` for 0-d shards or trailing-sliced overlaps."""
    sizes = tuple(int(s) for s in shard_sizes)
    if not sizes:
        return None
    for d in range(1, len(sizes)):
        s = overlap.src_slices[d]
        if s.start != 0 or s.stop != sizes[d]:
            return None
    r = overlap.src_slices[0]
    return (base + r.start * row_nbytes, base + r.stop * row_nbytes)


def assign_shard_owners(locations: Iterable[str], world_size: int) -> Dict[str, int]:
    """Deterministic owner rank per unique saved-shard blob: a stable
    content hash (CRC32 of the sorted locations; ``hash()`` is randomized
    per process) round-robined over the sorted locations. Every rank
    computing this over the same manifest gets the same table."""
    world = max(1, int(world_size))
    locs = sorted(set(locations))
    if not locs:
        return {}
    start = zlib.crc32("\n".join(locs).encode("utf-8")) % world
    return {loc: (start + i) % world for i, loc in enumerate(locs)}
