"""N-dimensional shard-overlap math for elastic resharding.

Counterpart of ``torchsnapshot_tpu/parallel/overlap.py`` (``Box``,
``box_overlap``, ``subdivide_box``: copied, since importing the JAX
package is not allowed). A *box* is ``(offsets, sizes)``, the
hyper-rectangle ``[offsets[d], offsets[d] + sizes[d])`` per dimension.

Where the JAX package reads a device's box off ``devices_indices_map``,
a ``DTensor``'s box follows from its mesh coordinate and placements
(:func:`placements_box`): torch's ``Shard(d)`` cuts dim ``d`` with
``torch.chunk`` semantics, ceil-divided, so trailing coordinates may get
a short or an empty piece, and several mesh dimensions that shard the
same tensor dimension nest left to right. Placements are given here as
plain tuples (``("shard", dim)`` or ``("replicate",)``, see
``resharding.placement_spec``), so this module stays pure geometry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

# A placement as plain data: ("shard", tensor_dim) or ("replicate",).
PlacementSpec = Tuple[Any, ...]


@dataclass(frozen=True)
class Box:
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]

    @classmethod
    def from_dtensor(cls, dt: Any) -> "Box":
        """This rank's box of a ``DTensor``: its local shard's place in the
        global array."""
        from ..resharding import mesh_box

        mine = mesh_box(dt.device_mesh, dt.placements, dt.shape)
        if mine is None:
            raise ValueError("this rank is not part of the DTensor's device mesh")
        return mine[0]

    @property
    def ndim(self) -> int:
        return len(self.offsets)

    def numel(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def to_index(self) -> Tuple[slice, ...]:
        return tuple(slice(o, o + s) for o, s in zip(self.offsets, self.sizes))


def placements_box(
    shape: Sequence[int],
    mesh_shape: Sequence[int],
    coordinate: Sequence[int],
    spec: Sequence[PlacementSpec],
) -> Box:
    """The box that mesh ``coordinate`` holds of an array of ``shape``
    placed by ``spec`` (one entry per mesh dimension), with torch's
    ``Shard`` semantics: mesh dimensions apply left to right, each cutting
    the current extent of its tensor dimension into ``mesh_shape[i]``
    chunks of ``ceil(extent / n)``; a chunk past the end is empty and sits
    at the array's end in that dimension, as torch places it
    (``compute_local_shape_and_global_offset``)."""
    if not (len(mesh_shape) == len(coordinate) == len(spec)):
        raise ValueError(
            f"mesh shape {tuple(mesh_shape)}, coordinate {tuple(coordinate)} and "
            f"{len(spec)} placements disagree in rank"
        )
    offsets = [0] * len(shape)
    sizes = [int(d) for d in shape]
    for n, c, p in zip(mesh_shape, coordinate, spec):
        if p[0] != "shard":
            continue
        d = p[1]
        chunk = -(-sizes[d] // n)
        start = min(c * chunk, sizes[d])
        sizes[d] = max(0, min(chunk, sizes[d] - start))
        offsets[d] = offsets[d] + start if sizes[d] else int(shape[d])
    return Box(tuple(offsets), tuple(sizes))


def writes_box(coordinate: Sequence[int], spec: Sequence[PlacementSpec]) -> bool:
    """The write-once election (the JAX package's ``replica_id == 0``): of
    the mesh coordinates that hold the same box, the one at 0 on every
    mesh dimension whose placement is ``Replicate`` writes it."""
    return all(c == 0 for c, p in zip(coordinate, spec) if p[0] == "replicate")


@dataclass(frozen=True)
class Overlap:
    """The intersection of a saved box and a destination box, expressed in
    each one's local coordinates."""

    src_slices: Tuple[slice, ...]  # into the saved shard's local array
    dst_slices: Tuple[slice, ...]  # into the destination box's local array


def box_overlap(saved: Box, dst: Box) -> Optional[Overlap]:
    """Per-dimension interval intersection; None when disjoint."""
    if saved.ndim != dst.ndim:
        raise ValueError(
            f"Rank mismatch: saved box has {saved.ndim} dims, destination "
            f"has {dst.ndim}"
        )
    src_slices: List[slice] = []
    dst_slices: List[slice] = []
    for d in range(saved.ndim):
        lo = max(saved.offsets[d], dst.offsets[d])
        hi = min(saved.offsets[d] + saved.sizes[d], dst.offsets[d] + dst.sizes[d])
        if hi <= lo:
            return None
        src_slices.append(slice(lo - saved.offsets[d], hi - saved.offsets[d]))
        dst_slices.append(slice(lo - dst.offsets[d], hi - dst.offsets[d]))
    return Overlap(tuple(src_slices), tuple(dst_slices))


def subdivide_box(box: Box, max_bytes: int, itemsize: int) -> List[Box]:
    """Split a box along dim 0 into pieces of at most ``max_bytes`` (rows
    larger than the budget stay whole)."""
    if box.numel() * itemsize <= max_bytes or box.ndim == 0 or box.sizes[0] <= 1:
        return [box]
    row_elems = box.numel() // box.sizes[0]
    rows_per_piece = max(1, max_bytes // max(1, row_elems * itemsize))
    pieces = []
    for start in range(0, box.sizes[0], rows_per_piece):
        rows = min(rows_per_piece, box.sizes[0] - start)
        pieces.append(
            Box(
                offsets=(box.offsets[0] + start,) + box.offsets[1:],
                sizes=(rows,) + box.sizes[1:],
            )
        )
    return pieces
