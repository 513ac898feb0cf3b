"""Sharded-tensor preparer: ``DTensor`` checkpointing in the JAX package's
``ShardedArray`` format, with elastic resharding on restore.

Counterpart of ``torchsnapshot_tpu/sharded_io_preparer.py``. Where the JAX
package walks a ``jax.Array``'s addressable device shards, a torch rank
holds one local shard of a ``DTensor``; its place in the global array
follows from the rank's mesh coordinate and the placements
(``parallel/overlap.py`` ``placements_box``, torch's ``Shard`` chunk
semantics: trailing ranks may hold a short or an empty box).

Write side:

- A rank writes its box only if its coordinate is 0 on every mesh
  dimension whose placement is ``Replicate`` (the JAX package's
  ``replica_id == 0``): each distinct box is written once, with no
  coordination round. An empty box writes nothing.
- Boxes larger than the shard-size knob subdivide along dim 0, at the
  places the JAX package cuts, under the same ``sharded/{path}_{offsets}``
  locations, so the same global array cut into the same boxes gives the
  same entry field for field in either package.
- An incremental take consults the leaf's plan per piece: an unchanged
  piece references the base's blob and gets no stager.

Read side (resharding):

- The destination box comes from the live ``DTensor``'s mesh and
  placements (whatever they were at the take), from a ``(mesh,
  placements)`` target (``read_object(sharding=)``), or is the whole array
  for a plain tensor. Every saved shard that overlaps it is read once, as
  a ranged row band where the overlap is a row range of the shard.
- The box lands on the card: in place into the ``DTensor``'s local tensor
  (``restore``), or in a fresh local tensor wrapped by
  ``DTensor.from_local(..., shape=, stride=, run_check=False)``, which
  runs no collective (``async_restore``, ``read_object``).
"""

from __future__ import annotations

import asyncio
import logging
import warnings
from concurrent.futures import Executor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .io_types import BufferConsumer, BufferType, ReadReq, WriteReq
from .manifest import ArrayEntry, ChunkedArrayEntry, Shard, ShardedArrayEntry
from .resharding import (
    Box,
    Overlap,
    box_overlap,
    mesh_box,
    placement_spec,
    plan_row_slab_reads,
    subdivide_box,
    writes_box,
)
from .serialization import (
    Serializer,
    array_size_bytes,
    copy_bytes_into,
    dtype_to_string,
    empty_tensor,
    string_to_dtype,
    tensor_from_numpy,
    try_writable_byte_view,
)
from .telemetry import names as metric_names
from .utils.tracing import trace_annotation

logger: logging.Logger = logging.getLogger(__name__)

# Below this size a buffer is consumed inline on the event loop.
_INLINE_CONSUME_MAX_BYTES = 1 << 20


def is_dtensor(obj: Any) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (parameters
    included), without importing torch.distributed for plain tensors."""
    if not isinstance(obj, torch.Tensor) or type(obj) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(obj, DTensor)


def is_sharded_dtensor(obj: Any) -> bool:
    """A ``DTensor`` partitioned over its mesh: some placement is ``Shard``
    on a mesh dimension of size > 1 (the JAX package's
    ``is_sharded_array``). A fully-replicated ``DTensor``, or one on a mesh
    of one device, is dense: its local tensor is the whole value. Raises on
    placements that have no box (``Partial``, ``_StridedShard``)."""
    if not is_dtensor(obj):
        return False
    spec = placement_spec(obj.placements, obj.ndim)
    return any(p[0] == "shard" and n > 1 for p, n in zip(spec, obj.device_mesh.shape))


def local_tensor(dt: Any) -> torch.Tensor:
    """The ``DTensor``'s local shard, sharing its storage (under no_grad
    ``to_local`` returns the local tensor itself, not an autograd view)."""
    with torch.no_grad():
        return dt.to_local().detach()


def _shard_location(logical_path: str, box: Box) -> str:
    """Storage path of one shard box: ``sharded/{path}_{offsets}``."""
    suffix = "_".join(str(o) for o in box.offsets) or "scalar"
    return f"sharded/{logical_path}_{suffix}"


def _contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= max(1, d)
    return tuple(reversed(stride))


def _tensor_of(buf: BufferType, dtype: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """A read-only CPU tensor over a read buffer's bytes (no copy)."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    with warnings.catch_warnings():
        # Read buffers may be immutable; the tensor is only read from.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(raw)
    return t.view(string_to_dtype(dtype)).reshape(shape)


class _OverlapConsumer(BufferConsumer):
    """Deserializes one saved shard (or a row band of it) and copies every
    overlap region into its destination view."""

    def __init__(
        self,
        dtype: str,
        buf_shape: Tuple[int, ...],
        copies: List[Tuple[torch.Tensor, Tuple[slice, ...]]],
        dest_owned: bool = False,
    ) -> None:
        self.dtype = dtype
        self.buf_shape = tuple(buf_shape)
        self.copies = copies  # (destination view, slices of the read buffer)
        self.dest_owned = dest_owned

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        if self.get_consuming_cost_bytes() <= _INLINE_CONSUME_MAX_BYTES:
            self._consume_sync(buf)
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(executor, self._consume_sync, buf)

    def _whole(self) -> Optional[torch.Tensor]:
        """The destination when this read is one straight copy of the whole
        buffer into a contiguous view."""
        if len(self.copies) != 1:
            return None
        dst, src_slices = self.copies[0]
        if tuple(dst.shape) != self.buf_shape or src_slices != tuple(
            slice(0, s) for s in self.buf_shape
        ):
            return None
        if not dst.is_contiguous() or dtype_to_string(dst.dtype) != self.dtype:
            return None
        return dst

    def _consume_sync(self, buf: BufferType) -> None:
        with trace_annotation(metric_names.SPAN_LEAF_CONSUME):
            whole = self._whole()
            if whole is not None:
                copy_bytes_into(whole, buf)
                return
            src = _tensor_of(buf, self.dtype, self.buf_shape)
            for dst, src_slices in self.copies:
                dst.copy_(src[src_slices])

    def get_consuming_cost_bytes(self) -> int:
        return array_size_bytes(self.buf_shape, self.dtype)

    def direct_destination(self) -> Optional[memoryview]:
        # Only a framework-owned buffer: a user's in-place tensor keeps
        # copy-on-success semantics, so a failed read cannot tear it.
        if not self.dest_owned:
            return None
        whole = self._whole()
        return None if whole is None else try_writable_byte_view(whole)


class ShardedRead:
    """A sharded entry's planned restore: the read requests, the CUDA
    tensor (or None) that the host boxes are copied into, and ``place``,
    which issues those copies into a placement batch and returns the
    restored value."""

    def __init__(
        self,
        reqs: List[ReadReq],
        place: Callable[[Any], Any],
        device_target: Optional[torch.Tensor],
    ) -> None:
        self.reqs = reqs
        self.place = place
        self.device_target = device_target


def as_sharded_entry(entry: Any) -> ShardedArrayEntry:
    """A dense entry seen as a sharded one: its whole array (or its chunks)
    as the saved boxes, so that a dense snapshot reshards onto a
    ``DTensor`` through the same reads."""
    if isinstance(entry, ShardedArrayEntry):
        return entry
    if isinstance(entry, ChunkedArrayEntry):
        return ShardedArrayEntry(dtype=entry.dtype, shape=entry.shape, shards=entry.chunks)
    if isinstance(entry, ArrayEntry):
        shape = [int(d) for d in entry.shape]
        return ShardedArrayEntry(
            dtype=entry.dtype, shape=shape, shards=[Shard([0] * len(shape), shape, entry)]
        )
    raise TypeError(f"{type(entry).__name__} is not an array entry")


def mesh_and_placements(target: Any) -> Tuple[Any, Tuple[Any, ...]]:
    """``read_object``'s ``sharding=``: a ``(DeviceMesh, placements)`` pair
    or a ``DTensor`` whose mesh and placements serve as the template."""
    if is_dtensor(target):
        return target.device_mesh, tuple(target.placements)
    if isinstance(target, (tuple, list)) and len(target) == 2:
        mesh, placements = target
        if hasattr(mesh, "get_coordinate"):
            return mesh, tuple(placements)
    raise TypeError(
        f"sharding= takes a (DeviceMesh, placements) pair or a DTensor template, got "
        f"{type(target).__name__}"
    )


class ShardedArrayIOPreparer:
    # ------------------------------------------------------------------
    # write
    # ------------------------------------------------------------------

    @staticmethod
    def prepare_write(
        dt: Any,
        logical_path: str,
        copier: Any,
        is_async_snapshot: bool = False,
        incremental: Optional[Any] = None,
    ) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
        from .io_preparer import ArrayBufferStager, effective_max_shard_size_bytes

        dtype_str = dtype_to_string(dt.dtype)
        local = local_tensor(dt)
        shards: List[Shard] = []
        write_reqs: List[WriteReq] = []
        box, coord, spec = _local_box(dt, local)
        if writes_box(coord, spec) and box.numel() > 0:
            max_shard = effective_max_shard_size_bytes(incremental)
            for piece in subdivide_box(box, max_shard, local.element_size()):
                if incremental is not None:
                    ref = incremental.ref_entry(piece.offsets, piece.sizes, False)
                    if ref is not None:
                        shards.append(Shard(list(piece.offsets), list(piece.sizes), ref))
                        continue
                location = _shard_location(logical_path, piece)
                slc = None
                if piece != box:
                    row0 = piece.offsets[0] - box.offsets[0]
                    slc = slice(row0, row0 + piece.sizes[0])
                shards.append(
                    Shard(
                        offsets=list(piece.offsets),
                        sizes=list(piece.sizes),
                        array=ArrayEntry(
                            location=location,
                            serializer=Serializer.BUFFER_PROTOCOL.value,
                            dtype=dtype_str,
                            shape=list(piece.sizes),
                            replicated=False,
                            digest=(
                                incremental.digest_for(piece.offsets, piece.sizes)
                                if incremental is not None
                                else None
                            ),
                        ),
                    )
                )
                stager = ArrayBufferStager(
                    local, copier, slc=slc, is_async_snapshot=is_async_snapshot
                )
                write_reqs.append(WriteReq(path=location, buffer_stager=stager))
        entry = ShardedArrayEntry(
            dtype=dtype_str, shape=[int(d) for d in dt.shape], shards=shards
        )
        return entry, write_reqs

    # ------------------------------------------------------------------
    # read
    # ------------------------------------------------------------------

    @staticmethod
    def prepare_read_into(
        entry: Any,
        current_leaf: Any,
        buffer_size_limit_bytes: Optional[int] = None,
        target: Optional[Any] = None,
        fresh: bool = False,
    ) -> ShardedRead:
        """Plan the reads of a sharded (or dense) entry into the
        destination that ``current_leaf`` or ``target`` defines (module
        docstring). ``fresh`` never reads into or copies into a live leaf
        (async restore)."""
        entry = as_sharded_entry(entry)
        boxes, owned, place, device_target = _destination(entry, current_leaf, target, fresh)
        reqs: List[ReadReq] = []
        for saved in entry.shards:
            saved_box = Box(tuple(saved.offsets), tuple(saved.sizes))
            overlaps: List[Tuple[torch.Tensor, Overlap]] = []
            for dst_box, dst in boxes.items():
                ov = box_overlap(saved_box, dst_box)
                if ov is not None:
                    overlaps.append((dst[ov.dst_slices], ov))
            if overlaps:
                reqs.extend(
                    _reqs_for_saved_shard(saved, saved_box, overlaps, buffer_size_limit_bytes, owned)
                )
        return ShardedRead(reqs, place, device_target)

    @staticmethod
    def prepare_read(
        entry: ShardedArrayEntry,
        obj_out: Any,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> List[ReadReq]:
        """Reads in place into a CPU tensor of the entry's whole shape and
        dtype. Callers that restore onto the card or into a ``DTensor`` use
        :meth:`prepare_read_into`, whose placement this entry point
        cannot run."""
        if not isinstance(obj_out, torch.Tensor) or obj_out.device.type != "cpu" or is_dtensor(obj_out):
            raise ValueError(
                f"Reading a sharded entry through prepare_read requires a CPU tensor "
                f"destination (got {type(obj_out)}); use prepare_read_into for DTensor "
                f"and device destinations"
            )
        return ShardedArrayIOPreparer.prepare_read_into(entry, obj_out, buffer_size_limit_bytes).reqs


def _local_box(dt: Any, local: torch.Tensor):
    """This rank's box, mesh coordinate and placement spec of ``dt``; the
    local tensor must have the box's shape (torch's chunk layout)."""
    mine = mesh_box(dt.device_mesh, dt.placements, dt.shape)
    if mine is None:
        raise ValueError("this rank is not part of the DTensor's device mesh")
    box, coord, _ = mine
    if tuple(local.shape) != box.sizes:
        raise ValueError(
            f"the DTensor's local shard has shape {tuple(local.shape)}, but its placements "
            f"{tuple(dt.placements)} give mesh coordinate {coord} the box {box}: only "
            f"torch.chunk layouts (DTensor's own) are supported"
        )
    return mine


def _destination(
    entry: ShardedArrayEntry, current: Any, target: Optional[Any], fresh: bool
) -> Tuple[Dict[Box, torch.Tensor], bool, Callable[[Any], Any], Optional[torch.Tensor]]:
    """``(host boxes, owned, place, device target)`` of one restore: the
    host tensors the reads fill, keyed by their box of the global array;
    whether they are framework-owned (direct-read targets); ``place``,
    which puts the copy of the host boxes to the card into a placement
    batch and returns the restored value; and that copy's CUDA target."""
    shape = tuple(int(d) for d in entry.shape)
    dtype = string_to_dtype(entry.dtype)
    if target is not None:
        mesh, placements = mesh_and_placements(target)
        return _dtensor_destination(shape, dtype, mesh, placements, None, None)
    if is_dtensor(current):
        if tuple(current.shape) != shape:
            raise ValueError(
                f"Cannot reshard a saved array of shape {list(shape)} into a leaf of shape "
                f"{list(current.shape)}"
            )
        local = None
        if current.dtype == dtype and not fresh:
            local = local_tensor(current)
        elif current.dtype != dtype:
            logger.warning(
                "Restoring %s %s over a DTensor of %s; the checkpointed value replaces the leaf",
                entry.dtype, list(shape), current.dtype,
            )
        return _dtensor_destination(
            shape, dtype, current.device_mesh, tuple(current.placements), local, current
        )
    full = Box((0,) * len(shape), shape)
    if isinstance(current, torch.Tensor) and current.layout == torch.strided:
        if tuple(current.shape) != shape or current.dtype != dtype:
            raise ValueError(
                f"Destination tensor (shape {tuple(current.shape)}, dtype {current.dtype}) "
                f"does not match the saved sharded array (shape {list(shape)}, dtype "
                f"{entry.dtype})"
            )
        if current.device.type == "cuda":
            host = empty_tensor(shape, entry.dtype, pin_memory=True)
            out = torch.empty(shape, dtype=dtype, device=current.device) if fresh else current
            return _placed({full: host}, host, out.detach(), out)
        if not fresh:
            return {full: current.detach()}, False, (lambda batch: current), None
    elif (
        isinstance(current, np.ndarray)
        and not fresh
        and current.flags.c_contiguous
        and current.flags.writeable
    ):
        if tuple(current.shape) != shape or current.dtype.name != entry.dtype:
            raise ValueError(
                f"Destination array (shape {current.shape}, dtype {current.dtype}) does not "
                f"match the saved sharded array (shape {list(shape)}, dtype {entry.dtype})"
            )
        return {full: tensor_from_numpy(current)}, False, (lambda batch: current), None
    host = empty_tensor(shape, entry.dtype)
    return {full: host}, True, (lambda batch: host), None


def _placed(boxes, host: torch.Tensor, device_target: torch.Tensor, value: Any):
    def place(batch) -> Any:
        batch.put(host, device_target)
        return value

    return boxes, True, place, device_target


def _dtensor_destination(
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    mesh: Any,
    placements: Tuple[Any, ...],
    local: Optional[torch.Tensor],
    live: Optional[Any],
):
    """The destination of one rank's box of a ``DTensor``: into ``local``
    (the live leaf's local tensor) in place, or into a fresh local tensor
    that a new ``DTensor`` wraps."""
    mine = mesh_box(mesh, placements, shape)
    if mine is None:
        raise ValueError("this rank is not part of the target device mesh")
    box = mine[0]
    if local is not None:
        if tuple(local.shape) != box.sizes:
            raise ValueError(
                f"the DTensor's local shard has shape {tuple(local.shape)}, but its "
                f"placements give this rank the box {box}: only torch.chunk layouts "
                f"(DTensor's own) are supported"
            )
        if local.is_cuda:
            host = empty_tensor(box.sizes, dtype_to_string(dtype), pin_memory=True)
            return _placed({box: host}, host, local, live)
        return {box: local}, False, (lambda batch: live), None
    from torch.distributed.tensor import DTensor

    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    new_local = torch.empty(box.sizes, dtype=dtype, device=device)
    value = DTensor.from_local(
        new_local, mesh, placements, run_check=False,
        shape=torch.Size(shape), stride=_contiguous_stride(shape),
    )
    if new_local.is_cuda:
        host = empty_tensor(box.sizes, dtype_to_string(dtype), pin_memory=True)
        return _placed({box: host}, host, new_local, value)
    return {box: new_local}, True, (lambda batch: value), None


def _reqs_for_saved_shard(
    saved: Shard,
    saved_box: Box,
    overlaps: List[Tuple[torch.Tensor, Overlap]],
    buffer_size_limit_bytes: Optional[int] = None,
    dest_owned: bool = False,
) -> List[ReadReq]:
    """Reads of one saved shard feeding all its overlap regions: the
    smallest row band covering every overlap (``plan_row_slab_reads``),
    split under a buffer limit; a band spanning the whole shard is one
    whole-blob read."""
    entry = saved.array
    shard_shape = tuple(saved_box.sizes)
    plan = None
    if shard_shape and entry.serializer == Serializer.BUFFER_PROTOCOL.value:
        plan = plan_row_slab_reads(
            shard_shape,
            [ov for _, ov in overlaps],
            row_nbytes=array_size_bytes(shard_shape[1:], entry.dtype),
            base=entry.byte_range_tuple[0] if entry.byte_range_tuple else 0,
            buffer_limit_bytes=buffer_size_limit_bytes,
        )
    if plan is not None:
        views = [dst for dst, _ in overlaps]
        return [
            ReadReq(
                path=entry.location,
                buffer_consumer=_OverlapConsumer(
                    entry.dtype,
                    read.buf_shape,
                    [(views[c.overlap_index][c.dst_rows], c.src_slices) for c in read.copies],
                    dest_owned=dest_owned,
                ),
                byte_range=read.byte_range,
            )
            for read in plan
        ]
    copies = [(dst, ov.src_slices) for dst, ov in overlaps]
    return [
        ReadReq(
            path=entry.location,
            buffer_consumer=_OverlapConsumer(entry.dtype, shard_shape, copies, dest_owned=dest_owned),
            byte_range=entry.byte_range_tuple,
        )
    ]
