"""Small-write coalescing into slab blobs.

Counterpart of ``torchsnapshot_tpu/batcher.py``. With
``TORCHSNAPSHOT_TPU_ENABLE_BATCHING`` set, buffer-protocol write requests
under the slab threshold (``TORCHSNAPSHOT_TPU_SLAB_SIZE_THRESHOLD_BYTES``,
128 MiB) are packed in plan order into ``batched/{uuid}`` slabs, and every
affected ``ArrayEntry`` (standalone, or nested in a chunked or sharded
entry) has its ``location`` and ``byte_range`` rewritten to point into
its slab. Member sizes are exact at planning time (dtype x shape), so byte
ranges are assigned before anything is staged, as in the JAX package: the
same plan gives the same slab layout in either package. On the read side,
ranged reads of one slab merge into one spanning read whose consumer hands
each member its slice.

The device pack (``TORCHSNAPSHOT_TPU_DEVICE_PACK``): a slab's members on
one device are packed there by the hand-written kernel
(``ops/device_pack.py``, ``csrc/device_pack.cu``) in one launch, and leave
through the take's ``DeviceCopier`` (its copy stream, a pinned host
buffer) in one copy, instead of one copy per member. Deliberate difference
from the JAX package: a pack that fails raises and fails the take (no
commit marker) instead of falling back to per-member staging, so a broken
kernel cannot hide behind a slower path.

The zero-pack vectorized slab write (``TORCHSNAPSHOT_TPU_WRITE_VECTORIZED``,
on by default, as in the JAX package): the slab is never assembled. Its
stage returns a ``BufferList`` of the members' own staged host buffers in
slab order (each pack group's pinned buffer cut into its members' parts),
which the fs plugin writes with one ``pwritev`` and a fused CRC, and the
scheduler consolidates for plugins without multi-buffer support. With the
knob off, the slab is staged into one buffer; when one pack covers the
whole slab, its pinned buffer is the slab. The bytes and the CRC table are
the same either way.
"""

from __future__ import annotations

import asyncio
import math
import operator
import uuid
from concurrent.futures import Executor
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from . import _native, knobs, telemetry
from .io_types import (
    BufferConsumer,
    BufferList,
    BufferStager,
    BufferType,
    ReadReq,
    WriteReq,
    as_bytes_view,
)
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ShardedArrayEntry
from .serialization import tensor_as_memoryview
from .telemetry import names as metric_names
from .telemetry.trace import get_recorder as _trace_recorder

Member = Tuple[WriteReq, int, int]  # (request, offset in the slab, bytes)


def _is_batchable(req: WriteReq) -> bool:
    """Tensor stagers produce exactly ``get_staging_cost_bytes()`` bytes."""
    from .io_preparer import ArrayBufferStager

    return isinstance(req.buffer_stager, ArrayBufferStager)


def _array_entries_by_location(entries: List[Entry]) -> Dict[str, List[ArrayEntry]]:
    """Every ArrayEntry of the manifest by storage location, those nested
    in chunked and sharded entries included."""
    out: Dict[str, List[ArrayEntry]] = {}
    for entry in entries:
        if isinstance(entry, ArrayEntry):
            out.setdefault(entry.location, []).append(entry)
        elif isinstance(entry, (ChunkedArrayEntry, ShardedArrayEntry)):
            shards = entry.chunks if isinstance(entry, ChunkedArrayEntry) else entry.shards
            for shard in shards:
                out.setdefault(shard.array.location, []).append(shard.array)
    return out


_TENSOR = operator.attrgetter("tensor")
_READY = operator.attrgetter("_ready")


class _PackGroup(NamedTuple):
    """A device group of one slab and its pack layout, made once when the
    slab is planned: the members' sizes are exact (dtype x shape) and
    their row ranges fixed, so a launch reads only their addresses."""

    items: List[Member]
    stagers: list
    rows: list  # each member's dim-0 row range, or None
    layout: Any  # ops.device_pack.PackLayout

    @classmethod
    def of(cls, items: List[Member]) -> "_PackGroup":
        """The group's layout, with the checks a launch no longer makes:
        each row range lies in its tensor's dim 0, and each planned size
        is the member's bytes, so that the kernel reads inside every
        member."""
        from .ops.device_pack import PackLayout

        stagers = [req.buffer_stager for req, _, _ in items]
        rows, offsets, copies = [], [], []
        for i, (stager, (req, _, size)) in enumerate(zip(stagers, items)):
            t, slc = stager.tensor, stager.slc
            if slc is None:
                rows.append(None)
                offsets.append(0)
                nbytes = t.numel() * t.element_size()
            else:
                if t.dim() == 0 or slc.step not in (None, 1) or not 0 <= slc.start <= slc.stop <= t.shape[0]:
                    raise ValueError(f"{req.path!r}: row range {slc} outside dim 0 of {tuple(t.shape)}")
                row_bytes = math.prod(t.shape[1:]) * t.element_size()
                rows.append((slc.start, slc.stop))
                offsets.append(slc.start * row_bytes)
                nbytes = (slc.stop - slc.start) * row_bytes
            if nbytes != size:
                raise ValueError(f"{req.path!r}: {nbytes} bytes to pack, planned at {size}")
            if not t.is_contiguous():
                copies.append(i)
        layout = PackLayout(stagers[0].tensor.device, [size for _, _, size in items], offsets, copies)
        return cls(items, stagers, rows, layout)


class BatchedBufferStager(BufferStager):
    """Stages the members of one slab: as one ``BufferList`` of their own
    host buffers (the vectorized write), or into one buffer. With the
    device pack on, the members of each device are packed there and
    copied to the host together; the others are staged one by one."""

    def __init__(self, members: List[Member]) -> None:
        self.members = members
        self.total = sum(size for _, _, size in members)
        # Fixed here: the split and the write path depend on knobs and on
        # stager fields that staging clears, and admission must see one
        # staging cost and get the payload that cost was for.
        self._vectorized = knobs.is_write_vectorized_enabled()
        packed, self._rest = self._split_device_groups()
        self._packed = [_PackGroup.of(items) for items in packed]
        if self._vectorized:
            # The members' staged buffers are the payload: no slab beside them.
            self._staging_cost = self.total
        else:
            # The packed host buffers sit beside the slab until scattered,
            # and the rest loop stages one member at a time beside them.
            pack_bytes = sum(size for items in packed for _, _, size in items)
            peak_member = max(
                (req.buffer_stager.get_staging_cost_bytes() for req, _, _ in self._rest), default=0
            )
            self._staging_cost = self.total + pack_bytes + peak_member

    def capture(self, cache: dict) -> None:
        """The async take's capture reaches every member's source (the
        shared ``cache`` snapshots a leaf split across slabs once); the
        group split and the pack layouts still hold, since a captured
        clone stays on its device, with the same shape."""
        for req, _, _ in self.members:
            req.buffer_stager.capture(cache)

    def _split_device_groups(self) -> Tuple[List[List[Member]], List[Member]]:
        """Device-pack groups (two or more tensor members on one device,
        with the knob on) and the members staged one by one."""
        if not knobs.is_device_pack_enabled():
            return [], list(self.members)
        from .ops.device_pack import device_group_key, pack_supported

        groups: Dict[int, List[Member]] = {}
        rest: List[Member] = []
        for item in self.members:
            tensor = item[0].buffer_stager.tensor
            if tensor is not None and pack_supported(tensor.dtype):
                groups.setdefault(device_group_key(tensor), []).append(item)
            else:
                rest.append(item)
        packed = []
        for items in groups.values():
            if len(items) < 2:
                rest.extend(items)
            else:
                packed.append(items)
        return packed, rest

    @staticmethod
    def _launch_pack(group: "_PackGroup"):
        """One pack launch and one copy to the host for a device group,
        issued from the event loop's thread; returns ``(host, event)``."""
        stagers = group.stagers
        tensors = list(map(_TENSOR, stagers))
        specs = list(zip(tensors, group.rows))
        host, event = stagers[0].copier.pack_to_host(specs, list(map(_READY, stagers)), group.layout)
        for stager in stagers:
            stager.tensor = None  # release device memory promptly
        return host, event

    @staticmethod
    def _wait(host, event) -> memoryview:
        if event is not None:
            event.synchronize()
        return tensor_as_memoryview(host)

    def _scatter(self, items: List[Member], host, event, view: memoryview) -> None:
        packed = self._wait(host, event)
        src = 0
        for _, offset, size in items:
            view[offset : offset + size] = packed[src : src + size]
            src += size

    def _parts(self, items: List[Member], host, event) -> List[Tuple[int, memoryview]]:
        """A pack group's pinned host buffer cut into its members' parts
        (each slice keeps the buffer alive until written)."""
        packed = self._wait(host, event)
        parts, src = [], 0
        for _, offset, size in items:
            parts.append((offset, packed[src : src + size]))
            src += size
        if src != len(packed):
            raise RuntimeError(f"device pack produced {len(packed)} bytes, planned {src}")
        return parts

    @staticmethod
    def _check_member_size(staged: int, req: WriteReq, size: int) -> None:
        if staged != size:
            raise RuntimeError(
                f"Slab member {req.path!r} staged {staged} bytes but was planned at "
                f"{size}; byte ranges in the manifest would be wrong"
            )

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if self._vectorized:
            # A span of its own: the pack pass did not run.
            with _trace_recorder().span(
                metric_names.SPAN_BATCHER_STAGE_SLAB_VECTORIZED, members=len(self.members), bytes=self.total
            ):
                return await self._stage_vectorized_impl(executor)
        with _trace_recorder().span(
            metric_names.SPAN_BATCHER_STAGE_SLAB, members=len(self.members), bytes=self.total
        ):
            return await self._stage_buffer_impl(executor)

    async def _stage_vectorized_impl(self, executor: Optional[Executor] = None) -> BufferList:
        """Stage every member and hand the staged buffers on as one
        ``BufferList`` in planned offset order: no buffer the size of the
        slab, and no pass that copies the members into one."""
        loop = asyncio.get_running_loop()
        cuts = [
            loop.run_in_executor(executor, self._parts, group.items, *self._launch_pack(group))
            for group in self._packed
        ]
        parts: List[Tuple[int, memoryview]] = []
        first_exc: Optional[BaseException] = None
        try:
            for req, offset, size in self._rest:
                mv = as_bytes_view(await req.buffer_stager.stage_buffer(executor))
                self._check_member_size(len(mv), req, size)
                parts.append((offset, mv))
        except BaseException as e:  # noqa: BLE001 - settle the cuts first
            first_exc = e
        results = await asyncio.gather(*cuts, return_exceptions=True)
        if first_exc is None:
            first_exc = next((r for r in results if isinstance(r, BaseException)), None)
        if first_exc is not None:
            raise first_exc
        for r in results:
            parts.extend(r)
        parts.sort(key=operator.itemgetter(0))
        expect = 0
        for offset, mv in parts:
            if offset != expect:
                raise RuntimeError(
                    f"vectorized slab has a hole at byte {expect} (next member starts at "
                    f"{offset}); manifest byte ranges would be wrong"
                )
            expect = offset + mv.nbytes
        if expect != self.total:
            raise RuntimeError(f"vectorized slab staged {expect} bytes, planned {self.total}")
        telemetry.metrics().counter_inc(metric_names.BATCHER_PACK_BYTES_AVOIDED_TOTAL, self.total)
        return BufferList([mv for _, mv in parts])

    async def _stage_buffer_impl(self, executor: Optional[Executor] = None) -> BufferType:
        loop = asyncio.get_running_loop()
        launched = [(group.items, self._launch_pack(group)) for group in self._packed]
        if len(launched) == 1 and not self._rest:
            # One pack holds every member, in slab order: it is the slab.
            (_, (host, event)), = launched
            return await loop.run_in_executor(executor, self._wait, host, event)
        # 4096-aligned: a slab qualifies for the fs plugin's O_DIRECT path.
        slab = _native.aligned_buffer(self.total)
        view = memoryview(slab)
        scatters = [
            loop.run_in_executor(executor, self._scatter, items, host, event, view)
            for items, (host, event) in launched
        ]
        # Every scatter must settle before this returns or raises: their
        # threads hold the slab's view.
        first_exc: Optional[BaseException] = None
        try:
            for req, offset, size in self._rest:
                mv = as_bytes_view(await req.buffer_stager.stage_buffer(executor))
                self._check_member_size(len(mv), req, size)
                view[offset : offset + size] = mv
        except BaseException as e:  # noqa: BLE001 - settle the scatters first
            first_exc = e
        results = await asyncio.gather(*scatters, return_exceptions=True)
        if first_exc is None:
            first_exc = next((r for r in results if isinstance(r, BaseException)), None)
        if first_exc is not None:
            raise first_exc
        return slab

    def get_staging_cost_bytes(self) -> int:
        return self._staging_cost


def batch_write_requests(
    entries: List[Entry], write_reqs: List[WriteReq]
) -> Tuple[List[Entry], List[WriteReq]]:
    """Coalesce sub-threshold tensor writes into slabs, rewriting the
    affected manifest entries in place."""
    threshold = knobs.get_slab_size_threshold_bytes()
    by_location = _array_entries_by_location(entries)

    small: List[Tuple[WriteReq, int]] = []
    kept: List[WriteReq] = []
    for req in write_reqs:
        size = req.buffer_stager.get_staging_cost_bytes()
        # Only writes whose manifest entry can be rewritten.
        if _is_batchable(req) and size < threshold and req.path in by_location:
            small.append((req, size))
        else:
            kept.append(req)
    if len(small) < 2:
        return entries, write_reqs

    # Greedy fill in plan order until a slab would overflow.
    slabs: List[List[Member]] = []
    current: List[Member] = []
    offset = 0
    for req, size in small:
        if current and offset + size > threshold:
            slabs.append(current)
            current, offset = [], 0
        current.append((req, offset, size))
        offset += size
    if current:
        slabs.append(current)

    for members in slabs:
        if len(members) == 1:
            kept.append(members[0][0])  # a lone member gains nothing
            continue
        location = f"batched/{uuid.uuid4().hex}"
        for req, off, size in members:
            for ae in by_location[req.path]:
                ae.location = location
                ae.byte_range = [off, off + size]
        kept.append(WriteReq(path=location, buffer_stager=BatchedBufferStager(members)))
    return entries, kept


# ----------------------------------------------------------------------
# read side
# ----------------------------------------------------------------------


class BatchedBufferConsumer(BufferConsumer):
    """Feeds each member consumer its slice of a spanning read."""

    def __init__(self, members: List[ReadReq], base: int, span_bytes: int) -> None:
        self.members = members
        self.base = base
        self.span_bytes = span_bytes

    async def consume_buffer(self, buf: BufferType, executor: Optional[Executor] = None) -> None:
        mv = as_bytes_view(buf)
        with _trace_recorder().span(
            metric_names.SPAN_BATCHER_CONSUME_SPANNING, members=len(self.members), bytes=self.span_bytes
        ):
            await asyncio.gather(
                *(
                    m.buffer_consumer.consume_buffer(
                        mv[m.byte_range[0] - self.base : m.byte_range[1] - self.base], executor
                    )
                    for m in self.members
                )
            )

    def get_consuming_cost_bytes(self) -> int:
        # The spanning buffer (gaps included) dominates; members consume
        # into destinations already accounted for.
        return max(
            self.span_bytes, sum(m.buffer_consumer.get_consuming_cost_bytes() for m in self.members)
        )


def batch_read_requests(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Merge ranged reads of one slab into one spanning read. Only
    ``batched/`` locations merge: other multi-read paths are budget-bounded
    row bands, and merging them back would undo the bound."""
    groups: Dict[str, List[ReadReq]] = {}
    out: List[ReadReq] = []
    for req in read_reqs:
        if not req.path.startswith("batched/") or req.byte_range is None:
            out.append(req)
            continue
        groups.setdefault(req.path, []).append(req)
    for path, members in groups.items():
        if len(members) == 1:
            out.append(members[0])
            continue
        base = min(m.byte_range[0] for m in members)
        end = max(m.byte_range[1] for m in members)
        out.append(
            ReadReq(
                path=path,
                buffer_consumer=BatchedBufferConsumer(members, base, end - base),
                byte_range=(base, end),
            )
        )
    return out
