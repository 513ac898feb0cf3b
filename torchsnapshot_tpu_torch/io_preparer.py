"""IO preparers: turn state-dict leaves into write/read requests + manifest
entries.

Counterpart of ``torchsnapshot_tpu/io_preparer.py``, with its dispatch order:
primitive-inline → dense tensor (chunked when larger than the chunk knob) →
opaque object pickle. ``prepare_read`` mirrors it.

Design points for torch tensors on the card:

- **Device to host through pinned memory on a side stream.** Staging a CUDA
  tensor allocates a pinned host buffer, issues the copy on a dedicated copy
  stream (ordered after the work already queued on the tensor's current
  stream) and records a CUDA event; the executor thread waits on that event
  before the bytes go to storage. It takes the place of
  ``arr.copy_to_host_async()`` in the JAX package. The copy is issued when
  the memory budget admits the request, not when the request is planned, so
  the pinned bytes in flight stay within the budget while the copies of
  admitted requests overlap the storage writes of earlier ones.
- **Tensors are mutable.** A ``jax.Array`` cannot change under a take; a
  tensor can. A sync take returns only after every copy of every leaf has
  landed, and the caller must not mutate the state while it runs. An async
  take first captures a consistent copy (:func:`capture_write_reqs`): an
  on-device clone of each CUDA leaf, dispatched on the caller's current
  stream (so ordered after every pending write to the live tensor and
  before the next training kernel) and followed by an event that the
  background device-to-host copy waits on; a host copy of each CPU leaf;
  an eager pickle of each object.
- **Incremental hooks.** ``prepare_write`` takes the leaf's
  ``incremental.LeafIncrementalPlan``: an unchanged chunk becomes an entry
  referencing the base snapshot's blob and gets no stager (so no copy to
  the host); a written chunk records its digest.
- **One byte path.** Every supported dtype is exported through a uint8 view
  (serialization.py), bfloat16 and fp8 included.
"""

from __future__ import annotations

import asyncio
import sys
from concurrent.futures import Executor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, telemetry
from .io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
)
from .serialization import (
    DTYPE_TO_STRING,
    Serializer,
    array_size_bytes,
    copy_bytes_into,
    dtype_to_string,
    empty_tensor,
    obj_type_name,
    pickle_load_from_bytes,
    pickle_save_as_bytes,
    tensor_as_memoryview,
    tensor_from_numpy,
    try_writable_byte_view,
)
from .telemetry import names as metric_names
from .utils.tracing import trace_annotation


def get_storage_path(logical_path: str, rank: int, replicated: bool) -> str:
    if replicated:
        return f"replicated/{logical_path}"
    return f"{rank}/{logical_path}"


def as_tensor_leaf(obj: Any) -> Optional[torch.Tensor]:
    """The dense tensor a leaf is checkpointed as, or ``None`` when it goes
    through the object path. Numpy arrays become CPU tensors aliasing their
    bytes; the three dtypes without a torch counterpart raise."""
    if isinstance(obj, np.ndarray):
        return tensor_from_numpy(obj)
    if (
        isinstance(obj, torch.Tensor)
        and obj.layout == torch.strided
        and obj.dtype in DTYPE_TO_STRING
    ):
        return obj.detach()
    return None


# Below this size a host-resident buffer is staged (or consumed) inline on
# the event loop instead of a thread-pool round trip.
_INLINE_STAGE_MAX_BYTES = 1 << 20


class DeviceCopier:
    """One take's or restore's copy streams, one per CUDA device, created on
    first use. Copies between the card and pinned host memory run on them,
    off the stream that computes."""

    def __init__(self) -> None:
        self._streams: dict = {}
        # device -> event on a caller's stream that copies to the card
        # issued later, from any thread, are ordered after (mark_ready).
        self._ready: dict = {}

    def stream(self, device: torch.device) -> "torch.cuda.Stream":
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    @staticmethod
    def _order_after(stream, device: torch.device, after: Optional["torch.cuda.Event"]) -> None:
        # The current stream is per thread: a copy issued from a background
        # thread is ordered by the event its caller recorded instead.
        if after is not None:
            stream.wait_event(after)
        else:
            stream.wait_stream(torch.cuda.current_stream(device))

    def to_host(
        self, src: torch.Tensor, after: Optional["torch.cuda.Event"] = None
    ) -> Tuple[torch.Tensor, "torch.cuda.Event"]:
        """Issue ``src``'s copy into a new pinned host tensor, ordered after
        ``after`` (or, without it, after the work queued on ``src``'s
        current stream); returns the host tensor and the event that marks
        the copy's end."""
        stream = self.stream(src.device)
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self._order_after(stream, src.device, after)
        # The caller may drop the last reference to ``src`` before the copy
        # ran: keep its memory from being reused until the stream is past it.
        src.record_stream(stream)
        with torch.cuda.stream(stream):
            host.copy_(src, non_blocking=True)
            # A staging thread waits on it: blocking, it sleeps rather than
            # spin a CPU core beside the training thread of an async take.
            event = torch.cuda.Event(blocking=True)
            event.record(stream)
        telemetry.metrics().counter_inc(
            metric_names.DEVICE_TO_HOST_BYTES_TOTAL, host.numel() * host.element_size()
        )
        return host, event

    def mark_ready(self, device: torch.device) -> None:
        """Record the calling thread's current stream of ``device`` as the
        point after which :meth:`to_device` copies run, whichever thread
        issues them (a background restore's placements)."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._ready[device] = event

    def to_device(self, dst: torch.Tensor, host: torch.Tensor) -> None:
        """Issue the copy of pinned ``host`` into the CUDA tensor ``dst``,
        ordered after :meth:`mark_ready`'s event for its device or, without
        one, after the work queued on ``dst``'s current stream;
        :meth:`synchronize` waits for it."""
        stream = self.stream(dst.device)
        self._order_after(stream, dst.device, self._ready.get(dst.device))
        dst.record_stream(stream)
        with torch.cuda.stream(stream):
            dst.copy_(host, non_blocking=True)
        telemetry.metrics().counter_inc(
            metric_names.HOST_TO_DEVICE_BYTES_TOTAL, host.numel() * host.element_size()
        )

    def synchronize(self) -> None:
        for s in self._streams.values():
            s.synchronize()


class ArrayBufferStager(BufferStager):
    """Stages a dense tensor (CPU or CUDA) to a host byte buffer. ``slc``
    selects a row range for chunked writes; the slice is taken on the
    device, so only the chunk's bytes cross to the host. ``is_async_snapshot``
    makes an uncaptured CPU source staged by copy (the caller resumes
    mutating it once staging ends, before the write)."""

    def __init__(
        self,
        tensor: torch.Tensor,
        copier: DeviceCopier,
        slc: Optional[slice] = None,
        is_async_snapshot: bool = False,
    ) -> None:
        self.tensor = tensor
        self.copier = copier
        self.slc = slc
        self.is_async_snapshot = is_async_snapshot
        self._captured = False
        # Recorded after the capture's clone on the caller's stream.
        self._ready: Optional["torch.cuda.Event"] = None

    def capture(self, cache: dict) -> None:
        """Device-snapshot capture, the async take's consistency point: a
        CUDA source gets an on-device clone on the caller's current stream
        (dispatched, not awaited), a CPU source a host copy; once per
        source tensor (``cache``) however many chunk stagers slice it."""
        t = self.tensor
        if t is None:
            return
        key = id(t)
        if key not in cache:
            snap = t.clone(memory_format=torch.contiguous_format)
            ready = None
            if snap.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(snap.device))
            cache[key] = (snap, ready)
        self.tensor, self._ready = cache[key]
        self._captured = True

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        t = self.tensor if self.slc is None else self.tensor[self.slc]
        # Drop the reference promptly: device memory isn't pinned by the
        # pending storage write.
        self.tensor = None
        loop = asyncio.get_running_loop()
        if t.is_cuda:
            # to_host records the copy stream on ``t``: the caching
            # allocator does not reuse a captured clone's memory before the
            # copy has read it.
            host, event = self.copier.to_host(t, after=self._ready)

            def _wait() -> BufferType:
                with trace_annotation(metric_names.SPAN_LEAF_STAGE):
                    event.synchronize()
                    return tensor_as_memoryview(host)

            return await loop.run_in_executor(executor, _wait)
        if t.numel() * t.element_size() <= _INLINE_STAGE_MAX_BYTES:
            return self._stage_host(t)
        return await loop.run_in_executor(executor, self._stage_host, t)

    def _stage_host(self, t: torch.Tensor) -> BufferType:
        with trace_annotation(metric_names.SPAN_LEAF_STAGE):
            if t.device.type != "cpu":
                raise ValueError(
                    f"cannot stage a tensor on {t.device}: only CPU and CUDA "
                    f"tensors are supported"
                )
            if self.is_async_snapshot and not self._captured:
                return tensor_as_memoryview(t.clone(memory_format=torch.contiguous_format))
            return tensor_as_memoryview(t.contiguous())

    def get_staging_cost_bytes(self) -> int:
        shape = tuple(self.tensor.shape)
        if self.slc is not None and shape:
            shape = (len(range(*self.slc.indices(shape[0]))),) + shape[1:]
        return int(self.tensor.element_size() * np.prod(shape, dtype=np.int64))


class ArrayBufferConsumer(BufferConsumer):
    """Copies read bytes into a host destination tensor (possibly a view of
    a larger restore target)."""

    def __init__(
        self,
        dst: torch.Tensor,
        dtype: str,
        shape: Tuple[int, ...],
        dest_owned: bool = False,
    ) -> None:
        self.dst = dst
        self.dtype = dtype
        self.shape = tuple(shape)
        # Only framework-allocated destinations may be read into directly:
        # a failed direct read leaves partial bytes, harmless in a fresh
        # buffer but tearing for a tensor the application still holds.
        self.dest_owned = dest_owned

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        if self.get_consuming_cost_bytes() <= _INLINE_STAGE_MAX_BYTES:
            self._consume_sync(buf)
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(executor, self._consume_sync, buf)

    def _consume_sync(self, buf: BufferType) -> None:
        with trace_annotation(metric_names.SPAN_LEAF_CONSUME):
            if self.dst.is_contiguous():
                copy_bytes_into(self.dst, buf)
                return
            src = empty_tensor(self.shape, self.dtype)
            copy_bytes_into(src, buf)
            self.dst.copy_(src)

    def get_consuming_cost_bytes(self) -> int:
        return array_size_bytes(self.shape, self.dtype)

    def direct_destination(self) -> Optional[memoryview]:
        if not self.dest_owned:
            return None
        if dtype_to_string(self.dst.dtype) != self.dtype or tuple(
            self.dst.shape
        ) != self.shape:
            return None
        return try_writable_byte_view(self.dst)


class ArrayIOPreparer:
    """Dense-tensor preparer."""

    @staticmethod
    def prepare_write(
        tensor: torch.Tensor,
        logical_path: str,
        rank: int,
        replicated: bool,
        copier: DeviceCopier,
        is_async_snapshot: bool = False,
        incremental: Optional[Any] = None,
    ) -> Tuple[Entry, List[WriteReq]]:
        location = get_storage_path(logical_path, rank, replicated)
        shape = [int(d) for d in tensor.shape]
        key = ([0] * len(shape), shape)
        if incremental is not None:
            # Unchanged since the incremental base: reference its blob and
            # make no stager (so no copy to the host).
            ref = incremental.ref_entry(*key, replicated)
            if ref is not None:
                return ref, []
        entry = ArrayEntry(
            location=location,
            serializer=Serializer.BUFFER_PROTOCOL.value,
            dtype=dtype_to_string(tensor.dtype),
            shape=shape,
            replicated=replicated,
            digest=incremental.digest_for(*key) if incremental is not None else None,
        )
        stager = ArrayBufferStager(tensor, copier, is_async_snapshot=is_async_snapshot)
        return entry, [WriteReq(path=location, buffer_stager=stager)]

    @staticmethod
    def prepare_read(
        entry: ArrayEntry,
        dst: torch.Tensor,
        buffer_size_limit_bytes: Optional[int] = None,
        dest_owned: bool = False,
    ) -> List[ReadReq]:
        """Read request(s) for a dense entry into the host tensor ``dst``.
        With a buffer size limit, a large entry becomes several ranged reads,
        each into a flat slice of the destination, so peak memory stays
        bounded."""
        if list(dst.shape) != list(entry.shape):
            raise ValueError(
                f"Destination shape {list(dst.shape)} != entry shape "
                f"{entry.shape} for {entry.location}"
            )
        total_bytes = array_size_bytes(entry.shape, entry.dtype)
        base = entry.byte_range_tuple[0] if entry.byte_range_tuple else 0
        if (
            buffer_size_limit_bytes is None
            or total_bytes <= buffer_size_limit_bytes
            or not dst.is_contiguous()
        ):
            byte_range = (
                (base, base + total_bytes) if entry.byte_range_tuple else None
            )
            consumer = ArrayBufferConsumer(
                dst, entry.dtype, tuple(entry.shape), dest_owned
            )
            return [ReadReq(entry.location, consumer, byte_range)]
        flat = dst.reshape(-1)
        itemsize = dst.element_size()
        elems_per_read = max(1, buffer_size_limit_bytes // itemsize)
        reqs = []
        for begin in range(0, flat.numel(), elems_per_read):
            end = min(begin + elems_per_read, flat.numel())
            consumer = ArrayBufferConsumer(
                flat[begin:end], entry.dtype, (end - begin,), dest_owned
            )
            reqs.append(
                ReadReq(
                    entry.location,
                    consumer,
                    (base + begin * itemsize, base + end * itemsize),
                )
            )
        return reqs


def chunk_shapes(
    shape: List[int], itemsize: int, max_chunk_size_bytes: int
) -> List[Tuple[int, int]]:
    """Split dim 0 into ``[start, stop)`` row ranges of at most the chunk
    budget; rows larger than the budget stay whole (the JAX package's
    ``parallel/overlap.py`` ``subdivide_box``, so both packages cut the same
    chunks)."""
    if not shape or shape[0] <= 1:
        return [(0, shape[0] if shape else 0)]
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize
    if row_bytes * shape[0] <= max_chunk_size_bytes:
        return [(0, shape[0])]
    rows = max(1, max_chunk_size_bytes // max(1, row_bytes))
    return [(s, min(s + rows, shape[0])) for s in range(0, shape[0], rows)]


def effective_max_chunk_size_bytes(incremental: Optional[Any]) -> int:
    """Digest-enabled takes chunk tighter (the incremental-chunk knob) so
    the skip unit is fine enough for sparse updates; plain takes use the
    chunk knob alone. The same on every step of a base chain, so chunk
    boundaries (the digest keys) stay stable."""
    size = knobs.get_max_chunk_size_bytes()
    if incremental is not None:
        size = min(size, knobs.get_incremental_chunk_size_bytes())
    return size


class ChunkedArrayIOPreparer:
    @staticmethod
    def should_chunk(tensor: torch.Tensor, incremental: Optional[Any] = None) -> bool:
        return (
            tensor.numel() * tensor.element_size() > effective_max_chunk_size_bytes(incremental)
            and tensor.dim() >= 1
            and int(tensor.shape[0]) > 1
        )

    @staticmethod
    def prepare_write(
        tensor: torch.Tensor,
        logical_path: str,
        rank: int,
        replicated: bool,
        copier: DeviceCopier,
        is_async_snapshot: bool = False,
        incremental: Optional[Any] = None,
    ) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
        location = get_storage_path(logical_path, rank, replicated)
        dtype_str = dtype_to_string(tensor.dtype)
        shape = [int(d) for d in tensor.shape]
        chunks: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for start, stop in chunk_shapes(
            shape, tensor.element_size(), effective_max_chunk_size_bytes(incremental)
        ):
            chunk_location = f"{location}_{start}"
            chunk_shape = [stop - start] + shape[1:]
            offsets = [start] + [0] * (len(shape) - 1)
            ref = (
                incremental.ref_entry(offsets, chunk_shape, replicated)
                if incremental is not None
                else None
            )
            if ref is not None:
                chunks.append(Shard(offsets=offsets, sizes=chunk_shape, array=ref))
                continue
            chunks.append(
                Shard(
                    offsets=offsets,
                    sizes=chunk_shape,
                    array=ArrayEntry(
                        location=chunk_location,
                        serializer=Serializer.BUFFER_PROTOCOL.value,
                        dtype=dtype_str,
                        shape=chunk_shape,
                        replicated=replicated,
                        digest=(
                            incremental.digest_for(offsets, chunk_shape)
                            if incremental is not None
                            else None
                        ),
                    ),
                )
            )
            stager = ArrayBufferStager(
                tensor, copier, slc=slice(start, stop), is_async_snapshot=is_async_snapshot
            )
            write_reqs.append(WriteReq(path=chunk_location, buffer_stager=stager))
        entry = ChunkedArrayEntry(
            dtype=dtype_str, shape=shape, chunks=chunks, replicated=replicated
        )
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ChunkedArrayEntry,
        dst: torch.Tensor,
        buffer_size_limit_bytes: Optional[int] = None,
        dest_owned: bool = False,
    ) -> List[ReadReq]:
        reqs: List[ReadReq] = []
        for chunk in entry.chunks:
            view = dst[
                tuple(slice(o, o + s) for o, s in zip(chunk.offsets, chunk.sizes))
            ]
            reqs.extend(
                ArrayIOPreparer.prepare_read(
                    chunk.array, view, buffer_size_limit_bytes, dest_owned
                )
            )
        return reqs


class ObjectBufferStager(BufferStager):
    def __init__(self, obj: Any) -> None:
        self.obj = obj
        self._buf: Optional[bytes] = None

    def capture(self, cache: dict) -> None:
        """Objects are pickled now: staging after the caller resumed would
        serialize a mutable object (a metrics dict) mid-mutation."""
        if self._buf is None:
            self._buf = pickle_save_as_bytes(self.obj)
            self.obj = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        if self._buf is not None:
            return self._buf
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(executor, pickle_save_as_bytes, self.obj)

    def get_staging_cost_bytes(self) -> int:
        if self._buf is not None:
            return len(self._buf)
        return sys.getsizeof(self.obj)


class ObjectBufferConsumer(BufferConsumer):
    """Objects can't be filled in place; the deserialized value is routed to
    a callback."""

    def __init__(self, callback: Callable[[Any], None], size_hint: int = 1024) -> None:
        self.callback = callback
        self.size_hint = size_hint

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        loop = asyncio.get_running_loop()
        obj = await loop.run_in_executor(executor, pickle_load_from_bytes, bytes(buf))
        self.callback(obj)

    def get_consuming_cost_bytes(self) -> int:
        return self.size_hint


class ObjectIOPreparer:
    @staticmethod
    def prepare_write(
        obj: Any, logical_path: str, rank: int, replicated: bool
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        location = get_storage_path(logical_path, rank, replicated)
        entry = ObjectEntry(
            location=location,
            serializer=Serializer.PICKLE.value,
            obj_type=obj_type_name(obj),
            replicated=replicated,
        )
        return entry, [WriteReq(path=location, buffer_stager=ObjectBufferStager(obj))]

    @staticmethod
    def prepare_read(entry: ObjectEntry, callback: Callable[[Any], None]) -> List[ReadReq]:
        return [ReadReq(entry.location, ObjectBufferConsumer(callback))]


class PrimitivePreparer:
    """Inline-able builtins; ``bool`` resolves before ``int`` because
    ``PrimitiveEntry.from_object`` dispatches on the exact type name."""

    @staticmethod
    def should_inline(obj: Any) -> bool:
        return type(obj) in (int, float, str, bool, bytes)

    @staticmethod
    def prepare_write(obj: Any, replicated: bool) -> PrimitiveEntry:
        return PrimitiveEntry.from_object(obj, replicated=replicated)


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    copier: DeviceCopier,
    replicated: bool = False,
    is_async_snapshot: bool = False,
    incremental: Optional[Any] = None,
) -> Tuple[Entry, List[WriteReq]]:
    """``incremental`` is the leaf's :class:`incremental.LeafIncrementalPlan`
    (or None), consulted chunk by chunk: unchanged chunks become
    base-referencing entries with no write request."""
    if PrimitivePreparer.should_inline(obj):
        return PrimitivePreparer.prepare_write(obj, replicated), []
    tensor = as_tensor_leaf(obj)
    if tensor is None:
        return ObjectIOPreparer.prepare_write(obj, logical_path, rank, replicated)
    preparer = (
        ChunkedArrayIOPreparer
        if ChunkedArrayIOPreparer.should_chunk(tensor, incremental)
        else ArrayIOPreparer
    )
    return preparer.prepare_write(
        tensor, logical_path, rank, replicated, copier, is_async_snapshot, incremental
    )


def capture_write_reqs(write_reqs: List[WriteReq]) -> int:
    """The async take's capture pass over its write plan: every stager pins
    a consistent copy of its source (:meth:`BufferStager.capture`), once
    per source. Returns the number of distinct tensors captured."""
    cache: dict = {}
    for req in write_reqs:
        req.buffer_stager.capture(cache)
    return len(cache)


def prepare_read(
    entry: Entry,
    obj_out: Optional[torch.Tensor] = None,
    buffer_size_limit_bytes: Optional[int] = None,
    callback: Optional[Callable[[Any], None]] = None,
    dest_owned: bool = False,
) -> List[ReadReq]:
    """Dense/chunked entries need a host tensor destination; object entries
    a ``callback``; primitives produce no reads. ``dest_owned`` declares the
    destination framework-allocated, enabling direct storage reads into it."""
    if isinstance(entry, PrimitiveEntry):
        return []
    if isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
        if not isinstance(obj_out, torch.Tensor) or obj_out.device.type != "cpu":
            raise ValueError(
                f"Reading a dense entry requires a CPU tensor destination "
                f"(got {type(obj_out)})"
            )
        preparer = (
            ArrayIOPreparer if isinstance(entry, ArrayEntry) else ChunkedArrayIOPreparer
        )
        return preparer.prepare_read(entry, obj_out, buffer_size_limit_bytes, dest_owned)
    if isinstance(entry, ObjectEntry):
        if callback is None:
            raise ValueError("Reading an object entry requires a callback")
        return ObjectIOPreparer.prepare_read(entry, callback)
    raise NotImplementedError(
        f"{entry.type} entries (written by a multi-process torchsnapshot_tpu "
        f"take) are not readable by torchsnapshot_tpu_torch yet"
    )
