"""Core I/O request/response types and the storage plugin interface.

Reference parity: torchsnapshot/io_types.py:29-103. A *write request* pairs a
storage path with a :class:`BufferStager` that produces the bytes (device →
host staging + serialization); a *read request* pairs a path (and optional
byte range) with a :class:`BufferConsumer` that absorbs the bytes
(deserialization + copy into the destination). The scheduler owns when each
stage runs; storage plugins own how bytes hit the backing store.
"""

from __future__ import annotations

import abc
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

BufferType = Union[bytes, bytearray, memoryview]


def as_bytes_view(buf: BufferType) -> memoryview:
    """The one contiguous-byte-view normalization (flat ``B``-format
    memoryview) the Python layers share — batcher, plugins and the
    integrity module funnel through here, so a future change (e.g.
    non-contiguous handling) has one home. ``_native`` keeps its own
    inline copy: it is the dependency-free bottom layer."""
    mv = memoryview(buf)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


class BufferList:
    """An ordered list of byte buffers forming ONE logical blob — the
    zero-pack write payload. The batcher's vectorized slab stage hands
    its members' staged buffers straight to the storage plugin as a
    ``BufferList`` instead of packing them into a staging bytearray
    (one full memory pass over every staged byte, eliminated); plugins
    that declare ``supports_multibuffer`` gather-write the parts in one
    vectorized kernel (fs: ``pwritev`` + fused CRC), and the scheduler
    consolidates for plugins that don't — paying exactly the old pack,
    never more.

    ``len()`` is the total byte count (scheduler budget accounting);
    ``parts`` are contiguous B-format memoryviews in blob order (the
    originals are kept referenced so the views stay valid)."""

    __slots__ = ("parts", "nbytes", "_keepalive")

    def __init__(self, parts: Sequence[BufferType]) -> None:
        self._keepalive = list(parts)
        self.parts: List[memoryview] = []
        total = 0
        for part in self._keepalive:
            mv = as_bytes_view(part)
            if mv.nbytes == 0:
                continue  # zero-length parts add nothing to the stream
            self.parts.append(mv)
            total += mv.nbytes
        self.nbytes = total

    def __len__(self) -> int:
        return self.nbytes

    def consolidate(self) -> memoryview:
        """One contiguous copy of the logical blob — the pack pass the
        zero-pack path avoids, kept as the compatibility fallback for
        plugins without multi-buffer support."""
        out = bytearray(self.nbytes)
        off = 0
        for mv in self.parts:
            out[off : off + mv.nbytes] = mv
            off += mv.nbytes
        return memoryview(out)


WritePayload = Union[BufferType, BufferList]


def payload_nbytes(buf: WritePayload) -> int:
    """Total byte count of a write payload, single-buffer or vectorized."""
    if isinstance(buf, BufferList):
        return buf.nbytes
    return as_bytes_view(buf).nbytes


@dataclass
class WriteIO:
    """A fully-staged write: raw bytes destined for ``path``. ``buf`` is
    a single contiguous buffer or a :class:`BufferList` (zero-pack
    vectorized form — only handed to plugins whose
    ``supports_multibuffer`` is true; the scheduler consolidates first
    otherwise). ``variant`` is set by the plugin after the write with
    the path that actually served it (``vectorized`` | ``direct`` |
    ``fused`` | ``buffered``) — the per-take write-path accounting
    SnapshotReports carry."""

    path: str
    buf: WritePayload
    variant: Optional[str] = field(default=None, compare=False)


@dataclass
class ReadIO:
    """A read of ``path``; ``byte_range`` is a half-open ``[start, end)``
    window, or ``None`` for the whole blob. ``buf`` is populated by the
    storage plugin.

    ``dest``, when set, is a writable view of the read's final destination
    (exactly the requested length). Plugins MAY read straight into it and
    set ``buf = dest`` — skipping the intermediate allocation and the
    consumer's copy — or ignore it and fill ``buf`` as usual.

    ``served_by`` is stamped by multi-source plugins (tiered, the peer
    ladder) with the tier that produced ``buf`` — the state
    :meth:`StoragePlugin.read_degraded` needs to try the *other*
    sources when verification rejects these bytes.
    """

    path: str
    byte_range: Optional[Tuple[int, int]] = None
    buf: Optional[memoryview] = None
    dest: Optional[memoryview] = None
    served_by: Optional[str] = field(default=None, compare=False)


class BufferStager(abc.ABC):
    """Produces the bytes for a write request.

    ``stage_buffer`` may run expensive work (device→host transfer,
    serialization) on ``executor``; the scheduler admits it only when the
    staging cost fits the host-memory budget.
    """

    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType: ...

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int: ...

    def capture(self, cache: dict) -> None:
        """Pin a consistent snapshot of this stager's source *before*
        ``async_take`` returns, so the application may mutate (or
        donate) the live state while staging runs on the background
        drain. ``cache`` is shared across one take's stagers, keyed by
        ``id(source)``, so several stagers over one leaf (chunked
        writes, shard pieces) snapshot it once. Default: no-op —
        stagers whose source cannot change under them (or that stage
        before the take returns) need nothing."""
        return None


class BufferConsumer(abc.ABC):
    @abc.abstractmethod
    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None: ...

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int: ...

    def direct_destination(self) -> Optional[memoryview]:
        """A writable byte view of this consumer's final destination, or
        ``None`` when consuming involves more than a straight byte copy
        (deserialization, scatter into multiple views, dtype conversion).
        When a plugin fills it, ``consume_buffer`` is skipped entirely."""
        return None


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[Tuple[int, int]] = None


class StoragePlugin(abc.ABC):
    """Abstract storage backend (reference: io_types.py:67-103).

    Implementations are used from a single asyncio event loop; blocking work
    must be dispatched to executors/threads internally. ``read`` fills
    ``read_io.buf`` (respecting ``byte_range``); ``write`` persists
    ``write_io.buf`` at ``write_io.path`` relative to the plugin root.
    """

    # Capability flag: plugins that can persist a BufferList payload
    # without consolidating it (fs: pwritev) set this true; for all
    # others the scheduler consolidates before the write ever reaches
    # the plugin, so write()/write_with_checksum() implementations may
    # assume a single contiguous buffer unless they opt in.
    supports_multibuffer: bool = False

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None: ...

    async def write_with_checksum(self, write_io: WriteIO):
        """Optional fused write + integrity pass: persist ``write_io`` AND
        return its checksum-table entry (``integrity.ChecksumTable``
        value), computed in the same pass over the bytes. Return ``None``
        to decline — having written NOTHING: the scheduler then computes
        the checksum separately and calls :meth:`write` (the default for
        every plugin without a native fused path). Declining is STICKY
        for the rest of the pipeline run (it signals a capability, e.g.
        "no native runtime here", not a per-request choice)."""
        return None

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None: ...

    async def read_with_checksum(self, read_io: ReadIO):
        """Optional fused whole-blob read + integrity pass: fill
        ``read_io.buf`` AND return the CRC32-C of each integrity page
        (``integrity.PAGE_SIZE``), computed in the same pass. Return
        ``None`` (having read nothing) to decline — the scheduler then
        calls :meth:`read` and verifies separately. Declining is STICKY
        for the rest of the pipeline run (a capability signal, not a
        per-request choice); ranged reads never reach this hook."""
        return None

    async def read_degraded(self, read_io: ReadIO) -> bool:
        """Self-healing hook: the bytes a prior :meth:`read` of
        ``read_io`` produced failed digest verification — re-serve the
        request from an alternate source (another tier's copy) if one
        remains untried. Returns True when an alternate produced bytes
        (``buf`` refilled, ``served_by`` restamped; the caller
        re-verifies and may call again on another mismatch), False when
        no alternates remain — the caller then raises the original
        ``ChecksumError``. Single-source plugins keep this default:
        there is nowhere else to turn."""
        return False

    @abc.abstractmethod
    async def delete(self, path: str) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...

    def sync_close(self) -> None:
        """Convenience for callers without a running loop."""
        from .event_loop import run_in_fresh_event_loop

        run_in_fresh_event_loop(self.close())
