"""Local/network filesystem storage plugin.

Reference parity: torchsnapshot/storage_plugins/fs.py:19-54 (async
read/write with ranged reads and a parent-directory cache), with a native
fast path: when the C++ runtime (native/ts_io.cpp) is available, reads and
writes go through ctypes-bound pwrite/pread on executor threads — ctypes
releases the GIL for the whole call, so the scheduler's concurrent I/O ops
become truly parallel kernel I/O streams instead of GIL-serialized Python
writes. Without the native lib, aiofiles provides the same semantics.
Each blocking call on a worker thread is also timed alone, without the
executor queue and the event loop (``telemetry.run_serviced``); the
aiofiles fallback's calls are not.

fsync is deliberately left to the OS (matching the reference; the commit
protocol tolerates torn data writes because the metadata file is written
only after all data writes return).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Set

logger = logging.getLogger(__name__)

try:
    import aiofiles
    import aiofiles.os
except ImportError:
    # aiofiles is optional: images without it (some TPU containers ship
    # only the native runtime) fall back to blocking stdlib I/O on
    # executor threads — same semantics, and the native fast path is
    # unaffected either way.
    aiofiles = None

import errno

from .. import _native, knobs, telemetry
from ..io_types import (
    BufferList,
    ReadIO,
    StoragePlugin,
    WriteIO,
    as_bytes_view,
    payload_nbytes,
)
from ..telemetry import names as metric_names, observe_io, run_serviced
from ..telemetry.trace import io_span
from ..utils.tracing import trace_annotation

# O_DIRECT is for LARGE writes: below this the page-cache copy is noise
# and the alignment bookkeeping isn't worth a syscall pattern change.
_DIRECT_IO_MIN_BYTES = 8 * 1024 * 1024

# errnos that mean "this filesystem / this buffer can't take O_DIRECT"
# (tmpfs fails the open with EINVAL) — a capability signal, not an I/O
# error: decline sticky-per-plugin back to the buffered path, mirroring
# the scheduler's fused_declined pattern.
_DIRECT_DECLINE_ERRNOS = {errno.EINVAL, errno.ENOTSUP, errno.EOPNOTSUPP}


class FSStoragePlugin(StoragePlugin):
    # BufferList payloads are written with one vectorized pwritev kernel
    # (native) or sequential part writes into one fd (fallback) — never
    # consolidated into a pack buffer here.
    supports_multibuffer = True

    def __init__(self, root: str) -> None:
        self.root = root
        self._dir_cache: Set[str] = set()
        self._native = _native.lib() is not None
        # Sticky per-plugin decline for the O_DIRECT variant: the first
        # EINVAL/unsupported-fs error turns it off for this plugin's
        # lifetime (same root = same filesystem), so later writes never
        # re-pay a doomed open.
        self._direct_declined = False

    def _full_path(self, path: str) -> str:
        full = os.path.join(self.root, path)
        if ".." in path:
            # Parent-relative refs (incremental ``../step_*``, CAS
            # ``../chunks/<key>``) resolve lexically, matching the
            # object-store plugins' normalize_object_key: kernel ``..``
            # resolution walks the directory tree, so an un-normalized
            # open would demand this plugin's own root dir EXIST on
            # this tier — which it may not yet (the mirror's durable-
            # side chunk probe runs before the step's first upload
            # creates the step dir there).
            full = os.path.normpath(full)
        return full

    def _direct_eligible(self, buf) -> bool:
        """Whether this single-buffer write qualifies for O_DIRECT:
        knob on, native runtime present, no sticky decline, large
        enough, and 4096-aligned (StagingPool/batcher slabs are
        allocated aligned; incidental alignment also qualifies)."""
        if (
            not self._native
            or self._direct_declined
            or not knobs.is_fs_direct_io_enabled()
            or isinstance(buf, BufferList)
        ):
            return False
        mv = as_bytes_view(buf)
        return (
            mv.nbytes >= _DIRECT_IO_MIN_BYTES and _native.is_direct_aligned(mv)
        )

    def _decline_direct(self, e: OSError, path: str) -> None:
        self._direct_declined = True
        logger.info(
            "O_DIRECT declined for %s (%s); buffered writes for the rest "
            "of this plugin's lifetime",
            path,
            e,
        )

    async def _ensure_parent_dir(self, full_path: str) -> None:
        parent = os.path.dirname(full_path)
        if parent and parent not in self._dir_cache:
            if aiofiles is not None:
                await aiofiles.os.makedirs(parent, exist_ok=True)
            else:
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(
                    None, lambda: os.makedirs(parent, exist_ok=True)
                )
            self._dir_cache.add(parent)

    async def write(self, write_io: WriteIO) -> None:
        nbytes = payload_nbytes(write_io.buf)
        t0 = time.monotonic()
        with io_span("fs", "write", write_io.path, nbytes):
            await self._write_impl(write_io)
        observe_io("fs", "write", nbytes, time.monotonic() - t0)

    async def _write_impl(self, write_io: WriteIO) -> None:
        full_path = self._full_path(write_io.path)
        await self._ensure_parent_dir(full_path)
        buf = write_io.buf
        if self._native:
            loop = asyncio.get_running_loop()
            # buf stays referenced by write_io for the call's duration.
            # The native kernels return None/False (wrote nothing) if the
            # lib became unavailable after construction — fall through.
            if isinstance(buf, BufferList):

                def _writev_native() -> bool:
                    with trace_annotation(
                        metric_names.SPAN_FS_NATIVE_PWRITEV,
                        blob=write_io.path,
                    ):
                        return (
                            _native.pwritev_file_crc(full_path, buf.parts)
                            is not None
                        )

                if await loop.run_in_executor(
                    None, run_serviced, "fs", "write", _writev_native
                ):
                    write_io.variant = "vectorized"
                    telemetry.metrics().counter_inc(
                        metric_names.FS_VECTORIZED_WRITE_BYTES_TOTAL,
                        buf.nbytes,
                        plugin="fs",
                    )
                    return
            else:
                if self._direct_eligible(buf):
                    try:
                        if await loop.run_in_executor(
                            None, run_serviced, "fs", "write",
                            self._write_direct_kernel, full_path, write_io,
                        ):
                            return
                    except OSError as e:
                        if e.errno not in _DIRECT_DECLINE_ERRNOS:
                            raise
                        self._decline_direct(e, write_io.path)

                def _write_native() -> bool:
                    with trace_annotation(
                        metric_names.SPAN_FS_NATIVE_WRITE, blob=write_io.path
                    ):
                        return _native.write_file(full_path, buf)

                if await loop.run_in_executor(
                    None, run_serviced, "fs", "write", _write_native
                ):
                    write_io.variant = "buffered"
                    return
        if isinstance(buf, BufferList):
            # Pure-Python zero-pack fallback: sequential part writes into
            # one fd — still no consolidation pass.
            write_io.variant = "buffered"
            if aiofiles is not None:
                async with aiofiles.open(full_path, "wb") as f:
                    for part in buf.parts:
                        await f.write(part)
                return

            def _writev_blocking() -> None:
                with open(full_path, "wb") as f:
                    for part in buf.parts:
                        f.write(part)

            await asyncio.get_running_loop().run_in_executor(
                None, run_serviced, "fs", "write", _writev_blocking
            )
            return
        write_io.variant = "buffered"
        if aiofiles is not None:
            async with aiofiles.open(full_path, "wb") as f:
                await f.write(buf)
            return

        def _write_blocking() -> None:
            with open(full_path, "wb") as f:
                f.write(buf)

        await asyncio.get_running_loop().run_in_executor(
            None, run_serviced, "fs", "write", _write_blocking
        )

    def _write_direct_kernel(self, full_path: str, write_io: WriteIO) -> bool:
        """Executor-thread O_DIRECT write for the plain (no-checksum)
        path — the CRC pass is skipped outright (``page_size=None`` hands
        the kernel a NULL page array), so a checksums-off run never pays
        a per-byte CRC for a result nobody reads. True on success; raises
        OSError with a decline errno for the caller's sticky fallback."""
        with trace_annotation(
            metric_names.SPAN_FS_NATIVE_DIRECT_WRITE, blob=write_io.path
        ):
            pages = _native.write_file_crc_direct(full_path, write_io.buf)
        if pages is None:
            return False
        write_io.variant = "direct"
        telemetry.metrics().counter_inc(
            metric_names.FS_DIRECT_WRITE_BYTES_TOTAL,
            payload_nbytes(write_io.buf),
            plugin="fs",
        )
        return True

    async def write_with_checksum(self, write_io: WriteIO):
        """Fused write + integrity pass (one cache-hot memory pass, one
        executor hop): returns the checksum-table entry, or None when the
        native runtime is unavailable (the scheduler then runs the
        two-step compute-then-write path). Serves all three native
        variants: vectorized pwritev for BufferList payloads (zero-pack),
        O_DIRECT for large aligned single buffers (knob-gated, sticky
        decline on unsupported filesystems), and the plain fused
        write+CRC otherwise."""
        if not self._native:
            return None
        from ..integrity import PAGE_SIZE, entry_from_page_crcs

        full_path = self._full_path(write_io.path)
        await self._ensure_parent_dir(full_path)
        loop = asyncio.get_running_loop()
        buf = write_io.buf
        nbytes = payload_nbytes(buf)

        def _writev_crc():
            with trace_annotation(
                metric_names.SPAN_FS_NATIVE_PWRITEV, blob=write_io.path
            ):
                pages = _native.pwritev_file_crc(
                    full_path, buf.parts, page_size=PAGE_SIZE
                )
            if pages is None:
                return None
            write_io.variant = "vectorized"
            telemetry.metrics().counter_inc(
                metric_names.FS_VECTORIZED_WRITE_BYTES_TOTAL,
                nbytes,
                plugin="fs",
            )
            return entry_from_page_crcs(pages, nbytes)

        def _direct_crc():
            with trace_annotation(
                metric_names.SPAN_FS_NATIVE_DIRECT_WRITE, blob=write_io.path
            ):
                pages = _native.write_file_crc_direct(
                    full_path, buf, PAGE_SIZE
                )
            if pages is None:
                return None
            write_io.variant = "direct"
            telemetry.metrics().counter_inc(
                metric_names.FS_DIRECT_WRITE_BYTES_TOTAL, nbytes, plugin="fs"
            )
            return entry_from_page_crcs(pages, nbytes)

        def _write_crc():
            with trace_annotation(
                metric_names.SPAN_FS_NATIVE_WRITE, blob=write_io.path
            ):
                pages = _native.write_file_crc(full_path, buf, PAGE_SIZE)
            if pages is None:
                return None
            write_io.variant = "fused"
            return entry_from_page_crcs(pages, nbytes)

        t0 = time.monotonic()
        with io_span("fs", "write", write_io.path, nbytes):
            entry = None
            if isinstance(buf, BufferList):
                entry = await loop.run_in_executor(
                    None, run_serviced, "fs", "write", _writev_crc
                )
            else:
                if self._direct_eligible(buf):
                    try:
                        entry = await loop.run_in_executor(
                            None, run_serviced, "fs", "write", _direct_crc
                        )
                    except OSError as e:
                        if e.errno not in _DIRECT_DECLINE_ERRNOS:
                            raise
                        self._decline_direct(e, write_io.path)
                if entry is None:
                    entry = await loop.run_in_executor(
                        None, run_serviced, "fs", "write", _write_crc
                    )
        if entry is not None:
            # A declined fused write wrote nothing; the scheduler's
            # two-step fallback lands in write(), which accounts itself.
            observe_io("fs", "write", nbytes, time.monotonic() - t0)
        return entry

    async def read(self, read_io: ReadIO) -> None:
        t0 = time.monotonic()
        with io_span("fs", "read", read_io.path, byte_range=read_io.byte_range):
            await self._read_dispatch(read_io)
        observe_io(
            "fs",
            "read",
            memoryview(read_io.buf).nbytes if read_io.buf is not None else 0,
            time.monotonic() - t0,
        )

    async def _read_dispatch(self, read_io: ReadIO) -> None:
        full_path = self._full_path(read_io.path)
        if self._native:
            loop = asyncio.get_running_loop()
            data = await loop.run_in_executor(
                None, run_serviced, "fs", "read", self._native_read, full_path,
                read_io,
            )
            if data is not None:
                # Identity matters: the scheduler detects a direct-into-
                # destination read by ``buf is dest``.
                read_io.buf = (
                    data if data is read_io.dest else memoryview(data)
                )
                return
        if aiofiles is not None:
            async with aiofiles.open(full_path, "rb") as f:
                if read_io.byte_range is None:
                    data = await f.read()
                else:
                    start, end = read_io.byte_range
                    await f.seek(start)
                    data = await f.read(end - start)
        else:

            def _read_blocking() -> bytes:
                with open(full_path, "rb") as f:
                    if read_io.byte_range is None:
                        return f.read()
                    start, end = read_io.byte_range
                    f.seek(start)
                    return f.read(end - start)

            data = await asyncio.get_running_loop().run_in_executor(
                None, run_serviced, "fs", "read", _read_blocking
            )
        if read_io.byte_range is not None:
            start, end = read_io.byte_range
            if len(data) < end - start:
                # Keep fallback semantics identical to the native path,
                # which fails ranged reads past EOF with EIO: a short
                # blob is corruption, not a partial success.
                raise OSError(
                    5,
                    f"short read: {full_path!r} has fewer than "
                    f"{end} bytes",
                    full_path,
                )
        read_io.buf = memoryview(data)

    async def read_with_checksum(self, read_io: ReadIO):
        """Fused whole-blob read + integrity pass: fills ``read_io.buf``
        and returns the CRC32-C of each integrity page, computed while
        the page is cache-hot from the read. None (nothing read) when the
        native runtime is unavailable or the read is ranged — the
        scheduler then plain-reads and verifies separately."""
        if not self._native or read_io.byte_range is not None:
            return None
        from ..integrity import PAGE_SIZE

        full_path = self._full_path(read_io.path)
        loop = asyncio.get_running_loop()

        def _read_crc():
            with trace_annotation(
                metric_names.SPAN_FS_NATIVE_READ, blob=read_io.path
            ):
                length = _native.file_size(full_path)
                if length is None:
                    return None
                if read_io.dest is not None and read_io.dest.nbytes == length:
                    out = read_io.dest
                else:
                    out = bytearray(length)
                pages = _native.pread_into_crc(full_path, out, PAGE_SIZE)
                if pages is None:
                    return None
                return out, pages

        t0 = time.monotonic()
        with io_span("fs", "read", read_io.path):
            res = await loop.run_in_executor(
                None, run_serviced, "fs", "read", _read_crc
            )
        if res is None:
            return None
        out, pages = res
        read_io.buf = out if out is read_io.dest else memoryview(out)
        observe_io(
            "fs", "read", memoryview(out).nbytes, time.monotonic() - t0
        )
        return pages

    def _native_read(self, full_path: str, read_io: ReadIO):
        """Read via the native lib; None if it became unavailable."""
        with trace_annotation(
            metric_names.SPAN_FS_NATIVE_READ, blob=read_io.path
        ):
            return self._native_read_impl(full_path, read_io)

    def _native_read_impl(self, full_path: str, read_io: ReadIO):
        if read_io.byte_range is None:
            start = 0
            length = _native.file_size(full_path)
            if length is None:
                return None
        else:
            start, end = read_io.byte_range
            length = end - start
        if read_io.dest is not None and read_io.dest.nbytes == length:
            # Read straight into the consumer's destination memory: no
            # intermediate allocation, no copy in the consume stage.
            # Failure semantics: if the read errors mid-way the destination
            # holds partial bytes. A raised restore already leaves app state
            # undefined at whole-tensor granularity (earlier consumers have
            # completed); direct reads widen that to partial-tensor, which
            # callers must treat the same way — retry or discard.
            if _native.pread_into(full_path, read_io.dest, offset=start):
                return read_io.dest
            return None
        out = bytearray(length)
        if not _native.pread_into(full_path, out, offset=start):
            return None
        return out

    async def delete(self, path: str) -> None:
        if aiofiles is not None:
            await aiofiles.os.remove(self._full_path(path))
            return
        await asyncio.get_running_loop().run_in_executor(
            None, os.remove, self._full_path(path)
        )

    async def close(self) -> None:
        self._dir_cache.clear()
