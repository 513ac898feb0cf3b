"""Pipelined write/read execution under a host-memory budget.

Counterpart of ``torchsnapshot_tpu/scheduler.py`` for one process. Each
request runs as its own coroutine:

    write:  acquire budget -> stage (device->host copy + serialize) ->
            re-price budget to the actual buffer size -> acquire an I/O slot
            -> storage.write (with the blob's CRC) -> release budget
    read:   acquire budget -> acquire I/O slot -> storage.read -> verify the
            CRC -> consume (copy into the destination) -> release budget

:class:`MemoryBudget` admits a request larger than the whole budget only
when nothing else is in flight, so huge buffers serialize instead of
deadlocking. ``execute_write_reqs`` returns a :class:`PendingIOWork` once
every request is past staging; storage I/O drains inside it. An async
take that captured its sources on the card returns a
:class:`DeferredIOWork` instead, which runs the whole pipeline on the
background thread through a :class:`StagingPool` of pinned host slabs.

A read whose bytes fail verification walks the plugin's self-healing
ladder (:func:`heal_read`): a plugin with another copy (the tiered
plugin's other tier) re-serves it, the bytes are verified again, and only
verified bytes reach the consumer; with no copy left the
``ChecksumError`` stands. A pipeline given the enclosing operation's
``progress`` tracker (``telemetry/progress.py``) feeds it from its live
counters, as the JAX package's does. Available host memory is read from
``/proc/meminfo`` (``psutil`` is not a dependency).
"""

from __future__ import annotations

import asyncio
import logging
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Awaitable, Callable, List, Optional

from . import knobs, telemetry
from .integrity import (
    ChecksumError,
    ChecksumTable,
    compute_checksum_entry,
    verify_checksum,
    verify_page_crcs,
    verify_range_checksum,
)
from .io_types import BufferList, ReadIO, ReadReq, StoragePlugin, WriteIO, WriteReq
from .telemetry.trace import get_recorder as _trace_recorder

if TYPE_CHECKING:
    from .telemetry.progress import ProgressTracker

logger: logging.Logger = logging.getLogger(__name__)

safe_rate_mb_s = telemetry.safe_rate_mb_s

_MAX_PER_RANK_MEMORY_BUDGET_BYTES: int = 32 * 1024 * 1024 * 1024
_LOG_LINE_LIMIT = 8
# Checksums of buffers up to this size run inline on the event loop: an
# executor round trip costs more than hashing them.
_INLINE_CHECKSUM_BYTES = 64 * 1024


class _CheckpointExecutor(ThreadPoolExecutor):
    """A pipeline's worker pool: each unit of work counts its thread's CPU
    seconds under ``role``, which also prefixes the threads' names."""

    def __init__(self, role: str) -> None:
        super().__init__(max_workers=knobs.get_staging_threads(), thread_name_prefix=role)
        self._role = role

    def submit(self, fn, /, *args, **kwargs):
        return super().submit(telemetry.run_counted, self._role, fn, *args, **kwargs)


def available_host_memory_bytes() -> int:
    """``MemAvailable`` from ``/proc/meminfo``."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def get_process_memory_budget_bytes(pg=None) -> int:
    """Host-memory budget for staging and consuming buffers:
    ``min(available * fraction / local_world_size, 32 GiB)``, or the
    ``TORCHSNAPSHOT_TPU_PER_RANK_MEMORY_BUDGET_BYTES`` override.
    ``local_world_size`` counts the processes of ``pg`` (a
    :class:`~torchsnapshot_tpu_torch.pg_wrapper.PGWrapper`) on this host,
    by a hostname all-gather: two ranks on one host share its memory."""
    override = knobs.get_per_rank_memory_budget_bytes_override()
    if override is not None:
        logger.info("Memory budget manually set to %d bytes", override)
        return override
    available = int(available_host_memory_bytes() * knobs.get_memory_budget_fraction())
    local_world_size = 1
    if pg is not None and pg.get_world_size() > 1:
        import socket

        hostnames = pg.all_gather_object(socket.gethostname())
        local_world_size = sum(1 for h in hostnames if h == socket.gethostname())
    budget = min(available // local_world_size, _MAX_PER_RANK_MEMORY_BUDGET_BYTES)
    logger.info("Memory budget set to %d bytes", budget)
    return budget


class MemoryBudget:
    """Async counting budget with an idle-admission escape hatch.

    ``acquire(cost)`` waits until ``cost`` fits, or until the pipeline is
    idle (then an oversized request is admitted alone). ``adjust(delta)``
    re-prices a held reservation; ``release`` returns the final amount.
    """

    def __init__(self, total_bytes: int) -> None:
        self.total_bytes = total_bytes
        self.available_bytes = total_bytes
        self.inflight = 0
        self._cond: asyncio.Condition = asyncio.Condition()
        self.wait_s = 0.0
        self.peak_reserved_bytes = 0

    def _note_reserved(self) -> None:
        reserved = self.total_bytes - self.available_bytes
        if reserved > self.peak_reserved_bytes:
            self.peak_reserved_bytes = reserved

    async def acquire(self, cost_bytes: int) -> None:
        t0 = time.monotonic()
        async with self._cond:
            await self._cond.wait_for(
                lambda: cost_bytes <= self.available_bytes or self.inflight == 0
            )
            self.available_bytes -= cost_bytes
            self.inflight += 1
            self._note_reserved()
        waited = time.monotonic() - t0
        self.wait_s += waited
        telemetry.metrics().histogram_observe(
            telemetry.names.MEMORY_BUDGET_WAIT_SECONDS, waited
        )

    async def adjust(self, delta_bytes: int) -> None:
        async with self._cond:
            self.available_bytes -= delta_bytes
            self._note_reserved()
            if delta_bytes < 0:
                self._cond.notify_all()

    async def release(self, cost_bytes: int) -> None:
        async with self._cond:
            self.available_bytes += cost_bytes
            self.inflight -= 1
            self._cond.notify_all()


class StagingPool(MemoryBudget):
    """Double-buffered host staging pool for background drains: the
    admission budget of a deferred async take's pipeline. Capacity is
    ``slabs x slab_bytes`` (default 2 x 128 MiB: one slab's worth of
    requests copies to the host while the previous one drains to storage),
    clamped to the process memory budget, so a checkpoint drains through
    ~256 MiB of pinned host memory instead of materializing whole. A
    request larger than the pool is admitted alone (``MemoryBudget``'s
    idle escape hatch)."""

    def __init__(self, memory_budget_bytes: int) -> None:
        self.slab_bytes = knobs.get_staging_pool_slab_bytes()
        self.slabs = knobs.get_staging_pool_slabs()
        super().__init__(min(memory_budget_bytes, max(1, self.slab_bytes * self.slabs)))

    def geometry(self) -> dict:
        return {"capacity_bytes": self.total_bytes, "slab_bytes": self.slab_bytes, "slabs": self.slabs}


class PeerCacheBudget:
    """Synchronous counting budget of the peer-RAM cache
    (``tiered/peer.py``): :class:`MemoryBudget`'s accounting without the
    event loop. The cache server's handler threads reserve and release
    under a plain lock, and a reservation that does not fit is refused,
    never queued: a push that cannot fit, even after the cache's LRU
    eviction, degrades to storage-only durability and never blocks the
    pusher or grows the cache past its bound."""

    def __init__(self, total_bytes: int) -> None:
        self.total_bytes = max(0, int(total_bytes))
        self.available_bytes = self.total_bytes
        self.peak_reserved_bytes = 0
        self._lock = threading.Lock()

    def try_reserve(self, cost_bytes: int) -> bool:
        """Reserve ``cost_bytes`` if they fit; False otherwise (the caller
        evicts and retries, or refuses the push)."""
        cost = int(cost_bytes)
        with self._lock:
            if cost > self.available_bytes:
                return False
            self.available_bytes -= cost
            reserved = self.total_bytes - self.available_bytes
            self.peak_reserved_bytes = max(self.peak_reserved_bytes, reserved)
            return True

    def release(self, cost_bytes: int) -> None:
        with self._lock:
            self.available_bytes = min(self.total_bytes, self.available_bytes + int(cost_bytes))

    def reserved_bytes(self) -> int:
        with self._lock:
            return self.total_bytes - self.available_bytes


class _PipelineStats:
    def __init__(self) -> None:
        self.pending = 0
        self.staging = 0
        self.waiting_io = 0
        self.io = 0
        self.done = 0
        self.bytes_moved = 0
        self.bytes_staged = 0
        self.write_variant_bytes: dict = {}
        # Reads healed from another copy after failing verification.
        self.degraded_reads = 0
        self.degraded_bytes = 0
        self.degraded_tier_bytes: dict = {}
        # Reads whose plugin had verified the bytes (the peer ladder).
        self.verified_by_plugin = 0


# report_phase_done -> the phase the op is in once that one completed,
# published to the live-progress heartbeat.
_NEXT_PHASE = {"staging": "writing", "writing": "committing", "loading": "applying"}


class _ProgressReporter:
    """Progress rows with RSS delta, budget and GB moved, and the feed of
    the enclosing operation's live-progress tracker (``progress``; None
    when the caller runs no heartbeat, as ``read_object`` does)."""

    _ROW = (
        "{rank:>4} {pending:>9} {staging:>9} {waiting:>9} {io:>9} "
        "{rss_delta:>15} {budget:>19} {moved:>15}"
    )

    def __init__(
        self,
        stats: _PipelineStats,
        budget: MemoryBudget,
        rank: int,
        total: int,
        progress: Optional["ProgressTracker"] = None,
    ) -> None:
        self.stats = stats
        self.budget = budget
        self.rank = rank
        self.progress = progress
        self.phase_s: dict = {}
        self.begin_ts = time.monotonic()
        self.baseline_rss = _rss_bytes()
        self.report_every = max(1, math.ceil(total / _LOG_LINE_LIMIT))

    def report(self) -> None:
        logger.info(
            self._ROW.format(
                rank=self.rank,
                pending=self.stats.pending,
                staging=self.stats.staging,
                waiting=self.stats.waiting_io,
                io=self.stats.io,
                rss_delta=f"{(_rss_bytes() - self.baseline_rss) / 1024**3:.2f}",
                budget=(
                    f"{self.budget.available_bytes / 1024**3:.2f}/"
                    f"{self.budget.total_bytes / 1024**3:.2f}"
                ),
                moved=f"{self.stats.bytes_moved / 1024**3:.2f}",
            )
        )

    def maybe_report(self) -> None:
        if self.stats.done % self.report_every == 0:
            self.report()

    def publish_progress(self) -> None:
        """Feed the op's tracker from this pipeline's counters (its file
        writes are interval-gated; the in-memory view updates each time)."""
        if self.progress is None:
            return
        self.progress.update_pipeline(
            pending=self.stats.pending,
            staging=self.stats.staging,
            inflight=self.stats.waiting_io + self.stats.io,
            done=self.stats.done,
            staged_bytes=self.stats.bytes_staged,
            done_bytes=self.stats.bytes_moved,
            budget_wait_s=self.budget.wait_s,
        )

    def report_phase_done(self, phase: str) -> None:
        elapsed = time.monotonic() - self.begin_ts
        self.phase_s[phase] = round(elapsed, 3)
        telemetry.record_phase(phase, elapsed)
        self.publish_progress()
        if self.progress is not None and phase in _NEXT_PHASE:
            self.progress.set_phase(_NEXT_PHASE[phase])
        logger.info(
            "Rank %d completed %s in %.2fs (throughput %.2f MB/s)",
            self.rank, phase, elapsed, safe_rate_mb_s(self.stats.bytes_moved, elapsed),
        )

    def pipeline_telemetry(self) -> dict:
        out = {
            "phases": dict(self.phase_s),
            "bytes_moved": self.stats.bytes_moved,
            "blobs": self.stats.done,
            "budget_wait_s": round(self.budget.wait_s, 6),
            "peak_staged_bytes": self.budget.peak_reserved_bytes,
        }
        if isinstance(self.budget, StagingPool):
            out["staging_pool"] = self.budget.geometry()
        if self.stats.write_variant_bytes:
            out["write_path"] = dict(self.stats.write_variant_bytes)
        if self.stats.verified_by_plugin:
            out["verified_by_plugin"] = self.stats.verified_by_plugin
        if self.stats.degraded_reads:
            # Reads rerouted around corruption, and the tiers that served
            # them (the JAX package's restore report fields).
            out["degraded_reads"] = {
                "blobs": self.stats.degraded_reads,
                "bytes": self.stats.degraded_bytes,
            }
            out["tier_split"] = dict(self.stats.degraded_tier_bytes)
        return out


class PendingIOWork:
    """Storage I/O still draining after staging completed. ``complete``
    re-raises the first failure; the commit marker must not be written in
    that case."""

    def __init__(
        self,
        io_tasks: List["asyncio.Task[None]"],
        reporter: _ProgressReporter,
        executor: ThreadPoolExecutor,
        checksums: ChecksumTable,
    ) -> None:
        self.io_tasks = io_tasks
        self.reporter = reporter
        self._executor = executor
        # Filled in as writes complete; stable only after complete().
        self.checksums = checksums
        # Run after complete(), before the table is written: an incremental
        # take inherits the referenced blobs' entries here.
        self.checksum_finalizer: Optional[Callable[[], None]] = None

    def pipeline_telemetry(self) -> dict:
        return self.reporter.pipeline_telemetry()

    async def complete(self) -> None:
        drain_span = _trace_recorder().begin(
            telemetry.names.SPAN_PIPELINE_WRITE_DRAIN, tasks=len(self.io_tasks)
        )
        try:
            if self.io_tasks:
                try:
                    await asyncio.gather(*self.io_tasks)
                except BaseException:
                    # Settle the sibling writes before re-raising, so no task
                    # dies mid-write when the caller closes the loop.
                    for t in self.io_tasks:
                        t.cancel()
                    await asyncio.gather(*self.io_tasks, return_exceptions=True)
                    raise
        finally:
            _trace_recorder().end(drain_span)
            self._executor.shutdown(wait=False)
        self.reporter.report_phase_done("writing")
        telemetry.metrics().gauge_set(
            telemetry.names.MEMORY_BUDGET_PEAK_STAGED_BYTES,
            self.reporter.budget.peak_reserved_bytes,
        )

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.complete())


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    staging_pool: Optional[MemoryBudget] = None,
    progress: Optional["ProgressTracker"] = None,
) -> PendingIOWork:
    """Run the staged write pipeline; returns once every request is past
    staging, with storage I/O continuing inside the returned handle.
    ``staging_pool`` replaces the process budget as the admission control
    (deferred async takes, whose pinned footprint must stay pool-sized);
    ``progress`` (the enclosing op's tracker) receives the live counters."""
    budget = staging_pool if staging_pool is not None else MemoryBudget(memory_budget_bytes)
    stats = _PipelineStats()
    stats.pending = len(write_reqs)
    reporter = _ProgressReporter(stats, budget, rank, len(write_reqs), progress)
    if progress is not None:
        progress.begin_pipeline(
            len(write_reqs),
            sum(r.buffer_stager.get_staging_cost_bytes() for r in write_reqs),
            phase="staging",
        )
    executor = _CheckpointExecutor("ts-stage")
    io_slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())
    io_tasks: List[asyncio.Task] = []
    record_checksums = not knobs.is_checksums_disabled()
    checksums: ChecksumTable = {}
    # A plugin that overrides write_with_checksum but declines (native
    # runtime unavailable) declines for the whole run.
    fused_declined = False

    async def checksum_off_slot(buf):
        if len(buf) <= _INLINE_CHECKSUM_BYTES:
            return compute_checksum_entry(buf)
        return await asyncio.get_running_loop().run_in_executor(
            executor, compute_checksum_entry, buf
        )

    async def write_one(req: WriteReq, buf) -> None:
        nonlocal fused_declined
        buf_len = len(buf)
        try:
            if isinstance(buf, BufferList) and not getattr(
                storage, "supports_multibuffer", False
            ):
                await budget.adjust(buf_len)
                try:
                    buf = await asyncio.get_running_loop().run_in_executor(
                        executor, buf.consolidate
                    )
                finally:
                    await budget.adjust(-buf_len)
            fused = (
                record_checksums
                and not fused_declined
                and type(storage).write_with_checksum
                is not StoragePlugin.write_with_checksum
            )
            if record_checksums and not fused:
                checksums[req.path] = await checksum_off_slot(buf)
            declined = False
            write_io = WriteIO(path=req.path, buf=buf)
            async with io_slots:
                stats.waiting_io -= 1
                stats.io += 1
                try:
                    if fused:
                        entry = await storage.write_with_checksum(write_io)
                        if entry is not None:
                            checksums[req.path] = entry
                        else:
                            declined = True
                    else:
                        await storage.write(write_io)
                finally:
                    stats.io -= 1
            if declined:
                fused_declined = True
                checksums[req.path] = await checksum_off_slot(buf)
                stats.waiting_io += 1
                async with io_slots:
                    stats.waiting_io -= 1
                    stats.io += 1
                    try:
                        await storage.write(write_io)
                    finally:
                        stats.io -= 1
            variant = write_io.variant or "buffered"
            stats.write_variant_bytes[variant] = (
                stats.write_variant_bytes.get(variant, 0) + buf_len
            )
        finally:
            del buf
            await budget.release(buf_len)
        stats.done += 1
        stats.bytes_moved += buf_len
        reporter.maybe_report()
        reporter.publish_progress()

    async def stage_one(req: WriteReq) -> None:
        recorder = _trace_recorder()
        cost = req.buffer_stager.get_staging_cost_bytes()
        with recorder.span(
            telemetry.names.SPAN_PIPELINE_BUDGET_ACQUIRE, blob=req.path, bytes=cost
        ):
            await budget.acquire(cost)
        stats.pending -= 1
        stats.staging += 1
        stage_span = recorder.begin(
            telemetry.names.SPAN_PIPELINE_STAGE, blob=req.path, bytes=cost
        )
        try:
            buf = await req.buffer_stager.stage_buffer(executor)
        except BaseException:
            recorder.end(stage_span)
            stats.staging -= 1
            await budget.release(cost)
            raise
        recorder.end(stage_span, staged_bytes=len(buf))
        stats.staging -= 1
        stats.waiting_io += 1
        stats.bytes_staged += len(buf)
        reporter.publish_progress()
        await budget.adjust(len(buf) - cost)
        io_tasks.append(asyncio.create_task(write_one(req, buf)))
        del buf

    staging_tasks = [asyncio.create_task(stage_one(r)) for r in write_reqs]
    try:
        if staging_tasks:
            await asyncio.gather(*staging_tasks)
    except BaseException:
        for t in staging_tasks + io_tasks:
            t.cancel()
        await asyncio.gather(*staging_tasks, *io_tasks, return_exceptions=True)
        executor.shutdown(wait=False)
        raise

    reporter.report_phase_done("staging")
    return PendingIOWork(
        io_tasks=io_tasks, reporter=reporter, executor=executor, checksums=checksums
    )


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    progress: Optional["ProgressTracker"] = None,
) -> PendingIOWork:
    return event_loop.run_until_complete(
        execute_write_reqs(write_reqs, storage, memory_budget_bytes, rank, progress=progress)
    )


class DeferredIOWork:
    """Write work whose staging has not run yet: the device-snapshot async
    take's handle. ``async_take`` builds one right after the capture pass
    and returns; the background thread then calls ``sync_complete``, which
    runs the whole pipeline (device-to-host copies, serialization, writes)
    through a :class:`StagingPool`. Same surface as :class:`PendingIOWork`
    (``sync_complete``, ``checksums``, ``checksum_finalizer``,
    ``pipeline_telemetry``). ``on_staged`` fires on
    the drain thread the moment staging finished: the take's ``staged``
    phase (``PendingSnapshot.wait(phase="staged")``)."""

    def __init__(
        self,
        write_reqs: List[WriteReq],
        storage: StoragePlugin,
        memory_budget_bytes: int,
        rank: int,
        progress: Optional["ProgressTracker"] = None,
    ) -> None:
        self.write_reqs = write_reqs
        self._storage = storage
        self._memory_budget_bytes = memory_budget_bytes
        self._rank = rank
        self._progress = progress
        self._inner: Optional[PendingIOWork] = None
        # Rebound to the live pipeline's table once staging starts; stable
        # only after sync_complete() returns.
        self.checksums: ChecksumTable = {}
        self.checksum_finalizer: Optional[Callable[[], None]] = None
        self.on_staged: Optional[Callable[[], None]] = None

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        inner = event_loop.run_until_complete(
            execute_write_reqs(
                self.write_reqs, self._storage, self._memory_budget_bytes, self._rank,
                staging_pool=StagingPool(self._memory_budget_bytes), progress=self._progress,
            )
        )
        self._inner = inner
        # The inner table is the live one: the checksum-table write and an
        # incremental take's inherit closure read ``self.checksums``.
        self.checksums = inner.checksums
        self.write_reqs = []
        if self.on_staged is not None:
            self.on_staged()
        inner.sync_complete(event_loop)

    def pipeline_telemetry(self) -> dict:
        return self._inner.pipeline_telemetry() if self._inner is not None else {}


def _entry_key(entry) -> tuple:
    return tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in entry)


def verified_by_plugin(read_io: ReadIO, entry) -> bool:
    """True when the plugin that served ``read_io`` verified its bytes
    against ``entry`` already (``ReadIO.verified_entry``): a peer pull,
    whose bytes are then verified exactly once."""
    got = read_io.verified_entry
    return got is not None and entry is not None and _entry_key(got) == _entry_key(entry)


async def heal_read(
    storage: StoragePlugin,
    read_io: ReadIO,
    verify: Callable[[object], Awaitable[None]],
    first_err: ChecksumError,
    stats: Optional[_PipelineStats] = None,
) -> object:
    """The self-healing ladder: ``read_io``'s bytes failed ``verify``
    with ``first_err``. Re-serve it from the plugin's other copies
    (``StoragePlugin.read_degraded``) until one verifies, and return that
    buffer; raise ``first_err`` when no copy is left. A healed read
    counts in ``storage_degraded_reads_total{tier=...}`` and its bytes
    in ``storage_degraded_read_bytes_total``, and logs a warning."""
    while await storage.read_degraded(read_io):
        buf = read_io.buf
        try:
            await verify(buf)
        except ChecksumError:
            continue
        tier = read_io.served_by or "unknown"
        nbytes = memoryview(buf).nbytes
        if stats is not None:
            stats.degraded_reads += 1
            stats.degraded_bytes += nbytes
            stats.degraded_tier_bytes[tier] = stats.degraded_tier_bytes.get(tier, 0) + nbytes
        registry = telemetry.metrics()
        registry.counter_inc(telemetry.names.STORAGE_DEGRADED_READS_TOTAL, tier=tier)
        registry.counter_inc(telemetry.names.STORAGE_DEGRADED_READ_BYTES_TOTAL, nbytes, tier=tier)
        logger.warning(
            "read of %s failed verification (%s); healed from the %r tier copy",
            read_io.path, first_err, tier,
        )
        return buf
    raise first_err


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    checksum_table: Optional[ChecksumTable] = None,
    on_req_complete: Optional[Callable[[ReadReq], None]] = None,
    progress: Optional["ProgressTracker"] = None,
) -> dict:
    """Read pipeline: storage read -> verify -> consume, budgeted by each
    request's consuming cost. ``on_req_complete`` fires on the event loop
    after a request's bytes are verified and consumed; ``progress`` (the
    enclosing op's tracker) receives the live counters. Returns the run's
    pipeline telemetry."""
    budget = MemoryBudget(memory_budget_bytes)
    stats = _PipelineStats()
    stats.pending = len(read_reqs)
    reporter = _ProgressReporter(stats, budget, rank, len(read_reqs), progress)
    if progress is not None:
        progress.begin_pipeline(
            len(read_reqs),
            sum(r.buffer_consumer.get_consuming_cost_bytes() for r in read_reqs),
            phase="loading",
        )
    executor = _CheckpointExecutor("ts-consume")
    io_slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())
    verify_skipped = [0]
    fused_read_declined = (
        type(storage).read_with_checksum is StoragePlugin.read_with_checksum
    )

    async def verify(buf, entry, req: ReadReq, fused_pages) -> None:
        loop = asyncio.get_running_loop()
        if fused_pages is not None and verify_page_crcs(
            fused_pages, memoryview(buf).nbytes, entry, req.path
        ):
            return
        small = memoryview(buf).nbytes <= _INLINE_CHECKSUM_BYTES
        # A ranged read of the whole blob (a slab's spanning read) verifies
        # as the whole blob: one of a single page has no page digests.
        if req.byte_range is None or tuple(req.byte_range) == (0, entry[2]):
            if small:
                verify_checksum(buf, entry, req.path)
            else:
                await loop.run_in_executor(executor, verify_checksum, buf, entry, req.path)
            return
        if small:
            page_verified = verify_range_checksum(buf, entry, req.byte_range, req.path)
        else:
            page_verified = await loop.run_in_executor(
                executor, verify_range_checksum, buf, entry, req.byte_range, req.path
            )
        if not page_verified:
            verify_skipped[0] += 1

    async def read_one(req: ReadReq) -> None:
        nonlocal fused_read_declined
        cost = req.buffer_consumer.get_consuming_cost_bytes()
        await budget.acquire(cost)
        stats.pending -= 1
        try:
            entry = checksum_table.get(req.path) if checksum_table is not None else None
            fused_pages = None
            async with io_slots:
                stats.io += 1
                read_io = ReadIO(
                    path=req.path,
                    byte_range=req.byte_range,
                    dest=req.buffer_consumer.direct_destination(),
                )
                try:
                    if (
                        entry is not None
                        and entry[0] == "crc32c"
                        and req.byte_range is None
                        and not fused_read_declined
                    ):
                        fused_pages = await storage.read_with_checksum(read_io)
                        if fused_pages is None:
                            fused_read_declined = True
                    if fused_pages is None:
                        await storage.read(read_io)
                finally:
                    stats.io -= 1
            buf = read_io.buf
            if buf is None:
                raise RuntimeError(f"Storage plugin did not populate buffer for {req.path}")
            if entry is not None and verified_by_plugin(read_io, entry):
                stats.verified_by_plugin += 1
            elif entry is not None:
                try:
                    await verify(buf, entry, req, fused_pages)
                except ChecksumError as first_err:
                    # Verified again before any consumer (and so any copy
                    # to the card) sees the bytes.
                    async with io_slots:
                        buf = await heal_read(
                            storage, read_io,
                            lambda b: verify(b, entry, req, None),
                            first_err, stats,
                        )
            if read_io.dest is None or buf is not read_io.dest:
                stats.staging += 1
                try:
                    with _trace_recorder().span(
                        telemetry.names.SPAN_PIPELINE_CONSUME,
                        blob=req.path,
                        bytes=memoryview(buf).nbytes,
                    ):
                        await req.buffer_consumer.consume_buffer(buf, executor)
                finally:
                    stats.staging -= 1
            stats.done += 1
            stats.bytes_moved += buf.nbytes
            del buf, read_io
            if on_req_complete is not None:
                on_req_complete(req)
            reporter.maybe_report()
            reporter.publish_progress()
        finally:
            await budget.release(cost)

    tasks = [asyncio.create_task(read_one(r)) for r in read_reqs]
    try:
        await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    finally:
        executor.shutdown(wait=False)
    if verify_skipped[0]:
        logger.info(
            "%d of %d reads were ranged with no fully-covered pages and "
            "skipped checksum verification",
            verify_skipped[0],
            len(read_reqs),
        )
    reporter.report_phase_done("loading")
    return reporter.pipeline_telemetry()


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    checksum_table: Optional[ChecksumTable] = None,
    on_req_complete: Optional[Callable[[ReadReq], None]] = None,
    progress: Optional["ProgressTracker"] = None,
) -> dict:
    return event_loop.run_until_complete(
        execute_read_reqs(
            read_reqs, storage, memory_budget_bytes, rank, checksum_table, on_req_complete,
            progress=progress,
        )
    )
