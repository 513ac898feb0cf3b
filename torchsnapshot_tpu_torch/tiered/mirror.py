"""Background durable-tier replication worker.

Counterpart of ``torchsnapshot_tpu/tiered/mirror.py``. One
:class:`Mirror` per process (``get_mirror()``), one daemon worker thread,
jobs run strictly in enqueue order. The order matters twice:

- within a job, the commit marker (``.snapshot_metadata``) is uploaded
  last, so the durable tier keeps the fast tier's commit-after-data
  invariant: a reader of the durable tier never sees a committed-looking
  step whose data is still on its way;
- across jobs, a step's blobs are enqueued (at its take plugin's close)
  before the manager's index rewrite that names the step, so the durable
  index never names a step the durable tier does not hold.

Per-blob progress is journaled in the fast tier (``journal.py``) after
every completed upload: a kill at any point leaves a journal that
resumes without re-sending completed blobs, or no journal at all, and
then ``resume()`` rebuilds the inventory from the fast-tier manifest.

Uploads retry under the collective-progress strategy
(``storage_plugins/retry.py``); a job whose retries run out keeps its
journal and raises from ``wait_durable``, while the fast-tier snapshot
stays committed and restorable.

A settled job emits a ``kind: "mirror"`` snapshot report, posts
``mirror-settled`` to the run ledger of the manager root this process
owns (rank 0), and exports its span window as a Chrome trace beside the
fast tier's take trace, as the JAX package does; the report's
``critical_path`` attributes the job's wall over its span window.
"""

from __future__ import annotations

import asyncio
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

from .. import knobs, telemetry
from ..event_loop import run_in_fresh_event_loop
from ..io_types import ReadIO, WriteIO
from ..storage_plugin import split_tiered_url, url_to_storage_plugin
from ..storage_plugins.retry import CollectiveProgressRetryStrategy
from ..telemetry import names as metric_names
from ..telemetry.trace import export_op_trace
from ..telemetry.trace import get_recorder as _trace_recorder
from .journal import MirrorJournal

logger: logging.Logger = logging.getLogger(__name__)

# Snapshot commit-marker name, duplicated from snapshot.py to keep this
# module importable without pulling the full snapshot machinery (the
# plugin layer must stay light).
_METADATA_FNAME = ".snapshot_metadata"


class _TransientMirrorError(Exception):
    pass


class MirrorJob:
    """One directory's replication work: blob inventory + completion."""

    def __init__(
        self,
        fast_url: str,
        durable_url: str,
        blobs: Dict[str, int],
        metadata_path: Optional[str] = None,
        fresh: bool = True,
    ) -> None:
        self.fast_url = fast_url
        self.durable_url = durable_url
        self.blobs = dict(blobs)
        self.metadata_path = metadata_path
        # fresh: newly-written blobs (invalidate prior done flags) vs a
        # resumed job (the journal's done flags are the point).
        self.fresh = fresh
        self.created_ts = time.monotonic()
        self.done_evt = threading.Event()
        self.error: Optional[BaseException] = None
        self.cancelled = False
        # This job's progress (the Mirror keeps the process totals).
        self.blobs_done = 0
        self.bytes_done = 0
        # The recorder's cursor when the job started running: the window
        # its trace export covers.
        self.trace_mark = 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done_evt.wait(timeout)


class Mirror:
    """Durable-tier replication worker (one daemon thread + fresh event
    loop per job). Thread-safe: ``enqueue``/``resume``/``metrics`` may be
    called from any thread, including a storage plugin's ``close()`` on
    an async-take commit thread."""

    def __init__(self) -> None:
        self._queue: "queue.Queue[Optional[MirrorJob]]" = queue.Queue()
        self._jobs: List[MirrorJob] = []  # enqueue order, for wait/cancel
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # Metrics (guarded by _lock).
        self._blobs_done = 0
        self._blobs_inflight = 0
        self._bytes_mirrored = 0
        self._snapshots_done = 0
        self._failures = 0

    # -- submission ------------------------------------------------------

    def enqueue(
        self,
        fast_url: str,
        durable_url: str,
        blobs: Dict[str, int],
        metadata_path: Optional[str] = None,
        fresh: bool = True,
    ) -> MirrorJob:
        """Queue one directory's blobs for replication; returns a handle
        whose ``wait()`` blocks until the job settles."""
        job = MirrorJob(fast_url, durable_url, blobs, metadata_path, fresh)
        with self._lock:
            if self._stopped:
                raise RuntimeError("Mirror is stopped")
            # Prune bookkeeping for settled jobs: successful ones carry
            # no information the durable tier doesn't (is_durable is the
            # truth), and failures for THIS url are superseded by the new
            # job. Keeps _jobs bounded to unsettled work + one standing
            # failure per other url over an arbitrarily long run.
            self._jobs = [
                j
                for j in self._jobs
                if not j.done_evt.is_set()
                or (j.error is not None and j.fast_url != fast_url)
            ]
            self._jobs.append(job)
            self._ensure_thread()
        self._queue.put(job)
        return job

    def resume(self, path_url: str) -> Optional[MirrorJob]:
        """Re-enqueue an interrupted mirror for one tiered snapshot path.

        Journal present and incomplete -> resume from it (completed blobs
        are skipped). No journal but a fast-tier commit marker -> rebuild
        the full inventory from the manifest and re-mirror. Already
        durable, or nothing committed on the fast tier -> None."""
        tiers = split_tiered_url(path_url)
        if tiers is None:
            raise ValueError(f"{path_url!r} is not a tiered URL")
        fast_url, durable_url = tiers
        plan = run_in_fresh_event_loop(_resume_plan(fast_url, durable_url))
        if plan is None:
            return None
        blobs, metadata_path = plan
        job = self.enqueue(
            fast_url, durable_url, blobs, metadata_path, fresh=False
        )
        # Journal/manifest resume count: how often this process picked up
        # interrupted mirrors — a restart-frequency signal on its own.
        telemetry.metrics().counter_inc(metric_names.MIRROR_RESUME_TOTAL)
        return job

    def cancel_path(self, fast_url: str) -> None:
        """Best-effort cancel of queued/running jobs for one fast root —
        the step is being GC'd and its fast blobs are about to vanish."""
        with self._lock:
            for job in self._jobs:
                if job.fast_url == fast_url and not job.done_evt.is_set():
                    job.cancelled = True

    # -- completion ------------------------------------------------------

    def jobs_for(self, fast_url: str) -> List[MirrorJob]:
        with self._lock:
            return [j for j in self._jobs if j.fast_url == fast_url]

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued job settles (True) or the timeout
        lapses (False). The preemption drain hook: called inside the
        eviction grace window, it pushes in-flight uploads out — and
        whatever doesn't fit the window is already journaled, so the
        restarted job resumes instead of re-uploading."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._lock:
            jobs = list(self._jobs)
        for job in jobs:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            if not job.wait(remaining):
                return False
        return True

    def stop(self) -> None:
        """Stop the worker after the current job; queued jobs are
        abandoned (their journals make them resumable)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            thread = self._thread
        self._queue.put(None)
        if thread is not None:
            thread.join(timeout=30)

    def metrics(self) -> Dict[str, float]:
        """Machine-readable mirror state: blob/byte progress plus the
        upload lag (age of the oldest unsettled job — how far durability
        trails the fast-tier commit)."""
        with self._lock:
            pending_jobs = [j for j in self._jobs if not j.done_evt.is_set()]
            blobs_pending = sum(
                len(j.blobs) for j in pending_jobs
            ) - self._blobs_inflight
            lag = 0.0
            if pending_jobs:
                lag = time.monotonic() - min(
                    j.created_ts for j in pending_jobs
                )
            out = {
                "blobs_pending": max(0, blobs_pending),
                "blobs_inflight": self._blobs_inflight,
                "blobs_done": self._blobs_done,
                "bytes_mirrored": self._bytes_mirrored,
                "snapshots_pending": len(pending_jobs),
                "snapshots_done": self._snapshots_done,
                "failures": self._failures,
                "upload_lag_s": round(lag, 3),
            }
        self._publish_gauges(out)
        return out

    @staticmethod
    def _publish_gauges(m: Dict[str, float]) -> None:
        """Mirror state -> registry gauges (queue depth / lag are the
        operator's 'is durability keeping up with the take cadence'
        signals). Called on every metrics() read and at job settle."""
        registry = telemetry.metrics()
        registry.gauge_set(
            metric_names.MIRROR_BLOBS_PENDING, m["blobs_pending"]
        )
        registry.gauge_set(
            metric_names.MIRROR_BLOBS_INFLIGHT, m["blobs_inflight"]
        )
        registry.gauge_set(
            metric_names.MIRROR_SNAPSHOTS_PENDING, m["snapshots_pending"]
        )
        registry.gauge_set(
            metric_names.MIRROR_UPLOAD_LAG_SECONDS, m["upload_lag_s"]
        )

    # -- worker ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        # Caller holds _lock.
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="tiered-mirror", daemon=True
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            began = time.monotonic()
            recorder = _trace_recorder()
            job.trace_mark = recorder.mark()
            job_span = recorder.begin(
                metric_names.SPAN_MIRROR_JOB,
                fast=job.fast_url,
                durable=job.durable_url,
                blobs=len(job.blobs),
            )
            try:
                if not job.cancelled:
                    run_in_fresh_event_loop(self._run_job(job))
                    with self._lock:
                        self._snapshots_done += 1
            except BaseException as e:  # noqa: BLE001 - surfaced via wait_durable
                job.error = e
                with self._lock:
                    self._failures += 1
                logger.error(
                    "mirror of %s -> %s failed (journal retained; a "
                    "restarted mirror resumes it): %r",
                    job.fast_url,
                    job.durable_url,
                    e,
                )
            finally:
                recorder.end(job_span)
                elapsed = time.monotonic() - began
                telemetry.record_phase("mirroring", elapsed)
                # Telemetry settles before the done event: a waiter that
                # unblocks on wait_durable() finds the job's report and
                # ledger event already written.
                self._settle_telemetry(job, elapsed)
                job.done_evt.set()
                try:
                    # Gauge refresh AFTER the event: the queue-depth/lag
                    # gauges must not still count this settled job.
                    self.metrics()
                except Exception:  # noqa: BLE001 - telemetry is best-effort
                    pass
                self._queue.task_done()

    @staticmethod
    def _settle_telemetry(job: MirrorJob, elapsed: float) -> None:
        """Registry counters, the job's report (kind "mirror", with the
        durability lag: how long the step's data existed only on the fast
        tier), its ledger post and its trace export. Best effort:
        telemetry never fails a job."""
        try:
            registry = telemetry.metrics()
            registry.counter_inc(metric_names.MIRROR_JOBS_DONE_TOTAL)
            if job.error is not None and not job.cancelled:
                # A job cancelled by GC is expected (the step left both
                # tiers), not a failure.
                registry.counter_inc(metric_names.MIRROR_JOBS_FAILED_TOTAL)
            registry.counter_inc(metric_names.MIRROR_BLOBS_DONE_TOTAL, job.blobs_done)
            registry.counter_inc(metric_names.MIRROR_BYTES_TOTAL, job.bytes_done)
            if job.cancelled:
                # A cancelled job's step is being deleted: a
                # snapshot-adjacent sink write would resurrect its fast
                # directory as an orphan.
                return
            lag_s = time.monotonic() - job.created_ts
            report = telemetry.SnapshotReport(
                kind="mirror",
                path=f"tiered://{job.fast_url}|{job.durable_url}",
                unix_ts=time.time(),
                phases={"mirroring": round(elapsed, 3)},
                bytes_moved=job.bytes_done,
                blobs=job.blobs_done,
                mirror={
                    "lag_s": round(lag_s, 3),
                    "blobs_total": len(job.blobs),
                    "cancelled": job.cancelled,
                    "resumed": not job.fresh,
                },
                error=repr(job.error) if job.error is not None else None,
            )
            # Which segment (per-blob copies, storage writes) gated the
            # replication wall.
            try:
                from ..telemetry import critpath

                report.critical_path = critpath.critical_path_from_events(
                    _trace_recorder().events_since(job.trace_mark), "mirror"
                )
            except Exception as e:  # noqa: BLE001 - attribution is best-effort
                logger.warning("mirror: critical-path attribution failed: %r", e)
            telemetry.emit_report(report, registry)
            # The owned-root gate keeps the post rank-0-only: a co-hosted
            # rank's mirror resolves to a ledger it did not open.
            from ..telemetry import ledger as run_ledger

            run_ledger.post_mirror_settled(
                job.fast_url, lag_s=lag_s, nbytes=job.bytes_done,
                blobs=job.blobs_done, error=job.error,
            )
            # The mirror has no rank: the file name carries the pid, so
            # that co-hosted ranks sharing a fast root keep their own.
            export_op_trace(f"mirror-pid{os.getpid()}", report.path, 0, job.trace_mark)
        except Exception as e:  # noqa: BLE001 - telemetry is best-effort
            logger.warning("mirror telemetry failed: %r", e)

    async def _run_job(self, job: MirrorJob) -> None:
        fast = url_to_storage_plugin(job.fast_url)
        durable = url_to_storage_plugin(job.durable_url)
        try:
            journal = await MirrorJournal.load(fast) or MirrorJournal()
            journal.register(
                job.blobs, metadata=job.metadata_path, fresh=job.fresh
            )
            if job.cancelled:
                # GC cancelled this job between dequeue and here: writing
                # the journal now would resurrect a just-deleted step dir.
                return
            await journal.save(fast)

            retry = CollectiveProgressRetryStrategy(
                progress_window_seconds=(
                    knobs.get_mirror_progress_window_seconds()
                ),
                scope="mirror",
            )
            slots = asyncio.Semaphore(knobs.get_mirror_io_concurrency())

            async def copy_one(path: str) -> int:
                async def op() -> int:
                    # Content-addressed chunks ship only when the
                    # durable tier doesn't already hold them: the chunk
                    # key IS the content AND embeds the byte length, so
                    # a ranged read of the LAST byte (one byte, no data
                    # transfer) is a full equality check — a truncated
                    # copy left by a crashed upload misses the probe and
                    # is re-shipped (overwritten whole), while dense
                    # retention mirrors one full step plus deltas
                    # instead of every retained step's bytes.
                    from ..cas import (
                        is_chunk_location,
                        key_of_location,
                        nbytes_of_key,
                    )

                    if is_chunk_location(path):
                        key = key_of_location(path)
                        want = nbytes_of_key(key) if key else None
                        held = False
                        if want:
                            probe = ReadIO(
                                path=path, byte_range=(want - 1, want)
                            )
                            try:
                                await durable.read(probe)
                                held = (
                                    memoryview(probe.buf).nbytes == 1
                                )
                            except (FileNotFoundError, OSError):
                                held = False
                        if held:
                            telemetry.metrics().counter_inc(
                                metric_names.MIRROR_CHUNKS_SKIPPED_TOTAL
                            )
                            return 0
                    read_io = ReadIO(path=path)
                    await fast.read(read_io)
                    nbytes = memoryview(read_io.buf).nbytes
                    await durable.write(WriteIO(path=path, buf=read_io.buf))
                    return nbytes

                async def guarded() -> int:
                    try:
                        return await op()
                    except FileNotFoundError:
                        # The fast blob vanished (eviction raced GC):
                        # definitive, never retried.
                        raise
                    except (OSError, asyncio.TimeoutError) as e:
                        raise _TransientMirrorError() from e

                async with slots:
                    if job.cancelled:
                        raise asyncio.CancelledError("mirror job cancelled")
                    with self._lock:
                        self._blobs_inflight += 1
                    try:
                        # Recorder-only span: uploads interleave as
                        # coroutines on one event-loop thread.
                        with _trace_recorder().span(
                            metric_names.SPAN_MIRROR_BLOB, blob=path
                        ):
                            return await retry.run(
                                guarded,
                                retriable_exceptions=(_TransientMirrorError,),
                            )
                    finally:
                        with self._lock:
                            self._blobs_inflight -= 1

            async def copy_and_tag(path: str):
                return path, await copy_one(path)

            tasks = [
                asyncio.create_task(copy_and_tag(p)) for p in journal.pending()
            ]
            try:
                # Journal after EVERY completed blob: the crash-resume
                # granularity is one blob, and the journal is a tiny
                # fast-tier JSON — two local writes per mirrored blob.
                for fut in asyncio.as_completed(tasks):
                    path, nbytes = await fut
                    journal.done.add(path)
                    job.blobs_done += 1
                    job.bytes_done += nbytes
                    with self._lock:
                        self._blobs_done += 1
                        self._bytes_mirrored += nbytes
                    await journal.save(fast)
            except BaseException:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                # Persist whatever completed before the failure: the
                # in-flight completions since the last save are lost to
                # the journal only if this save also fails (then they
                # re-upload — safe). EXCEPT for a cancelled job — the
                # step is being GC'd and a save here would resurrect the
                # just-deleted journal (and its parent directory) as an
                # orphan on the fast tier.
                if not job.cancelled:
                    try:
                        await journal.save(fast)
                    except Exception:  # noqa: BLE001 - already failing
                        pass
                raise

            meta = journal.metadata
            if meta is not None and not journal.durable_committed:
                # Commit marker LAST: durable commit-after-data.
                nbytes = await copy_one(meta)
                journal.done.add(meta)
                journal.durable_committed = True
                job.blobs_done += 1
                job.bytes_done += nbytes
                with self._lock:
                    self._blobs_done += 1
                    self._bytes_mirrored += nbytes
                await journal.save(fast)
        finally:
            await fast.close()
            await durable.close()


async def _resume_plan(fast_url: str, durable_url: str):
    """``(blobs, metadata_path)`` still needing a mirror pass, or None.

    Journal-first; manifest-walk fallback when no journal survived (the
    kill landed between the fast commit and the first journal write)."""
    fast = url_to_storage_plugin(fast_url)
    durable = url_to_storage_plugin(durable_url)
    try:
        journal = await MirrorJournal.load(fast)
        if journal is not None:
            if journal.complete:
                return None
            return dict(journal.blobs), journal.metadata
        read_io = ReadIO(path=_METADATA_FNAME)
        try:
            await fast.read(read_io)
        except FileNotFoundError:
            return None  # never committed on the fast tier: nothing to do
        meta_bytes = bytes(read_io.buf)
        durable_probe = ReadIO(path=_METADATA_FNAME, byte_range=(0, 1))
        try:
            await durable.read(durable_probe)
            return None  # already durable-committed
        except (FileNotFoundError, OSError):
            pass
        from ..integrity import table_path
        from ..manifest import SnapshotMetadata

        metadata = SnapshotMetadata.from_yaml(meta_bytes.decode("utf-8"))
        blobs: Dict[str, int] = {}
        from ..cas import chunk_map_path, is_chunk_location
        from ..manifest import entry_locations

        for entry in metadata.manifest.values():
            for location in entry_locations(entry):
                if not location:
                    continue
                # Parent-relative refs are another step's blobs; that
                # step mirrors (or mirrored) itself — EXCEPT chunk refs:
                # the chunk store belongs to every referencing step, and
                # the worker's existence probe skips whatever the
                # durable side already holds.
                if location.startswith("../") and not is_chunk_location(
                    location
                ):
                    continue
                blobs[location] = 0
        for rank in range(metadata.world_size):
            for control in (table_path(rank), chunk_map_path(rank)):
                probe = ReadIO(path=control, byte_range=(0, 1))
                try:
                    await fast.read(probe)
                except (FileNotFoundError, OSError):
                    continue
                blobs[control] = 0
        blobs[_METADATA_FNAME] = len(meta_bytes)
        return blobs, _METADATA_FNAME
    finally:
        await fast.close()
        await durable.close()


# ---------------------------------------------------------------------------
# Process-wide default mirror + durability barrier
# ---------------------------------------------------------------------------

_default_mirror: Optional[Mirror] = None
_default_mirror_lock = threading.Lock()


def get_mirror() -> Mirror:
    """The process-wide mirror every :class:`TieredStoragePlugin`
    enqueues to (plugin instances are created per operation; the upload
    backlog must outlive them all)."""
    global _default_mirror
    with _default_mirror_lock:
        if _default_mirror is None:
            _default_mirror = Mirror()
        return _default_mirror


def mirror_state_for_path(path_url: str) -> Optional[Dict[str, float]]:
    """The process mirror's queue and lag state when ``path_url`` is
    tiered, else None: what snapshot reports and progress heartbeats
    record about the durability backlog."""
    try:
        if split_tiered_url(path_url) is None:
            return None
    except ValueError:
        return None
    return dict(get_mirror().metrics())


def reset_mirror() -> None:
    """Stop and discard the process-wide mirror (tests simulating a
    process restart)."""
    global _default_mirror
    with _default_mirror_lock:
        mirror, _default_mirror = _default_mirror, None
    if mirror is not None:
        mirror.stop()


async def is_durable_async(path_url: str) -> bool:
    """True when the durable tier holds the snapshot's commit marker
    (which, by mirror ordering, implies every data blob preceded it)."""
    tiers = split_tiered_url(path_url)
    if tiers is None:
        return True  # single-tier plugins are durable at commit
    _, durable_url = tiers
    durable = url_to_storage_plugin(durable_url)
    try:
        read_io = ReadIO(path=_METADATA_FNAME, byte_range=(0, 1))
        try:
            await durable.read(read_io)
        except (FileNotFoundError, OSError):
            return False
        return True
    finally:
        await durable.close()


def is_durable(path_url: str) -> bool:
    return run_in_fresh_event_loop(is_durable_async(path_url))


def wait_durable(
    path_url: str,
    timeout: Optional[float] = None,
    poll_interval: float = 0.05,
) -> None:
    """Block until the snapshot at ``path_url`` is durable-committed.

    Non-tiered URLs return immediately (their commit WAS the durable
    write). For tiered URLs: waits on the in-process mirror's jobs for
    the path (re-raising a failed job's error), resuming from the
    journal/manifest first if no job is in flight (the restarted-process
    case); then confirms the durable commit marker exists. Raises
    ``TimeoutError`` when the deadline lapses with durability not yet
    reached.

    ``timeout=None`` resolves to the
    ``TORCHSNAPSHOT_TPU_WAIT_DURABLE_TIMEOUT_SECONDS`` knob (default
    30 min) rather than waiting forever; a non-positive knob value
    opts back into the unbounded wait."""
    tiers = split_tiered_url(path_url)
    if tiers is None:
        return
    if timeout is None:
        default_timeout = knobs.get_wait_durable_timeout_seconds()
        timeout = default_timeout if default_timeout > 0 else None
    fast_url, _ = tiers
    deadline = time.monotonic() + timeout if timeout is not None else None
    mirror = get_mirror()
    if not mirror.jobs_for(fast_url) and not is_durable(path_url):
        if mirror.resume(path_url) is None:
            raise FileNotFoundError(
                f"{path_url!r} has no fast-tier commit marker and is not "
                f"durable: nothing to wait for"
            )
    while True:
        # Durability first: a stale failed job (since superseded by a
        # successful resume) must never poison the barrier once the
        # durable commit marker actually exists.
        if is_durable(path_url):
            return
        jobs = mirror.jobs_for(fast_url)
        unsettled = [j for j in jobs if not j.done_evt.is_set()]
        if unsettled:
            for job in unsettled:
                remaining = None
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                if not job.wait(remaining):
                    raise TimeoutError(
                        f"snapshot {path_url!r} not durable within "
                        f"{timeout}s (mirror metrics: {mirror.metrics()})"
                    )
            continue  # re-probe durability
        # Everything settled yet not durable: the newest outcome is the
        # authoritative failure to surface.
        if jobs and jobs[-1].error is not None:
            raise RuntimeError(
                f"mirror of {path_url!r} failed; the fast tier remains "
                f"restorable and the journal resumes the upload"
            ) from jobs[-1].error
        if deadline is not None and time.monotonic() >= deadline:
            raise TimeoutError(
                f"snapshot {path_url!r} not durable within {timeout}s"
            )
        time.sleep(poll_interval)
