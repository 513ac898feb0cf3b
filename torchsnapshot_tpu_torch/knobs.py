"""Environment-variable knobs with test-friendly override context managers.

The knobs this package reads, under the same ``TORCHSNAPSHOT_TPU_`` names
as torchsnapshot_tpu's, so one environment configures both packages.
Values are read lazily on every call so tests and subprocesses can flip
them at any time. Knobs of subsystems not ported yet (SLO, bundles, the
autotuner, ...) come with those subsystems; the CDN knob is here only so
that the manager can refuse it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Generator, Optional

_MAX_CHUNK_SIZE_BYTES_ENV = "TORCHSNAPSHOT_TPU_MAX_CHUNK_SIZE_BYTES"
_PER_RANK_MEMORY_BUDGET_BYTES_ENV = "TORCHSNAPSHOT_TPU_PER_RANK_MEMORY_BUDGET_BYTES"
_MEMORY_BUDGET_FRACTION_ENV = "TORCHSNAPSHOT_TPU_MEMORY_BUDGET_FRACTION"
_PER_RANK_IO_CONCURRENCY_ENV = "TORCHSNAPSHOT_TPU_PER_RANK_IO_CONCURRENCY"
_STAGING_THREADS_ENV = "TORCHSNAPSHOT_TPU_STAGING_THREADS"
_DISABLE_CHECKSUMS_ENV = "TORCHSNAPSHOT_TPU_DISABLE_CHECKSUMS"
_DISABLE_NATIVE_ENV = "TORCHSNAPSHOT_TPU_DISABLE_NATIVE"
_FS_DIRECT_IO_ENV = "TORCHSNAPSHOT_TPU_FS_DIRECT_IO"
_TRACE_BUFFER_EVENTS_ENV = "TORCHSNAPSHOT_TPU_TRACE_BUFFER_EVENTS"
_INCREMENTAL_CHUNK_SIZE_BYTES_ENV = "TORCHSNAPSHOT_TPU_INCREMENTAL_CHUNK_BYTES"
_RESTORE_FLUSH_BYTES_ENV = "TORCHSNAPSHOT_TPU_RESTORE_PLACEMENT_FLUSH_BYTES"
_ASYNC_DEVICE_SNAPSHOT_ENV = "TORCHSNAPSHOT_TPU_ASYNC_DEVICE_SNAPSHOT"
_STAGING_POOL_SLAB_BYTES_ENV = "TORCHSNAPSHOT_TPU_STAGING_POOL_SLAB_BYTES"
_STAGING_POOL_SLABS_ENV = "TORCHSNAPSHOT_TPU_STAGING_POOL_SLABS"
_CAS_ENV = "TORCHSNAPSHOT_TPU_CAS"
_CAS_GC_GRACE_ENV = "TORCHSNAPSHOT_TPU_CAS_GC_GRACE_SECONDS"
_CDN_ENV = "TORCHSNAPSHOT_TPU_CDN"
_DISABLE_PARTITIONER_ENV = "TORCHSNAPSHOT_TPU_DISABLE_PARTITIONER"
_FANOUT_RESTORE_ENV = "TORCHSNAPSHOT_TPU_FANOUT_RESTORE"
_TREE_BARRIER_ENV = "TORCHSNAPSHOT_TPU_TREE_BARRIER"
_BARRIER_FANOUT_ENV = "TORCHSNAPSHOT_TPU_BARRIER_FANOUT"
_STORE_SHARDS_ENV = "TORCHSNAPSHOT_TPU_STORE_SHARDS"
_MAX_SHARD_SIZE_BYTES_ENV = "TORCHSNAPSHOT_TPU_MAX_SHARD_SIZE_BYTES"
_SLAB_SIZE_THRESHOLD_BYTES_ENV = "TORCHSNAPSHOT_TPU_SLAB_SIZE_THRESHOLD_BYTES"
_ENABLE_BATCHING_ENV = "TORCHSNAPSHOT_TPU_ENABLE_BATCHING"
_DEVICE_PACK_ENV = "TORCHSNAPSHOT_TPU_DEVICE_PACK"
_MIRROR_IO_CONCURRENCY_ENV = "TORCHSNAPSHOT_TPU_MIRROR_IO_CONCURRENCY"
_MIRROR_PROGRESS_WINDOW_ENV = "TORCHSNAPSHOT_TPU_MIRROR_PROGRESS_WINDOW_SECONDS"
_WAIT_DURABLE_TIMEOUT_ENV = "TORCHSNAPSHOT_TPU_WAIT_DURABLE_TIMEOUT_SECONDS"

_DEFAULT_MAX_CHUNK_SIZE_BYTES: int = 512 * 1024 * 1024
_DEFAULT_MEMORY_BUDGET_FRACTION: float = 0.6
_DEFAULT_PER_RANK_IO_CONCURRENCY: int = 16
_DEFAULT_STAGING_THREADS: int = 4
_DEFAULT_TRACE_BUFFER_EVENTS: int = 16384
_DEFAULT_INCREMENTAL_CHUNK_SIZE_BYTES: int = 16 * 1024 * 1024
_DEFAULT_RESTORE_FLUSH_BYTES: int = 128 * 1024 * 1024
_DEFAULT_STAGING_POOL_SLAB_BYTES: int = 128 * 1024 * 1024
_DEFAULT_STAGING_POOL_SLABS: int = 2
_DEFAULT_BARRIER_FANOUT: int = 16
_DEFAULT_STORE_SHARDS: int = 1
_DEFAULT_MAX_SHARD_SIZE_BYTES: int = 512 * 1024 * 1024
_DEFAULT_SLAB_SIZE_THRESHOLD_BYTES: int = 128 * 1024 * 1024
_DEFAULT_CAS_GC_GRACE_SECONDS: float = 900.0
_DEFAULT_WAIT_DURABLE_TIMEOUT_SECONDS: float = 1800.0


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    return default if val is None else int(val)


def get_max_chunk_size_bytes() -> int:
    """Arrays larger than this are split into chunks written independently."""
    return _get_int_env(_MAX_CHUNK_SIZE_BYTES_ENV, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


def get_max_shard_size_bytes() -> int:
    """Local shards of a sharded (``DTensor``) leaf larger than this are
    subdivided along dim 0 before writing."""
    return _get_int_env(_MAX_SHARD_SIZE_BYTES_ENV, _DEFAULT_MAX_SHARD_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    """Write requests smaller than this are eligible for slab batching."""
    return _get_int_env(_SLAB_SIZE_THRESHOLD_BYTES_ENV, _DEFAULT_SLAB_SIZE_THRESHOLD_BYTES)


def is_batching_enabled() -> bool:
    """Opt-in: the env var's presence coalesces small writes into slabs
    (``batcher.py``)."""
    return _ENABLE_BATCHING_ENV in os.environ


def is_device_pack_enabled() -> bool:
    """Opt-in: a slab's members on one device are packed there by the
    hand-written pack kernel (``ops/device_pack.py``) and leave in one
    device-to-host copy, instead of one copy per member."""
    return _DEVICE_PACK_ENV in os.environ


def get_per_rank_memory_budget_bytes_override() -> Optional[int]:
    """Explicit staging budget in bytes; bypasses the memory fraction."""
    val = os.environ.get(_PER_RANK_MEMORY_BUDGET_BYTES_ENV)
    return int(val) if val is not None else None


def get_memory_budget_fraction() -> float:
    """Fraction of *available* host memory the per-process staging budget
    may claim (scheduler.get_process_memory_budget_bytes)."""
    val = os.environ.get(_MEMORY_BUDGET_FRACTION_ENV)
    return _DEFAULT_MEMORY_BUDGET_FRACTION if val is None else float(val)


def get_per_rank_io_concurrency() -> int:
    """Max concurrent storage I/O ops per process."""
    return _get_int_env(_PER_RANK_IO_CONCURRENCY_ENV, _DEFAULT_PER_RANK_IO_CONCURRENCY)


def get_staging_threads() -> int:
    """Threads for device->host staging / (de)serialization."""
    return _get_int_env(_STAGING_THREADS_ENV, _DEFAULT_STAGING_THREADS)


def is_checksums_disabled() -> bool:
    """Blob CRC recording (take) and verification (restore) are on by
    default; presence of the env var disables both."""
    return _DISABLE_CHECKSUMS_ENV in os.environ


def is_native_disabled() -> bool:
    """Kill-switch for the ctypes native I/O runtime (``_native.py``):
    presence of the env var keeps ``lib()`` returning None so every
    caller stays on its pure-Python path. Behavior is identical either
    way, only slower."""
    return _DISABLE_NATIVE_ENV in os.environ


def is_fs_direct_io_enabled() -> bool:
    """O_DIRECT fs writes for large 4096-aligned buffers (default OFF):
    the aligned body of a qualifying blob bypasses the page cache, the
    unaligned tail is written buffered. Unsupported filesystems (tmpfs:
    EINVAL) decline sticky-per-plugin back to the buffered path."""
    return _get_int_env(_FS_DIRECT_IO_ENV, 0) != 0


def get_trace_buffer_events() -> int:
    """Flight-recorder ring capacity, in completed events. Oldest
    events evict first; the recorder counts what it dropped."""
    return _get_int_env(_TRACE_BUFFER_EVENTS_ENV, _DEFAULT_TRACE_BUFFER_EVENTS)


def get_incremental_chunk_size_bytes() -> int:
    """Chunk granularity of digest-enabled takes: the skip unit of
    incremental checkpointing. Applied as ``min`` with the chunk knob
    whenever digests are recorded, so chunk boundaries (the digest keys)
    stay stable along a base/incremental chain."""
    return _get_int_env(
        _INCREMENTAL_CHUNK_SIZE_BYTES_ENV, _DEFAULT_INCREMENTAL_CHUNK_SIZE_BYTES
    )


def get_restore_placement_flush_bytes() -> int:
    """Streaming-restore flush granularity: once this many bytes of leaves
    have completed their reads, their host-to-device copies are issued
    together while the remaining reads continue. 0 places everything in
    one batch after all reads."""
    return _get_int_env(_RESTORE_FLUSH_BYTES_ENV, _DEFAULT_RESTORE_FLUSH_BYTES)


def is_async_device_snapshot_enabled() -> bool:
    """Default-on device-snapshot async takes: ``async_take`` clones the
    CUDA leaves on the card (dispatched, not awaited), copies mutable CPU
    leaves and pickles objects, then returns; the device-to-host copies,
    serialization and writes all run on the background thread. Costs a
    transient copy of the saved device state in device memory. ``"0"``
    stages before ``async_take`` returns, with no device clone."""
    return os.environ.get(_ASYNC_DEVICE_SNAPSHOT_ENV, "1") != "0"


def get_staging_pool_slab_bytes() -> int:
    """Slab size of the background drain's pinned staging pool
    (``scheduler.StagingPool``); with the slab count it bounds a deferred
    async take's host staging footprint."""
    return _get_int_env(_STAGING_POOL_SLAB_BYTES_ENV, _DEFAULT_STAGING_POOL_SLAB_BYTES)


def get_staging_pool_slabs() -> int:
    """Slab count of the staging pool. 2 is double buffering: one slab's
    worth of requests copies to the host while the previous one drains to
    storage."""
    return _get_int_env(_STAGING_POOL_SLABS_ENV, _DEFAULT_STAGING_POOL_SLABS)


def is_cas_enabled() -> bool:
    """Content-addressed chunk store (``cas/``), default OFF: with ``"1"``,
    new takes write their data blobs once into a root-level ``chunks/``
    store keyed by content digest, manifests reference the chunks
    (``../chunks/<key>`` parent refs), and the manager refcounts them.
    Requires a root on the local filesystem; other roots warn once and
    take the legacy layout. Restores resolve either layout regardless of
    this knob."""
    return os.environ.get(_CAS_ENV, "0") not in ("", "0")


def get_cas_gc_grace_seconds() -> float:
    """Minimum age (mtime) before the manager's chunk GC may delete a
    refcount-dead chunk. A take that dedups against an existing chunk
    touches its mtime before relying on it, so an in-flight (not yet
    pinned) step's chunks look fresh to a racing GC pass and are deferred
    as journaled orphans instead of reclaimed. Non-positive: reclaim at
    once."""
    val = os.environ.get(_CAS_GC_GRACE_ENV)
    return _DEFAULT_CAS_GC_GRACE_SECONDS if val is None else float(val)


def is_cdn_enabled() -> bool:
    """The checkpoint CDN's publish side (default OFF). Not ported:
    ``CheckpointManager`` reads it only to refuse."""
    return os.environ.get(_CDN_ENV, "0") not in ("", "0")


def is_partitioner_disabled() -> bool:
    """With the variable set, a multi-rank take of replicated state
    raises instead of spreading its writes over the ranks (the
    reference raises there too)."""
    return _DISABLE_PARTITIONER_ENV in os.environ


def is_fanout_restore_enabled() -> bool:
    """Single-reader fan-out restore (default ON, as in the JAX package):
    in a multi-rank restore each unique saved shard blob is read from
    storage by one owner rank and shipped to the ranks that need it over
    the coordination store (``fanout.py``). ``"0"`` is the kill switch
    back to every-rank-reads. Rank 0's value decides for the job (it is
    broadcast at restore start); one-process restores never fan out."""
    return os.environ.get(_FANOUT_RESTORE_ENV, "1") != "0"


def is_tree_barrier_enabled() -> bool:
    """Tree-structured store barriers (default ON): arrive and depart
    aggregate through a fanout-``k`` rank tree. ``"0"`` is the kill
    switch back to the leader-centric ``LinearBarrier``."""
    return os.environ.get(_TREE_BARRIER_ENV, "1") != "0"


def get_barrier_fanout() -> int:
    """The tree barrier's branching factor ``k`` (at least 2)."""
    return max(2, _get_int_env(_BARRIER_FANOUT_ENV, _DEFAULT_BARRIER_FANOUT))


def get_store_shards() -> int:
    """Coordination-store shard count: more than 1 bootstraps that many
    TCPStore servers, spread over the ranks, behind key->shard hashing.
    Rank 0's reading decides for the job."""
    return max(1, _get_int_env(_STORE_SHARDS_ENV, _DEFAULT_STORE_SHARDS))


def get_mirror_io_concurrency() -> int:
    """Concurrent blob copies inside the tiered mirror; defaults to the
    per-rank I/O concurrency (the mirror contends with the next take's
    fast-tier writes)."""
    val = os.environ.get(_MIRROR_IO_CONCURRENCY_ENV)
    if val is not None:
        return int(val)
    return get_per_rank_io_concurrency()


def get_mirror_progress_window_seconds() -> float:
    """Collective-progress retry window of the mirror's durable copies
    (``storage_plugins/retry.py``: any completed copy pushes the shared
    deadline out)."""
    val = os.environ.get(_MIRROR_PROGRESS_WINDOW_ENV)
    if val is not None:
        return float(val)
    from .storage_plugins.retry import DEFAULT_PROGRESS_WINDOW_SECONDS

    return DEFAULT_PROGRESS_WINDOW_SECONDS


def get_wait_durable_timeout_seconds() -> float:
    """Deadline of ``wait_durable`` (manager and mirror) when the caller
    gives none; <= 0 waits without a bound."""
    val = os.environ.get(_WAIT_DURABLE_TIMEOUT_ENV)
    if val is not None:
        return float(val)
    return _DEFAULT_WAIT_DURABLE_TIMEOUT_SECONDS


@contextlib.contextmanager
def _override_env(name: str, value: Optional[str]) -> Generator[None, None, None]:
    prev = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def override_max_chunk_size_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_MAX_CHUNK_SIZE_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def override_per_rank_memory_budget_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_PER_RANK_MEMORY_BUDGET_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def disable_checksums() -> Generator[None, None, None]:
    with _override_env(_DISABLE_CHECKSUMS_ENV, "1"):
        yield


@contextlib.contextmanager
def disable_native() -> Generator[None, None, None]:
    with _override_env(_DISABLE_NATIVE_ENV, "1"):
        yield


@contextlib.contextmanager
def override_incremental_chunk_size_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_INCREMENTAL_CHUNK_SIZE_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def override_restore_placement_flush_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_RESTORE_FLUSH_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def disable_async_device_snapshot() -> Generator[None, None, None]:
    with _override_env(_ASYNC_DEVICE_SNAPSHOT_ENV, "0"):
        yield


@contextlib.contextmanager
def disable_tree_barrier() -> Generator[None, None, None]:
    with _override_env(_TREE_BARRIER_ENV, "0"):
        yield


@contextlib.contextmanager
def override_barrier_fanout(fanout: int) -> Generator[None, None, None]:
    with _override_env(_BARRIER_FANOUT_ENV, str(fanout)):
        yield


@contextlib.contextmanager
def enable_fanout_restore() -> Generator[None, None, None]:
    with _override_env(_FANOUT_RESTORE_ENV, "1"):
        yield


@contextlib.contextmanager
def disable_fanout_restore() -> Generator[None, None, None]:
    with _override_env(_FANOUT_RESTORE_ENV, "0"):
        yield


@contextlib.contextmanager
def enable_cas() -> Generator[None, None, None]:
    with _override_env(_CAS_ENV, "1"):
        yield


@contextlib.contextmanager
def override_cas_gc_grace_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_CAS_GC_GRACE_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_max_shard_size_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_MAX_SHARD_SIZE_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def override_slab_size_threshold_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_SLAB_SIZE_THRESHOLD_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def enable_batching() -> Generator[None, None, None]:
    with _override_env(_ENABLE_BATCHING_ENV, "1"):
        yield


@contextlib.contextmanager
def enable_device_pack() -> Generator[None, None, None]:
    with _override_env(_DEVICE_PACK_ENV, "1"):
        yield


@contextlib.contextmanager
def override_mirror_progress_window_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_MIRROR_PROGRESS_WINDOW_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_wait_durable_timeout_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_WAIT_DURABLE_TIMEOUT_ENV, str(seconds)):
        yield
