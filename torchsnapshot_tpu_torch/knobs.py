"""Environment-variable knobs with test-friendly override context managers.

The knobs this package reads, under the same ``TORCHSNAPSHOT_TPU_`` names
as torchsnapshot_tpu's, so one environment configures both packages.
Values are read lazily on every call so tests and subprocesses can flip
them at any time. Knobs of subsystems not ported yet come with those
subsystems.

The throughput knobs (the *tunable* set: staging threads, per-rank I/O
concurrency, staging-pool geometry, memory-budget fraction, chunk, shard
and slab-threshold sizes, direct I/O, barrier fanout, store shards) also
honor a **programmatic override layer**, the write surface of the
autotuner (``tuner/``), as in the JAX package: an env var always wins, a
tuner override applies only where no env var is set, and the default
closes the chain. The override layer is process-local: nothing the tuner
does reaches a subprocess or outlives the process (its decision log,
``.tuner-state.json``, does).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Generator, Optional, Union

_MAX_CHUNK_SIZE_BYTES_ENV = "TORCHSNAPSHOT_TPU_MAX_CHUNK_SIZE_BYTES"
_PER_RANK_MEMORY_BUDGET_BYTES_ENV = "TORCHSNAPSHOT_TPU_PER_RANK_MEMORY_BUDGET_BYTES"
_MEMORY_BUDGET_FRACTION_ENV = "TORCHSNAPSHOT_TPU_MEMORY_BUDGET_FRACTION"
_PER_RANK_IO_CONCURRENCY_ENV = "TORCHSNAPSHOT_TPU_PER_RANK_IO_CONCURRENCY"
_S3_ENDPOINT_URL_ENV = "TORCHSNAPSHOT_TPU_S3_ENDPOINT"
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
_FLEET_OBS_ENV = "TORCHSNAPSHOT_TPU_FLEET_OBS"
_CDN_PULL_TIMEOUT_ENV = "TORCHSNAPSHOT_TPU_CDN_PULL_TIMEOUT_SECONDS"
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
_PEER_TIER_ENV = "TORCHSNAPSHOT_TPU_PEER_TIER"
_PEER_RING_OFFSET_ENV = "TORCHSNAPSHOT_TPU_PEER_RING_OFFSET"
_PEER_CACHE_BUDGET_BYTES_ENV = "TORCHSNAPSHOT_TPU_PEER_CACHE_BUDGET_BYTES"
_PEER_TRANSFER_TIMEOUT_ENV = "TORCHSNAPSHOT_TPU_PEER_TRANSFER_TIMEOUT_SECONDS"
_TELEMETRY_ENV = "TORCHSNAPSHOT_TPU_TELEMETRY"
_TELEMETRY_DIR_ENV = "TORCHSNAPSHOT_TPU_TELEMETRY_DIR"
_PROM_FILE_ENV = "TORCHSNAPSHOT_TPU_PROM_FILE"
_TRACE_ENV = "TORCHSNAPSHOT_TPU_TRACE"
_TRACE_DIR_ENV = "TORCHSNAPSHOT_TPU_TRACE_DIR"
_PROGRESS_SECONDS_ENV = "TORCHSNAPSHOT_TPU_PROGRESS_SECONDS"
_PROGRESS_DIR_ENV = "TORCHSNAPSHOT_TPU_PROGRESS_DIR"
_HISTORY_MAX_RECORDS_ENV = "TORCHSNAPSHOT_TPU_HISTORY_MAX_RECORDS"
_LEDGER_ENV = "TORCHSNAPSHOT_TPU_LEDGER"
_LEDGER_MAX_RECORDS_ENV = "TORCHSNAPSHOT_TPU_LEDGER_MAX_RECORDS"
_WATCHDOG_SECONDS_ENV = "TORCHSNAPSHOT_TPU_WATCHDOG_SECONDS"
_ASYNC_VISIBLE_BUDGET_ENV = "TORCHSNAPSHOT_TPU_ASYNC_VISIBLE_BUDGET_SECONDS"
_COLD_START_BUDGET_FRACTION_ENV = "TORCHSNAPSHOT_TPU_COLD_START_BUDGET_FRACTION"
_CDN_STALENESS_BUDGET_ENV = "TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS"
_AUTOTUNE_ENV = "TORCHSNAPSHOT_TPU_AUTOTUNE"
_SLO_ENV = "TORCHSNAPSHOT_TPU_SLO"
_SLO_FAST_WINDOW_ENV = "TORCHSNAPSHOT_TPU_SLO_FAST_WINDOW"
_SLO_SLOW_WINDOW_ENV = "TORCHSNAPSHOT_TPU_SLO_SLOW_WINDOW"
_SLO_FAST_BURN_ENV = "TORCHSNAPSHOT_TPU_SLO_FAST_BURN_THRESHOLD"
_SLO_SLOW_BURN_ENV = "TORCHSNAPSHOT_TPU_SLO_SLOW_BURN_THRESHOLD"
_SLO_ERROR_BUDGET_ENV = "TORCHSNAPSHOT_TPU_SLO_ERROR_BUDGET_FRACTION"
_SLO_RESTORE_BUDGET_ENV = "TORCHSNAPSHOT_TPU_SLO_RESTORE_SECONDS"
_SLO_MIRROR_LAG_BUDGET_ENV = "TORCHSNAPSHOT_TPU_SLO_MIRROR_LAG_SECONDS"
_SLO_OVERHEAD_BUDGET_ENV = "TORCHSNAPSHOT_TPU_SLO_OVERHEAD_FRACTION"
_SLO_COORD_BUDGET_ENV = "TORCHSNAPSHOT_TPU_SLO_COORDINATION_FRACTION"
_BUNDLE_DIR_ENV = "TORCHSNAPSHOT_TPU_BUNDLE_DIR"
_BUNDLE_MAX_BYTES_ENV = "TORCHSNAPSHOT_TPU_BUNDLE_MAX_BYTES"
_BUNDLE_MIN_INTERVAL_ENV = "TORCHSNAPSHOT_TPU_BUNDLE_MIN_INTERVAL_SECONDS"

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
_DEFAULT_PEER_RING_OFFSET: int = 1
_DEFAULT_PEER_CACHE_BUDGET_BYTES: int = 1024 * 1024 * 1024
_DEFAULT_PEER_TRANSFER_TIMEOUT_SECONDS: float = 30.0
_DEFAULT_PROGRESS_SECONDS: float = 1.0
_DEFAULT_HISTORY_MAX_RECORDS: int = 512
_DEFAULT_LEDGER_MAX_RECORDS: int = 4096
_DEFAULT_WATCHDOG_SECONDS: float = 60.0
_DEFAULT_ASYNC_VISIBLE_BUDGET_SECONDS: float = 5.0
_DEFAULT_COLD_START_BUDGET_FRACTION: float = 0.5
_DEFAULT_CDN_STALENESS_BUDGET_SECONDS: float = 5.0
_DEFAULT_SLO_FAST_WINDOW: int = 8
_DEFAULT_SLO_SLOW_WINDOW: int = 64
_DEFAULT_SLO_FAST_BURN_THRESHOLD: float = 2.0
_DEFAULT_SLO_SLOW_BURN_THRESHOLD: float = 1.0
_DEFAULT_SLO_ERROR_BUDGET_FRACTION: float = 0.1
_DEFAULT_SLO_RESTORE_SECONDS: float = 60.0
_DEFAULT_SLO_MIRROR_LAG_SECONDS: float = 120.0
_DEFAULT_SLO_OVERHEAD_FRACTION: float = 0.1
_DEFAULT_SLO_COORDINATION_FRACTION: float = 0.3
_DEFAULT_BUNDLE_MAX_BYTES: int = 64 * 1024 * 1024
_DEFAULT_BUNDLE_MIN_INTERVAL_SECONDS: float = 300.0


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    return default if val is None else int(val)


def _get_float_env(name: str, default: float) -> float:
    val = os.environ.get(name)
    return default if val is None else float(val)


# Programmatic tunable overrides, keyed by env-var name so that a tuner
# decision and the operator's env var name the same thing. Locked: an
# async save's commit thread applies a vector while pipelines read.
_TUNER_OVERRIDES: Dict[str, Union[int, float]] = {}
_TUNER_OVERRIDES_LOCK = threading.Lock()


def set_tuner_override(env_name: str, value: Union[int, float]) -> None:
    """Install one tunable's programmatic value. It applies only while no
    env var of the same name is set: a hand-set value always wins."""
    with _TUNER_OVERRIDES_LOCK:
        _TUNER_OVERRIDES[env_name] = value


def clear_tuner_override(env_name: str) -> None:
    with _TUNER_OVERRIDES_LOCK:
        _TUNER_OVERRIDES.pop(env_name, None)


def clear_tuner_overrides() -> None:
    """Drop every programmatic override (kill switch, test teardown)."""
    with _TUNER_OVERRIDES_LOCK:
        _TUNER_OVERRIDES.clear()


def get_tuner_overrides() -> Dict[str, Union[int, float]]:
    """A copy of the active programmatic overrides."""
    with _TUNER_OVERRIDES_LOCK:
        return dict(_TUNER_OVERRIDES)


def _get_tunable_int(name: str, default: int) -> int:
    """Env var, else tuner override, else default: the read every
    tunable getter goes through."""
    val = os.environ.get(name)
    if val is not None:
        return int(val)
    with _TUNER_OVERRIDES_LOCK:
        ov = _TUNER_OVERRIDES.get(name)
    return default if ov is None else int(ov)


def _get_tunable_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is not None:
        return float(val)
    with _TUNER_OVERRIDES_LOCK:
        ov = _TUNER_OVERRIDES.get(name)
    return default if ov is None else float(ov)


def get_max_chunk_size_bytes() -> int:
    """Arrays larger than this are split into chunks written independently."""
    return _get_tunable_int(_MAX_CHUNK_SIZE_BYTES_ENV, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


def get_max_shard_size_bytes() -> int:
    """Local shards of a sharded (``DTensor``) leaf larger than this are
    subdivided along dim 0 before writing."""
    return _get_tunable_int(_MAX_SHARD_SIZE_BYTES_ENV, _DEFAULT_MAX_SHARD_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    """Write requests smaller than this are eligible for slab batching."""
    return _get_tunable_int(
        _SLAB_SIZE_THRESHOLD_BYTES_ENV, _DEFAULT_SLAB_SIZE_THRESHOLD_BYTES
    )


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
    return _get_tunable_float(_MEMORY_BUDGET_FRACTION_ENV, _DEFAULT_MEMORY_BUDGET_FRACTION)


def get_per_rank_io_concurrency() -> int:
    """Max concurrent storage I/O ops per process."""
    return _get_tunable_int(_PER_RANK_IO_CONCURRENCY_ENV, _DEFAULT_PER_RANK_IO_CONCURRENCY)


def get_s3_endpoint_url() -> Optional[str]:
    """Non-AWS S3-compatible endpoint (MinIO, private object stores);
    unset = real S3."""
    return os.environ.get(_S3_ENDPOINT_URL_ENV) or None


def get_staging_threads() -> int:
    """Threads for device->host staging / (de)serialization."""
    return _get_tunable_int(_STAGING_THREADS_ENV, _DEFAULT_STAGING_THREADS)


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
    return _get_tunable_int(_FS_DIRECT_IO_ENV, 0) != 0


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
    return _get_tunable_int(_STAGING_POOL_SLAB_BYTES_ENV, _DEFAULT_STAGING_POOL_SLAB_BYTES)


def get_staging_pool_slabs() -> int:
    """Slab count of the staging pool. 2 is double buffering: one slab's
    worth of requests copies to the host while the previous one drains to
    storage."""
    return _get_tunable_int(_STAGING_POOL_SLABS_ENV, _DEFAULT_STAGING_POOL_SLABS)


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
    """The checkpoint CDN's publish side (``cdn/``), default OFF: with
    ``"1"``, a manager constructed with a ``cdn_topic`` announces every
    committed step (its chunk-store keys) to the topic on the coordination
    store. Off, the manager never touches the topic keys; subscribers
    built explicitly work either way (the knob gates the training job's
    side, where a publish adds store traffic to every commit)."""
    return os.environ.get(_CDN_ENV, "0") not in ("", "0")


def is_fleet_obs_enabled() -> bool:
    """The fleet metrics plane (``telemetry/wire.py``), default OFF: with
    ``"1"``, storm ranks, CDN publishers and CDN subscribers publish one
    compact crc-guarded wire snapshot each under ``__obs/`` on the
    coordination store (paced by world size, reaped on a clean close),
    which ``python -m torchsnapshot_tpu_torch.telemetry fleet <target>``
    renders as a live table. Off, no ``__obs/`` key is written; the fleet
    CLI still reads what another process published."""
    return os.environ.get(_FLEET_OBS_ENV, "0") not in ("", "0")


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
    return max(2, _get_tunable_int(_BARRIER_FANOUT_ENV, _DEFAULT_BARRIER_FANOUT))


def get_store_shards() -> int:
    """Coordination-store shard count: more than 1 bootstraps that many
    TCPStore servers, spread over the ranks, behind key->shard hashing.
    Rank 0's reading decides for the job."""
    return max(1, _get_tunable_int(_STORE_SHARDS_ENV, _DEFAULT_STORE_SHARDS))


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


def is_peer_tier_enabled() -> bool:
    """The peer-RAM tier (``tiered/peer.py``): every rank pushes its
    committed blobs into a neighbour rank's host-RAM cache, and restores
    resolve peer RAM -> local fast tier -> durable per blob. On by
    default, but inert until a multi-rank process group configures it
    (``CheckpointManager(pg=...)`` or ``tiered.peer.maybe_configure``):
    a single-process job starts no server. ``"0"`` kills it: no server,
    no pushes, no pulls."""
    return os.environ.get(_PEER_TIER_ENV, "1") != "0"


def get_peer_ring_offset() -> int:
    """Ring placement distance: rank ``r`` pushes to ``(r + offset) %
    world``. The default of 1 survives any single-rank preemption."""
    return _get_int_env(_PEER_RING_OFFSET_ENV, _DEFAULT_PEER_RING_OFFSET)


def get_peer_cache_budget_bytes() -> int:
    """Host-RAM bound on one process's peer cache (the blobs pushed to
    this rank): LRU by step with the newest committed step pinned; a
    push that cannot fit is refused, never the cache over budget."""
    return _get_int_env(_PEER_CACHE_BUDGET_BYTES_ENV, _DEFAULT_PEER_CACHE_BUDGET_BYTES)


def get_peer_transfer_timeout_seconds() -> float:
    """Deadline of one peer transfer (connect, one blob push or pull) and
    the no-progress retry window of a push job."""
    val = os.environ.get(_PEER_TRANSFER_TIMEOUT_ENV)
    if val is not None:
        return float(val)
    return _DEFAULT_PEER_TRANSFER_TIMEOUT_SECONDS


def get_cdn_pull_timeout_seconds() -> float:
    """Per-chunk deadline of a CDN subscriber's peer pull (connect and one
    digest-verified transfer) and of its wait for the chunk's elected
    owner to hold it. On expiry the subscriber reads the chunk from
    durable storage: correctness never rides a peer, only the one-read-
    per-chunk economics do. Defaults to the peer transfer timeout."""
    val = os.environ.get(_CDN_PULL_TIMEOUT_ENV)
    if val is not None:
        return float(val)
    return get_peer_transfer_timeout_seconds()


def get_telemetry_dir() -> Optional[str]:
    """Local directory for the telemetry JSONL event log
    (``<dir>/events.jsonl``). Takes precedence over the snapshot-adjacent
    sink; unset = no directory sink."""
    return os.environ.get(_TELEMETRY_DIR_ENV) or None


def is_telemetry_sink_enabled() -> bool:
    """Snapshot-adjacent JSONL sink toggle: with the env var present (any
    value, ``0`` included), every take/restore/mirror against a *local*
    snapshot path appends its SnapshotReport to
    ``<snapshot>/.telemetry.jsonl``. A telemetry dir also counts as
    enablement; reports then go there instead. The registry itself always
    records; these knobs only control whether anything is written out."""
    return _TELEMETRY_ENV in os.environ or get_telemetry_dir() is not None


def get_prometheus_textfile() -> Optional[str]:
    """Prometheus text-exposition file, rewritten atomically after every
    report emission (the node-exporter textfile-collector convention).
    Unset = disabled."""
    return os.environ.get(_PROM_FILE_ENV) or None


def get_trace_dir() -> Optional[str]:
    """Local directory for flight-recorder Chrome-trace exports
    (``<dir>/trace-<kind>-rank<r>.json``). Takes precedence over the
    snapshot-adjacent trace files; unset = no directory sink."""
    return os.environ.get(_TRACE_DIR_ENV) or None


def is_trace_sink_enabled() -> bool:
    """Trace-export toggle: with the env var present (any value, ``0``
    included), every take/restore/mirror against a *local* snapshot path
    writes its span timeline to ``<snapshot>/.trace-<kind>-rank<r>.json``.
    A trace dir also counts as enablement. The recorder itself always
    records into its bounded ring."""
    return _TRACE_ENV in os.environ or get_trace_dir() is not None


def get_progress_interval_seconds() -> float:
    """Minimum interval between live-progress heartbeat rewrites
    (``<snapshot>/.progress-rank<r>.json``, telemetry/progress.py). <= 0
    disables the file heartbeat; the in-memory
    ``telemetry.current_progress()`` view is always on."""
    val = os.environ.get(_PROGRESS_SECONDS_ENV)
    if val is not None:
        return float(val)
    return _DEFAULT_PROGRESS_SECONDS


def get_progress_dir() -> Optional[str]:
    """Local directory for live-progress heartbeat files
    (``<dir>/progress-<digest>-<kind>-rank<r>.json``). Takes precedence
    over the snapshot-adjacent heartbeat; unset = snapshot-adjacent when
    the snapshot path is local."""
    return os.environ.get(_PROGRESS_DIR_ENV) or None


def get_history_max_records() -> int:
    """Bound on the per-manager rolling step history
    (``<root>/.telemetry-history.jsonl``, telemetry/history.py): the
    newest N summaries are kept. <= 0 disables history recording."""
    val = os.environ.get(_HISTORY_MAX_RECORDS_ENV)
    if val is not None:
        return int(val)
    return _DEFAULT_HISTORY_MAX_RECORDS


def is_ledger_enabled() -> bool:
    """The run ledger (``<root>/.ledger.jsonl``, telemetry/ledger.py): on
    by default. The manager, snapshot envelopes, tiered mirror, preemption
    saver, CDN and GC post typed events rank-0-only, and the goodput
    engine attributes the run's wall time from them. ``"0"`` disables
    every ledger read and write; so does a non-positive max-records
    bound."""
    return os.environ.get(_LEDGER_ENV, "1") != "0" and get_ledger_max_records() > 0


def get_ledger_max_records() -> int:
    """Bound on the run ledger: the newest N records are kept (the newest
    run-start always survives a trim). <= 0 disables ledger recording."""
    val = os.environ.get(_LEDGER_MAX_RECORDS_ENV)
    if val is not None:
        return int(val)
    return _DEFAULT_LEDGER_MAX_RECORDS


def get_watchdog_deadline_seconds() -> float:
    """Open-span age past which the stall watchdog fires (a
    ``watchdog:stall`` instant, the open-span tree and thread stacks in
    the log, ``watchdog_stalls_total`` and an incident bundle), when the
    recorder has also been idle that long. <= 0 disables the watchdog
    (the suite's conftest pins 0). Re-read on every scan."""
    return _get_float_env(_WATCHDOG_SECONDS_ENV, _DEFAULT_WATCHDOG_SECONDS)


def get_async_visible_budget_seconds() -> float:
    """Threshold of the doctor's ``async-visible-stall`` rule: an async
    take whose training-visible span (``visible_s``) exceeds it is
    flagged. <= 0 disables the rule."""
    return _get_float_env(_ASYNC_VISIBLE_BUDGET_ENV, _DEFAULT_ASYNC_VISIBLE_BUDGET_SECONDS)


def get_cold_start_budget_fraction() -> float:
    """Threshold of the doctor's ``restore-cold-start-slow`` rule: the
    share of a restore's wall its recorded ``cold_start_s`` may take.
    <= 0 disables the rule."""
    return _get_float_env(
        _COLD_START_BUDGET_FRACTION_ENV, _DEFAULT_COLD_START_BUDGET_FRACTION
    )


def get_cdn_staleness_budget_seconds() -> float:
    """Publish-to-swap latency budget of the doctor's
    ``cdn-staleness-high`` rule (median over the ledger's
    ``cdn-swapped`` records)."""
    return _get_float_env(_CDN_STALENESS_BUDGET_ENV, _DEFAULT_CDN_STALENESS_BUDGET_SECONDS)


def is_autotune_enabled() -> bool:
    """The write-path autotuner (``tuner/``), on by default: after each
    manager commit rank 0 decides the next knob vector from the step's
    report and the doctor's verdicts, and every rank applies it. ``"0"``
    is the kill switch: no tuner object, no ``.tuner-state.json``, no
    override, no broadcast (the suite's conftest pins it). A knob set in
    the environment is never moved either way."""
    return os.environ.get(_AUTOTUNE_ENV, "1") != "0"


def is_slo_enabled() -> bool:
    """The SLO engine (``telemetry/slo.py``), on by default: after each
    manager commit rank 0 judges the declared objectives with
    multi-window burn rates over the run ledger and step history, sets
    the ``slo_burn_rate`` gauges and posts an edge-triggered
    ``slo-breach`` ledger event. ``"0"`` disables it (the suite's
    conftest pins it); it needs the ledger on to have samples."""
    return os.environ.get(_SLO_ENV, "1") != "0"


def get_slo_fast_window() -> int:
    """Sample count of the fast burn window (the look that catches
    cliffs). <= 0 disables it."""
    return _get_int_env(_SLO_FAST_WINDOW_ENV, _DEFAULT_SLO_FAST_WINDOW)


def get_slo_slow_window() -> int:
    """Sample count of the slow burn window (the look that catches
    drift). <= 0 disables it."""
    return _get_int_env(_SLO_SLOW_WINDOW_ENV, _DEFAULT_SLO_SLOW_WINDOW)


def get_slo_fast_burn_threshold() -> float:
    """Burn rate at which the fast window fires (1.0 spends the error
    budget at exactly the sustainable rate)."""
    return _get_float_env(_SLO_FAST_BURN_ENV, _DEFAULT_SLO_FAST_BURN_THRESHOLD)


def get_slo_slow_burn_threshold() -> float:
    """Burn rate at which the slow window fires."""
    return _get_float_env(_SLO_SLOW_BURN_ENV, _DEFAULT_SLO_SLOW_BURN_THRESHOLD)


def get_slo_error_budget_fraction() -> float:
    """Allowed bad-sample fraction per objective: burn rate = observed
    bad fraction / this."""
    return _get_float_env(_SLO_ERROR_BUDGET_ENV, _DEFAULT_SLO_ERROR_BUDGET_FRACTION)


def get_slo_restore_seconds() -> float:
    """Target of the ``restore-wall`` objective. <= 0 disables it."""
    return _get_float_env(_SLO_RESTORE_BUDGET_ENV, _DEFAULT_SLO_RESTORE_SECONDS)


def get_slo_mirror_lag_seconds() -> float:
    """Target of the ``mirror-durability-lag`` objective: how long a
    step's bytes may live only on the fast tier. <= 0 disables it."""
    return _get_float_env(_SLO_MIRROR_LAG_BUDGET_ENV, _DEFAULT_SLO_MIRROR_LAG_SECONDS)


def get_slo_overhead_fraction() -> float:
    """Target of the ``goodput-overhead`` objective: the share of a
    commit interval that checkpoint overhead may take. <= 0 disables
    it."""
    return _get_float_env(_SLO_OVERHEAD_BUDGET_ENV, _DEFAULT_SLO_OVERHEAD_FRACTION)


def get_slo_coordination_fraction() -> float:
    """Target of the ``coordination-fraction`` objective: the share of a
    take's wall that coordination may take. <= 0 disables it."""
    return _get_float_env(_SLO_COORD_BUDGET_ENV, _DEFAULT_SLO_COORDINATION_FRACTION)


def get_bundle_dir() -> Optional[str]:
    """Where incident bundles land. Unset: ``<root>/.bundles`` beside the
    root that triggered the capture (the fast tier of a tiered root)."""
    return os.environ.get(_BUNDLE_DIR_ENV) or None


def get_bundle_max_bytes() -> int:
    """Size cap of one incident bundle; <= 0 disables capture (the
    suite's conftest pins 0)."""
    return _get_int_env(_BUNDLE_MAX_BYTES_ENV, _DEFAULT_BUNDLE_MAX_BYTES)


def get_bundle_min_interval_seconds() -> float:
    """Least time between two captures into one bundle dir: a breach
    storm leaves one black box, not one per step."""
    return _get_float_env(_BUNDLE_MIN_INTERVAL_ENV, _DEFAULT_BUNDLE_MIN_INTERVAL_SECONDS)


def tunable_snapshot() -> Dict[str, Union[int, float]]:
    """Effective value of every tunable knob the port reads, under the
    JAX package's short names: the ``tunables`` field each SnapshotReport
    records: env var, else tuner override, else default. The JAX
    package's ``write_vectorized`` is absent (the port has no vectorized
    slab write)."""
    return {
        "staging_threads": get_staging_threads(),
        "io_concurrency": get_per_rank_io_concurrency(),
        "staging_pool_slab_bytes": get_staging_pool_slab_bytes(),
        "staging_pool_slabs": get_staging_pool_slabs(),
        "memory_budget_fraction": get_memory_budget_fraction(),
        "max_chunk_size_bytes": get_max_chunk_size_bytes(),
        "max_shard_size_bytes": get_max_shard_size_bytes(),
        "slab_size_threshold_bytes": get_slab_size_threshold_bytes(),
        "fs_direct_io": int(is_fs_direct_io_enabled()),
        "barrier_fanout": get_barrier_fanout(),
        "store_shards": get_store_shards(),
    }


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


@contextlib.contextmanager
def enable_peer_tier() -> Generator[None, None, None]:
    with _override_env(_PEER_TIER_ENV, "1"):
        yield


@contextlib.contextmanager
def disable_peer_tier() -> Generator[None, None, None]:
    with _override_env(_PEER_TIER_ENV, "0"):
        yield


@contextlib.contextmanager
def override_peer_ring_offset(offset: int) -> Generator[None, None, None]:
    with _override_env(_PEER_RING_OFFSET_ENV, str(offset)):
        yield


@contextlib.contextmanager
def override_peer_cache_budget_bytes(nbytes: int) -> Generator[None, None, None]:
    with _override_env(_PEER_CACHE_BUDGET_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def override_peer_transfer_timeout_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_PEER_TRANSFER_TIMEOUT_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def enable_cdn() -> Generator[None, None, None]:
    """The CDN publish hook on for the block (the suite's conftest pins it
    off, so that manager tests see no announce traffic)."""
    with _override_env(_CDN_ENV, "1"):
        yield


@contextlib.contextmanager
def enable_fleet_obs() -> Generator[None, None, None]:
    """The fleet metrics plane on for the block (the suite's conftest pins
    it off, so that store-traffic tests see only the keys they wrote)."""
    with _override_env(_FLEET_OBS_ENV, "1"):
        yield


@contextlib.contextmanager
def override_cdn_pull_timeout_seconds(seconds: float) -> Generator[None, None, None]:
    """Pin the CDN peer-pull deadline for the block (subscribers read it
    at each pull)."""
    with _override_env(_CDN_PULL_TIMEOUT_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def enable_telemetry() -> Generator[None, None, None]:
    with _override_env(_TELEMETRY_ENV, "1"):
        yield


@contextlib.contextmanager
def override_telemetry_dir(path: str) -> Generator[None, None, None]:
    with _override_env(_TELEMETRY_DIR_ENV, path):
        yield


@contextlib.contextmanager
def override_prometheus_textfile(path: str) -> Generator[None, None, None]:
    with _override_env(_PROM_FILE_ENV, path):
        yield


@contextlib.contextmanager
def enable_trace() -> Generator[None, None, None]:
    with _override_env(_TRACE_ENV, "1"):
        yield


@contextlib.contextmanager
def override_trace_dir(path: str) -> Generator[None, None, None]:
    with _override_env(_TRACE_DIR_ENV, path):
        yield


@contextlib.contextmanager
def override_trace_buffer_events(n: int) -> Generator[None, None, None]:
    with _override_env(_TRACE_BUFFER_EVENTS_ENV, str(n)):
        yield


@contextlib.contextmanager
def override_progress_interval_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_PROGRESS_SECONDS_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_progress_dir(path: str) -> Generator[None, None, None]:
    with _override_env(_PROGRESS_DIR_ENV, path):
        yield


@contextlib.contextmanager
def override_history_max_records(n: int) -> Generator[None, None, None]:
    with _override_env(_HISTORY_MAX_RECORDS_ENV, str(n)):
        yield


@contextlib.contextmanager
def enable_ledger() -> Generator[None, None, None]:
    """The run ledger on for the block (the suite's conftest pins it off
    so that manager dirs hold exactly the files the code under test
    wrote)."""
    with _override_env(_LEDGER_ENV, "1"):
        yield


@contextlib.contextmanager
def disable_ledger() -> Generator[None, None, None]:
    with _override_env(_LEDGER_ENV, "0"):
        yield


@contextlib.contextmanager
def override_ledger_max_records(n: int) -> Generator[None, None, None]:
    with _override_env(_LEDGER_MAX_RECORDS_ENV, str(n)):
        yield


@contextlib.contextmanager
def override_watchdog_deadline_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_WATCHDOG_SECONDS_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_async_visible_budget_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_ASYNC_VISIBLE_BUDGET_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_cold_start_budget_fraction(fraction: float) -> Generator[None, None, None]:
    with _override_env(_COLD_START_BUDGET_FRACTION_ENV, str(fraction)):
        yield


@contextlib.contextmanager
def enable_autotune() -> Generator[None, None, None]:
    """The autotuner on for the block (the suite's conftest pins it off);
    the overrides it installs are cleared on exit."""
    with _override_env(_AUTOTUNE_ENV, "1"):
        try:
            yield
        finally:
            clear_tuner_overrides()


@contextlib.contextmanager
def override_staging_threads(n: int) -> Generator[None, None, None]:
    with _override_env(_STAGING_THREADS_ENV, str(n)):
        yield


@contextlib.contextmanager
def override_per_rank_io_concurrency(n: int) -> Generator[None, None, None]:
    with _override_env(_PER_RANK_IO_CONCURRENCY_ENV, str(n)):
        yield


@contextlib.contextmanager
def enable_slo() -> Generator[None, None, None]:
    """The SLO engine on for the block (the suite's conftest pins it
    off)."""
    with _override_env(_SLO_ENV, "1"):
        yield


@contextlib.contextmanager
def override_slo_windows(fast: int, slow: int) -> Generator[None, None, None]:
    with _override_env(_SLO_FAST_WINDOW_ENV, str(fast)):
        with _override_env(_SLO_SLOW_WINDOW_ENV, str(slow)):
            yield


@contextlib.contextmanager
def override_slo_restore_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_SLO_RESTORE_BUDGET_ENV, str(seconds)):
        yield


@contextlib.contextmanager
def override_slo_overhead_fraction(fraction: float) -> Generator[None, None, None]:
    with _override_env(_SLO_OVERHEAD_BUDGET_ENV, str(fraction)):
        yield


@contextlib.contextmanager
def override_bundle_max_bytes(nbytes: int) -> Generator[None, None, None]:
    """Bundle capture on, and bounded, for the block (the suite's
    conftest pins the cap to 0)."""
    with _override_env(_BUNDLE_MAX_BYTES_ENV, str(nbytes)):
        yield


@contextlib.contextmanager
def override_bundle_min_interval_seconds(seconds: float) -> Generator[None, None, None]:
    with _override_env(_BUNDLE_MIN_INTERVAL_ENV, str(seconds)):
        yield
