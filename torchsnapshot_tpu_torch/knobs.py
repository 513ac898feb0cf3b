"""Environment-variable knobs with test-friendly override context managers.

The knobs this package reads, under the same ``TORCHSNAPSHOT_TPU_`` names
as torchsnapshot_tpu's, so one environment configures both packages.
Values are read lazily on every call so tests and subprocesses can flip
them at any time. Knobs of subsystems not ported yet (CAS, tiered storage,
SLO, bundles, the autotuner, ...) come with those subsystems.
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

_DEFAULT_MAX_CHUNK_SIZE_BYTES: int = 512 * 1024 * 1024
_DEFAULT_MEMORY_BUDGET_FRACTION: float = 0.6
_DEFAULT_PER_RANK_IO_CONCURRENCY: int = 16
_DEFAULT_STAGING_THREADS: int = 4
_DEFAULT_TRACE_BUFFER_EVENTS: int = 16384


def _get_int_env(name: str, default: int) -> int:
    val = os.environ.get(name)
    return default if val is None else int(val)


def get_max_chunk_size_bytes() -> int:
    """Arrays larger than this are split into chunks written independently."""
    return _get_int_env(_MAX_CHUNK_SIZE_BYTES_ENV, _DEFAULT_MAX_CHUNK_SIZE_BYTES)


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
