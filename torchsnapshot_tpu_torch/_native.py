"""ctypes bindings for the native I/O runtime (native/ts_io.cpp).

The shared library is compiled on first use with the host toolchain and
cached next to the source (falling back to a temp dir when the package is
installed read-only). Everything degrades gracefully: if no C++ compiler
is available or the build fails, ``lib()`` returns ``None`` and callers
use their pure-Python paths — behavior is identical, only slower.

Why ctypes and not a CPython extension: ctypes releases the GIL around
every foreign call, which is exactly what the scheduler's executor threads
need (N threads → N concurrent pwrite/pread streams), and it keeps the
package importable on machines with no toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

from . import knobs

logger = logging.getLogger(__name__)

_SRC_PATH = os.path.join(os.path.dirname(__file__), "native", "ts_io.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _compiler() -> Optional[str]:
    for cc in ("g++", "clang++", "c++"):
        path = shutil.which(cc)
        if path:
            return path
    return None


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC_PATH):
        logger.warning("native source missing at %s", _SRC_PATH)
        return None
    cc = _compiler()
    if cc is None:
        logger.info("no C++ compiler found; using pure-Python I/O paths")
        return None
    with open(_SRC_PATH, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + cc.encode()).hexdigest()[:16]
    candidates = [
        os.path.join(os.path.dirname(_SRC_PATH), f"_ts_io_{tag}.so"),
        os.path.join(
            tempfile.gettempdir(), f"torchsnapshot_tpu_torch_{os.getuid()}",
            f"_ts_io_{tag}.so",
        ),
    ]
    for so_path in candidates:
        if os.path.exists(so_path):
            try:
                return ctypes.CDLL(so_path)
            except OSError:
                pass  # stale/corrupt cache: rebuild below
        out_dir = os.path.dirname(so_path)
        tmp_out = None
        try:
            os.makedirs(out_dir, exist_ok=True)
            # Build to a temp name then rename: concurrent processes racing
            # the build each atomically install a complete .so.
            fd, tmp_out = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [
                cc, "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
                _SRC_PATH, "-o", tmp_out,
            ]
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120
            )
            if proc.returncode != 0:
                logger.warning(
                    "native build failed (%s): %s", cc, proc.stderr[-2000:]
                )
                return None
            os.replace(tmp_out, so_path)
            tmp_out = None
            return ctypes.CDLL(so_path)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.debug("native build in %s failed: %s", out_dir, e)
            continue
        finally:
            if tmp_out is not None:
                try:
                    os.unlink(tmp_out)
                except OSError:
                    pass
    return None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (disabled / unbuildable)."""
    global _lib, _load_attempted
    if knobs.is_native_disabled():
        return None
    if _load_attempted:
        return _lib
    with _lock:
        if not _load_attempted:
            l = _build_and_load()
            if l is not None:
                _declare(l)
                logger.info("native I/O runtime loaded")
            _lib = l
            _load_attempted = True
    return _lib


def _declare(l: ctypes.CDLL) -> None:
    l.ts_write_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]
    l.ts_write_file.restype = ctypes.c_int
    l.ts_pread_range.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    l.ts_pread_range.restype = ctypes.c_int
    l.ts_file_size.argtypes = [ctypes.c_char_p]
    l.ts_file_size.restype = ctypes.c_int64
    l.ts_gather_memcpy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    l.ts_gather_memcpy.restype = None
    l.ts_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    l.ts_crc32c.restype = ctypes.c_uint32
    l.ts_write_file_crc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    l.ts_write_file_crc.restype = ctypes.c_int
    l.ts_pread_crc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    l.ts_pread_crc.restype = ctypes.c_int
    l.ts_pwritev_file_crc.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    l.ts_pwritev_file_crc.restype = ctypes.c_int
    l.ts_write_file_crc_direct.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    l.ts_write_file_crc_direct.restype = ctypes.c_int


def _raise_errno(rc: int, path: str) -> None:
    err = -rc
    raise OSError(err, os.strerror(err), path)


def _addr_of(mv: memoryview) -> int:
    """Address of a contiguous memoryview's first byte (no copy).

    The address stays valid only while ``mv`` is alive — callers keep the
    view referenced for the duration of the foreign call. Writable
    buffers resolve through ``ctypes.from_buffer`` (pure C, no wrapper
    object churn); read-only ones (bytes / serialized payloads, which
    ``from_buffer`` rejects) fall back to the ``np.frombuffer`` route.
    This runs once per chunk on the hottest path in the library, so the
    numpy import is hoisted to module scope (lazily, on first read-only
    caller) instead of being re-resolved per call.
    """
    if mv.nbytes == 0:
        return 0
    if not mv.readonly:
        return ctypes.addressof(ctypes.c_char.from_buffer(mv))
    global _np
    if _np is None:
        import numpy

        _np = numpy
    return int(_np.frombuffer(mv, dtype=_np.uint8).ctypes.data)


_np = None

# O_DIRECT alignment unit (matches kDirectAlign in ts_io.cpp): buffer
# addresses must sit on this boundary for the direct write path.
DIRECT_IO_ALIGNMENT = 4096


def aligned_buffer(nbytes: int, align: int = DIRECT_IO_ALIGNMENT) -> memoryview:
    """A writable ``nbytes`` view whose first byte sits on an ``align``
    boundary — what makes a staged slab O_DIRECT-eligible. The view
    keeps its backing bytearray alive; zero-size requests still return
    a (degenerate) view so callers never branch."""
    raw = bytearray(nbytes + align)
    base = ctypes.addressof(ctypes.c_char.from_buffer(raw))
    off = (-base) % align
    return memoryview(raw)[off : off + nbytes]


def is_direct_aligned(mv: memoryview) -> bool:
    """True when ``mv``'s first byte is O_DIRECT-aligned."""
    if mv.nbytes == 0:
        return False
    return _addr_of(mv) % DIRECT_IO_ALIGNMENT == 0


def write_file(path: str, buf, do_fsync: bool = False) -> bool:
    """Native whole-file write. Returns False when native is unavailable."""
    l = lib()
    if l is None:
        return False
    mv = memoryview(buf).cast("B")
    rc = l.ts_write_file(
        path.encode(), _addr_of(mv), mv.nbytes, 1 if do_fsync else 0
    )
    if rc != 0:
        _raise_errno(rc, path)
    return True


def pread_into(path: str, out, offset: int = 0) -> bool:
    """Read exactly len(out) bytes at offset into writable buffer ``out``."""
    l = lib()
    if l is None:
        return False
    mv = memoryview(out).cast("B")
    if mv.readonly:
        raise ValueError("pread_into requires a writable buffer")
    rc = l.ts_pread_range(path.encode(), _addr_of(mv), mv.nbytes, offset)
    if rc != 0:
        _raise_errno(rc, path)
    return True


def file_size(path: str) -> Optional[int]:
    l = lib()
    if l is None:
        return None
    size = l.ts_file_size(path.encode())
    if size < 0:
        _raise_errno(int(size), path)
    return int(size)


def gather_memcpy(
    dst, parts: Sequence[Tuple[object, int]], n_threads: int = 4
) -> bool:
    """Scatter ``parts`` = [(src_buffer, dst_offset), ...] into writable
    ``dst`` with a multithreaded native memcpy. Returns False when native
    is unavailable (caller falls back to Python slicing)."""
    l = lib()
    if l is None or not parts:
        return l is not None
    dst_mv = memoryview(dst).cast("B")
    if dst_mv.readonly:
        raise ValueError("gather_memcpy requires a writable destination")
    n = len(parts)
    srcs = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_uint64 * n)()
    offsets = (ctypes.c_uint64 * n)()
    # Keep memoryviews alive (and pinned) for the duration of the call.
    keepalive: List[memoryview] = []
    for i, (src, off) in enumerate(parts):
        mv = memoryview(src).cast("B")
        keepalive.append(mv)
        if off + mv.nbytes > dst_mv.nbytes:
            raise ValueError(
                f"part {i} [{off}, {off + mv.nbytes}) exceeds dst size "
                f"{dst_mv.nbytes}"
            )
        srcs[i] = _addr_of(mv)
        sizes[i] = mv.nbytes
        offsets[i] = off
    l.ts_gather_memcpy(
        _addr_of(dst_mv), srcs, sizes, offsets, n, int(n_threads)
    )
    return True


def crc32c(buf, seed: int = 0) -> Optional[int]:
    """CRC32-C of a bytes-like object, or None when native is unavailable."""
    l = lib()
    if l is None:
        return None
    mv = memoryview(buf).cast("B")
    return int(l.ts_crc32c(_addr_of(mv), mv.nbytes, seed & 0xFFFFFFFF))


def pread_into_crc(
    path: str, out, page_size: int, offset: int = 0
) -> Optional[List[int]]:
    """Fused read + integrity pass: fills ``out`` and returns the CRC32-C
    of each ``page_size`` page, computed while the page is cache-hot from
    the read. None when native is unavailable."""
    l = lib()
    if l is None:
        return None
    mv = memoryview(out).cast("B")
    if mv.readonly:
        raise ValueError("pread_into_crc requires a writable buffer")
    n_pages = (mv.nbytes + page_size - 1) // page_size
    crcs = (ctypes.c_uint32 * max(1, n_pages))()
    rc = l.ts_pread_crc(
        path.encode(), _addr_of(mv), mv.nbytes, offset, page_size, crcs
    )
    if rc != 0:
        _raise_errno(rc, path)
    return [int(crcs[i]) for i in range(n_pages)]


def pwritev_file_crc(
    path: str,
    parts: Sequence[object],
    page_size: Optional[int] = None,
    do_fsync: bool = False,
) -> Optional[List[int]]:
    """Zero-pack vectorized write: gather ``parts`` (buffer-protocol
    objects, concatenated in order) straight into a fresh file with
    pwritev. With ``page_size`` set, additionally computes the CRC32-C
    of each page of the concatenated stream (pages cross part
    boundaries) in the same cache-hot pass and returns the page list;
    without it, returns ``[]`` on success. ``None`` when the native
    runtime is unavailable (nothing written)."""
    l = lib()
    if l is None:
        return None
    n = len(parts)
    bufs = (ctypes.c_void_p * max(1, n))()
    lens = (ctypes.c_uint64 * max(1, n))()
    keepalive: List[memoryview] = []
    total = 0
    for i, part in enumerate(parts):
        mv = memoryview(part)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        keepalive.append(mv)
        bufs[i] = _addr_of(mv)
        lens[i] = mv.nbytes
        total += mv.nbytes
    crcs = None
    if page_size is not None:
        n_pages = (total + page_size - 1) // page_size
        crcs = (ctypes.c_uint32 * max(1, n_pages))()
    rc = l.ts_pwritev_file_crc(
        path.encode(),
        bufs,
        lens,
        n,
        page_size or 0,
        crcs,
        1 if do_fsync else 0,
    )
    if rc != 0:
        _raise_errno(rc, path)
    if crcs is None:
        return []
    n_pages = (total + page_size - 1) // page_size
    return [int(crcs[i]) for i in range(n_pages)]


def write_file_crc_direct(
    path: str, buf, page_size: Optional[int] = None, do_fsync: bool = False
) -> Optional[List[int]]:
    """O_DIRECT fused write (+ optional integrity pass) for large aligned
    buffers: the 4096-aligned body bypasses the page cache, the unaligned
    tail is written buffered, and — with ``page_size`` set — each page's
    CRC32-C is computed in the same loop. ``page_size=None`` skips the
    CRC pass entirely (the kernel takes a NULL page array; no per-byte
    CRC cost when the caller doesn't record checksums) and returns ``[]``
    on success. ``None`` when the native runtime is unavailable. Raises
    ``OSError(EINVAL)`` on filesystems without O_DIRECT support (tmpfs)
    or for unaligned buffers — callers treat that as a sticky decline
    back to the buffered fused path."""
    l = lib()
    if l is None:
        return None
    mv = memoryview(buf)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if page_size is None:
        n_pages = 0
        out = None
    else:
        n_pages = (mv.nbytes + page_size - 1) // page_size
        out = (ctypes.c_uint32 * max(1, n_pages))()
    rc = l.ts_write_file_crc_direct(
        path.encode(),
        _addr_of(mv),
        mv.nbytes,
        page_size or 0,
        out,
        1 if do_fsync else 0,
    )
    if rc != 0:
        _raise_errno(rc, path)
    return [int(out[i]) for i in range(n_pages)]


def write_file_crc(
    path: str, buf, page_size: int, do_fsync: bool = False
) -> Optional[List[int]]:
    """Fused write + integrity pass: writes ``buf`` to a fresh file and
    returns the CRC32-C of each ``page_size`` page (computed while the
    page is cache-hot from the write — one memory pass instead of two).
    None when native is unavailable."""
    l = lib()
    if l is None:
        return None
    mv = memoryview(buf).cast("B")
    n_pages = (mv.nbytes + page_size - 1) // page_size
    out = (ctypes.c_uint32 * max(1, n_pages))()
    rc = l.ts_write_file_crc(
        path.encode(),
        _addr_of(mv),
        mv.nbytes,
        page_size,
        out,
        1 if do_fsync else 0,
    )
    if rc != 0:
        _raise_errno(rc, path)
    return [int(out[i]) for i in range(n_pages)]
