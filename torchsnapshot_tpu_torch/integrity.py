"""Blob-level integrity: CRC32-C checksums recorded at write time and
verified on read.

This subsystem has no counterpart in the reference (its durability story
ends at the atomic commit marker, snapshot.py:230-237); it exists here
because the native I/O runtime already computes CRC32-C at memory speed
with the GIL released (native/ts_io.cpp), so end-to-end bit-rot detection
costs a small fraction of storage bandwidth.

Layout: each rank writes a ``checksums/{rank}`` JSON table after all its
storage writes are durable and *before* the commit barrier — a committed
snapshot therefore always has complete tables. Keys are storage paths
(globally unique per blob); values are ``[alg, crc, nbytes]`` or, for
blobs larger than one page, ``[alg, crc, nbytes, page_size, [page
crcs...]]``. Readers merge every rank's table (shards/replicated blobs
may be read by any rank, see manifest.get_manifest_for_rank). Whole-blob
reads verify against the blob digest; *ranged* reads (memory-budgeted
chunked restores, batched slabs) verify every page their byte range
fully covers — a range only loses coverage of its up-to-two partial edge
pages, so "checksums on" is never hollow for large-blob restores.

Algorithms: ``crc32c`` via the native lib; if it is unavailable the
writer falls back to zlib's ``crc32`` and tags the table accordingly, so
a reader verifies with whichever algorithm the writer used. Tables are
optional on read — snapshots written with checksums disabled (or by
older versions) restore without verification.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import zlib
from typing import Dict, Optional, Tuple

from . import _native, knobs
from .io_types import (
    BufferList,
    BufferType,
    ReadIO,
    StoragePlugin,
    WriteIO,
    as_bytes_view as _as_bytes_view,
)

logger: logging.Logger = logging.getLogger(__name__)

CHECKSUM_DIR = "checksums"

# Page granularity for ranged-read verification. 4 MiB: small enough that
# memory-budgeted chunk reads (typically >= tens of MiB) cover many full
# pages, large enough that per-page crc call overhead is noise.
PAGE_SIZE = 4 * 1024 * 1024

# path -> (alg, crc, nbytes) | (alg, crc, nbytes, page_size, [page crcs])
ChecksumTable = Dict[str, Tuple]


def table_path(rank: int) -> str:
    return f"{CHECKSUM_DIR}/{rank}"


def _pick_alg() -> str:
    return "crc32c" if _native.crc32c(b"") is not None else "crc32"


# Reflected polynomials for CRC combination (zlib crc32_combine algorithm).
_POLY = {"crc32c": 0x82F63B78, "crc32": 0xEDB88320}


def _gf2_times(mat, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat):
    return [_gf2_times(mat, mat[i]) for i in range(32)]


@functools.lru_cache(maxsize=64)
def _crc_shift_operator(length: int, alg: str):
    """GF(2) operator advancing a CRC over ``length`` zero bytes — the
    zlib crc32_combine construction, parametrized by polynomial. Applying
    it to crc(a) and XORing crc(b) yields crc(a ‖ b) for len(b)=length.
    Cached: the construction is ~22 pure-Python matrix squarings and the
    write path needs it once per (length, alg), not once per blob."""
    poly = _POLY[alg]
    # operator for one zero BIT
    odd = [poly] + [1 << (i - 1) for i in range(1, 32)]
    even = _gf2_square(odd)   # two bits
    odd = _gf2_square(even)   # four bits
    # Walk ``length`` in BYTES (zlib crc32_combine): the first squaring
    # below yields the 8-bit (one-byte) operator, matching bit 0 of the
    # byte count; each further squaring doubles the byte weight.
    op = None
    mat = odd
    n = length
    while n:
        mat = _gf2_square(mat)
        if n & 1:
            op = mat if op is None else [_gf2_times(mat, op[i]) for i in range(32)]
        n >>= 1
    if op is None:  # length 0
        op = [1 << i for i in range(32)]
    return op


def crc_combine(crc1: int, crc2: int, len2: int, alg: str, _op=None) -> int:
    """crc(a ‖ b) from crc(a)=crc1, crc(b)=crc2, len(b)=len2."""
    op = _op if _op is not None else _crc_shift_operator(len2, alg)
    return _gf2_times(op, crc1) ^ crc2


def _crc_of(mv: memoryview, alg: str, seed: int = 0) -> int:
    """Running digest: ``seed`` is the digest of the preceding bytes, so
    page digests chain into the whole-blob digest (both the native
    CRC32-C and zlib CRC32 support continuation)."""
    if alg == "crc32c":
        crc = _native.crc32c(mv, seed=seed)
        assert crc is not None  # caller picked the alg from availability
        return crc
    return zlib.crc32(mv, seed) & 0xFFFFFFFF


def compute_checksum(buf: BufferType) -> Tuple[str, int]:
    """Digest of ``buf``: native CRC32-C when available (GIL-free, fast),
    else zlib CRC32. Returns ``(alg, value)``."""
    alg = _pick_alg()
    return (alg, _crc_of(_as_bytes_view(buf), alg))


def compute_checksum_entry(buf) -> Tuple:
    """Full table entry for one staged blob. Single-page blobs get the
    whole-blob digest; larger blobs additionally get per-page digests for
    ranged-read verification. The whole-blob digest is folded from the
    page digests with GF(2) shift operators (the zlib crc32_combine
    construction) — O(1) per page, so each byte is CRC'd exactly once.
    Accepts a :class:`BufferList` (the zero-pack vectorized payload):
    page digests then chain across part boundaries, yielding the exact
    entry the consolidated bytes would — bit-identical tables on both
    write paths, without consolidating."""
    if isinstance(buf, BufferList):
        return _entry_from_parts(buf.parts, buf.nbytes)
    mv = _as_bytes_view(buf)
    nbytes = mv.nbytes
    alg = _pick_alg()
    if nbytes <= PAGE_SIZE:
        return (alg, _crc_of(mv, alg), nbytes)
    pages: list = [
        _crc_of(mv[off : off + PAGE_SIZE], alg)
        for off in range(0, nbytes, PAGE_SIZE)
    ]
    return entry_from_page_crcs(pages, nbytes, alg)


def _entry_from_parts(parts, nbytes: int) -> Tuple:
    """Table entry for a logically-concatenated multi-part blob: per-page
    digests over the concatenated stream (both CRC implementations
    support continuation, so a page straddling parts chains its running
    digest through the seed), folded exactly like the contiguous path."""
    alg = _pick_alg()
    pages: list = []
    cur = 0
    cur_len = 0
    for mv in parts:
        off = 0
        while off < mv.nbytes:
            take = min(PAGE_SIZE - cur_len, mv.nbytes - off)
            cur = _crc_of(mv[off : off + take], alg, seed=cur)
            cur_len += take
            off += take
            if cur_len == PAGE_SIZE:
                pages.append(cur)
                cur, cur_len = 0, 0
    if cur_len:
        pages.append(cur)
    if nbytes <= PAGE_SIZE:
        return (alg, pages[0] if pages else _crc_of(memoryview(b""), alg), nbytes)
    return entry_from_page_crcs(pages, nbytes, alg)


def entry_from_page_crcs(pages: list, nbytes: int, alg: str = "crc32c") -> Tuple:
    """Table entry from per-page digests (the shared tail of both the
    two-step path, :func:`compute_checksum_entry`, and the fused native
    write+CRC path): the whole-blob digest is folded from the page
    digests in O(1) per page (GF(2) shift operators) — each byte is
    CRC'd exactly once, wherever the pages came from."""
    if nbytes <= PAGE_SIZE:
        return (alg, pages[0] if pages else _crc_of(memoryview(b""), alg), nbytes)
    assert len(pages) == (nbytes + PAGE_SIZE - 1) // PAGE_SIZE
    full_op = _crc_shift_operator(PAGE_SIZE, alg)
    tail = nbytes - (len(pages) - 1) * PAGE_SIZE
    tail_op = full_op if tail == PAGE_SIZE else _crc_shift_operator(tail, alg)
    whole = pages[0]
    for i, page_crc in enumerate(pages[1:], start=1):
        op = tail_op if i == len(pages) - 1 else full_op
        whole = crc_combine(whole, page_crc, 0, alg, _op=op)
    return (alg, whole, nbytes, PAGE_SIZE, pages)


def _alg_available(alg: str) -> bool:
    if alg == "crc32c":
        return _native.crc32c(b"") is not None
    return alg == "crc32"


def verify_checksum(buf: BufferType, expected: Tuple, path: str) -> None:
    """Raise :class:`ChecksumError` when ``buf`` does not match the
    recorded digest. Paged entries carry a real whole-blob digest (folded
    from the page digests) and verify through the normal whole-CRC path;
    only interim-format tables whose whole-blob field is None fall back
    to page-by-page verification. Algorithm mismatches (table written
    with crc32c but the native lib is unavailable here, or vice versa)
    are skipped — a missing implementation must not fail restores."""
    alg, crc, nbytes = expected[0], expected[1], expected[2]
    mv = _as_bytes_view(buf)
    if mv.nbytes != nbytes:
        raise ChecksumError(
            f"{path}: size mismatch (expected {nbytes} bytes, read {mv.nbytes})"
        )
    if not _alg_available(alg):
        return  # unknown algorithm / native lib unavailable on this host
    if crc is None and len(expected) >= 5:
        # Interim paged format carried no whole-blob digest: verify
        # page-by-page (covers every byte plus the size check above).
        verify_range_checksum(mv, expected, (0, nbytes), path)
        return
    actual = _crc_of(mv, alg)
    if actual != crc:
        raise ChecksumError(
            f"{path}: {alg} mismatch (expected {crc:#010x}, got {actual:#010x})"
        )


def verify_page_crcs(
    pages: list, nbytes: int, expected: Tuple, path: str
) -> bool:
    """Verify a whole blob from per-page digests computed during its read
    (the fused native read+CRC path) — no second pass over the bytes.
    Pure GF(2) arithmetic: O(pages), independent of blob size.

    Returns True when verification ran (raising :class:`ChecksumError`
    on mismatch); False when the entry cannot be checked from these
    pages (non-crc32c table, or an interim-format entry recorded with a
    different page size) — the caller then verifies the buffer itself."""
    alg, crc, exp_nbytes = expected[0], expected[1], expected[2]
    if nbytes != exp_nbytes:
        raise ChecksumError(
            f"{path}: size mismatch (expected {exp_nbytes} bytes, "
            f"read {nbytes})"
        )
    if alg != "crc32c":
        return False  # pages are crc32c; a foreign-alg table needs the bytes
    if crc is None:
        # Interim paged format (no whole digest): page lists compare only
        # at matching granularity.
        if len(expected) >= 5 and expected[3] == PAGE_SIZE:
            if list(expected[4]) != list(pages):
                raise ChecksumError(f"{path}: crc32c page digests mismatch")
            return True
        return False
    folded = entry_from_page_crcs(pages, nbytes, alg)
    if folded[1] != crc:
        raise ChecksumError(
            f"{path}: {alg} mismatch (expected {crc:#010x}, "
            f"got {folded[1]:#010x})"
        )
    return True


def verify_range_checksum(
    buf: BufferType, expected: Tuple, byte_range: Tuple[int, int], path: str
) -> bool:
    """Verify a ranged read of ``path`` covering blob bytes
    ``[byte_range[0], byte_range[1])`` against the entry's per-page
    digests: a short read raises (a truncated blob must fail loudly here,
    not as an opaque consumer error), every fully-covered page is
    checked, and up-to-two partial edge pages are skipped. Returns True
    when at least one page was verified (False = entry has no pages or
    the range covers none fully)."""
    start, end = byte_range
    mv = _as_bytes_view(buf)
    # Size check first: a truncated ranged read of a *non-paged* entry
    # (len(expected) < 5) must still fail loudly here.
    if mv.nbytes != end - start:
        raise ChecksumError(
            f"{path}: ranged read [{start}, {end}) returned {mv.nbytes} "
            f"bytes (expected {end - start})"
        )
    if len(expected) < 5:
        return False
    alg, _, nbytes, page_size, pages = expected[:5]
    if not _alg_available(alg):
        return False
    first_page = (start + page_size - 1) // page_size  # first fully-covered
    verified = False
    for page in range(first_page, len(pages)):
        p0 = page * page_size
        p1 = min(p0 + page_size, nbytes)
        if p1 > end:
            break
        actual = _crc_of(mv[p0 - start : p1 - start], alg)
        if actual != pages[page]:
            raise ChecksumError(
                f"{path}: {alg} mismatch in page {page} "
                f"(blob bytes [{p0}, {p1})): expected "
                f"{pages[page]:#010x}, got {actual:#010x}"
            )
        verified = True
    return verified


class ChecksumError(RuntimeError):
    """A blob's bytes do not match the digest recorded at write time."""


async def write_checksum_table(
    checksums: ChecksumTable, rank: int, storage: StoragePlugin
) -> None:
    payload = json.dumps(
        {path: list(entry) for path, entry in sorted(checksums.items())}
    ).encode()
    await storage.write(WriteIO(path=table_path(rank), buf=payload))


def sync_write_checksum_table(
    checksums: ChecksumTable,
    rank: int,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> None:
    event_loop.run_until_complete(write_checksum_table(checksums, rank, storage))


def load_checksum_tables(
    world_size: int,
    storage: StoragePlugin,
    event_loop: asyncio.AbstractEventLoop,
) -> Optional[ChecksumTable]:
    """Merge every rank's table; ``None`` when the snapshot has no tables
    (written with checksums disabled, or predates them)."""

    async def _load_one(rank: int) -> Optional[ChecksumTable]:
        read_io = ReadIO(path=table_path(rank))
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            return None  # table never written (checksums disabled / old snapshot)
        except Exception as e:
            # Integrity must not silently turn off exactly when storage is
            # unhealthy: make degraded verification visible.
            logger.warning(
                "Could not read checksum table %s (%r); blobs it covers "
                "will restore UNVERIFIED",
                table_path(rank),
                e,
            )
            return None
        if read_io.buf is None:
            return None
        try:
            raw = json.loads(bytes(read_io.buf).decode())
        except (ValueError, UnicodeDecodeError) as e:
            logger.warning(
                "Checksum table %s is unparseable (%r); blobs it covers "
                "will restore UNVERIFIED",
                table_path(rank),
                e,
            )
            return None
        return {path: tuple(e) for path, e in raw.items()}

    async def _load_all() -> Optional[ChecksumTable]:
        # Bounded like every other storage op: world_size unbounded GETs per
        # reading rank is O(world^2) simultaneous requests fleet-wide at the
        # barrier-synchronized start of a restore — enough to trip cloud
        # throttling precisely when verification is wanted.
        slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())

        async def _bounded(rank: int) -> Optional[ChecksumTable]:
            async with slots:
                return await _load_one(rank)

        tables = await asyncio.gather(*(_bounded(r) for r in range(world_size)))
        if all(t is None for t in tables):
            return None
        merged: ChecksumTable = {}
        for t in tables:
            if t:
                merged.update(t)
        return merged

    return event_loop.run_until_complete(_load_all())
