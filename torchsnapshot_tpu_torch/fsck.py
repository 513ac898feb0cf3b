"""Snapshot fsck: verify a committed snapshot's blobs without restoring.

Counterpart of ``torchsnapshot_tpu/fsck.py``. Fleets audit checkpoints
before pointing an expensive job at them. Two levels:

- **shallow** (default): the manifest parses; every entry's blob exists
  and holds at least the bytes the entry claims (one ranged read of the
  final byte per blob, no data transfer). Chunked entries are checked
  chunk by chunk.
- **deep** (``--deep``): additionally reads every blob fully and verifies
  its recorded CRC (the integrity.py tables, including entries inherited
  from incremental bases).

Incremental snapshots are first-class: parent-relative (``../step_X``)
locations resolve through the storage plugin like any restore would, so
a broken chain (a GC'd base, a missing origin blob) is caught here
instead of at restore time.

CLI::

    python -m torchsnapshot_tpu_torch.fsck /path/to/snapshot [--deep]

exits 0 when the snapshot is sound, 1 otherwise, printing one line per
problem.

Not ported yet: the per-tier and peer-placement audits (``--tier``) and
the chunk-store audit and repair (``--cas``, ``--repair``), which come
with ROADMAP queue 1 step 9; the telemetry summary (``--stats``) comes
with step 10.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from . import knobs
from .integrity import _alg_available, _as_bytes_view, _crc_of, load_checksum_tables
from .io_types import ReadIO, StoragePlugin
from .manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    is_container_entry,
)
from .serialization import array_size_bytes
from .snapshot import SNAPSHOT_METADATA_FNAME
from .storage_plugin import url_to_storage_plugin

logger: logging.Logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FsckProblem:
    location: str
    kind: str  # missing | truncated | checksum | unreadable | unmirrored
    detail: str


@dataclasses.dataclass
class FsckReport:
    path: str
    blobs_checked: int
    bytes_verified: int
    problems: List[FsckProblem]
    deep: bool
    # Number of blobs whose content was actually CRC-verified in a deep
    # audit. 0 with deep=True means the audit was length-only (snapshot
    # written with checksums off, or verification disabled locally) —
    # surfaced so "deep OK" can never silently be hollow.
    crcs_verified: int = 0

    @property
    def ok(self) -> bool:
        return not self.problems


def blob_requirements(manifest: Dict[str, Entry]) -> Dict[str, int]:
    """location -> minimum byte length the manifest implies. Batched slab
    members share a location; the requirement is the max end offset any
    member claims. Shared by the audit below and the manager's ledger
    accounting (per-step new vs. base-referenced bytes)."""
    need: Dict[str, int] = {}

    def add_array(ae: ArrayEntry) -> None:
        nbytes = array_size_bytes(ae.shape, ae.dtype)
        end = ae.byte_range_tuple[1] if ae.byte_range_tuple else nbytes
        need[ae.location] = max(need.get(ae.location, 0), end)

    for entry in manifest.values():
        if is_container_entry(entry):
            continue
        if isinstance(entry, ArrayEntry):
            add_array(entry)
        elif isinstance(entry, (ChunkedArrayEntry, ShardedArrayEntry)):
            shards = (
                entry.chunks
                if isinstance(entry, ChunkedArrayEntry)
                else entry.shards
            )
            for shard in shards:
                add_array(shard.array)
        elif isinstance(entry, ObjectEntry):
            # Pickled blobs carry no size in the manifest; existence (>= 1
            # byte) is the shallow requirement.
            need.setdefault(entry.location, 1)
    return need


# Streaming chunk for deep audits: bounds the audit host's memory at
# ~(io concurrency × 16 MiB) regardless of blob size (batched slabs can
# be GBs; the tool must never OOM the host it exists to protect).
_DEEP_CHUNK_BYTES = 16 * 1024 * 1024


async def _shallow_check(
    storage: StoragePlugin,
    location: str,
    min_bytes: int,
    problems: List[FsckProblem],
) -> int:
    """Existence + length via one ranged read of the final required byte
    (object-store HEAD-equivalent; no data transfer)."""
    start = max(0, min_bytes - 1)
    want = min_bytes - start
    read_io = ReadIO(path=location, byte_range=(start, min_bytes))
    try:
        await storage.read(read_io)
    except FileNotFoundError:
        problems.append(FsckProblem(location, "missing", "blob not found"))
        return 0
    except OSError as e:
        # Plugins fail short ranged reads with plain OSError (the native
        # path uses EIO): the blob exists but lacks the byte.
        problems.append(
            FsckProblem(
                location,
                "truncated",
                f"cannot read byte {min_bytes - 1} ({e!r})",
            )
        )
        return 0
    except Exception as e:  # noqa: BLE001 - transient/storage errors are
        # NOT corruption; misreporting them as such would make fleets
        # discard sound checkpoints on a retryable 503.
        problems.append(FsckProblem(location, "unreadable", repr(e)))
        return 0
    got = memoryview(read_io.buf).nbytes
    if got < want:
        # Plugins without short-read errors (e.g. the in-memory store
        # slices past EOF silently) surface truncation here instead.
        problems.append(
            FsckProblem(
                location,
                "truncated",
                f"byte {min_bytes - 1} absent ({got} of {want} bytes read)",
            )
        )
        return 0
    return got


async def _deep_check(
    storage: StoragePlugin,
    location: str,
    min_bytes: int,
    expected: Optional[Tuple],
    problems: List[FsckProblem],
) -> Tuple[int, bool]:
    """Stream the blob in bounded chunks, chaining the CRC across them
    (both crc32c and crc32 support continuation). Returns (bytes read,
    crc verified?)."""
    if expected is None or not _alg_available(expected[0]):
        return await _shallow_check(storage, location, min_bytes, problems), False

    alg, want_crc, nbytes = expected[0], expected[1], expected[2]
    crc = 0
    pos = 0
    while pos < nbytes:
        end = min(pos + _DEEP_CHUNK_BYTES, nbytes)
        read_io = ReadIO(path=location, byte_range=(pos, end))
        try:
            await storage.read(read_io)
        except FileNotFoundError:
            problems.append(
                FsckProblem(location, "missing", "blob not found")
            )
            return pos, False
        except OSError as e:
            problems.append(
                FsckProblem(
                    location,
                    "truncated",
                    f"{nbytes} bytes recorded, read fails at {pos} ({e!r})",
                )
            )
            return pos, False
        except Exception as e:  # noqa: BLE001
            problems.append(FsckProblem(location, "unreadable", repr(e)))
            return pos, False
        mv = _as_bytes_view(read_io.buf)
        if mv.nbytes != end - pos:
            problems.append(
                FsckProblem(
                    location,
                    "truncated",
                    f"ranged read [{pos}, {end}) returned {mv.nbytes} bytes",
                )
            )
            return pos, False
        crc = _crc_of(mv, alg, seed=crc)
        pos = end
    if want_crc is not None and crc != want_crc:
        problems.append(
            FsckProblem(
                location,
                "checksum",
                f"{alg} mismatch (expected {want_crc:#010x}, "
                f"got {crc:#010x})",
            )
        )
        return nbytes, False
    if nbytes < min_bytes:
        problems.append(
            FsckProblem(
                location,
                "truncated",
                f"{nbytes} bytes recorded, manifest needs >= {min_bytes}",
            )
        )
    return nbytes, True


async def _check_blob(
    storage: StoragePlugin,
    location: str,
    min_bytes: int,
    deep: bool,
    checksum_table,
    problems: List[FsckProblem],
    slots: asyncio.Semaphore,
) -> Tuple[int, bool]:
    async with slots:
        if deep:
            expected = (
                checksum_table.get(location) if checksum_table else None
            )
            return await _deep_check(
                storage, location, min_bytes, expected, problems
            )
        return (
            await _shallow_check(storage, location, min_bytes, problems),
            False,
        )


def verify_snapshot(path: str, deep: bool = False, tier: Optional[str] = None) -> FsckReport:
    """Audit one committed snapshot. Never raises for snapshot damage:
    every problem lands in the report (a path that is not a snapshot at
    all yields a report with the metadata problem recorded).

    ``tier`` selects a tier of a ``tiered://`` path or the peer-RAM
    placement journal; neither is ported yet (ROADMAP queue 1 step 9), so
    any value but None raises."""
    if tier is not None:
        raise NotImplementedError(
            f"fsck tier={tier!r}: the tiered and peer audits are not ported to "
            "torchsnapshot_tpu_torch yet (ROADMAP queue 1 step 9)"
        )
    problems: List[FsckProblem] = []
    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(path)
        try:
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            try:
                event_loop.run_until_complete(storage.read(read_io))
                metadata = SnapshotMetadata.from_yaml(
                    bytes(read_io.buf).decode("utf-8")
                )
            except FileNotFoundError:
                problems.append(
                    FsckProblem(
                        SNAPSHOT_METADATA_FNAME,
                        "missing",
                        "no commit marker: not a committed snapshot",
                    )
                )
                return FsckReport(path, 0, 0, problems, deep)
            except Exception as e:  # noqa: BLE001
                problems.append(
                    FsckProblem(SNAPSHOT_METADATA_FNAME, "unreadable", repr(e))
                )
                return FsckReport(path, 0, 0, problems, deep)

            checksum_table = None
            if deep and not knobs.is_checksums_disabled():
                checksum_table = load_checksum_tables(
                    metadata.world_size, storage, event_loop
                )

            need = blob_requirements(metadata.manifest)
            slots = asyncio.Semaphore(knobs.get_per_rank_io_concurrency())

            async def _run() -> List[Tuple[int, bool]]:
                return await asyncio.gather(
                    *(
                        _check_blob(
                            storage,
                            loc,
                            n,
                            deep,
                            checksum_table,
                            problems,
                            slots,
                        )
                        for loc, n in sorted(need.items())
                    )
                )

            results = event_loop.run_until_complete(_run())
            return FsckReport(
                path=path,
                blobs_checked=len(need),
                bytes_verified=(
                    sum(nb for nb, crc_ok in results if crc_ok)
                    if deep
                    else 0
                ),
                problems=problems,
                deep=deep,
                crcs_verified=sum(1 for _, crc_ok in results if crc_ok),
            )
        finally:
            event_loop.run_until_complete(storage.close())
    finally:
        event_loop.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="torchsnapshot_tpu_torch.fsck",
        description="Verify a committed snapshot's blobs without restoring.",
    )
    p.add_argument("path", help="snapshot location (path or storage URL)")
    p.add_argument(
        "--deep",
        action="store_true",
        help="read every blob fully and verify recorded CRCs",
    )
    args = p.parse_args(argv)
    report = verify_snapshot(args.path, deep=args.deep)
    for prob in report.problems:
        print(f"FSCK {prob.kind}: {prob.location}: {prob.detail}")
    mode = "deep" if report.deep else "shallow"
    if report.deep and report.crcs_verified == 0 and report.blobs_checked:
        print(
            "WARNING: 0 blobs CRC-verified (snapshot has no checksum "
            "tables, or checksums are disabled locally) — this deep "
            "audit checked existence and length only"
        )
    if report.ok:
        extra = (
            f", {report.crcs_verified} CRC-verified "
            f"({report.bytes_verified / 1e6:.1f} MB)"
            if report.deep
            else ""
        )
        print(f"OK ({mode}): {report.blobs_checked} blobs checked{extra}")
        return 0
    print(
        f"FAILED ({mode}): {len(report.problems)} problem(s) across "
        f"{report.blobs_checked} blobs"
    )
    return 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
