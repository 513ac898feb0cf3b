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

Incremental snapshots and chunk-store snapshots are first-class:
parent-relative locations (``../step_X/...``, ``../chunks/<key>``)
resolve through the storage plugin like any restore would, and their
checksum entries sit in the tables under those locations, so a broken
chain (a GC'd base, a missing chunk) is caught here instead of at
restore time.

``--tier fast|durable`` audits one tier of a ``tiered://`` path (the
default is the composed view, each blob read fast first with the
durable fallback, as a restore reads it); the durable tier of a step
whose mirror has not finished reports an ``unmirrored`` problem with the
journal's progress.

``--cas`` treats the path as a manager root and audits its chunk store
(:func:`verify_cas_store`): every chunk a committed or pinned step names
exists, in every tier that holds it, with the length its key claims
(``--deep``: bytes matching the key's CRC, per tier copy), and
unreferenced chunks are listed without failing the audit. ``--repair``
first rebuilds damaged copies from a tier whose copy verifies
(:func:`repair_cas_store`, :func:`repair_snapshot`); a chunk that no tier
holds intact is moved to ``chunks/.quarantine/``, where its refs dangle
loudly.

CLI::

    python -m torchsnapshot_tpu_torch.fsck PATH [--deep] [--cas] [--repair] [--tier fast|durable|peer]

exits 0 when the snapshot (or the store) is sound, 1 otherwise, printing
one line per problem.

``--tier peer`` (any path) audits the peer tier's placement docs
instead of storage bytes: every required blob with no recorded peer copy,
and every push that recorded a degradation, is a problem.

A repair that acted posts ``repair-performed`` to the root's run ledger
(where a manager opened one), and the printed report of a path whose root
has a run ledger ends with the ledger's summary: event counts, runs and
segments, interrupted segments and their lost work.

Not ported yet, and refused: the telemetry summary (``--stats``, ROADMAP
step 10d).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
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
from .io_types import WriteIO
from .snapshot import SNAPSHOT_METADATA_FNAME
from .storage_plugin import split_tiered_url, url_to_storage_plugin

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


def _describe_partial_mirror(tiered_path: str, event_loop: asyncio.AbstractEventLoop) -> Optional[str]:
    """For a tiered snapshot whose durable tier lacks the commit marker:
    the mirror's progress from the fast tier's journal, or None when there
    is no journal (nothing committed, or the mirror never started)."""
    tiers = split_tiered_url(tiered_path)
    if tiers is None:
        return None
    from .tiered.journal import MirrorJournal

    fast = url_to_storage_plugin(tiers[0])
    try:
        journal = event_loop.run_until_complete(MirrorJournal.load(fast))
    finally:
        event_loop.run_until_complete(fast.close())
    if journal is None:
        return None
    return (
        f"mirror in progress: {len(journal.done)} of {len(journal.blobs)} blobs "
        f"durable (journal in the fast tier resumes the upload)"
    )


def _verify_peer_placement(path: str) -> FsckReport:
    """``fsck --tier peer``: audit the peer tier's placement docs. For each
    rank of the snapshot's metadata, load ``.peer_placement-rank<r>.json``
    (written by that rank's push job, on the fast tier of a tiered path)
    and union the blobs it claims; every required data blob with no
    claim (base-referenced locations excluded: they belong to another
    step's placement; chunk refs included: they are this step's payload),
    and every doc that records a degraded push, lands in the report."""
    import json

    from .cas import is_chunk_location
    from .tiered.peer import placement_doc_path

    problems: List[FsckProblem] = []
    event_loop = asyncio.new_event_loop()
    tiers = split_tiered_url(path)
    storage = url_to_storage_plugin(path)
    # Placement docs live on the fast tier only, like the mirror journal.
    placement_storage = url_to_storage_plugin(tiers[0]) if tiers is not None else storage
    try:
        read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
        try:
            event_loop.run_until_complete(storage.read(read_io))
            metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode("utf-8"))
        except FileNotFoundError:
            problems.append(
                FsckProblem(SNAPSHOT_METADATA_FNAME, "missing", "no commit marker: not a committed snapshot")
            )
            return FsckReport(path, 0, 0, problems, False)
        except Exception as e:  # noqa: BLE001
            problems.append(FsckProblem(SNAPSHOT_METADATA_FNAME, "unreadable", repr(e)))
            return FsckReport(path, 0, 0, problems, False)
        placed = set()
        docs = 0
        for rank in range(metadata.world_size):
            doc_path = placement_doc_path(rank)
            doc_io = ReadIO(path=doc_path)
            try:
                event_loop.run_until_complete(placement_storage.read(doc_io))
                doc = json.loads(bytes(doc_io.buf))
            except FileNotFoundError:
                continue
            except Exception as e:  # noqa: BLE001
                problems.append(FsckProblem(doc_path, "unreadable", repr(e)))
                continue
            docs += 1
            placed.update(str(blob) for blob in doc.get("blobs", []))
            if doc.get("error") or doc.get("blobs_failed") or doc.get("blobs_refused"):
                problems.append(
                    FsckProblem(
                        doc_path,
                        "unmirrored",
                        f"degraded push: {doc.get('blobs_failed', 0)} failed, "
                        f"{doc.get('blobs_refused', 0)} refused ({doc.get('error')})",
                    )
                )
        required = {
            loc for loc in blob_requirements(metadata.manifest)
            if not loc.startswith("../") or is_chunk_location(loc)
        }
        if docs == 0:
            problems.append(
                FsckProblem(
                    placement_doc_path(0),
                    "missing",
                    "no peer placement recorded: the peer tier never pushed this step "
                    "(tier off, single-process world, or every push failed)",
                )
            )
        else:
            for loc in sorted(required - placed):
                problems.append(
                    FsckProblem(loc, "missing", "no peer copy recorded: a preemption now restores this blob from storage")
                )
        return FsckReport(path=path, blobs_checked=len(required), bytes_verified=0, problems=problems, deep=False)
    finally:
        event_loop.run_until_complete(storage.close())
        if placement_storage is not storage:
            event_loop.run_until_complete(placement_storage.close())
        event_loop.close()


def verify_snapshot(path: str, deep: bool = False, tier: Optional[str] = None) -> FsckReport:
    """Audit one committed snapshot. Never raises for snapshot damage:
    every problem lands in the report (a path that is not a snapshot at
    all yields a report with the metadata problem recorded).

    ``tier`` (``tiered://`` paths only) restricts the audit to one tier,
    ``"fast"`` or ``"durable"``; the default audits the composed view.
    The durable tier of a step whose mirror has not finished reports an
    ``unmirrored`` problem with the journal's progress instead of a bare
    missing commit marker. ``"peer"`` (any path) audits the peer tier's
    placement docs instead of storage bytes (:func:`_verify_peer_placement`):
    the offline view of what a preemption now could recover at RAM
    speed."""
    audit_path = path
    if tier == "peer":
        return _verify_peer_placement(path)
    if tier is not None:
        tiers = split_tiered_url(path)
        if tiers is None:
            raise ValueError(f"tier={tier!r} requires a tiered:// path, got {path!r}")
        if tier not in ("fast", "durable"):
            raise ValueError(f"tier must be 'fast', 'durable' or 'peer', got {tier!r}")
        audit_path = tiers[0] if tier == "fast" else tiers[1]
    problems: List[FsckProblem] = []
    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(audit_path)
        try:
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            try:
                event_loop.run_until_complete(storage.read(read_io))
                metadata = SnapshotMetadata.from_yaml(
                    bytes(read_io.buf).decode("utf-8")
                )
            except FileNotFoundError:
                partial = _describe_partial_mirror(path, event_loop) if tier == "durable" else None
                if partial is not None:
                    problems.append(FsckProblem(SNAPSHOT_METADATA_FNAME, "unmirrored", partial))
                else:
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


@dataclasses.dataclass
class CasStoreReport:
    """Audit of a manager root's chunk store: every referenced chunk
    exists with the byte length its key claims (with ``deep``, bytes that
    match the key), no committed manifest's ref dangles, and unreferenced
    chunks are listed (never a failure: strays of crashed takes, or dead
    chunks inside the GC grace window)."""

    root: str
    steps: List[int]
    chunks_present: int
    stored_bytes: int
    chunks_referenced: int
    logical_bytes: int  # retention-visible bytes across all steps
    problems: List[FsckProblem]
    unreferenced: Dict[str, int]
    deep: bool
    crcs_verified: int = 0

    @property
    def ok(self) -> bool:
        return not self.problems

    @property
    def dedup_ratio(self) -> float:
        """Logical bytes per stored byte: 1.0 means no sharing; N retained
        steps of an unchanged state approach N."""
        return self.logical_bytes / self.stored_bytes if self.stored_bytes else 0.0

    @property
    def bytes_per_retained_step(self) -> float:
        return self.stored_bytes / len(self.steps) if self.steps else 0.0


@dataclasses.dataclass
class RepairReport:
    """What ``fsck --repair`` did: ``rewritten`` maps a damaged copy to
    the tier (directory or name) whose verifying copy replaced it;
    ``quarantined`` lists the chunks no tier holds intact, every copy
    moved to ``chunks/.quarantine/`` so that a later restore fails loudly
    instead of serving rot; ``unrepairable`` lists the damage with no copy
    to rebuild from."""

    target: str
    rewritten: Dict[str, str] = dataclasses.field(default_factory=dict)
    quarantined: List[str] = dataclasses.field(default_factory=list)
    unrepairable: List[FsckProblem] = dataclasses.field(default_factory=list)
    checked: int = 0

    @property
    def acted(self) -> bool:
        return bool(self.rewritten or self.quarantined)


QUARANTINE_DIRNAME = ".quarantine"


def _present_chunks(root: str) -> Dict[str, Dict[str, int]]:
    """The chunk files of the root's store in every local tier (fast and
    durable for a ``tiered://`` root of local directories): ``key ->
    {chunk directory: size}``. Sizes stay per copy, so that a torn copy
    on one tier is a finding even when the other tier holds the bytes."""
    from .cas import CASStore, local_chunks_dir

    tiers = split_tiered_url(root)
    present: Dict[str, Dict[str, int]] = {}
    for url in tiers if tiers is not None else (root,):
        chunk_dir = local_chunks_dir(url)
        if chunk_dir is None:
            continue
        for key, size in CASStore(url).list_chunks().items():
            present.setdefault(key, {})[chunk_dir] = size
    return present


def _root_chunk_refs(root: str, on_error) -> Tuple[List[int], Dict[str, int], int]:
    """``(steps, key -> nbytes, logical bytes)`` over the root's committed
    and pinned steps' manifests; index and manifest damage goes to
    ``on_error(FsckProblem)``."""
    from . import manager as manager_mod
    from .cas import chunk_refs

    steps: List[int] = []
    referenced: Dict[str, int] = {}
    logical_bytes = 0
    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(root)
        try:
            try:
                index = event_loop.run_until_complete(manager_mod.read_index_full_async(storage))
                steps = sorted(set(index["steps"]) | set(index["pinned"]))
            except Exception as e:  # noqa: BLE001 - index damage is a finding
                on_error(FsckProblem(manager_mod.INDEX_BLOB, "unreadable", repr(e)))
            for step in steps:
                meta_path = f"{manager_mod._step_dirname(step)}/{SNAPSHOT_METADATA_FNAME}"
                read_io = ReadIO(path=meta_path)
                try:
                    event_loop.run_until_complete(storage.read(read_io))
                    metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode("utf-8"))
                except FileNotFoundError:
                    on_error(FsckProblem(meta_path, "missing", "indexed step has no commit marker"))
                    continue
                except Exception as e:  # noqa: BLE001
                    on_error(FsckProblem(meta_path, "unreadable", repr(e)))
                    continue
                refs = chunk_refs(metadata.manifest)
                logical_bytes += sum(refs.values())
                for key, nbytes in refs.items():
                    referenced[key] = max(referenced.get(key, 0), nbytes)
        finally:
            event_loop.run_until_complete(storage.close())
    finally:
        event_loop.close()
    return steps, referenced, logical_bytes


def _chunk_copy_ok(path: str, key: str) -> bool:
    """One chunk file against its self-describing key: size, and the
    whole-blob CRC streamed in bounded pieces."""
    from .cas import parse_key

    parsed = parse_key(key)
    if parsed is None:
        return False
    alg, want_n, want_crc = parsed
    try:
        if os.path.getsize(path) != want_n:
            return False
    except OSError:
        return False
    if not _alg_available(alg):
        return True  # the bytes cannot be judged here; the size is all
    crc = 0
    try:
        with open(path, "rb") as f:
            while True:
                block = f.read(_DEEP_CHUNK_BYTES)
                if not block:
                    break
                crc = _crc_of(memoryview(block), alg, seed=crc)
    except OSError:
        return False
    return crc == want_crc


def verify_cas_store(root: str, deep: bool = False) -> CasStoreReport:
    """Audit one manager root's chunk store against its committed and
    pinned steps' manifests, every tier's copy on its own (a good fast
    copy must not mask a damaged durable one). Never raises for store
    damage: every problem lands in the report."""
    from .cas import CHUNKS_DIRNAME, nbytes_of_key

    problems: List[FsckProblem] = []
    steps, referenced, logical_bytes = _root_chunk_refs(root, problems.append)
    present = _present_chunks(root)
    crcs_verified = 0
    for key in sorted(referenced):
        location = f"{CHUNKS_DIRNAME}/{key}"
        want = nbytes_of_key(key)
        if key not in present:
            problems.append(
                FsckProblem(
                    location, "missing",
                    "chunk referenced by a committed manifest is absent from the store (dangling ref)",
                )
            )
            continue
        torn = [(d, n) for d, n in sorted(present[key].items()) if want is not None and n != want]
        for chunk_dir, size in torn:
            problems.append(
                FsckProblem(
                    location, "truncated",
                    f"digest key claims {want} bytes, {size} stored in {chunk_dir} (torn chunk write)",
                )
            )
        if torn or not deep:
            continue
        bad = [d for d in sorted(present[key]) if not _chunk_copy_ok(os.path.join(d, key), key)]
        for chunk_dir in bad:
            problems.append(
                FsckProblem(
                    location, "checksum",
                    f"bytes do not match the digest key in {chunk_dir} "
                    "(fsck --repair rebuilds from a verifying tier)",
                )
            )
        if not bad:
            crcs_verified += 1
    return CasStoreReport(
        root=root,
        steps=steps,
        chunks_present=len(present),
        stored_bytes=sum(max(copies.values()) for copies in present.values()),
        chunks_referenced=len(referenced),
        logical_bytes=logical_bytes,
        problems=problems,
        unreferenced={
            k: max(copies.values()) for k, copies in sorted(present.items()) if k not in referenced
        },
        deep=deep,
        crcs_verified=crcs_verified,
    )


def repair_cas_store(root: str) -> RepairReport:
    """Cross-tier chunk repair: each tier's copy of every chunk a
    committed manifest references is verified against its key; a damaged
    copy is rewritten from a tier whose copy verifies, and a chunk with
    no verifying copy has every copy moved to ``chunks/.quarantine/<key>``:
    a dangling ref that a later restore fails on loudly, rather than
    corrupt bytes served."""
    report = RepairReport(target=root)
    _, referenced, _ = _root_chunk_refs(root, lambda problem: None)
    present = _present_chunks(root)
    for key in sorted(set(referenced) & set(present)):
        report.checked += 1
        status = {d: _chunk_copy_ok(os.path.join(d, key), key) for d in sorted(present[key])}
        good = [d for d, ok in status.items() if ok]
        bad = [d for d, ok in status.items() if not ok]
        if not bad:
            continue
        if good:
            with open(os.path.join(good[0], key), "rb") as f:
                data = f.read()
            for chunk_dir in bad:
                dst = os.path.join(chunk_dir, key)
                tmp = dst + ".repair-tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, dst)
                report.rewritten[f"{chunk_dir}/{key}"] = good[0]
            continue
        for chunk_dir in bad:
            os.makedirs(os.path.join(chunk_dir, QUARANTINE_DIRNAME), exist_ok=True)
            os.replace(os.path.join(chunk_dir, key), os.path.join(chunk_dir, QUARANTINE_DIRNAME, key))
        report.quarantined.append(key)
        report.unrepairable.append(
            FsckProblem(
                f"chunks/{key}", "checksum",
                "no tier holds a verifying copy; all copies quarantined (chunks/.quarantine/)",
            )
        )
    for key in sorted(set(referenced) - set(present)):
        report.unrepairable.append(
            FsckProblem(
                f"chunks/{key}", "missing",
                "referenced chunk absent from every tier (dangling ref); nothing to rebuild from",
            )
        )
    if report.acted:
        _post_repair_event(root, report)
    return report


def repair_snapshot(path: str) -> RepairReport:
    """Cross-tier repair of one committed snapshot's step-local blobs
    (``tiered://`` paths): every blob with a recorded digest is verified
    per tier, and a damaged copy is rewritten from the tier whose copy
    verifies. Parent-relative locations are skipped: incremental refs
    belong to their origin step, chunk refs to :func:`repair_cas_store`.
    A path of one tier has nothing to rebuild from, and its report is
    empty (a restore or a deep fsck still fails loudly on the damage)."""
    from .integrity import verify_checksum

    report = RepairReport(target=path)
    tiers = split_tiered_url(path)
    event_loop = asyncio.new_event_loop()
    try:
        storage = url_to_storage_plugin(path)
        try:
            read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
            try:
                event_loop.run_until_complete(storage.read(read_io))
                metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode("utf-8"))
            except Exception as e:  # noqa: BLE001
                report.unrepairable.append(FsckProblem(SNAPSHOT_METADATA_FNAME, "unreadable", repr(e)))
                return report
            table = load_checksum_tables(metadata.world_size, storage, event_loop)
        finally:
            event_loop.run_until_complete(storage.close())
        if tiers is None:
            return report  # one tier: nothing to rebuild from
        if not table:
            report.unrepairable.append(
                FsckProblem(
                    SNAPSHOT_METADATA_FNAME, "unreadable",
                    "no checksum tables: repair cannot judge which copy is sound",
                )
            )
            return report
        locations = sorted(
            loc for loc in blob_requirements(metadata.manifest) if not loc.startswith("../") and loc in table
        )
        tier_plugins = {name: url_to_storage_plugin(url) for name, url in zip(("fast", "durable"), tiers)}
        try:
            for loc in locations:
                report.checked += 1
                good: Optional[bytes] = None
                bad: List[str] = []
                for name, plugin in tier_plugins.items():
                    tier_io = ReadIO(path=loc)
                    try:
                        event_loop.run_until_complete(plugin.read(tier_io))
                        data: Optional[bytes] = bytes(tier_io.buf)
                    except FileNotFoundError:
                        continue  # absent here (evicted or not mirrored): fine
                    except Exception:  # noqa: BLE001
                        data = None
                    try:
                        if data is None:
                            raise ValueError("unreadable")
                        verify_checksum(data, table[loc], loc)
                        good = data if good is None else good
                    except Exception:  # noqa: BLE001 - damage
                        bad.append(name)
                if not bad:
                    continue
                if good is None:
                    report.unrepairable.append(
                        FsckProblem(loc, "checksum", f"no tier holds a verifying copy (damaged: {sorted(bad)})")
                    )
                    continue
                for name in bad:
                    event_loop.run_until_complete(tier_plugins[name].write(WriteIO(path=loc, buf=good)))
                    report.rewritten[f"{name}:{loc}"] = "cross-tier"
        finally:
            for plugin in tier_plugins.values():
                event_loop.run_until_complete(plugin.close())
    finally:
        event_loop.close()
    if report.acted:
        from .cas.store import root_url_of_snapshot

        try:
            _post_repair_event(root_url_of_snapshot(path), report)
        except ValueError:
            pass  # a path of no root shape has no ledger
    return report


def _post_repair_event(root: str, report: RepairReport) -> None:
    """Record the repair in the root's run ledger (only a root a manager
    opened a run for has one: no ledger is created here)."""
    try:
        from .telemetry import ledger as run_ledger
        from .telemetry import names as event_names

        run_ledger.post_event(
            root,
            event_names.EVENT_REPAIR_PERFORMED,
            target=report.target,
            rewritten=len(report.rewritten),
            quarantined=len(report.quarantined),
            unrepairable=len(report.unrepairable),
            locations=sorted(list(report.rewritten) + report.quarantined)[:20],
        )
    except Exception as e:  # noqa: BLE001 - repair must not fail on telemetry
        logger.warning("could not post repair-performed event: %r", e)


def _print_ledger(path: str) -> None:
    """The run ledger's summary, when ``path`` (a root or a step of one)
    has a ledger: the evidence of how the run's checkpoints went."""
    from .telemetry.ledger import describe, find_ledger_for, load_ledger

    try:
        ledger_file = find_ledger_for(path)
        records = load_ledger(ledger_file) if ledger_file else []
    except Exception:  # noqa: BLE001 - the summary is an aid, not the audit
        return
    if not records:
        return
    print(f"run ledger ({ledger_file}):")
    for line in describe(records):
        print(f"  {line}")
    print("  full attribution: python -m torchsnapshot_tpu_torch.telemetry.goodput <root>")


def _print_repair(report: RepairReport) -> None:
    for loc, src in sorted(report.rewritten.items()):
        print(f"FSCK repaired: {loc}: rewritten from {src}")
    for key in report.quarantined:
        print(f"FSCK quarantined: chunks/{key}: no tier verified; moved to chunks/{QUARANTINE_DIRNAME}/")
    for prob in report.unrepairable:
        print(f"FSCK unrepairable: {prob.location}: {prob.detail}")
    if not report.acted and not report.unrepairable:
        print(f"repair: nothing to do ({report.checked} location(s) sound)")


def _cas_main(root: str, deep: bool, repair: bool = False) -> int:
    if repair:
        _print_repair(repair_cas_store(root))
    report = verify_cas_store(root, deep=deep)
    for prob in report.problems:
        print(f"FSCK {prob.kind}: {prob.location}: {prob.detail}")
    mode = "deep" if report.deep else "shallow"
    print(
        f"chunk store: {report.chunks_present} chunk(s), {report.stored_bytes / 1e6:.1f} MB stored "
        f"across {len(report.steps)} retained step(s)"
    )
    print(
        f"  dedup ratio: {report.dedup_ratio:.2f}x ({report.logical_bytes / 1e6:.1f} MB "
        f"retention-visible per {report.stored_bytes / 1e6:.1f} MB stored); "
        f"{report.bytes_per_retained_step / 1e6:.2f} MB per retained step"
    )
    if report.unreferenced:
        print(
            f"  {len(report.unreferenced)} unreferenced chunk(s) "
            f"({sum(report.unreferenced.values()) / 1e6:.1f} MB): strays of crashed takes or dead "
            "chunks inside the GC grace window, reclaimed by the manager's next retention pass"
        )
    if report.deep:
        print(f"  {report.crcs_verified} chunk(s) CRC-verified")
    _print_ledger(root)
    if report.ok:
        print(f"OK ({mode}): {report.chunks_referenced} referenced chunk(s) checked")
        return 0
    print(
        f"FAILED ({mode}): {len(report.problems)} problem(s) across "
        f"{report.chunks_referenced} referenced chunk(s)"
    )
    return 1


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
    p.add_argument(
        "--cas",
        action="store_true",
        help="treat PATH as a manager root and audit its content-addressed chunk store",
    )
    p.add_argument(
        "--repair",
        action="store_true",
        help="before the audit, rebuild damaged copies from a tier whose copy verifies (with --cas: "
        "per-tier chunk repair, quarantining chunks with no verifying copy; without: the step-local "
        "blobs of a tiered:// snapshot)",
    )
    p.add_argument(
        "--tier",
        choices=("fast", "durable", "peer"),
        default=None,
        help="for tiered:// paths: audit only this tier (default: the composed view, each blob "
        "fast first with the durable fallback); 'peer' (any path) audits the peer tier's placement "
        "docs: which required blobs have a recorded peer copy",
    )
    p.add_argument("--stats", action="store_true", help="not ported yet (ROADMAP step 10d)")
    args = p.parse_args(argv)
    if args.stats:
        raise NotImplementedError(
            "fsck --stats (the telemetry summary) is not ported to torchsnapshot_tpu_torch yet "
            "(ROADMAP queue 1 step 10d)"
        )
    if args.cas:
        return _cas_main(args.path, deep=args.deep, repair=args.repair)
    if args.repair:
        _print_repair(repair_snapshot(args.path))
    report = verify_snapshot(args.path, deep=args.deep, tier=args.tier)
    for prob in report.problems:
        print(f"FSCK {prob.kind}: {prob.location}: {prob.detail}")
    mode = "deep" if report.deep else "shallow"
    if report.deep and report.crcs_verified == 0 and report.blobs_checked:
        print(
            "WARNING: 0 blobs CRC-verified (snapshot has no checksum "
            "tables, or checksums are disabled locally) — this deep "
            "audit checked existence and length only"
        )
    _print_ledger(args.path)
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
