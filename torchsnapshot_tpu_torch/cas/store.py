"""Content-addressed chunk store: layout, digest keys, refcount journal.

Counterpart of ``torchsnapshot_tpu/cas/store.py``, in the same on-disk
format: keys, journal lines and the directory layout are byte for byte
the JAX package's, so either package's manager pins, reconciles and
collects a chunk store the other wrote.

The store is a ``chunks/`` directory next to a manager root's ``step_*``
directories, holding every data blob once, keyed by the content digest
the integrity layer computes (``integrity.compute_checksum_entry``).
Manifest entries reference chunks through parent-relative locations
(``../chunks/<key>``), the mechanism incremental takes use for
``../step_*/...`` refs, so restore, fsck and checksum verification
resolve them with no new read-path code.

Keys embed the algorithm, byte length, whole-blob CRC and, for blobs of
more than one integrity page, a fold of the page CRCs::

    cas-crc32c-<nbytes hex>-<crc 8hex>[-p<page-fold 8hex>]

Two blobs collide only at equal length and equal CRC32-C (multi-page
blobs add 32 bits through the fold); verification on restore cannot
catch a true collision, the trade of CRC-keyed addressing.

**Refcounts** are step-level pins in an append-only journal
(``chunks/.refcounts.jsonl``) that only the manager's rank-0 commit path
writes: one line per record, so a kill mid-append leaves at most one torn
tail line, which load skips and the next append heals. The journal caches
what the manifests say (a committed step's chunk refs are the
``../chunks/`` locations of its manifest), so a lost or stale journal is
rebuilt from the index and manifests (:meth:`CASStore.reconcile`).
Leases (non-step pins that CDN subscribers of either package hold,
``lease`` / ``unlease``) are kept through every rewrite.

**GC** deletes a chunk that no pinned step references once its mtime is
older than the grace window (``TORCHSNAPSHOT_TPU_CAS_GC_GRACE_SECONDS``):
a take that dedups against a chunk touches it first, so an in-flight
step's chunks are always younger than the window; dead but young chunks
are journaled as orphans and reclaimed by a later pass.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterable, Optional, Set, Tuple

logger: logging.Logger = logging.getLogger(__name__)

CHUNKS_DIRNAME = "chunks"
# Manifest locations of chunk blobs are step-relative parent refs —
# resolved lexically by every storage plugin, like incremental refs.
CHUNK_LOCATION_PREFIX = "../" + CHUNKS_DIRNAME + "/"
# The per-rank path -> digest maps each writing rank commits next to
# its checksum table (read back by rank 0's manifest rewrite).
CAS_MAP_DIR = "cas"
REFCOUNTS_BASENAME = ".refcounts.jsonl"

_KEY_PREFIX = "cas-"

# Serializes journal appends/rewrites within the process (rank 0 is the
# only writer across processes; tests run several managers in-process).
_JOURNAL_LOCK = threading.RLock()


def digest_key(entry: Tuple) -> str:
    """The chunk store key for one integrity-table entry
    (``(alg, crc, nbytes)`` or the paged form). Deterministic, filename-
    safe, and self-describing: the key embeds the byte length (so a
    partial chunk left by a crash can never satisfy an existence check)
    and the digest (so fsck verifies a chunk's bytes against its own
    name)."""
    alg, crc, nbytes = entry[0], entry[1], int(entry[2])
    crc_val = int(crc) & 0xFFFFFFFF if crc is not None else 0
    key = f"{_KEY_PREFIX}{alg}-{nbytes:x}-{crc_val:08x}"
    if len(entry) >= 5 and entry[4]:
        fold = (
            zlib.crc32(
                b"".join(
                    struct.pack("<I", int(p) & 0xFFFFFFFF) for p in entry[4]
                )
            )
            & 0xFFFFFFFF
        )
        key += f"-p{fold:08x}"
    return key


def is_chunk_key(name: str) -> bool:
    return name.startswith(_KEY_PREFIX)


def is_chunk_location(location: str) -> bool:
    """True for manifest/storage locations that address a chunk blob
    (step-relative ``../chunks/<key>``)."""
    return location.startswith(CHUNK_LOCATION_PREFIX)


def chunk_location(key: str) -> str:
    """The step-relative storage location of a chunk."""
    return CHUNK_LOCATION_PREFIX + key


def key_of_location(location: str) -> Optional[str]:
    if not is_chunk_location(location):
        return None
    key = location[len(CHUNK_LOCATION_PREFIX) :]
    return key if is_chunk_key(key) and "/" not in key else None


def nbytes_of_key(key: str) -> Optional[int]:
    """The byte length a chunk key claims (embedded at key derivation),
    or None for a malformed key."""
    parts = key.split("-")
    # cas-<alg>-<nbytes>-<crc>[-p<fold>]
    if len(parts) < 4 or parts[0] != "cas":
        return None
    try:
        return int(parts[2], 16)
    except ValueError:
        return None


def parse_key(key: str) -> Optional[Tuple[str, int, int]]:
    """``(alg, nbytes, crc)`` from a chunk key, or None."""
    parts = key.split("-")
    if len(parts) < 4 or parts[0] != "cas":
        return None
    try:
        return parts[1], int(parts[2], 16), int(parts[3], 16)
    except ValueError:
        return None


def chunk_refs(manifest) -> Dict[str, int]:
    """Every chunk a manifest references: ``digest key -> nbytes``
    (length decoded from the key itself — a manifest is a complete
    refcount input on its own, no side table needed)."""
    from ..manifest import entry_locations

    out: Dict[str, int] = {}
    for entry in manifest.values():
        for location in entry_locations(entry):
            key = key_of_location(location)
            if key is not None:
                out[key] = nbytes_of_key(key) or 0
    return out


def root_url_of_snapshot(path_url: str) -> str:
    """The manager-root URL a snapshot path's chunk store hangs off:
    the parent directory, per tier for ``tiered://`` URLs."""
    from ..storage_plugin import split_tiered_url

    tiers = split_tiered_url(path_url)
    if tiers is not None:
        fast, durable = tiers
        return (
            f"tiered://{_parent_of_url(fast)}|{_parent_of_url(durable)}"
        )
    return _parent_of_url(path_url)


def _parent_of_url(url: str) -> str:
    if "://" in url:
        scheme, _, path = url.partition("://")
        return f"{scheme}://{os.path.dirname(path.rstrip('/'))}"
    return os.path.dirname(os.path.abspath(url.rstrip("/")))


def local_chunks_dir(root_url: str) -> Optional[str]:
    """The local filesystem directory of a root's chunk store, or None
    when the root has no local tier (object-store roots — ineligible
    for CAS; the journal and existence checks need a local fs)."""
    local = _local_fs_root(root_url)
    if local is None:
        return None
    return os.path.join(local, CHUNKS_DIRNAME)


def _local_fs_root(url: str) -> Optional[str]:
    """The local directory a URL names, or None for other schemes (a
    ``tiered://`` URL through its fast tier)."""
    if "://" not in url:
        return url
    if url.startswith("fs://"):
        return url[len("fs://") :]
    if url.startswith("tiered://"):
        from ..storage_plugin import split_tiered_url

        try:
            tiers = split_tiered_url(url)
        except ValueError:
            return None
        if tiers is not None:
            return _local_fs_root(tiers[0])
    return None


def cas_eligible(path_url: str) -> bool:
    """Whether the CAS layout can serve a snapshot at ``path_url``:
    the knob is on AND the root resolves to a local filesystem tier
    (fs, or tiered with an fs fast tier). Object-store-only roots fall
    back to the legacy layout with a one-time warning — their lexical
    ``../`` resolution would serve reads, but the refcount journal and
    dedup existence checks are local-fs constructs."""
    from .. import knobs

    if not knobs.is_cas_enabled():
        return False
    try:
        root = root_url_of_snapshot(path_url)
    except ValueError:
        return False
    if local_chunks_dir(root) is None:
        _warn_ineligible_once(path_url)
        return False
    return True


_WARNED_INELIGIBLE = False


def _warn_ineligible_once(path_url: str) -> None:
    global _WARNED_INELIGIBLE
    if not _WARNED_INELIGIBLE:
        _WARNED_INELIGIBLE = True
        logger.warning(
            "TORCHSNAPSHOT_TPU_CAS is on but %r has no local filesystem "
            "tier; taking snapshots in the legacy (non-deduplicated) "
            "layout",
            path_url,
        )


class CASStore:
    """Rank-0 view of one root's chunk store: the refcount journal and
    the chunk-file inventory. All journal mutation happens here (the
    manager's commit path); writers of chunk *bytes* never touch it."""

    def __init__(self, root_url: str) -> None:
        self.root_url = root_url
        local = local_chunks_dir(root_url)
        if local is None:
            raise ValueError(
                f"{root_url!r} has no local filesystem tier; the CAS "
                f"refcount journal requires one"
            )
        self.local_dir = local
        self.journal_path = os.path.join(local, REFCOUNTS_BASENAME)

    # -- journal ---------------------------------------------------------

    def load(self) -> Tuple[Dict[int, Dict[str, int]], Dict[str, int]]:
        """``(pins, orphans)`` from the journal; a torn tail line (kill
        mid-append) is skipped — the next append heals it."""
        pins, orphans, _ = self.load_full()
        return pins, orphans

    def load_full(
        self,
    ) -> Tuple[
        Dict[int, Dict[str, int]], Dict[str, int], Dict[str, Dict[str, int]]
    ]:
        """``(pins, orphans, leases)``. Leases are non-step pins — a
        CDN subscriber's (or any external reader's) held chunk set,
        keyed by lease id; the newest lease record per id wins (a
        re-lease IS the release of the chunks the new set dropped)."""
        pins: Dict[int, Dict[str, int]] = {}
        orphans: Dict[str, int] = {}
        leases: Dict[str, Dict[str, int]] = {}
        try:
            with open(self.journal_path, "r", encoding="utf-8") as f:
                raw = f.read()
        except OSError:
            return pins, orphans, leases
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn append; heals on next write
            op = rec.get("op")
            if op == "pin":
                pins[int(rec["step"])] = {
                    str(k): int(v) for k, v in rec.get("chunks", {}).items()
                }
            elif op == "unpin":
                pins.pop(int(rec["step"]), None)
            elif op == "orphan":
                for k, v in rec.get("chunks", {}).items():
                    orphans[str(k)] = int(v)
            elif op == "unorphan":
                for k in rec.get("chunks", []):
                    orphans.pop(str(k), None)
            elif op == "lease":
                leases[str(rec["id"])] = {
                    str(k): int(v) for k, v in rec.get("chunks", {}).items()
                }
            elif op == "unlease":
                leases.pop(str(rec["id"]), None)
        return pins, orphans, leases

    def _append(self, record: Dict) -> None:
        with _JOURNAL_LOCK:
            os.makedirs(self.local_dir, exist_ok=True)
            heal = ""
            try:
                with open(self.journal_path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) not in (b"\n", b""):
                        heal = "\n"  # torn tail from a previous crash
            except OSError:
                pass
            line = heal + json.dumps(record, sort_keys=True) + "\n"
            with open(self.journal_path, "a", encoding="utf-8") as f:
                f.write(line)

    def pin(self, step: int, chunks: Dict[str, int]) -> None:
        self._append({"op": "pin", "step": int(step), "chunks": chunks})

    def unpin(self, step: int) -> None:
        self._append({"op": "unpin", "step": int(step)})

    def lease(self, lease_id: str, chunks: Dict[str, int]) -> None:
        """Pin ``chunks`` outside step retention under ``lease_id`` (a CDN
        subscriber's held set, an external reader's working set). Replaces
        this id's previous lease: callers re-lease their full current set,
        they never diff."""
        self._append({"op": "lease", "id": str(lease_id), "chunks": chunks})

    def unlease(self, lease_id: str) -> None:
        self._append({"op": "unlease", "id": str(lease_id)})

    def record_orphans(self, chunks: Dict[str, int]) -> None:
        if chunks:
            self._append({"op": "orphan", "chunks": chunks})

    def clear_orphans(self, keys: Iterable[str]) -> None:
        keys = sorted(keys)
        if keys:
            self._append({"op": "unorphan", "chunks": keys})

    def maybe_compact(self, max_bytes: int = 256 * 1024) -> None:
        """Opportunistic journal compaction: once the append log outgrows
        ``max_bytes``, rewrite it to the canonical state (one pin record
        per live step + one orphan record)."""
        try:
            if os.path.getsize(self.journal_path) <= max_bytes:
                return
        except OSError:
            return
        pins, orphans = self.load()
        self.compact(pins, orphans)

    def compact(
        self,
        pins: Dict[int, Dict[str, int]],
        orphans: Dict[str, int],
        leases: Optional[Dict[str, Dict[str, int]]] = None,
    ) -> None:
        """Atomic rewrite to the canonical state (bounds journal growth
        over long runs; called opportunistically by the manager's GC).
        Leases default to whatever the journal currently holds — a
        compaction driven by step state must never drop a subscriber's
        outstanding pin."""
        with _JOURNAL_LOCK:
            if leases is None:
                _, _, leases = self.load_full()
            os.makedirs(self.local_dir, exist_ok=True)
            tmp = self.journal_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for step in sorted(pins):
                    f.write(
                        json.dumps(
                            {"op": "pin", "step": step, "chunks": pins[step]},
                            sort_keys=True,
                        )
                        + "\n"
                    )
                for lease_id in sorted(leases):
                    f.write(
                        json.dumps(
                            {
                                "op": "lease",
                                "id": lease_id,
                                "chunks": leases[lease_id],
                            },
                            sort_keys=True,
                        )
                        + "\n"
                    )
                if orphans:
                    f.write(
                        json.dumps(
                            {"op": "orphan", "chunks": orphans},
                            sort_keys=True,
                        )
                        + "\n"
                    )
            os.replace(tmp, self.journal_path)

    # -- inventory -------------------------------------------------------

    @staticmethod
    def live_chunks(
        pins: Dict[int, Dict[str, int]],
        leases: Optional[Dict[str, Dict[str, int]]] = None,
    ) -> Set[str]:
        """Chunks GC must not delete: every step-pinned chunk, plus —
        when ``leases`` is given — every chunk a lease still holds
        (a serving fleet's copy source outlives step retention)."""
        live: Set[str] = set()
        for chunks in pins.values():
            live.update(chunks)
        for chunks in (leases or {}).values():
            live.update(chunks)
        return live

    def list_chunks(self) -> Dict[str, int]:
        """``key -> on-disk byte size`` of every chunk file present
        locally (the journal and tmp files excluded)."""
        out: Dict[str, int] = {}
        try:
            names = os.listdir(self.local_dir)
        except OSError:
            return out
        for name in names:
            if not is_chunk_key(name):
                continue
            try:
                out[name] = os.path.getsize(
                    os.path.join(self.local_dir, name)
                )
            except OSError:
                continue
        return out

    def chunk_age_seconds(self, key: str) -> Optional[float]:
        try:
            return max(
                0.0,
                time.time()
                - os.path.getmtime(os.path.join(self.local_dir, key)),
            )
        except OSError:
            return None

    # -- reconcile (crash healing) --------------------------------------

    def reconcile(self, indexed: Dict[int, Dict[str, int]]) -> bool:
        """Bring the journal in line with manifest-derived truth:
        ``indexed`` maps every committed-or-pinned step to its chunk
        refs. Steps missing a pin record get one (the crash-between-
        chunk-write-and-refcount-append heal); pinned steps no longer in
        the index are unpinned (their chunks become GC candidates).
        Returns True when anything changed."""
        pins, orphans = self.load()
        changed = False
        for step, chunks in indexed.items():
            if not chunks:
                # A legacy-layout step: its absence from the journal IS
                # the canonical state (pins exist only for chunky steps).
                if step in pins:
                    self.unpin(step)
                    changed = True
                continue
            if pins.get(step) != chunks:
                self.pin(step, chunks)
                changed = True
        for step in list(pins):
            if step not in indexed:
                self.unpin(step)
                changed = True
        return changed
