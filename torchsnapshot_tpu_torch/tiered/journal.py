"""Crash-consistent mirror-progress journal, stored in the fast tier.

Counterpart of ``torchsnapshot_tpu/tiered/journal.py``, in the same JSON
schema and the same two slots, so either package's mirror resumes the
other's journal. One journal per snapshot (or manager-root) directory,
rewritten on every progress point, backup slot first and primary second
(the manager index's discipline): whichever slot survives a crash is
valid, at worst one blob stale, and a stale journal only costs the
re-upload of blobs whose completion was not recorded yet. The durable
commit marker is mirrored last and an upload is idempotent, so that
never costs correctness.

Schema (version 1)::

    {
      "version": 1,
      "blobs": {"<path>": <nbytes>},   # the inventory to mirror
      "done": ["<path>", ...],          # uploaded to the durable tier
      "metadata": "<path>" | null,      # the commit marker, mirrored last
      "durable_committed": bool         # the marker landed on the durable tier
    }

A restarted mirror uploads only ``blobs - done``; fsck reports a partly
mirrored durable step from it. A snapshot with no journal and no durable
commit marker resumes from its fast-tier manifest instead: the journal
saves work, correctness never depends on it.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Optional, Set

from ..io_types import ReadIO, StoragePlugin, WriteIO

logger: logging.Logger = logging.getLogger(__name__)

JOURNAL_BLOB = ".mirror_journal"
JOURNAL_BACKUP_BLOB = ".mirror_journal.backup"


class MirrorJournal:
    """Per-directory mirror progress: blob inventory + done set."""

    def __init__(
        self,
        blobs: Optional[Dict[str, int]] = None,
        done: Optional[Set[str]] = None,
        metadata: Optional[str] = None,
        durable_committed: bool = False,
    ) -> None:
        self.blobs: Dict[str, int] = dict(blobs or {})
        self.done: Set[str] = set(done or ())
        self.metadata = metadata
        self.durable_committed = durable_committed

    # ------------------------------------------------------------------

    def register(
        self,
        blobs: Dict[str, int],
        metadata: Optional[str] = None,
        fresh: bool = True,
    ) -> None:
        """Merge a mirror job's inventory. With ``fresh`` (newly-written
        blobs handed over at plugin close) re-registered paths lose their
        done flag — their durable copy is stale; the manager index is
        rewritten on every save and must re-mirror each time. A RESUMED
        job (``fresh=False``) merges the inventory but keeps done flags:
        skipping completed uploads is the journal's whole point."""
        for path, nbytes in blobs.items():
            self.blobs[path] = nbytes
            if fresh:
                self.done.discard(path)
        if metadata is not None:
            self.metadata = metadata
            if fresh:
                self.durable_committed = False

    def pending(self) -> list:
        """Data blobs still to upload, commit marker excluded (it goes
        last, via :attr:`metadata`)."""
        return sorted(
            p for p in self.blobs if p not in self.done and p != self.metadata
        )

    @property
    def complete(self) -> bool:
        data_done = all(
            p in self.done for p in self.blobs if p != self.metadata
        )
        if self.metadata is None:
            return data_done
        return data_done and self.durable_committed

    # ------------------------------------------------------------------

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "version": 1,
                "blobs": self.blobs,
                "done": sorted(self.done),
                "metadata": self.metadata,
                "durable_committed": self.durable_committed,
            }
        ).encode("utf-8")

    @classmethod
    def from_json(cls, raw: bytes) -> "MirrorJournal":
        doc = json.loads(raw)
        return cls(
            blobs={str(k): int(v) for k, v in doc["blobs"].items()},
            done={str(p) for p in doc.get("done", [])},
            metadata=doc.get("metadata"),
            durable_committed=bool(doc.get("durable_committed", False)),
        )

    # ------------------------------------------------------------------

    @classmethod
    async def load(cls, fast: StoragePlugin) -> Optional["MirrorJournal"]:
        """Primary slot, falling back to backup (manager-index recovery
        rule). Both slots unreadable -> None: the caller falls back to a
        full re-mirror, which is always safe."""
        for slot in (JOURNAL_BLOB, JOURNAL_BACKUP_BLOB):
            read_io = ReadIO(path=slot)
            try:
                await fast.read(read_io)
            except FileNotFoundError:
                continue
            except Exception as e:  # noqa: BLE001 - degrade to re-mirror
                logger.warning("mirror journal slot %s unreadable: %r", slot, e)
                continue
            if read_io.buf is None:
                continue
            try:
                return cls.from_json(bytes(read_io.buf))
            except (ValueError, KeyError, TypeError) as e:
                logger.warning(
                    "mirror journal slot %s is corrupt (%r); trying backup",
                    slot,
                    e,
                )
        return None

    async def save(self, fast: StoragePlugin) -> None:
        payload = self.to_json()
        await fast.write(WriteIO(path=JOURNAL_BACKUP_BLOB, buf=payload))
        await fast.write(WriteIO(path=JOURNAL_BLOB, buf=payload))

    async def delete(self, fast: StoragePlugin) -> None:
        """Drop both slots (step GC / post-eviction cleanup)."""
        for slot in (JOURNAL_BLOB, JOURNAL_BACKUP_BLOB):
            try:
                await fast.delete(slot)
            except FileNotFoundError:
                pass
