"""TieredStoragePlugin: write through the fast tier, read fast-first with
a per-blob fallback to the durable tier, and hand what was written to the
background mirror at close.

Counterpart of ``torchsnapshot_tpu/tiered/plugin.py``. The plugin
composes two ordinary plugins and records what was written through it.
``Snapshot.take`` / ``async_take`` need nothing else: every data write,
checksum table and the commit marker land on the fast tier, the take
commits there, and when the take closes its plugin the recorded blobs
are enqueued to the process-wide :class:`~.mirror.Mirror`, the commit
marker ordered last. A take that failed before its commit never closes
its plugin, so nothing of it is enqueued.

Reads try the fast tier and fall back per blob on ``FileNotFoundError``:
an evicted, partly evicted or absent fast tier is transparent to
restore, fsck and checksum-table loading. A blob whose fast bytes fail
verification is re-read from the durable tier by :meth:`read_degraded`
(the scheduler's self-healing ladder).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..io_types import ReadIO, StoragePlugin, WriteIO, payload_nbytes
from ..storage_plugin import url_to_storage_plugin

_METADATA_FNAME = ".snapshot_metadata"  # == snapshot.SNAPSHOT_METADATA_FNAME


class TieredStoragePlugin(StoragePlugin):
    def __init__(
        self,
        fast_url: Optional[str] = None,
        durable_url: Optional[str] = None,
        fast: Optional[StoragePlugin] = None,
        durable: Optional[StoragePlugin] = None,
    ) -> None:
        """Compose the ``fast`` and ``durable`` tiers, each given as a URL
        or as a plugin instance. Mirroring needs URLs (the mirror's worker
        builds its own plugins): a plugin composed of instances reads and
        writes but never enqueues."""
        if fast is None:
            if fast_url is None:
                raise ValueError("either fast or fast_url is required")
            fast = url_to_storage_plugin(fast_url)
        if durable is None:
            if durable_url is None:
                raise ValueError("either durable or durable_url is required")
            durable = url_to_storage_plugin(durable_url)
        self.fast = fast
        self.durable = durable
        self.fast_url = fast_url
        self.durable_url = durable_url
        # path -> byte count, in write order; drained into a mirror job
        # at close().
        self._written: Dict[str, int] = {}

    # -- writes: fast tier only ------------------------------------------

    @property
    def supports_multibuffer(self) -> bool:  # type: ignore[override]
        return getattr(self.fast, "supports_multibuffer", False)

    async def write(self, write_io: WriteIO) -> None:
        await self.fast.write(write_io)
        self._written[write_io.path] = payload_nbytes(write_io.buf)

    def note_written(self, path: str, nbytes: int) -> None:
        """Record a blob for the mirror without writing it: a chunk the
        CAS wrapper deduped. Its bytes are on the fast tier already, but
        this step's durability covers them; if the chunk's first writer
        died before its mirror ran, nothing else would ship it. The
        mirror's one-byte probe of the durable tier skips a held chunk."""
        self._written[path] = int(nbytes)

    async def write_with_checksum(self, write_io: WriteIO):
        entry = await self.fast.write_with_checksum(write_io)
        if entry is not None:
            self._written[write_io.path] = payload_nbytes(write_io.buf)
        return entry

    # -- reads: fast first, durable per blob -----------------------------

    async def read(self, read_io: ReadIO) -> None:
        try:
            await self.fast.read(read_io)
            read_io.served_by = "fast"
        except FileNotFoundError:
            await self.durable.read(read_io)
            read_io.served_by = "durable"

    async def read_degraded(self, read_io: ReadIO) -> bool:
        """The tier that served ``read_io`` gave bytes that failed
        verification: re-read from a tier not tried yet. The caller
        verifies again and comes back here on another mismatch, until
        both tiers are spent."""
        tried = getattr(read_io, "_tiers_tried", None)
        if tried is None:
            tried = {read_io.served_by} if read_io.served_by else set()
            read_io._tiers_tried = tried
        for tier, plugin in (("durable", self.durable), ("fast", self.fast)):
            if tier in tried:
                continue
            tried.add(tier)
            try:
                await plugin.read(read_io)
            except (FileNotFoundError, OSError):
                continue  # absent or torn here: keep walking the ladder
            read_io.served_by = tier
            return True
        return False

    async def read_with_checksum(self, read_io: ReadIO):
        try:
            pages = await self.fast.read_with_checksum(read_io)
        except FileNotFoundError:
            # Declined, having read nothing: the scheduler falls back to
            # read(), whose durable fallback serves the blob.
            return None
        if pages is not None:
            read_io.served_by = "fast"
        return pages

    # -- delete: both tiers (step GC removes the step entirely) ----------

    async def delete(self, path: str) -> None:
        found = False
        for plugin in (self.fast, self.durable):
            try:
                await plugin.delete(path)
                found = True
            except FileNotFoundError:
                pass
        if not found:
            raise FileNotFoundError(path)

    # -- close: hand the write record to the mirror ----------------------

    async def close(self) -> None:
        if self._written and self.fast_url and self.durable_url:
            from .mirror import get_mirror

            metadata_path = _METADATA_FNAME if _METADATA_FNAME in self._written else None
            get_mirror().enqueue(
                self.fast_url, self.durable_url, dict(self._written), metadata_path=metadata_path
            )
            self._written.clear()
            from ..chaos import crashpoint
            from ..telemetry import names as _names

            crashpoint(_names.CRASH_MIRROR_ENQUEUED)
        await self.fast.close()
        await self.durable.close()
