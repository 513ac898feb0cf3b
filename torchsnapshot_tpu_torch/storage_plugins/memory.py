"""In-memory storage plugin.

No reference counterpart as a shipped plugin; it serves the role the
reference's test-side fake plugins play (tests/test_async_take.py:25-65) and
is handy as a scratch target (``memory://``). A process-wide registry of
named stores lets a writer and a reader in the same process share contents.
"""

from __future__ import annotations

import asyncio
import errno
from typing import Dict

from ..io_types import ReadIO, StoragePlugin, WriteIO

_STORES: Dict[str, Dict[str, bytes]] = {}


class MemoryStoragePlugin(StoragePlugin):
    def __init__(self, name: str = "default") -> None:
        self.name = name
        self._blobs: Dict[str, bytes] = _STORES.setdefault(name, {})

    async def write(self, write_io: WriteIO) -> None:
        self._blobs[write_io.path] = bytes(write_io.buf)
        await asyncio.sleep(0)  # keep scheduling behavior async-plugin-like

    async def read(self, read_io: ReadIO) -> None:
        if read_io.path not in self._blobs:
            raise FileNotFoundError(read_io.path)  # the FS plugin contract
        data = self._blobs[read_io.path]
        if read_io.byte_range is not None:
            start, end = read_io.byte_range
            if start < 0 or start > end or end > len(data):
                # FS-plugin contract (EIO, matching its native pread
                # path): a ranged read outside the blob is corruption,
                # not a partial success.
                raise OSError(
                    errno.EIO,
                    f"ranged read [{start}, {end}) invalid for "
                    f"{len(data)}-byte blob",
                    read_io.path,
                )
            data = data[start:end]
        read_io.buf = memoryview(data)
        await asyncio.sleep(0)

    async def delete(self, path: str) -> None:
        if path not in self._blobs:
            raise FileNotFoundError(path)
        del self._blobs[path]

    async def close(self) -> None:
        pass

    @classmethod
    def drop_store(cls, name: str) -> None:
        _STORES.pop(name, None)
