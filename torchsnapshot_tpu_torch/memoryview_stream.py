"""File-like, zero-copy reader over a memoryview.

Reference parity: torchsnapshot/memoryview_stream.py:12-81 — uploads hand
storage clients a file-like object so multi-GB staged buffers are
streamed instead of copied into a ``bytes`` (S3 put_object bodies,
storage_plugins/s3.py). Read-only, seekable; ``read`` returns memoryview
slices (clients treat them as bytes-like) so no byte is duplicated.
"""

from __future__ import annotations

import io
from typing import Optional


class MemoryviewStream(io.RawIOBase):
    def __init__(self, mv: memoryview) -> None:
        super().__init__()
        self._mv = mv if mv.format == "B" and mv.ndim == 1 else mv.cast("B")
        self._pos = 0

    # ------------------------------------------------------------------
    # io.RawIOBase interface
    # ------------------------------------------------------------------

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            new_pos = pos
        elif whence == io.SEEK_CUR:
            new_pos = self._pos + pos
        elif whence == io.SEEK_END:
            new_pos = len(self._mv) + pos
        else:
            raise ValueError(f"invalid whence: {whence}")
        if new_pos < 0:
            raise ValueError(f"negative seek position {new_pos}")
        self._pos = new_pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: Optional[int] = -1) -> memoryview:
        if self.closed:
            raise ValueError("I/O operation on closed stream")
        start = min(self._pos, len(self._mv))
        if size is None or size < 0:
            end = len(self._mv)
        else:
            end = min(start + size, len(self._mv))
        out = self._mv[start:end]
        if end > start:
            self._pos = end
        return out

    def readinto(self, b) -> int:
        chunk = self.read(len(b))
        n = len(chunk)
        b[:n] = chunk
        return n

    def readall(self) -> bytes:  # pragma: no cover - RawIOBase fallback
        return bytes(self.read(-1))

    def __len__(self) -> int:
        return len(self._mv)
