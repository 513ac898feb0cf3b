"""On-device slab packing: many small tensors -> one uint8 buffer -> one
copy to the host.

Counterpart of ``torchsnapshot_tpu/ops/device_pack.py``, whose ``_pack_jit``
(``:52``) is a jitted XLA program that bitcasts each member to its uint8
memory image and concatenates them. Here the pack is the hand-written CUDA
kernel ``csrc/device_pack.cu``, one launch per slab, through
:func:`pack_async`: a slab of N small tensors costs one launch and one
device-to-host copy instead of N copies, which pays where per-copy
overhead dominates (states of 10^4 small leaves).

Bit-exactness: the packed bytes equal each member's little-endian memory
image, as the serializer writes it (``.contiguous()`` then a uint8 view;
bool is one 0/1 byte per element). :func:`pack_plain` is the plain
version (``torch.cat`` of the members' uint8 views); on a CPU tensor the
wrapper runs it, on a CUDA tensor it launches the kernel or raises. A
member that is not contiguous is made contiguous by the wrapper with a
copy, counted in ``copy_counts``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import operator
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..serialization import DTYPE_TO_STRING
from . import kernels

# Kernel launches; incremented only where the kernel is launched.
launch_counts: Dict[str, int] = {"device_pack": 0}
# Members the wrapper made contiguous before a launch.
copy_counts: Dict[str, int] = {"device_pack_contiguous": 0}

# A member: (tensor, dim-0 row range [start, stop) or None for all of it).
RowSlice = Optional[Tuple[int, int]]


def reset_launch_counts() -> None:
    for counts in (launch_counts, copy_counts):
        for name in counts:
            counts[name] = 0


def pack_supported(dtype: Any) -> bool:
    """Packable: a dtype the port serializes, with a uint8 view of its
    memory image; complex is excluded, as the JAX package's
    ``bitcastable_dtype`` excludes it, so that both packages put the same
    members into a slab's pack."""
    return isinstance(dtype, torch.dtype) and dtype in DTYPE_TO_STRING and not dtype.is_complex


def device_group_key(t: torch.Tensor) -> int:
    """Grouping key of the tensors one pack may take: the CUDA device
    index (-1 for the CPU)."""
    return t.get_device()


def _member(t: torch.Tensor, rows: RowSlice) -> torch.Tensor:
    t = t.detach()
    if rows is not None:
        if t.dim() == 0 or not 0 <= rows[0] <= rows[1] <= t.shape[0]:
            raise ValueError(f"row range {rows} outside dim 0 of {tuple(t.shape)}")
        t = t[rows[0] : rows[1]]
    if not pack_supported(t.dtype):
        raise TypeError(f"device pack does not support dtype {t.dtype}")
    return t


def pack_plain(specs: Sequence[Tuple[torch.Tensor, RowSlice]]) -> torch.Tensor:
    """Plain version of the kernel: the members' uint8 memory images
    concatenated, on their device."""
    parts = [_member(t, r).contiguous().reshape(-1).view(torch.uint8) for t, r in specs]
    if not parts:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat(parts)


_DTYPE = operator.attrgetter("dtype")
_NBYTES = operator.attrgetter("nbytes")
_PACKABLE = frozenset(d for d in DTYPE_TO_STRING if not d.is_complex)

# The kernel's tile (``kTileBytes`` in csrc/device_pack.cu, which refuses
# any other): the table names, per tile, the member that holds its first
# byte, so that no thread searches for its member.
TILE_BYTES = 16 * 1024


def tile_table(offsets: np.ndarray) -> np.ndarray:
    """Per ``TILE_BYTES`` tile of the slab, the member that holds its first
    byte (the last member that starts at or before it), given the ``n + 1``
    slab offsets: each member names the tiles whose first byte it holds, so
    a member of zero bytes names none."""
    first_tiles = -(-offsets // TILE_BYTES)
    return np.repeat(np.arange(len(offsets) - 1, dtype=np.int64), np.diff(first_tiles))


class PackLayout:
    """The kernel's table for one slab, all but the members' addresses:
    ``n + 1`` slab offsets, room for ``n`` addresses, and the tile table,
    made once per slab from the members' byte sizes and their byte offsets
    into their tensors (a row range's first row times the row's bytes).
    :func:`pack_async` given a layout reads nothing of a member but its
    ``data_ptr``; the layout's maker vouches for the rest (one device, a
    packable dtype, the sizes). ``copy_members`` are the members that were
    not contiguous when it was made: they are made contiguous at launch
    if they still are not, and counted."""

    def __init__(
        self,
        device: torch.device,
        nbytes: Sequence[int],
        src_offsets: Sequence[int],
        copy_members: Sequence[int] = (),
    ) -> None:
        n = len(nbytes)
        offsets = np.empty(n + 1, dtype=np.int64)
        offsets[0] = 0
        np.cumsum(np.asarray(nbytes, dtype=np.int64), out=offsets[1:])
        tiles = tile_table(offsets)
        self.device = device
        self.n = n
        self.total = int(offsets[n])
        self.src_offsets = np.asarray(src_offsets, dtype=np.int64)
        self.copy_members = tuple(copy_members)
        self.table = np.zeros(2 * n + 1 + len(tiles), dtype=np.int64)
        self.table[: n + 1] = offsets
        self.table[2 * n + 1 :] = tiles

    @classmethod
    def from_specs(cls, specs: Sequence[Tuple[torch.Tensor, RowSlice]]):
        """``(layout, members)`` of plain specs, with every check: dtypes,
        row ranges; a member that is not contiguous is copied (and
        counted), and ``members`` are the tensors the addresses point
        into. The members' attributes are read through ``map``: the
        host's cost per member is what bounds a plain pack of 10^4 small
        members."""
        tensors = [t for t, _ in specs]
        unsupported = set(map(_DTYPE, tensors)).difference(_PACKABLE)
        if unsupported:
            raise TypeError(f"device pack does not support dtype {unsupported.pop()}")
        if not all(map(torch.Tensor.is_contiguous, tensors)):
            for i, t in enumerate(tensors):
                if not t.is_contiguous():
                    tensors[i] = t.contiguous()
                    copy_counts["device_pack_contiguous"] += 1
        n = len(tensors)
        nbytes = np.fromiter(map(_NBYTES, tensors), dtype=np.int64, count=n)
        src_offsets = np.zeros(n, dtype=np.int64)
        for i in [i for i, (_, rows) in enumerate(specs) if rows is not None]:
            t, rows = tensors[i], specs[i][1]
            if t.dim() == 0 or not 0 <= rows[0] <= rows[1] <= t.shape[0]:
                raise ValueError(f"row range {rows} outside dim 0 of {tuple(t.shape)}")
            row_bytes = int(nbytes[i]) // max(1, t.shape[0])
            src_offsets[i] = rows[0] * row_bytes
            nbytes[i] = (rows[1] - rows[0]) * row_bytes
        return cls(tensors[0].device, nbytes, src_offsets), tensors

    def addresses(self, tensors: Sequence[torch.Tensor], out: Optional[np.ndarray] = None) -> np.ndarray:
        """The members' source addresses: each ``data_ptr`` plus its
        offset, into ``out`` where given."""
        ptrs = np.fromiter(map(torch.Tensor.data_ptr, tensors), dtype=np.int64, count=self.n)
        return np.add(ptrs, self.src_offsets, out=out)


def build_table(specs: Sequence[Tuple[torch.Tensor, RowSlice]]):
    """``(table, total, members)`` of plain specs: the kernel's int64 table
    (``n + 1`` slab offsets, ``n`` source addresses, then the tile
    table), the slab's bytes, and the tensors the addresses point into."""
    layout, members = PackLayout.from_specs(specs)
    table = layout.table.copy()
    layout.addresses(members, out=table[layout.n + 1 : 2 * layout.n + 1])
    return table, layout.total, members


class _PinnedTables:
    """The kernel's tables in flight, per device. A slot is a pinned host
    buffer, a device buffer of its size, the event recorded once the
    table's copy to the card has run and the event recorded once the
    kernel that reads it has run. The copy goes on a side stream of the
    device, so that it does not wait for the work queued before the pack
    on the pack's stream, and the pack's stream waits for it. A slot is
    reused once its kernel has run, oldest first, and grows only when a
    larger table comes; calls queued faster than the card runs them take
    a slot each. The copy, the wait and the events are queued by
    ``ts_pack`` in one C call and the events are C's: queued from Python
    with torch's ``Stream`` and ``Event`` instead, a call cost the host
    17-47 us more at a 36-member slab (``chip_pack_probe.py``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # device index -> slots [host, device buffer, copied, used], in the
        # order their kernels were queued
        self._free: Dict[int, Deque[list]] = {}
        self._streams: Dict[int, "torch.cuda.Stream"] = {}

    def take(self, lib: ctypes.CDLL, device: int, size: int):
        """``(slot, copy stream)`` for a table of ``size`` int64 on
        ``device``, the current device."""
        with self._lock:
            free = self._free.setdefault(device, collections.deque())
            slot = free.popleft() if free and _event_done(lib, free[0][3]) else None
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device=device)
        if slot is None:
            events = [lib.ts_pack_event_create(), lib.ts_pack_event_create()]
            if not all(events):
                raise RuntimeError("device_pack: cannot create a CUDA event")
            slot = [torch.empty(0, dtype=torch.int64, pin_memory=True), None, *events]
        if slot[0].numel() < size:
            slot[0] = torch.empty(size, dtype=torch.int64, pin_memory=True)
            slot[1] = torch.empty(size, dtype=torch.int64, device=torch.device("cuda", device))
        return slot, stream

    def give_back(self, device: int, slot: list) -> None:
        with self._lock:
            self._free[device].append(slot)


def _event_done(lib: ctypes.CDLL, event: int) -> bool:
    state = lib.ts_pack_event_done(event)
    if state < 0:
        raise RuntimeError(f"device_pack: CUDA error {-state} on a table copy's event")
    return state == 1


_tables = _PinnedTables()


def _library() -> ctypes.CDLL:
    lib = kernels.library("device_pack")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_pack.argtypes = [ptr, ptr, i32, i64, i64, ptr, ptr, ptr, ptr, ptr]
        lib.ts_pack.restype = i32
        lib.ts_pack_event_create.argtypes = []
        lib.ts_pack_event_create.restype = ptr
        lib.ts_pack_event_done.argtypes = [ptr]
        lib.ts_pack_event_done.restype = i32
        lib._ts_declared = True
    return lib


def pack_async(
    specs: Sequence[Tuple[torch.Tensor, RowSlice]], layout: Optional[PackLayout] = None
) -> torch.Tensor:
    """Pack ``[(tensor, row_slice | None), ...]``, all on one device, into
    one flat uint8 tensor whose bytes are the members' memory images in
    order. On a CUDA card: one launch of the pack kernel on the current
    stream (not synchronized); on the CPU: the plain version. ``layout``:
    the slab's :class:`PackLayout`, made once from the same members'
    sizes and row offsets; with it, a launch reads only each member's
    ``data_ptr``, without it every check runs."""
    if not specs:
        return torch.empty(0, dtype=torch.uint8)
    if layout is None:
        device = specs[0][0].device
        if len(set(map(torch.Tensor.get_device, (t for t, _ in specs)))) != 1:
            raise ValueError("pack_async takes tensors of one device; group them by device_group_key")
    else:
        device = layout.device
        if layout.n != len(specs):
            raise ValueError(f"a layout of {layout.n} members given {len(specs)}")
    if device.type == "cpu":
        return pack_plain(specs)
    if device.type != "cuda":
        raise ValueError(f"pack_async takes CPU or CUDA tensors, got {device}")
    if layout is None:
        layout, members = PackLayout.from_specs(specs)
    else:
        members = [t for t, _ in specs]
        for i in layout.copy_members:
            if not members[i].is_contiguous():
                members[i] = members[i].contiguous()
                copy_counts["device_pack_contiguous"] += 1
    total = layout.total
    # Whole 16-byte units: the kernel stores nothing narrower.
    out = torch.empty(-(-total // 16) * 16, dtype=torch.uint8, device=device)
    if total == 0:
        return out
    lib = _library()
    index = device.index if device.index is not None else torch.cuda.current_device()
    with contextlib.ExitStack() as stack:
        if index != torch.cuda.current_device():
            stack.enter_context(torch.cuda.device(index))
        slot, copy_stream = _tables.take(lib, index, layout.table.size)
        try:
            view = slot[0].numpy()
            view[: layout.table.size] = layout.table
            layout.addresses(members, out=view[layout.n + 1 : 2 * layout.n + 1])
            err = lib.ts_pack(
                slot[0].data_ptr(), slot[1].data_ptr(), layout.n, total, TILE_BYTES, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream, copy_stream.cuda_stream, slot[2], slot[3],
            )
        finally:
            _tables.give_back(index, slot)
    if err != 0:
        raise RuntimeError(f"device_pack: CUDA error {err} at launch")
    launch_counts["device_pack"] += 1
    return out[:total]


def pack_bytes(specs: Sequence[Tuple[torch.Tensor, RowSlice]]) -> int:
    """Bytes of the packed slab of ``specs``."""
    return sum(_member(t, r).numel() * t.element_size() for t, r in specs)


__all__: List[str] = [
    "PackLayout",
    "TILE_BYTES",
    "build_table",
    "copy_counts",
    "device_group_key",
    "launch_counts",
    "pack_async",
    "pack_bytes",
    "pack_plain",
    "pack_supported",
    "reset_launch_counts",
    "tile_table",
]
