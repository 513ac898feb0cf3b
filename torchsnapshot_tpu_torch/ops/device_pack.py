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

import ctypes
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def build_table(specs: Sequence[Tuple[torch.Tensor, RowSlice]]):
    """``(table, total, members)``: the kernel's int64 table (n + 1 slab
    offsets, then n source addresses), the slab's bytes, and the tensors
    the addresses point into (kept alive until the launch). The members'
    attributes are read through ``map`` and the offsets are one prefix sum
    over them: the host's cost per member is what bounds a pack of 10^4
    small members, and a per-layout cache would cost more to key than the
    sum does to compute."""
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
    addr = np.fromiter(map(torch.Tensor.data_ptr, tensors), dtype=np.int64, count=n)
    nbytes = np.fromiter(map(_NBYTES, tensors), dtype=np.int64, count=n)
    for i in [i for i, (_, rows) in enumerate(specs) if rows is not None]:
        t, rows = tensors[i], specs[i][1]
        if t.dim() == 0 or not 0 <= rows[0] <= rows[1] <= t.shape[0]:
            raise ValueError(f"row range {rows} outside dim 0 of {tuple(t.shape)}")
        row_bytes = int(nbytes[i]) // max(1, t.shape[0])
        addr[i] += rows[0] * row_bytes
        nbytes[i] = (rows[1] - rows[0]) * row_bytes
    table = np.empty(2 * n + 1, dtype=np.int64)
    table[0] = 0
    np.cumsum(nbytes, out=table[1 : n + 1])
    table[n + 1 :] = addr
    return table, int(table[n]), tensors


def _library() -> ctypes.CDLL:
    lib = kernels.library("device_pack")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_pack.argtypes = [ptr, i32, i64, ptr, ptr]
        lib.ts_pack.restype = i32
        lib._ts_declared = True
    return lib


def pack_async(specs: Sequence[Tuple[torch.Tensor, RowSlice]]) -> torch.Tensor:
    """Pack ``[(tensor, row_slice | None), ...]``, all on one device, into
    one flat uint8 tensor whose bytes are the members' memory images in
    order. On a CUDA card: one launch of the pack kernel on the current
    stream (not synchronized); on the CPU: the plain version."""
    if not specs:
        return torch.empty(0, dtype=torch.uint8)
    device = specs[0][0].device
    if len(set(map(torch.Tensor.get_device, (t for t, _ in specs)))) != 1:
        raise ValueError("pack_async takes tensors of one device; group them by device_group_key")
    if device.type == "cpu":
        return pack_plain(specs)
    if device.type != "cuda":
        raise ValueError(f"pack_async takes CPU or CUDA tensors, got {device}")
    table, total, members = build_table(specs)
    out = torch.empty(total, dtype=torch.uint8, device=device)
    if total == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        # From pinned memory, so the copy is queued and the host goes on; the
        # caching host allocator keeps the block until the copy has run.
        table_dev = torch.empty(table.size, dtype=torch.int64, device=device)
        table_dev.copy_(torch.from_numpy(table).pin_memory(), non_blocking=True)
        err = lib.ts_pack(
            table_dev.data_ptr(), len(members), total, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"device_pack: CUDA error {err} at launch")
    launch_counts["device_pack"] += 1
    return out


def pack_bytes(specs: Sequence[Tuple[torch.Tensor, RowSlice]]) -> int:
    """Bytes of the packed slab of ``specs``."""
    return sum(_member(t, r).numel() * t.element_size() for t, r in specs)


__all__: List[str] = [
    "copy_counts",
    "device_group_key",
    "launch_counts",
    "pack_async",
    "pack_bytes",
    "pack_plain",
    "pack_supported",
    "reset_launch_counts",
]
