"""Content digests for change detection (the ``mlh64`` hash).

Counterpart of ``torchsnapshot_tpu/ops/device_digest.py``. An incremental
take asks "did this chunk's bytes change since the base snapshot?" without
moving the chunk to the host: the digest of every chunk is computed on the
card and only 8 bytes a chunk cross to the host.

Digest: a 64-bit multilinear hash over the bytes viewed as unsigned lanes
(uint32 when the itemsize is a multiple of 4, else uint16 or uint8), with
position-dependent weights from a splitmix32-style mixer::

    w(i, seed) = mix32(i * GOLDEN + seed)
    d_seed     = mix32((sum_i lane_i * w(i, seed)) mod 2^32 ^ nbytes)
    digest     = "mlh64:" + hex(d_SEED1 || d_SEED2)

Three implementations, bit-identical (pinned by
``tests/test_torch_device_digest.py`` against the JAX package's):

- :func:`digest_host`: numpy, for CPU leaves, as in the JAX package;
- :func:`digest_many_plain`: plain torch, in int64 masked to 32 bits after
  every operation (torch has no uint32 arithmetic; an int64 product that
  passes 2^63 wraps and keeps its low 32 bits);
- the hand-written CUDA kernel ``csrc/device_digest.cu``, through
  :func:`digest_many_async`: one launch for many (tensor, row ranges)
  pairs on one card. On a CPU tensor the wrapper runs the plain version;
  on a CUDA tensor it launches the kernel or raises.

The dtype rules and :func:`digest_host` / :func:`format_digest` are this
package's own copies: importing the JAX module would import jax.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import operator
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels

_GOLDEN = 0x9E3779B9
_SEED1 = 0x243F6A88
_SEED2 = 0xB7E15162
_MASK = 0xFFFFFFFF

# Lanes per block of the host and plain versions: bounds the weight arrays.
_HOST_BLOCK_LANES = 1 << 22
_PLAIN_BLOCK_LANES = 1 << 24

# The kernel's schedule (csrc/device_digest.cu checks both): one block
# digests one window of WINDOW_BYTES of at most SLICE_SEGMENTS segments.
WINDOW_BYTES = 32 * 1024
SLICE_SEGMENTS = 32

DIGEST_PREFIX = "mlh64:"

# Kernel launches; incremented only where the kernel is launched.
launch_counts: Dict[str, int] = {"device_digest": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# dtype support / lane views
# ---------------------------------------------------------------------------

# Sub-byte dtypes report itemsize 1 but have no byte-lane view.
SUB_BYTE_DTYPE_NAMES: Tuple[str, ...] = ("int4", "uint4", "int2", "uint2", "float4_e2m1fn")


def _dtype_name_and_itemsize(dtype: Any) -> Optional[Tuple[str, int]]:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1], dtype.itemsize
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return None
    if dt.hasobject:
        return None
    return dt.name, dt.itemsize


def digest_supported(dtype: Any) -> bool:
    """A fixed-width, byte-aligned, non-complex dtype (torch or numpy) of
    itemsize 1, 2, 4 or 8."""
    info = _dtype_name_and_itemsize(dtype)
    if info is None:
        return False
    name, itemsize = info
    if name.startswith("complex") or name in SUB_BYTE_DTYPE_NAMES:
        return False
    return itemsize in (1, 2, 4, 8)


def lane_bytes(itemsize: int) -> int:
    if itemsize % 4 == 0:
        return 4
    return 2 if itemsize == 2 else 1


_NP_LANE = {4: np.uint32, 2: np.uint16, 1: np.uint8}


# ---------------------------------------------------------------------------
# numpy implementation
# ---------------------------------------------------------------------------


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def digest_host(arr: Any) -> Tuple[int, int]:
    """Digest of the memory image of a numpy array or a CPU tensor.
    Blockwise; block sums are exact because uint32 addition wraps
    associatively."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(f"digest_host takes CPU data, got a tensor on {arr.device}")
        dtype, itemsize = arr.dtype, arr.element_size()
        raw = arr.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    else:
        arr = np.ascontiguousarray(arr)
        dtype, itemsize = arr.dtype, arr.dtype.itemsize
        raw = arr.reshape(-1).view(np.uint8)
    if not digest_supported(dtype):
        raise TypeError(f"digest does not support dtype {dtype}")
    nbytes = raw.nbytes & _MASK
    lanes = raw.view(_NP_LANE[lane_bytes(itemsize)])
    # Plain ints masked to 32 bits: numpy scalar uint32 arithmetic warns on
    # overflow, while array ops wrap silently.
    acc1 = acc2 = 0
    for start in range(0, lanes.size, _HOST_BLOCK_LANES):
        block = lanes[start : start + _HOST_BLOCK_LANES].astype(np.uint32, copy=False)
        idx = np.arange(start, start + block.size, dtype=np.uint64).astype(np.uint32)
        base = idx * np.uint32(_GOLDEN)
        w1 = _mix32_np(base + np.uint32(_SEED1))
        w2 = _mix32_np(base + np.uint32(_SEED2))
        acc1 = (acc1 + int(np.sum(block * w1, dtype=np.uint32))) & _MASK
        acc2 = (acc2 + int(np.sum(block * w2, dtype=np.uint32))) & _MASK
    d1 = int(_mix32_np(np.asarray(acc1 ^ nbytes, dtype=np.uint32))[()])
    d2 = int(_mix32_np(np.asarray(acc2 ^ nbytes, dtype=np.uint32))[()])
    return d1, d2


# ---------------------------------------------------------------------------
# (tensor, row ranges) specs
# ---------------------------------------------------------------------------

# Row ranges of a tensor's dim 0, or None for the whole tensor.
RangeSpec = Optional[Sequence[Tuple[int, int]]]


def _segments(specs: Sequence[Tuple[torch.Tensor, RangeSpec]]):
    """``(contiguous tensor, byte offset, nbytes, lane bytes)`` per output
    row, in spec order with ranges expanded in order. A non-contiguous
    tensor is digested from its ``.contiguous()`` image, which is what
    serialization writes."""
    out = []
    for t, ranges in specs:
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            raise TypeError(f"digest takes dense tensors, got {type(t)}")
        if not digest_supported(t.dtype):
            raise TypeError(f"digest does not support dtype {t.dtype}")
        t = t.detach()
        if not t.is_contiguous():
            t = t.contiguous()
        itemsize = t.element_size()
        lane = lane_bytes(itemsize)
        if ranges is None:
            out.append((t, 0, t.numel() * itemsize, lane))
            continue
        if t.dim() == 0:
            raise ValueError("row ranges need a tensor of at least one dimension")
        row_bytes = itemsize * (t.numel() // t.shape[0] if t.shape[0] else 0)
        for start, stop in ranges:
            if not 0 <= start <= stop <= t.shape[0]:
                raise ValueError(f"row range ({start}, {stop}) outside dim 0 of {tuple(t.shape)}")
            out.append((t, start * row_bytes, (stop - start) * row_bytes, lane))
    return out


# ---------------------------------------------------------------------------
# plain torch implementation
# ---------------------------------------------------------------------------


def _mix32_i64(x: torch.Tensor) -> torch.Tensor:
    """mix32 on int64 tensors holding uint32 values, in place."""
    x ^= x >> 16
    x.mul_(0x7FEB352D).bitwise_and_(_MASK)
    x ^= x >> 15
    x.mul_(0x846CA68B).bitwise_and_(_MASK)
    x ^= x >> 16
    return x


def _plain_one(t: torch.Tensor, offset: int, nbytes: int, lane: int) -> torch.Tensor:
    raw = t.reshape(-1).view(torch.uint8)[offset : offset + nbytes]
    if lane == 4:
        lanes, lane_mask = raw.view(torch.int32), _MASK
    elif lane == 2:
        lanes, lane_mask = raw.view(torch.int16), 0xFFFF
    else:
        lanes, lane_mask = raw, 0xFF
    acc = torch.zeros(2, dtype=torch.int64, device=t.device)
    for start in range(0, lanes.numel(), _PLAIN_BLOCK_LANES):
        v = lanes[start : start + _PLAIN_BLOCK_LANES].to(torch.int64) & lane_mask
        base = torch.arange(start, start + v.numel(), dtype=torch.int64, device=t.device)
        base.bitwise_and_(_MASK).mul_(_GOLDEN).bitwise_and_(_MASK)
        for k, seed in enumerate((_SEED1, _SEED2)):
            w = _mix32_i64((base + seed).bitwise_and_(_MASK))
            acc[k] = (acc[k] + (w.mul_(v).bitwise_and_(_MASK)).sum()) & _MASK
    return _mix32_i64(acc ^ (nbytes & _MASK))


def digest_many_plain(specs: Sequence[Tuple[torch.Tensor, RangeSpec]]) -> torch.Tensor:
    """Plain version of the kernel: ``(n, 2)`` int64 holding the uint32
    digests, on the tensors' device, rows in spec order."""
    rows = [_plain_one(*seg) for seg in _segments(specs)]
    if not rows:
        return torch.empty((0, 2), dtype=torch.int64)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


# The kernel's table, as csrc/device_digest.cu reads it: Segments sorted by
# lane width, then longest first; then one Window per (lane width, window
# index) that some segment reaches.
SEGMENT_DTYPE = np.dtype(
    [("addr", "<i8"), ("nbytes", "<i8"), ("row", "<i4"), ("lane_bytes", "<i4")]
)
WINDOW_DTYPE = np.dtype(
    [("item_begin", "<i4"), ("seg_begin", "<i4"), ("n_reach", "<i4"), ("index", "<i4")]
)

_DTYPE = operator.attrgetter("dtype")
_NBYTES = operator.attrgetter("nbytes")

# Lane bytes of every torch dtype the digest takes.
_TORCH_LANE_BYTES: Dict[torch.dtype, int] = {
    d: lane_bytes(d.itemsize)
    for d in vars(torch).values()
    if isinstance(d, torch.dtype) and digest_supported(d)
}


class DigestTable(NamedTuple):
    """The kernel's table for some specs. ``buffer`` holds ``segments`` then
    ``windows``; ``n_items`` is the number of (window, slice) items, one
    block each; ``tensors`` are the contiguous images the addresses point
    into, kept alive until the launch."""

    buffer: np.ndarray
    segments: np.ndarray
    windows: np.ndarray
    n_items: int
    tensors: List[torch.Tensor]


def items_per_window(n_reach: np.ndarray) -> np.ndarray:
    """Items of windows that ``n_reach`` segments reach: slices of at most
    SLICE_SEGMENTS, of equal length +-1 (item i of k holds segments
    [i n / k, (i + 1) n / k) of the window's prefix)."""
    return -(-n_reach // SLICE_SEGMENTS)


def build_table(specs: Sequence[Tuple[torch.Tensor, RangeSpec]]) -> DigestTable:
    """The kernel's table for ``specs`` (tensors of one device, CPU or
    CUDA). Each tensor's attributes are read through ``map``; the rows'
    order and windows depend only on the layout (dtypes, bytes, row
    ranges), which :func:`_plan` computes over numpy arrays and caches, so
    a take that digests the same layout at every step pays it once."""
    if not specs:
        raise ValueError("no specs")
    tensors = [t for t, _ in specs]
    try:
        dtypes = tuple(map(_DTYPE, tensors))
    except AttributeError:
        raise TypeError("digest takes dense tensors") from None
    unsupported = set(dtypes).difference(_TORCH_LANE_BYTES)
    if unsupported:
        raise TypeError(f"digest does not support dtype {unsupported.pop()}")
    if len(set(map(torch.Tensor.get_device, tensors))) != 1:
        raise ValueError("digest_many_async takes tensors of one device; group them by device")
    try:
        if not all(map(torch.Tensor.is_contiguous, tensors)):
            tensors = [t if t.is_contiguous() else t.contiguous() for t in tensors]
        addr = np.fromiter(map(torch.Tensor.data_ptr, tensors), dtype=np.int64, count=len(tensors))
        nbytes = tuple(map(_NBYTES, tensors))
    except RuntimeError:  # a sparse or opaque layout: no data pointer
        raise TypeError("digest takes dense tensors") from None
    ranged = []
    for i, (t, r) in enumerate(specs):
        if r is not None:
            if t.dim() == 0:
                raise ValueError("row ranges need a tensor of at least one dimension")
            ranged.append((i, t.shape[0], r))
    key = (dtypes, nbytes, tuple(ranged))
    try:
        plan = _plan(key)
    except TypeError:  # ranges given as lists: unhashable
        plan = _plan.__wrapped__(key)
    if plan.spec is not None:
        addr = addr[plan.spec] + plan.offset
    if (addr % plan.lane).any():
        k = int(np.flatnonzero(addr % plan.lane)[0])
        raise ValueError(f"segment at {int(addr[k]):#x} is not aligned to its {int(plan.lane[k])}-byte lanes")
    buffer = plan.buffer.copy()
    n = plan.order.size
    segments = buffer[: n * SEGMENT_DTYPE.itemsize].view(SEGMENT_DTYPE)
    segments["addr"] = addr[plan.order]
    return DigestTable(buffer, segments, buffer[n * SEGMENT_DTYPE.itemsize :].view(WINDOW_DTYPE),
                       plan.n_items, tensors)


class _Plan(NamedTuple):
    spec: Optional[np.ndarray]  # each row's spec (None: one row per spec)
    offset: Optional[np.ndarray]  # each row's byte offset in its tensor
    lane: np.ndarray  # each row's lane bytes
    order: np.ndarray  # the rows, sorted
    buffer: np.ndarray  # the table, addresses unset
    n_items: int


@functools.lru_cache(maxsize=16)
def _plan(key) -> _Plan:
    """The table of a layout ``(dtype per spec, bytes per spec,
    ((spec, dim-0 length, row ranges), ...) of the specs with ranges))``:
    rows in spec order, each spec's ranges in order, sorted by lane width
    and then longest first; within a group, the segments that reach window
    j are those longer than j * WINDOW_BYTES."""
    dtypes, nbytes, ranged = key
    lane = np.array([_TORCH_LANE_BYTES[d] for d in dtypes], dtype=np.int64)
    nbytes = np.array(nbytes, dtype=np.int64)
    spec = offset = None
    if ranged:
        n_specs = lane.size
        idx = [i for i, _, _ in ranged]
        counts = np.ones(n_specs, dtype=np.int64)
        counts[idx] = [len(r) for _, _, r in ranged]
        n0 = np.ones(n_specs, dtype=np.int64)
        n0[idx] = [n for _, n, _ in ranged]
        row_bytes = nbytes // np.maximum(n0, 1)
        spec = np.repeat(np.arange(n_specs), counts)
        flat = np.array(
            list(itertools.chain.from_iterable(itertools.chain.from_iterable(r for _, _, r in ranged))),
            dtype=np.int64,
        ).reshape(-1, 2)
        start = np.zeros(spec.size, dtype=np.int64)
        stop = np.ones(spec.size, dtype=np.int64)
        is_ranged = np.zeros(n_specs, dtype=bool)
        is_ranged[idx] = True
        rows = is_ranged[spec]
        start[rows], stop[rows] = flat[:, 0], flat[:, 1]
        bad = np.flatnonzero((start < 0) | (start > stop) | (stop > n0[spec]))
        if bad.size:
            k = int(bad[0])
            raise ValueError(f"row range ({start[k]}, {stop[k]}) outside dim 0 of length {n0[spec[k]]}")
        offset = start * row_bytes[spec]
        nbytes = (stop - start) * row_bytes[spec]
        lane = lane[spec]
    order = np.argsort(-((lane << 56) | nbytes), kind="stable")
    sorted_nbytes, sorted_lane = nbytes[order], lane[order]
    n = order.size
    bounds = [0, *(np.flatnonzero(np.diff(sorted_lane)) + 1).tolist(), n] if n else [0]
    seg_begin, reach = [], []
    for g0, g1 in zip(bounds[:-1], bounds[1:]):  # at most 3 lane widths
        n_windows = -(-int(sorted_nbytes[g0]) // WINDOW_BYTES)
        reach.append(np.searchsorted(
            -sorted_nbytes[g0:g1], np.arange(0, -n_windows * WINDOW_BYTES, -WINDOW_BYTES), side="left"
        ))
        seg_begin.append(g0)
    sizes = [r.size for r in reach]
    m = sum(sizes)
    buffer = np.zeros(n * SEGMENT_DTYPE.itemsize + m * WINDOW_DTYPE.itemsize, dtype=np.uint8)
    segments = buffer[: n * SEGMENT_DTYPE.itemsize].view(SEGMENT_DTYPE)
    windows = buffer[n * SEGMENT_DTYPE.itemsize :].view(WINDOW_DTYPE)
    segments["nbytes"] = sorted_nbytes
    segments["row"] = order
    segments["lane_bytes"] = sorted_lane
    n_items = 0
    if m:
        reach = np.concatenate(reach)
        items = items_per_window(reach)
        ends = np.cumsum(items)
        windows["item_begin"] = ends - items
        windows["seg_begin"] = np.repeat(seg_begin, sizes)
        windows["n_reach"] = reach
        windows["index"] = np.concatenate([np.arange(k) for k in sizes])
        n_items = int(ends[-1])
    if n_items >= 2**31 or n >= 2**31:
        raise ValueError(f"digest table too large: {n} segments, {n_items} items")
    for a in (spec, offset, lane, order, buffer):
        if a is not None:
            a.flags.writeable = False  # shared by every call of the layout
    return _Plan(spec, offset, lane, order, buffer, n_items)


def _library() -> ctypes.CDLL:
    lib = kernels.library("device_digest")
    if not getattr(lib, "_ts_declared", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ts_digest_many.argtypes = [ptr, i64, ptr, i32, i32, i32, i64, i32, ptr, ptr]
        lib.ts_digest_many.restype = i32
        lib._ts_declared = True
    return lib


def digest_many_async(specs: Sequence[Tuple[torch.Tensor, RangeSpec]]) -> torch.Tensor:
    """Digest many tensors (each whole, or per dim-0 row range) in one
    launch. ``specs`` is ``[(tensor, row_ranges | None), ...]``, all on one
    device. Returns ``(n, 2)`` digests, rows in spec order (ranges expanded
    in order): on a CUDA card an int32 tensor holding the uint32 bits,
    written by the kernel on the current stream (one 8n-byte copy to the
    host reads it); on the CPU the plain version's int64."""
    if not specs:
        return torch.empty((0, 2), dtype=torch.int64)
    device = specs[0][0].device
    if device.type == "cpu":
        if any(t.device != device for t, _ in specs):
            raise ValueError("digest_many_async takes tensors of one device; group them by device")
        return digest_many_plain(specs)
    if device.type != "cuda":
        raise ValueError(f"digest_many_async takes CPU or CUDA tensors, got {device}")
    table = build_table(specs)
    lib = _library()
    n = len(table.segments)
    scratch = torch.empty(table.buffer.nbytes, dtype=torch.uint8, device=device)
    out = torch.empty((n, 2), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.ts_digest_many(
            table.buffer.ctypes.data, table.buffer.nbytes, scratch.data_ptr(), n,
            len(table.windows), table.n_items, WINDOW_BYTES, SLICE_SEGMENTS, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"device_digest: CUDA error {err} at launch")
    launch_counts["device_digest"] += 1
    return out


def materialize_many(digests: torch.Tensor) -> np.ndarray:
    """Block on a :func:`digest_many_async` result: ``(n, 2)`` uint32."""
    return digests.cpu().numpy().astype(np.uint32)


def digest_bytes(specs: Sequence[Tuple[torch.Tensor, RangeSpec]]) -> int:
    """Bytes the digests of ``specs`` read (each once)."""
    return sum(nbytes for _, _, nbytes, _ in _segments(specs))


# ---------------------------------------------------------------------------
# string form (what manifests carry)
# ---------------------------------------------------------------------------


def format_digest(d: Tuple[int, int]) -> str:
    return f"{DIGEST_PREFIX}{d[0]:08x}{d[1]:08x}"


__all__ = [
    "DIGEST_PREFIX",
    "digest_bytes",
    "digest_host",
    "digest_many_async",
    "digest_many_plain",
    "digest_supported",
    "format_digest",
    "launch_counts",
    "materialize_many",
    "reset_launch_counts",
]
