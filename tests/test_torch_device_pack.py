"""The port's device pack (``ops/device_pack.py``): the plain version's
bytes against the JAX package's pack and the serializer's, the kernel's
table, and batched snapshots that stage a slab's members through one pack
and one copy to the host.

Port of the JAX package's ``tests/test_device_pack.py``. On the CPU the
wrapper runs the plain version (``torch.cat`` of the members' uint8
views), as the JAX package's pack runs its XLA program on the CPU backend;
the kernel itself is held against it on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``). Deliberate
difference: the JAX package falls back to per-member staging when a pack
fails (its ``test_pack_failure_falls_back`` and
``test_pack_fallback_skips_already_scattered_members``); the port raises,
so the take fails and leaves no commit marker
(``test_pack_failure_fails_the_take``). Its group cap of 128 members per
dispatch (a compile-time bound of the XLA program) has no counterpart: one
kernel launch packs a slab's members of one device, however many.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch.io_preparer import ArrayBufferStager, DeviceCopier
from torchsnapshot_tpu_torch.io_types import BufferList, WriteReq
from torchsnapshot_tpu_torch.knobs import (
    enable_batching,
    enable_device_pack,
    override_slab_size_threshold_bytes,
)
from torchsnapshot_tpu_torch.ops import device_pack as dp
from torchsnapshot_tpu_torch.serialization import tensor_as_memoryview
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME

torch.set_num_threads(1)

DTYPES = [
    "float32", "float16", "bfloat16", "float64", "int8", "uint8", "int16", "int32",
    "int64", "bool", "float8_e4m3fn", "float8_e5m2",
]


def _np_array(shape, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype.startswith(("int", "uint")):
        return rng.integers(-100 if dtype.startswith("int") else 0, 100, shape).astype(dtype)
    x = (rng.standard_normal(shape) * 10).astype(np.float32)
    if dtype in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        import ml_dtypes

        return x.astype(getattr(ml_dtypes, dtype))
    return x.astype(dtype)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    from torchsnapshot_tpu_torch.serialization import tensor_from_numpy

    return tensor_from_numpy(arr).clone()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_plain_matches_the_jax_pack_and_the_serializer(dtype) -> None:
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import device_pack as jdp
    from torchsnapshot_tpu.serialization import array_as_memoryview
    from torchsnapshot_tpu.test_utils import backend_materializes_dtype

    hosts = [_np_array((5, 3), dtype, seed=i) for i in range(3)]
    packed = dp.pack_async([(_tensor(h), None) for h in hosts])
    assert packed.dtype == torch.uint8 and packed.device.type == "cpu"
    expect = b"".join(bytes(array_as_memoryview(h)) for h in hosts)
    assert packed.numpy().tobytes() == expect
    assert packed.numpy().tobytes() == b"".join(
        bytes(tensor_as_memoryview(_tensor(h))) for h in hosts
    )
    # Without x64, jax keeps 64-bit dtypes as 32-bit: no JAX pack to hold.
    if backend_materializes_dtype(dtype) and jnp.asarray(hosts[0]).dtype == hosts[0].dtype:
        theirs = np.asarray(jdp.pack_async([(jnp.asarray(h), None) for h in hosts]))
        assert theirs.tobytes() == packed.numpy().tobytes()


def test_pack_row_slices_match_the_jax_pack() -> None:
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import device_pack as jdp

    host = _np_array((16, 4), "float32", seed=1)
    specs = [((2, 7)), ((10, 12)), ((0, 0))]
    packed = dp.pack_async([(_tensor(host), s) for s in specs])
    assert packed.numpy().tobytes() == host[2:7].tobytes() + host[10:12].tobytes()
    theirs = np.asarray(jdp.pack_async([(jnp.asarray(host), s) for s in specs[:2]]))
    assert theirs.tobytes() == packed.numpy().tobytes()
    with pytest.raises(ValueError, match="row range"):
        dp.pack_async([(_tensor(host), (3, 17))])


def test_pack_supported_excludes_complex() -> None:
    assert not dp.pack_supported(torch.complex64)
    assert dp.pack_supported(torch.float32) and dp.pack_supported(torch.bool)
    assert not dp.pack_supported(np.float32)  # a torch dtype is expected


def test_kernel_table_layout_and_the_contiguous_copy() -> None:
    """The table the kernel reads: n + 1 slab offsets (empty and 1-byte
    members included), each member's source address, then per tile the
    member that holds its first byte; a member that is not contiguous is
    copied first, and counted."""
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = torch.zeros(0)
    c = torch.ones(1, dtype=torch.uint8)
    d = torch.arange(20, dtype=torch.float32).reshape(4, 5)[:, 1::2]  # not contiguous
    dp.reset_launch_counts()
    table, total, members = dp.build_table([(a, (1, 3)), (b, None), (c, None), (d, None)])
    assert dp.copy_counts["device_pack_contiguous"] == 1
    assert total == 2 * 16 + 0 + 1 + 4 * 2 * 4
    assert table[:5].tolist() == [0, 32, 32, 33, total]
    assert table[5] == a.data_ptr() + 16
    assert table[7] == c.data_ptr()
    assert table[9:].tolist() == [0]  # one tile, whose first byte is a's
    assert members[3].is_contiguous() and torch.equal(members[3], d)
    assert dp.launch_counts["device_pack"] == 0  # nothing launched on the CPU
    assert dp.pack_plain([(d, None)]).numpy().tobytes() == d.contiguous().numpy().tobytes()


def _random_specs(seed: int, n: int) -> list:
    """``n`` members of a random layout, made from a seed: sizes of 0, 1,
    odd, a few 16-byte units and longer than a tile, of several dtypes;
    every fifth member a row range (odd rows included) of a uint8 table
    whose rows are 1, 3 or 7 bytes wide."""
    rng = np.random.default_rng(seed)
    dtypes = [torch.uint8, torch.bfloat16, torch.float32, torch.int64, torch.bool]
    long_bytes = dp.TILE_BYTES + int(rng.integers(1, 3 * dp.TILE_BYTES))
    specs = []
    for i in range(n):
        kind = rng.integers(0, 10)
        if i % 5 == 4:
            width = int(rng.choice([1, 3, 7]))
            rows = int(rng.integers(1, 64))
            base = torch.from_numpy(rng.integers(0, 256, (rows, width), dtype=np.uint8))
            start = int(rng.integers(0, rows + 1))
            specs.append((base, (start, int(rng.integers(start, rows + 1)))))
            continue
        dtype = dtypes[int(rng.integers(0, len(dtypes)))]
        if kind == 0:
            nbytes = 0
        elif kind == 1:
            nbytes = 1
        elif kind == 2 and n <= 64:
            nbytes = long_bytes
        elif kind < 6:
            nbytes = 2 * int(rng.integers(0, 40)) + 1
        else:
            nbytes = 16 * int(rng.integers(1, 20))
        numel = max(0, nbytes // dtype.itemsize)
        raw = rng.integers(0, 256, numel * dtype.itemsize, dtype=np.uint8)
        if dtype == torch.bool:
            t = torch.from_numpy(raw % 2 == 1)
        else:
            t = torch.from_numpy(raw).view(dtype) if numel else torch.empty(0, dtype=dtype)
        specs.append((t, None))
    return specs


def _member_bytes(specs) -> np.ndarray:
    return np.array([dp.pack_bytes([s]) for s in specs], dtype=np.int64)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 9), (3, 64), (4, 300), (5, 2000), (6, 10_000)])
def test_tile_table_names_each_tiles_first_member(seed, n) -> None:
    """Per tile of ``TILE_BYTES``, the table names the last member with a
    byte at or before the tile's start: the member that holds it, never
    one of zero bytes."""
    specs = _random_specs(seed, n)
    table, total, _ = dp.build_table(specs)
    sizes = _member_bytes(specs)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    assert total == starts[-1] and table[: n + 1].tolist() == starts.tolist()
    tiles = table[2 * n + 1 :]
    assert len(tiles) == -(-total // dp.TILE_BYTES)
    nonempty = np.flatnonzero(sizes > 0)
    for t, first in enumerate(tiles.tolist()):
        p = t * dp.TILE_BYTES
        want = max(i for i in nonempty.tolist() if starts[i] <= p)
        assert first == want, (t, first, want)
        assert starts[first] <= p < starts[first + 1]


def _kernel_model(table: np.ndarray, n: int, total: int) -> bytes:
    """A numpy model of ``csrc/device_pack.cu`` on CPU members, whose
    table addresses are this process's memory. Per tile: one bulk copy per
    member whose source sits at a 16-byte-aligned distance from its slab
    offset, of its whole units in the tile; the owner of each unit from the
    members' marks and a prefix maximum; a unit inside a member at an odd
    distance from the aligned 16-byte source words that hold its bytes,
    shifted into place per 32-bit word as ``__funnelshift_r`` does (the
    model asserts that each word holds a byte of the member); a unit that
    straddles two members from the words that hold the tail of one and the
    head of the other; a unit over more members byte by byte, stepping
    over empty members.
    It asserts that the bulk copies and the threads' units cover each tile
    once. Returns the slab's bytes."""
    import ctypes

    tile_units = dp.TILE_BYTES // 16
    offsets, srcs, tiles = table[: n + 1], table[n + 1 : 2 * n + 1], table[2 * n + 1 :]
    windows = {}

    def window(j: int):
        """Member j's bytes with the rest of their aligned 16-byte words."""
        if j not in windows:
            lo = int(srcs[j]) & ~15
            hi = -(-(int(srcs[j]) + int(offsets[j + 1] - offsets[j])) // 16) * 16
            windows[j] = (lo, np.frombuffer(ctypes.string_at(lo, hi - lo), dtype=np.uint8))
        return windows[j]

    def member_bytes(j: int, p: int, q: int) -> np.ndarray:
        """Slab bytes [p, q) of member j."""
        base, mem = window(j)
        at = int(srcs[j]) + p - int(offsets[j]) - base
        return mem[at : at + q - p]

    def load_bytes(j: int, a: int, c: int) -> np.ndarray:
        """Bytes [a, a + c) of member j from the one or two aligned words
        that hold them, each of which holds a byte of the member."""
        base, mem = window(j)
        words = range(a & ~15, a + c, 16)
        assert len(words) <= 2 and all(base <= w and w + 16 <= base + len(mem) for w in words)
        return mem[a - base : a - base + c]

    out = np.zeros(-(-total // 16) * 16, dtype=np.uint8)
    for t in range(len(tiles)):
        t0 = t * dp.TILE_BYTES
        t1 = min(t0 + dp.TILE_BYTES, total)
        first = int(tiles[t])
        last = int(tiles[t + 1]) if t + 1 < len(tiles) else n - 1
        covered = np.zeros(-(-(t1 - t0) // 16), dtype=np.int64)
        for j in range(first, last + 1):
            b, e = int(offsets[j]), int(offsets[j + 1])
            lo, hi = max(-(-b // 16) * 16, t0), min(e // 16 * 16, t1)
            if hi > lo and (int(srcs[j]) - b) % 16 == 0:
                out[lo:hi] = member_bytes(j, lo, hi)
                covered[(lo - t0) // 16 : (hi - t0) // 16] += 1
        js = np.arange(1, last - first + 1)
        u = (offsets[first + js] - t0 + 15) >> 4
        mark = (u < tile_units) & (u != np.append(u[1:], -1))
        own = np.zeros(tile_units, dtype=np.int64)
        own[u[mark]] = js[mark]
        own = np.maximum.accumulate(own)
        for unit in range(len(covered)):
            pos = t0 + 16 * unit
            j = first + int(own[unit])
            if pos + 16 <= offsets[j + 1]:
                a = int(srcs[j]) + pos - int(offsets[j])
                k = a & 15
                if k == 0:
                    continue  # the bulk copy's
                covered[unit] += 1
                base, mem = window(j)
                words = [a - k, a - k + 16]
                assert all(base <= w and w + 16 <= base + len(mem) for w in words)
                x = np.concatenate([mem[w - base : w - base + 16] for w in words]).view("<u4").astype(np.uint64)
                ws, sh = k >> 2, (k & 3) * 8
                y = x[ws : ws + 5]
                r = ((y[:4] >> np.uint64(sh)) | (y[1:] << np.uint64(32 - sh))) & np.uint64(0xFFFFFFFF)
                out[pos : pos + 16] = r.astype("<u4").view(np.uint8)
                continue
            covered[unit] += 1
            b, e = int(offsets[j]), int(offsets[j + 1])
            end = min(pos + 16, total)
            na = min(e, end) - pos
            nb = end - pos - na
            if nb == 0 or offsets[j + 2] >= end:
                # The tail of j and the head of j + 1, each from its words.
                out[pos : pos + na] = load_bytes(j, int(srcs[j]) + pos - b, na)
                if nb:
                    out[pos + na : end] = load_bytes(j + 1, int(srcs[j + 1]), nb)
                continue
            for p in range(pos, end):
                while p >= e:
                    j += 1
                    b, e = e, int(offsets[j + 1])
                out[p] = member_bytes(j, p, p + 1)[0]
        assert (covered == 1).all(), t
    return out[:total].tobytes()


@pytest.mark.parametrize("seed,n", [(10, 1), (11, 5), (12, 40), (13, 64), (14, 700), (15, 3000)])
def test_kernel_model_reassembles_the_plain_pack(seed, n) -> None:
    """The kernel's tile walk, modelled in numpy over the table and the
    members' memory, gives ``pack_plain``'s bytes bit for bit."""
    specs = _random_specs(seed, n)
    table, total, members = dp.build_table(specs)
    assert _kernel_model(table, n, total) == dp.pack_plain(specs).numpy().tobytes()
    del members


def test_kernel_model_at_odd_distances_over_tiles() -> None:
    """Every member after the first at an odd distance from 16-byte
    alignment (4,093 bytes each), a member that spans several tiles at an
    odd distance, and empty members on a tile boundary."""
    rng = np.random.default_rng(7)

    def u8(nbytes):
        return torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8))

    specs = [(u8(4093), None) for _ in range(12)]
    specs += [(u8(3 * dp.TILE_BYTES + 5), None)]
    pad = dp.TILE_BYTES * 8 - sum(dp.pack_bytes([s]) for s in specs)
    specs += [(u8(pad), None), (u8(0), None), (u8(0), None), (u8(33), None)]
    table, total, _ = dp.build_table(specs)
    n = len(specs)
    assert table[n + 1 - 4] == table[n + 1 - 3] == 8 * dp.TILE_BYTES  # the empties sit on a tile boundary
    assert table[2 * n + 1 + 8] == n - 1  # the tile there starts at the member after them
    assert _kernel_model(table, n, total) == dp.pack_plain(specs).numpy().tobytes()


def test_batcher_layout_equals_the_plain_table() -> None:
    """The layout the batcher makes once per slab, from the members'
    planned sizes and row ranges, is the table the plain specs give: the
    same offsets and tiles, and the same addresses from ``data_ptr``
    alone; a member that is not contiguous is named for a copy."""
    from torchsnapshot_tpu_torch import batcher

    copier = DeviceCopier()
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.integers(0, 256, (40, 7), dtype=np.uint8))
    strided = torch.arange(20, dtype=torch.float32).reshape(4, 5)[:, 1::2]
    stagers = [
        ArrayBufferStager(big, copier, slc=slice(3, 17)),
        ArrayBufferStager(torch.zeros(0), copier),
        ArrayBufferStager(torch.ones(5, dtype=torch.bfloat16), copier),
        ArrayBufferStager(big, copier, slc=slice(17, 40)),
        ArrayBufferStager(strided, copier),
    ]
    items, off = [], 0
    for i, st in enumerate(stagers):
        size = st.get_staging_cost_bytes()
        items.append((WriteReq(path=f"p{i}", buffer_stager=st), off, size))
        off += size
    with enable_device_pack():
        stager = batcher.BatchedBufferStager(items)
    (group,) = stager._packed
    layout = group.layout
    specs = [(st.tensor, rows) for st, rows in zip(stagers, group.rows)]
    assert group.rows == [(3, 17), None, None, (17, 40), None]
    assert layout.copy_members == (4,)
    table, total, members = dp.build_table(specs)
    n = len(specs)
    assert layout.total == total == off
    assert layout.table[: n + 1].tolist() == table[: n + 1].tolist()
    assert layout.table[2 * n + 1 :].tolist() == table[2 * n + 1 :].tolist()
    got = layout.addresses([st.tensor for st in stagers])
    assert got[:4].tolist() == table[n + 1 : n + 5].tolist()
    assert got[0] == big.data_ptr() + 3 * 7 and got[3] == big.data_ptr() + 17 * 7
    assert dp.pack_async(specs, layout=layout).numpy().tobytes() == dp.pack_plain(specs).numpy().tobytes()


@pytest.mark.parametrize(
    "slc, planned, match",
    [
        (slice(3, 41), 38 * 7, "outside dim 0"),
        (slice(5, 3), 0, "outside dim 0"),
        (slice(0, 40, 2), 20 * 7, "outside dim 0"),
        (slice(3, 17), 14 * 7 + 1, "planned at"),
        (None, 40 * 7 - 16, "planned at"),
    ],
)
def test_batcher_layout_refuses_a_member_it_would_misread(slc, planned, match) -> None:
    """A launch with a layout reads only the members' addresses, so the
    slab's plan is checked once when the layout is made: a row range
    outside dim 0, or a planned size that is not the member's bytes,
    raises there instead of letting the kernel read past a member."""
    from torchsnapshot_tpu_torch import batcher

    copier = DeviceCopier()
    big = torch.zeros(40, 7, dtype=torch.uint8)
    other = ArrayBufferStager(torch.ones(4), copier)
    items = [
        (WriteReq(path="bad", buffer_stager=ArrayBufferStager(big, copier, slc=slc)), 0, planned),
        (WriteReq(path="ok", buffer_stager=other), planned, 16),
    ]
    with enable_device_pack(), pytest.raises(ValueError, match=match):
        batcher.BatchedBufferStager(items)


def _spy(monkeypatch) -> list:
    calls = []
    orig = dp.pack_async

    def counting(specs, layout=None):
        calls.append(len(specs))
        return orig(specs, layout=layout)

    monkeypatch.setattr(dp, "pack_async", counting)
    return calls


def test_batched_snapshot_uses_device_pack(tmp_path, monkeypatch) -> None:
    """With batching and the pack on, a slab's tensor members stage
    through one pack call; the restore is bit-exact."""
    calls = _spy(monkeypatch)
    tree = {f"leaf_{i}": _tensor(_np_array((32, 8), "float32", seed=i)) for i in range(6)}
    tree["obj"] = {"not": "a tensor"}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == [6]
    dest = {"m": TensorTreeState({**{k: torch.zeros(32, 8) for k in tree if k != "obj"}, "obj": None})}
    Snapshot(p).restore(dest)
    for k, v in tree.items():
        if k != "obj":
            assert torch.equal(dest["m"].tree[k], v), k
    assert dest["m"].tree["obj"] == tree["obj"]


def test_one_pack_per_slab_however_many_members(tmp_path, monkeypatch) -> None:
    """300 members (over the JAX package's cap of 128 a dispatch) in one
    slab: one pack."""
    calls = _spy(monkeypatch)
    tree = {f"l{i:03d}": torch.full((4,), float(i)) for i in range(300)}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack():
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == [300]
    assert Snapshot(p).read_object("0/m/l123").tolist() == [123.0] * 4


def test_batched_snapshot_mixed_dtypes_roundtrip(tmp_path) -> None:
    tree = {f"a_{dt}": _tensor(_np_array((7, 3), dt, seed=i)) for i, dt in enumerate(DTYPES)}
    p = str(tmp_path / "snap")
    with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    dest = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in tree.items()})}
    Snapshot(p).restore(dest)
    for k, v in tree.items():
        assert bytes(tensor_as_memoryview(dest["m"].tree[k])) == bytes(tensor_as_memoryview(v)), k


def test_pack_failure_fails_the_take(tmp_path, monkeypatch) -> None:
    """No fallback: a failing pack raises out of the take, and no commit
    marker is written."""

    def boom(specs, layout=None):
        raise RuntimeError("injected pack failure")

    monkeypatch.setattr(dp, "pack_async", boom)
    tree = {f"leaf_{i}": _tensor(_np_array((8, 8), "float32", seed=i)) for i in range(4)}
    for name, vectorized in (("vec", knobs.enable_write_vectorized), ("packed", knobs.disable_write_vectorized)):
        p = str(tmp_path / name)
        with enable_batching(), enable_device_pack(), override_slab_size_threshold_bytes(1 << 20), vectorized():
            with pytest.raises(RuntimeError, match="injected pack failure"):
                Snapshot.take(p, {"m": TensorTreeState(tree)})
        assert not os.path.exists(os.path.join(p, SNAPSHOT_METADATA_FNAME))


def test_batched_stager_cost_stable_across_staging() -> None:
    """The staging cost is fixed at construction: staging clears the
    members' tensors, and a later read must see the admission value."""
    from torchsnapshot_tpu_torch import batcher

    copier = DeviceCopier()
    tensors = [_tensor(_np_array((8, 8), "float32", seed=i)) for i in range(2)]
    size = tensors[0].numel() * 4
    items = [
        (WriteReq(path=f"p{i}", buffer_stager=ArrayBufferStager(t, copier)), i * size, size)
        for i, t in enumerate(tensors)
    ]
    for vectorized in (knobs.enable_write_vectorized, knobs.disable_write_vectorized):
        for req, _, _ in items:
            req.buffer_stager.tensor = tensors[int(req.path[1:])]
        with enable_device_pack(), vectorized():
            stager = batcher.BatchedBufferStager(items)
        cost_before = stager.get_staging_cost_bytes()
        buf = asyncio.run(stager.stage_buffer())
        assert len(buf) == 2 * size
        data = buf.consolidate() if isinstance(buf, BufferList) else buf
        assert bytes(data) == b"".join(t.numpy().tobytes() for t in tensors)
        assert stager.get_staging_cost_bytes() == cost_before


def test_device_pack_off_by_default(tmp_path, monkeypatch) -> None:
    calls = _spy(monkeypatch)
    tree = {f"leaf_{i}": torch.full((8,), float(i)) for i in range(4)}
    p = str(tmp_path / "snap")
    with enable_batching(), override_slab_size_threshold_bytes(1 << 20):
        Snapshot.take(p, {"m": TensorTreeState(tree)})
    assert calls == []
    assert os.listdir(os.path.join(p, "batched"))
