"""The port's digest (``ops/device_digest.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX package's
``digest_host`` and ``digest_many_async`` (on CPU jax arrays) and through
the port's ``digest_host`` and plain torch version (what the kernel wrapper
runs for a CPU tensor). Tolerance: none, the digests must be equal bit for
bit; that is what lets an incremental take of either package use a base
written by the other. The CUDA kernel is held to the same plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import ctypes

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torchsnapshot_tpu.ops import device_digest as jdd
from torchsnapshot_tpu_torch.ops import device_digest as dd
from torchsnapshot_tpu_torch.serialization import tensor_from_numpy

# One intra-op thread: the suite runs this file beside others in parallel
# workers.
torch.set_num_threads(1)

# Every digestible dtype of the serialization table, by lane width (the
# JAX package's tests/test_device_digest.py list).
DTYPES = [
    "float32", "float16", "bfloat16", "float64", "int8", "uint8", "int16",
    "int32", "uint32", "int64", "bool", "float8_e4m3fn",
]
SHAPES = [(7,), (4, 5), (1,), (), (3, 2, 2), (0,), (33, 17)]


def _np_array(shape, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bool":
        return f > 0
    if dtype in ("bfloat16", "float8_e4m3fn"):
        return f.astype(getattr(ml_dtypes, dtype))
    if dtype.startswith(("int", "uint")):
        return rng.integers(0, 1 << 15, shape).astype(dtype)
    return (f * 100).astype(dtype)


def _rows(result) -> list:
    return [tuple(int(x) for x in row) for row in dd.materialize_many(result)]


def _jax_device_ok(dtype: str) -> bool:
    # 64-bit device arrays need x64; without it jax narrows them.
    return dtype not in ("float64", "int64") or jax.config.read("jax_enable_x64")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_digests_equal_the_jax_package(dtype, shape) -> None:
    host = _np_array(shape, dtype, seed=3)
    want = jdd.digest_host(host)
    t = tensor_from_numpy(host)
    assert dd.digest_host(host) == want
    assert dd.digest_host(t) == want
    before = dict(dd.launch_counts)
    assert _rows(dd.digest_many_async([(t, None)])) == [want]
    assert _rows(dd.digest_many_plain([(t, None)])) == [want]
    assert dd.launch_counts == before  # a CPU tensor runs the plain version
    if _jax_device_ok(dtype):
        assert jdd.materialize(jdd.digest_device_async(jnp.asarray(host))) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_ranges_and_batches_equal_the_jax_package(dtype) -> None:
    a = _np_array((16, 8), dtype, seed=7)
    b = _np_array((5, 3, 2), dtype, seed=8)
    ranges = ((0, 3), (3, 16), (5, 5), (15, 16))
    specs = [(tensor_from_numpy(a), ranges), (tensor_from_numpy(b), None)]
    want = [jdd.digest_host(a[s:e]) for s, e in ranges] + [jdd.digest_host(b)]
    assert _rows(dd.digest_many_async(specs)) == want
    if _jax_device_ok(dtype):
        got = jdd.materialize_many(
            jdd.digest_many_async([(jnp.asarray(a), ranges), (jnp.asarray(b), None)])
        )
        assert [tuple(int(x) for x in row) for row in got] == want


def test_non_contiguous_view_is_digested_from_its_contiguous_image() -> None:
    base = _np_array((10, 10), "float32", seed=9)
    view = tensor_from_numpy(base)[:, ::2]
    assert not view.is_contiguous()
    want = jdd.digest_host(np.ascontiguousarray(base[:, ::2]))
    assert dd.digest_host(view) == want
    assert _rows(dd.digest_many_async([(view, ((2, 7),))])) == [
        jdd.digest_host(np.ascontiguousarray(base[2:7, ::2]))
    ]


def test_blockwise_sums_match_whole(monkeypatch) -> None:
    arr = tensor_from_numpy(_np_array((3, 1 << 12), "float32", seed=5))
    whole = dd.digest_host(arr)
    monkeypatch.setattr(dd, "_HOST_BLOCK_LANES", 1000)
    monkeypatch.setattr(dd, "_PLAIN_BLOCK_LANES", 999)
    assert dd.digest_host(arr) == whole
    assert _rows(dd.digest_many_plain([(arr, None)])) == [whole]


def test_digest_is_sensitive_to_bits_position_and_length() -> None:
    base = _np_array((64, 64), "float32", seed=1)
    flipped = base.copy()
    flipped.reshape(-1).view(np.uint8)[12345] ^= 1
    assert dd.digest_host(flipped) != dd.digest_host(base)
    a = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    assert dd.digest_host(a) != dd.digest_host(a.flip(0))
    assert dd.digest_host(torch.zeros(8, dtype=torch.uint8)) != dd.digest_host(
        torch.zeros(9, dtype=torch.uint8)
    )


def test_format_digest_and_unsupported_dtypes() -> None:
    assert dd.format_digest((0x1234ABCD, 0x00FF00FF)) == "mlh64:1234abcd00ff00ff"
    assert dd.format_digest((1, 2)) == jdd.format_digest((1, 2))
    for dtype in (torch.complex64, np.complex128, ml_dtypes.int4, ml_dtypes.uint4, object):
        assert not dd.digest_supported(dtype)
    for dtype in (torch.bfloat16, torch.float8_e5m2, torch.uint16, np.float64, "int8"):
        assert dd.digest_supported(dtype)
    with pytest.raises(TypeError):
        dd.digest_host(torch.zeros(3, dtype=torch.complex64))
    with pytest.raises(TypeError):
        dd.digest_many_async([(torch.zeros(3, dtype=torch.complex64), None)])
    with pytest.raises(ValueError, match="row range"):
        dd.digest_many_async([(torch.zeros(4, 2), ((1, 5),))])


# ---------------------------------------------------------------------------
# The kernel's schedule, emulated in numpy uint32 from the wrapper's table
# ---------------------------------------------------------------------------


def _read(addr: int, nbytes: int) -> np.ndarray:
    """``nbytes`` bytes of host memory at ``addr``, as the kernel reads a
    segment through its address."""
    if nbytes == 0:
        return np.zeros(0, dtype=np.uint8)
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(addr)).copy()


def _weights(first_lane: int, count: int):
    idx = (np.arange(count, dtype=np.uint64) + np.uint64(first_lane)).astype(np.uint32)
    base = idx * np.uint32(dd._GOLDEN)
    return dd._mix32_np(base + np.uint32(dd._SEED1)), dd._mix32_np(base + np.uint32(dd._SEED2))


def _window_lanes(g, window: int) -> np.ndarray:
    """The lanes of segment ``g`` in bytes [window, window + WINDOW_BYTES),
    through the kernel's two paths: 16-byte positions that are aligned and
    whole as one load each, every other lane (an unaligned segment, or the
    segment's tail) as a load of its own, masked at the segment's end."""
    lane, nbytes, addr = int(g["lane_bytes"]), int(g["nbytes"]), int(g["addr"])
    n = min(dd.WINDOW_BYTES, nbytes - window)
    whole = 0 if addr % 16 else n // 16 * 16
    vector = _read(addr + window, whole).view(dd._NP_LANE[lane])
    # Lane loads from window + whole on, up to the window's end; the lanes
    # at or past the segment's end read as 0.
    scalar = np.zeros((dd.WINDOW_BYTES - whole) // lane, dtype=dd._NP_LANE[lane])
    inside = _read(addr + window + whole, n - whole).view(dd._NP_LANE[lane])
    scalar[: inside.size] = inside
    return np.concatenate([vector, scalar]).astype(np.uint32)


def _emulate_kernel(table: "dd.DigestTable", reuse_weights: bool = False) -> np.ndarray:
    """csrc/device_digest.cu in numpy: per (window, slice) item, the weights
    of the window's lanes computed once and shared by every segment of the
    slice, each segment's two sums added to its output row; then the final
    mix. ``reuse_weights`` plants a fault: window j + 1 takes window j's
    weights (j even)."""
    seg, win = table.segments, table.windows
    acc = np.zeros((len(seg), 2), dtype=np.uint32)
    for w in win:
        n_reach, begin, j = int(w["n_reach"]), int(w["seg_begin"]), int(w["index"])
        lane = int(seg[begin]["lane_bytes"])
        weighted = j - 1 if reuse_weights and j % 2 else j
        w1, w2 = _weights(weighted * dd.WINDOW_BYTES // lane, dd.WINDOW_BYTES // lane)
        k = int(dd.items_per_window(np.int64(n_reach)))
        for i in range(k):  # one block each
            for s in range(begin + i * n_reach // k, begin + (i + 1) * n_reach // k):
                g = seg[s]
                assert g["nbytes"] > j * dd.WINDOW_BYTES  # the prefix reaches the window
                x = _window_lanes(g, j * dd.WINDOW_BYTES)
                acc[g["row"]] += np.array(
                    [np.sum(x * w1[: x.size], dtype=np.uint32), np.sum(x * w2[: x.size], dtype=np.uint32)],
                    dtype=np.uint32,
                )
    nbytes = seg["nbytes"].astype(np.uint64).astype(np.uint32)
    out = np.empty_like(acc)
    out[seg["row"]] = np.stack(
        [dd._mix32_np(acc[seg["row"], 0] ^ nbytes), dd._mix32_np(acc[seg["row"], 1] ^ nbytes)], axis=1
    )
    return out


def _schedule_case(case: str):
    """(numpy arrays with their ranges, specs over CPU tensors) of one case."""
    if case == "shared-windows":
        # 40 bf16 row ranges and 24 float32 ones, all of unequal lengths,
        # at 16-byte-unaligned starts too: two slices of 20 share the
        # first bf16 windows; a 1-byte group besides.
        a = _np_array((22_200, 61), "bfloat16", seed=11)  # 122-byte rows
        cuts = np.cumsum(np.r_[0, 300 + 13 * np.arange(40)])  # 36.6 to 98.5 KB
        b = _np_array((4000, 37), "float32", seed=12)
        cuts_b = np.cumsum(np.r_[0, 60 + 9 * np.arange(24)])
        c = _np_array((100_003,), "uint8", seed=13)
        arrays = [
            (a, tuple((int(x), int(y)) for x, y in zip(cuts[:-1], cuts[1:]))),
            (b, tuple((int(x), int(y)) for x, y in zip(cuts_b[:-1], cuts_b[1:]))),
            (c, ((0, 100_003), (3, 70_001))),
        ]
        return arrays, [(tensor_from_numpy(x), r) for x, r in arrays]
    big = _np_array((1031, 77), case, seed=21)  # odd rows and row bytes, 5+ windows
    arrays = [
        (big, None),
        (big, ((0, 1), (3, 517), (517, 1031), (9, 9))),  # unaligned starts, an empty range
        (_np_array((3, 5), case, seed=22), None),  # shorter than one 16-byte load
        (_np_array((0,), case, seed=23), None),
        (_np_array((100_003,), case, seed=24), ((7, 99_999),)),
    ]
    specs = [(tensor_from_numpy(x), r) for x, r in arrays]
    view_base = _np_array((64, 33), case, seed=25)
    arrays.append((np.ascontiguousarray(view_base[:, 1::2]), None))
    specs.append((tensor_from_numpy(view_base)[:, 1::2], None))  # non-contiguous
    return arrays, specs


def _jax_rows(arrays) -> list:
    if all(_jax_device_ok(str(x.dtype)) for x, _ in arrays):
        got = jdd.materialize_many(jdd.digest_many_async([(jnp.asarray(x), r) for x, r in arrays]))
        return [tuple(int(v) for v in row) for row in got]
    rows = []
    for x, ranges in arrays:
        rows += [jdd.digest_host(x)] if ranges is None else [jdd.digest_host(x[s:e]) for s, e in ranges]
    return rows


@pytest.mark.parametrize("case", DTYPES + ["shared-windows"])
def test_kernel_schedule_equals_the_jax_package(case) -> None:
    """The wrapper's table, built from CPU tensors, through a numpy
    emulation of the kernel's schedule, bit for bit against the JAX
    package."""
    arrays, specs = _schedule_case(case)
    table = dd.build_table(specs)
    assert len(table.segments) == len(_jax_rows(arrays))
    lanes = table.segments["lane_bytes"]
    key = np.stack([-lanes, -table.segments["nbytes"]], axis=1)
    assert all(tuple(key[i]) <= tuple(key[i + 1]) for i in range(len(key) - 1))  # sorted
    assert sorted(table.segments["row"]) == list(range(len(table.segments)))
    got = [tuple(int(v) for v in row) for row in _emulate_kernel(table)]
    assert got == _jax_rows(arrays)
    if case == "shared-windows":
        assert int(table.windows["n_reach"].max()) >= 20 and table.n_items > len(table.windows)


def test_kernel_schedule_with_reused_weights_fails() -> None:
    """Planted fault: window j + 1 digested with window j's weights."""
    arrays, specs = _schedule_case("shared-windows")
    table = dd.build_table(specs)
    want = _jax_rows(arrays)
    assert [tuple(int(v) for v in row) for row in _emulate_kernel(table)] == want
    faulty = [tuple(int(v) for v in row) for row in _emulate_kernel(table, reuse_weights=True)]
    reaches_window_1 = table.segments["nbytes"] > dd.WINDOW_BYTES
    assert reaches_window_1.sum() >= 20
    for row, reaches in zip(table.segments["row"], reaches_window_1):
        assert (faulty[row] != want[row]) == reaches
