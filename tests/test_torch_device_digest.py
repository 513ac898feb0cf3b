"""The port's digest (``ops/device_digest.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX package's
``digest_host`` and ``digest_many_async`` (on CPU jax arrays) and through
the port's ``digest_host`` and plain torch version (what the kernel wrapper
runs for a CPU tensor). Tolerance: none, the digests must be equal bit for
bit; that is what lets an incremental take of either package use a base
written by the other. The CUDA kernel is held to the same plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

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
