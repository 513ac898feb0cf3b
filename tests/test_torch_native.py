"""The port's native I/O runtime (``_native.py``, ``native/ts_io.cpp``).

Port of the JAX package's ``tests/test_native.py``: exact ranged reads and
writes, scatter-pack, CRC32-C known answers, errno propagation as
OSError, and byte-identical behaviour of the native and pure-Python fs
plugin paths, with torch tensors as the in-place restore destination.
Plus the cross-package check that both runtimes compute the same CRC32-C
(the checksum tables of either package verify in the other). Bytes
compare exactly.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import _native as jnative
from torchsnapshot_tpu_torch import _native
from torchsnapshot_tpu_torch.event_loop import run_in_fresh_event_loop
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.knobs import _override_env
from torchsnapshot_tpu_torch.knobs import disable_native as _disable_native
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin


@pytest.fixture
def native_lib():
    """Decided in the test, not at import: the runtime builds on first use."""
    if _native.lib() is None:
        pytest.skip("native runtime unavailable on this host")


def test_write_read_roundtrip(tmp_path, native_lib) -> None:
    p = str(tmp_path / "blob")
    data = os.urandom(1 << 16)
    assert _native.write_file(p, data)
    assert _native.file_size(p) == len(data)
    out = bytearray(len(data))
    assert _native.pread_into(p, out)
    assert bytes(out) == data


def test_ranged_pread(tmp_path, native_lib) -> None:
    p = str(tmp_path / "blob")
    data = bytes(range(256)) * 16
    _native.write_file(p, data)
    out = bytearray(100)
    _native.pread_into(p, out, offset=300)
    assert bytes(out) == data[300:400]


def test_pread_past_eof_raises(tmp_path, native_lib) -> None:
    p = str(tmp_path / "blob")
    _native.write_file(p, b"short")
    with pytest.raises(OSError):
        _native.pread_into(p, bytearray(100), offset=0)


def test_missing_file_raises_enoent(tmp_path, native_lib) -> None:
    with pytest.raises(OSError) as ei:
        _native.pread_into(str(tmp_path / "nope"), bytearray(1))
    assert ei.value.errno == 2


def test_gather_memcpy_scatter_and_bounds(tmp_path, native_lib) -> None:
    dst = bytearray(64)
    parts = [(b"aaaa", 0), (b"bb", 62), (b"cccccc", 20)]
    assert _native.gather_memcpy(dst, parts, n_threads=2)
    assert bytes(dst[0:4]) == b"aaaa"
    assert bytes(dst[62:64]) == b"bb"
    assert bytes(dst[20:26]) == b"cccccc"
    with pytest.raises(ValueError):
        _native.gather_memcpy(dst, [(b"xx", 63)])


def test_gather_memcpy_large_multithreaded(native_lib) -> None:
    rng = np.random.default_rng(0)
    srcs = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in (1 << 20, 3 << 20, 1 << 10)]
    total = sum(s.nbytes for s in srcs)
    dst = bytearray(total)
    off, parts = 0, []
    for s in srcs:
        parts.append((s, off))
        off += s.nbytes
    _native.gather_memcpy(dst, parts, n_threads=4)
    assert bytes(dst) == b"".join(s.tobytes() for s in srcs)


def test_crc32c_known_answer(native_lib) -> None:
    # RFC 3720 test vector.
    assert _native.crc32c(b"123456789") == 0xE3069283
    assert _native.crc32c(b"") == 0


def _fs_roundtrip(root: str) -> bytes:
    plugin = FSStoragePlugin(root)

    async def go():
        data = os.urandom(1 << 16)
        await plugin.write(WriteIO(path="a/b/blob", buf=data))
        whole = ReadIO(path="a/b/blob")
        await plugin.read(whole)
        assert bytes(whole.buf) == data
        ranged = ReadIO(path="a/b/blob", byte_range=(100, 1100))
        await plugin.read(ranged)
        assert bytes(ranged.buf) == data[100:1100]
        await plugin.close()
        return data

    return run_in_fresh_event_loop(go())


def test_fs_plugin_native_and_fallback_parity(tmp_path) -> None:
    _fs_roundtrip(str(tmp_path / "native"))
    with _disable_native():
        plugin = FSStoragePlugin(str(tmp_path / "fallback"))
        assert plugin._native is False
        _fs_roundtrip(str(tmp_path / "fallback"))


@pytest.mark.parametrize("disable_native", [False, True])
def test_fs_ranged_read_past_eof_raises_both_paths(
    tmp_path, disable_native
) -> None:
    """Short blobs are corruption: ranged reads past EOF must fail the same
    way (OSError) whether or not the native lib is in play."""
    ctx = (
        _disable_native()
        if disable_native
        else _override_env("_TS_NOOP", None)
    )
    with ctx:
        plugin = FSStoragePlugin(str(tmp_path))

        async def go():
            await plugin.write(WriteIO(path="blob", buf=b"short"))
            with pytest.raises(OSError):
                await plugin.read(ReadIO(path="blob", byte_range=(0, 100)))
            await plugin.close()

        run_in_fresh_event_loop(go())


def test_fs_write_falls_back_when_native_vanishes_mid_process(
    tmp_path,
) -> None:
    """A plugin constructed with native available must still write correctly
    if the disable knob flips afterwards (lib() re-checks env every call)."""
    plugin = FSStoragePlugin(str(tmp_path))
    with _disable_native():

        async def go():
            data = os.urandom(4096)
            await plugin.write(WriteIO(path="blob", buf=data))
            rio = ReadIO(path="blob")
            await plugin.read(rio)
            assert bytes(rio.buf) == data
            await plugin.close()

        run_in_fresh_event_loop(go())


def test_user_owned_destination_never_direct_read(tmp_path) -> None:
    """A failed read must not tear a user-owned in-place destination:
    direct (zero-copy) reads are gated to framework-allocated buffers, so
    an in-place restore keeps copy-on-success semantics."""
    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
    from torchsnapshot_tpu_torch.io_preparer import prepare_read

    path = str(tmp_path)
    Snapshot.take(path, {"s": TensorTreeState({"w": torch.arange(16.0).reshape(4, 4)})})
    entry = Snapshot(path).get_manifest()["0/s/w"]

    [user_req] = prepare_read(entry, obj_out=torch.zeros(4, 4), dest_owned=False)
    assert user_req.buffer_consumer.direct_destination() is None
    [owned_req] = prepare_read(entry, obj_out=torch.zeros(4, 4), dest_owned=True)
    assert owned_req.buffer_consumer.direct_destination() is not None

    # End to end: truncate the blob; the in-place restore fails but the
    # user's tensor is untouched (no half-old, half-new bytes).
    blob = os.path.join(path, "0", "s", "w")
    with open(blob, "rb") as f:
        data = f.read()
    with open(blob, "wb") as f:
        f.write(data[: len(data) // 2])
    dst = {"s": TensorTreeState({"w": torch.full((4, 4), 7.0)})}
    with pytest.raises(Exception):
        Snapshot(path).restore(dst)
    assert torch.equal(dst["s"].tree["w"], torch.full((4, 4), 7.0))


@pytest.mark.parametrize("size", [0, 1, 9, 4096, (1 << 20) + 3])
def test_crc32c_equal_across_packages(native_lib, size) -> None:
    if jnative.lib() is None:
        pytest.skip("the JAX package's native runtime is unavailable on this host")
    buf = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert _native.crc32c(buf) == jnative.crc32c(buf)
    half = size // 2
    assert _native.crc32c(buf[half:], seed=_native.crc32c(buf[:half])) == _native.crc32c(buf)
