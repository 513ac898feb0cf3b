"""The port's fs and memory storage plugins: round trips, ranged reads,
deletes, URL dispatch.

Port of the JAX package's ``tests/test_storage_plugins.py``, plus a blob
written by either package's fs plugin read back byte for byte by the
other's, and the refusal of the schemes not ported yet: the s3 and gcs
plugins, the retry wrapper around them and ``tiered://`` come with ROADMAP
queue 1 step 9.
"""

import asyncio

import pytest

from torchsnapshot_tpu import io_types as jio
from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFSStoragePlugin
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(params=["fs", "memory"])
def plugin(request, tmp_path):
    if request.param == "fs":
        p = FSStoragePlugin(root=str(tmp_path))
        yield p
    else:
        name = f"test-{id(request)}"
        p = MemoryStoragePlugin(name=name)
        yield p
        MemoryStoragePlugin.drop_store(name)


def test_write_read_roundtrip(plugin) -> None:
    async def go():
        payload = bytes(range(256)) * 4
        await plugin.write(WriteIO(path="a/b/data", buf=payload))
        read_io = ReadIO(path="a/b/data")
        await plugin.read(read_io)
        assert bytes(read_io.buf) == payload

        ranged = ReadIO(path="a/b/data", byte_range=(256, 512))
        await plugin.read(ranged)
        assert bytes(ranged.buf) == bytes(range(256))

        await plugin.delete("a/b/data")
        with pytest.raises(Exception):
            await plugin.read(ReadIO(path="a/b/data"))
        await plugin.close()

    _run(go())


def test_ranged_read_past_eof_is_an_error(plugin) -> None:
    """Both plugins share the contract: a ranged read past the end of a
    blob is corruption (the manifest promised bytes that aren't there),
    never a silent partial result."""

    async def go():
        await plugin.write(WriteIO(path="short", buf=b"0123456789"))
        with pytest.raises(OSError) as exc_info:
            await plugin.read(ReadIO(path="short", byte_range=(4, 64)))
        import errno

        assert exc_info.value.errno == errno.EIO
        await plugin.close()

    _run(go())


def test_write_accepts_memoryview_and_bytearray(plugin) -> None:
    async def go():
        await plugin.write(WriteIO(path="mv", buf=memoryview(b"hello")))
        await plugin.write(WriteIO(path="ba", buf=bytearray(b"world")))
        r1, r2 = ReadIO(path="mv"), ReadIO(path="ba")
        await plugin.read(r1)
        await plugin.read(r2)
        assert bytes(r1.buf) == b"hello" and bytes(r2.buf) == b"world"

    _run(go())


def test_url_dispatch(tmp_path) -> None:
    assert isinstance(url_to_storage_plugin(str(tmp_path)), FSStoragePlugin)
    assert isinstance(url_to_storage_plugin(f"fs://{tmp_path}"), FSStoragePlugin)
    assert isinstance(url_to_storage_plugin("memory://x"), MemoryStoragePlugin)
    with pytest.raises(RuntimeError, match="Unsupported storage scheme"):
        url_to_storage_plugin("warpdrive://x")


def test_fs_overwrite(tmp_path) -> None:
    async def go():
        p = FSStoragePlugin(root=str(tmp_path))
        await p.write(WriteIO(path="f", buf=b"111111"))
        await p.write(WriteIO(path="f", buf=b"22"))
        r = ReadIO(path="f")
        await p.read(r)
        assert bytes(r.buf) == b"22"

    _run(go())


@pytest.mark.parametrize("url", ["s3://bucket/run", "gs://bucket/run", "tiered:///fast|/durable"])
def test_unported_schemes_name_their_step(url) -> None:
    """The cloud schemes stay refused (step 9d); ``tiered://`` is ported
    and composes its two tiers."""
    if url.startswith("tiered://"):
        from torchsnapshot_tpu_torch.tiered import TieredStoragePlugin

        plugin = url_to_storage_plugin(url)
        assert isinstance(plugin, TieredStoragePlugin)
        assert (plugin.fast_url, plugin.durable_url) == ("/fast", "/durable")
        assert isinstance(plugin.fast, FSStoragePlugin) and isinstance(plugin.durable, FSStoragePlugin)
        return
    with pytest.raises(RuntimeError, match="ROADMAP queue 1 step 9d"):
        url_to_storage_plugin(url)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fs_blobs_read_across_packages(tmp_path, writer) -> None:
    payload = bytes(range(256)) * 64
    port, jax = FSStoragePlugin(root=str(tmp_path)), JaxFSStoragePlugin(root=str(tmp_path))
    w_plugin, w_io = (port, WriteIO) if writer == "port" else (jax, jio.WriteIO)
    r_plugin, r_io = (jax, jio.ReadIO) if writer == "port" else (port, ReadIO)

    async def go():
        await w_plugin.write(w_io(path="x/blob", buf=payload))
        whole, ranged = r_io(path="x/blob"), r_io(path="x/blob", byte_range=(100, 4196))
        await r_plugin.read(whole)
        await r_plugin.read(ranged)
        assert bytes(whole.buf) == payload
        assert bytes(ranged.buf) == payload[100:4196]
        await port.close()
        await jax.close()

    _run(go())
