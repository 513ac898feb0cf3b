"""The port's blob-level CRC integrity: recorded at take, verified on
restore, read and ``read_object``.

Port of the JAX package's ``tests/test_integrity.py`` with torch tensors
in ``TensorTreeState`` in place of ``PyTreeState``, plus a check that the
two packages compute the same table entries for the same bytes. The
sharded cases take ``DTensor``s on two gloo ranks (spawned workers) and
restore them resharded into a plain tensor. Digests compare exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import integrity as jintegrity
from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.integrity import (
    ChecksumError,
    compute_checksum,
    compute_checksum_entry,
    load_checksum_tables,
    table_path,
    verify_checksum,
)
from torchsnapshot_tpu_torch.knobs import disable_checksums

torch.set_num_threads(1)

def _tree(**tensors):
    return {"s": TensorTreeState(dict(tensors))}


def test_compute_verify_roundtrip() -> None:
    buf = b"hello, checkpoint world" * 100
    alg, crc = compute_checksum(buf)
    assert alg in ("crc32c", "crc32")
    verify_checksum(buf, (alg, crc, len(buf)), "p")  # no raise

    corrupted = bytearray(buf)
    corrupted[7] ^= 0xFF
    with pytest.raises(ChecksumError, match="mismatch"):
        verify_checksum(bytes(corrupted), (alg, crc, len(buf)), "p")

    with pytest.raises(ChecksumError, match="size mismatch"):
        verify_checksum(buf[:-1], (alg, crc, len(buf)), "p")

    # Unknown algorithm from a future version: skipped, not fatal.
    verify_checksum(buf, ("sha999", 0, len(buf)), "p")


def test_take_writes_checksum_table(tmp_path) -> None:
    Snapshot.take(str(tmp_path), _tree(w=torch.ones(8, 8), n=torch.arange(10)))
    table_file = tmp_path / table_path(0)
    assert table_file.exists()
    table = json.loads(table_file.read_text())
    assert "0/s/w" in table and "0/s/n" in table
    for alg, crc, nbytes in table.values():
        assert alg in ("crc32c", "crc32")
        assert nbytes > 0


def test_corruption_detected_on_restore(tmp_path) -> None:
    arr = torch.arange(64, dtype=torch.float64).reshape(8, 8)
    Snapshot.take(str(tmp_path), _tree(w=arr.clone()))

    # Same-length bit flip: only the digest can catch this.
    blob = tmp_path / "0" / "s" / "w"
    data = bytearray(blob.read_bytes())
    data[5] ^= 0x40
    blob.write_bytes(bytes(data))

    dst = _tree(w=torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ChecksumError, match="0/s/w"):
        Snapshot(str(tmp_path)).restore(dst)
    # The in-place destination was not touched by the failed restore.
    assert torch.equal(dst["s"].tree["w"], torch.zeros(8, 8, dtype=torch.float64))


def test_corruption_detected_for_module_destination(tmp_path) -> None:
    src = torch.nn.Linear(4, 4)
    Snapshot.take(str(tmp_path), {"s": src})
    blob = tmp_path / "0" / "s" / "weight"
    data = bytearray(blob.read_bytes())
    data[0] ^= 0x01
    blob.write_bytes(bytes(data))
    with pytest.raises(ChecksumError):
        Snapshot(str(tmp_path)).restore({"s": torch.nn.Linear(4, 4)})


def test_read_object_verifies(tmp_path) -> None:
    Snapshot.take(str(tmp_path), _tree(w=torch.arange(16.0)))
    blob = tmp_path / "0" / "s" / "w"
    data = bytearray(blob.read_bytes())
    data[-1] ^= 0x80
    blob.write_bytes(bytes(data))
    with pytest.raises(ChecksumError):
        Snapshot(str(tmp_path)).read_object("0/s/w")


def test_disable_checksums(tmp_path) -> None:
    with disable_checksums():
        Snapshot.take(str(tmp_path), _tree(w=torch.ones(4)))
        assert not (tmp_path / table_path(0)).exists()
        # Restore of an unchecksummed snapshot works.
        dst = _tree(w=torch.zeros(4))
        Snapshot(str(tmp_path)).restore(dst)
        assert torch.equal(dst["s"].tree["w"], torch.ones(4))


def test_missing_tables_restore_without_verification(tmp_path) -> None:
    """Snapshots whose tables were deleted (or predate checksums) restore
    fine — verification is best-effort, the commit marker is the
    correctness gate."""
    Snapshot.take(str(tmp_path), _tree(w=torch.ones(4)))
    os.remove(tmp_path / table_path(0))
    dst = _tree(w=torch.zeros(4))
    Snapshot(str(tmp_path)).restore(dst)
    assert torch.equal(dst["s"].tree["w"], torch.ones(4))


def _take_sharded(path, rows: int, cols: int, page_size=None) -> None:
    from test_torch_resharding import row_sharded_take_worker
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    run_multiprocess(row_sharded_take_worker, 2, args=(str(path), rows, cols, page_size))


def test_sharded_blobs_are_checksummed(tmp_path) -> None:
    _take_sharded(tmp_path, 16, 8)
    keys = []
    for rank in (0, 1):
        table = json.loads((tmp_path / table_path(rank)).read_text())
        keys += [k for k in table if k.startswith("sharded/s/emb")]
    assert sorted(keys) == ["sharded/s/emb_0_0", "sharded/s/emb_8_0"]

    # Corrupt one shard; the resharded restore must fail.
    victim = tmp_path / keys[0]
    data = bytearray(victim.read_bytes())
    data[3] ^= 0x10
    victim.write_bytes(bytes(data))
    with pytest.raises(ChecksumError):
        Snapshot(str(tmp_path)).restore(_tree(emb=torch.zeros(16, 8)))


def test_load_checksum_tables_merges_ranks(tmp_path) -> None:
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    (tmp_path / "checksums").mkdir()
    (tmp_path / table_path(0)).write_text(json.dumps({"a": ["crc32c", 1, 2]}))
    (tmp_path / table_path(1)).write_text(json.dumps({"b": ["crc32c", 3, 4]}))

    import asyncio

    loop = asyncio.new_event_loop()
    try:
        plugin = FSStoragePlugin(str(tmp_path))
        merged = load_checksum_tables(2, plugin, loop)
        loop.run_until_complete(plugin.close())
    finally:
        loop.close()
    assert merged == {"a": ("crc32c", 1, 2), "b": ("crc32c", 3, 4)}


def test_sharded_ranged_restore_verifies_pages(tmp_path, monkeypatch) -> None:
    """Memory-budgeted sharded restores split each shard into ranged row
    reads; every page a range fully covers is verified, so mid-shard
    corruption is caught though no read sees the whole shard blob."""
    import torchsnapshot_tpu_torch.integrity as integrity
    from torchsnapshot_tpu_torch.knobs import override_per_rank_memory_budget_bytes

    monkeypatch.setattr(integrity, "PAGE_SIZE", 64 * 1024)
    # 128 rows x 4 KiB per rank's shard = 512 KiB a shard = 8 pages.
    rows, cols = 256, 1024
    _take_sharded(tmp_path, rows, cols, page_size=64 * 1024)
    table = json.loads((tmp_path / table_path(0)).read_text())
    shard_keys = sorted(k for k in table if k.startswith("sharded/"))
    assert len(table[shard_keys[0]]) == 5  # paged entry

    victim = tmp_path / shard_keys[0]
    data = bytearray(victim.read_bytes())
    data[4 * 64 * 1024 + 17] ^= 0x04  # page 4 of 8
    victim.write_bytes(bytes(data))
    with override_per_rank_memory_budget_bytes(128 * 1024):
        with pytest.raises(ChecksumError, match="page 4"):
            Snapshot(str(tmp_path)).restore(_tree(emb=torch.zeros(rows, cols)))


def test_read_object_budgeted_verifies_pages(tmp_path, monkeypatch) -> None:
    import torchsnapshot_tpu_torch.integrity as integrity

    monkeypatch.setattr(integrity, "PAGE_SIZE", 64 * 1024)
    arr = torch.arange(64 * 1024, dtype=torch.float64)  # 512 KiB = 8 pages
    Snapshot.take(str(tmp_path), _tree(big=arr.clone()))
    blob = tmp_path / "0" / "s" / "big"
    data = bytearray(blob.read_bytes())
    data[3 * 64 * 1024 + 9] ^= 0x10
    blob.write_bytes(bytes(data))
    with pytest.raises(ChecksumError, match="page 3"):
        Snapshot(str(tmp_path)).read_object(
            "0/s/big", memory_budget_bytes=128 * 1024
        )


def test_verify_range_checksum_unit() -> None:
    from torchsnapshot_tpu_torch.integrity import (
        compute_checksum_entry,
        verify_range_checksum,
    )
    import torchsnapshot_tpu_torch.integrity as integrity

    page = integrity.PAGE_SIZE
    blob = bytes(bytearray((i * 7) % 256 for i in range(page * 2 + 100)))
    entry = compute_checksum_entry(blob)
    assert len(entry) == 5
    # Paged entries still carry a real whole-blob digest (chained from
    # the page walk) so older readers can verify whole reads.
    from torchsnapshot_tpu_torch.integrity import compute_checksum

    assert entry[1] == compute_checksum(blob)[1]

    # Full-page-aligned range: the page verifies.
    assert verify_range_checksum(blob[:page], entry, (0, page), "p")
    # Unaligned range fully inside one page: nothing fully covered.
    assert not verify_range_checksum(
        blob[10 : page - 10], entry, (10, page - 10), "p"
    )
    # Range covering the partial tail page verifies it.
    assert verify_range_checksum(
        blob[page * 2 :], entry, (page * 2, len(blob)), "p"
    )
    # Corrupted page detected.
    bad = bytearray(blob[:page])
    bad[50] ^= 0xFF
    with pytest.raises(ChecksumError, match="page 0"):
        verify_range_checksum(bytes(bad), entry, (0, page), "p")
    # Truncated ranged read fails loudly, not as an opaque consumer error.
    with pytest.raises(ChecksumError, match="returned"):
        verify_range_checksum(blob[: page - 1], entry, (0, page), "p")

    # Whole-blob verification of a paged entry uses the chained digest.
    from torchsnapshot_tpu_torch.integrity import verify_checksum as _vc

    _vc(blob, entry, "p")  # no raise
    whole_bad = bytearray(blob)
    whole_bad[page + 5] ^= 0x01
    with pytest.raises(ChecksumError, match="mismatch"):
        _vc(bytes(whole_bad), entry, "p")

    # Interim paged format (whole digest None) verifies page-by-page.
    interim = (entry[0], None, entry[2], entry[3], entry[4])
    _vc(blob, interim, "p")  # no raise
    with pytest.raises(ChecksumError, match="page 1"):
        _vc(bytes(whole_bad), interim, "p")


def test_fused_write_checksum_matches_two_step(tmp_path) -> None:
    """FSStoragePlugin.write_with_checksum produces byte-identical table
    entries to compute-then-write, across page boundaries, and the bytes
    on disk are the same."""
    import asyncio

    from torchsnapshot_tpu_torch.integrity import PAGE_SIZE, compute_checksum_entry
    from torchsnapshot_tpu_torch.io_types import WriteIO
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    plugin = FSStoragePlugin(root=str(tmp_path))
    if plugin._native is False:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(0)
    sizes = [
        0,
        1,
        PAGE_SIZE - 1,
        PAGE_SIZE,
        PAGE_SIZE + 1,
        2 * PAGE_SIZE,
        2 * PAGE_SIZE + 12345,
    ]

    async def run() -> None:
        for i, size in enumerate(sizes):
            buf = rng.integers(0, 256, size, dtype="uint8").tobytes()
            entry = await plugin.write_with_checksum(
                WriteIO(path=f"blob{i}", buf=buf)
            )
            assert entry == compute_checksum_entry(buf), size
            assert (tmp_path / f"blob{i}").read_bytes() == buf

    asyncio.run(run())


def test_fused_write_checksum_declines_without_native(tmp_path) -> None:
    """A plugin whose native runtime is unavailable declines the fused
    path (returns None) so the scheduler falls back to two-step."""
    import asyncio

    from torchsnapshot_tpu_torch.io_types import WriteIO
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin._native = False
    assert asyncio.run(
        plugin.write_with_checksum(WriteIO(path="x", buf=b"abc"))
    ) is None


def test_fused_read_checksum_roundtrip_and_corruption(tmp_path) -> None:
    """read_with_checksum returns page digests that verify against both
    entry formats, and a corrupted blob fails through the fused path."""
    import asyncio

    from torchsnapshot_tpu_torch.integrity import (
        PAGE_SIZE,
        ChecksumError,
        compute_checksum_entry,
        verify_page_crcs,
    )
    from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    plugin = FSStoragePlugin(root=str(tmp_path))
    if plugin._native is False:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(1)

    async def run() -> None:
        for i, size in enumerate([10, PAGE_SIZE, 2 * PAGE_SIZE + 7]):
            buf = rng.integers(0, 256, size, dtype="uint8").tobytes()
            await plugin.write(WriteIO(path=f"b{i}", buf=buf))
            entry = compute_checksum_entry(buf)
            read_io = ReadIO(path=f"b{i}")
            pages = await plugin.read_with_checksum(read_io)
            assert pages is not None and bytes(read_io.buf) == buf
            verify_page_crcs(pages, size, entry, f"b{i}")  # no raise
            # Ranged reads decline the fused path.
            assert (
                await plugin.read_with_checksum(
                    ReadIO(path=f"b{i}", byte_range=(0, 1))
                )
                is None
            )

        # An interim entry at a foreign page granularity cannot be checked
        # from these pages: signalled as False (caller re-verifies bytes),
        # never a crash.
        buf0 = (tmp_path / "b0").read_bytes()
        read_io0 = ReadIO(path="b0")
        pages0 = await plugin.read_with_checksum(read_io0)
        foreign = ("crc32c", None, len(buf0), PAGE_SIZE * 2, [0])
        assert verify_page_crcs(pages0, len(buf0), foreign, "b0") is False

        # Corruption detected from the digests computed during the read.
        blob = tmp_path / "b2"
        data = bytearray(blob.read_bytes())
        entry = compute_checksum_entry(bytes(data))
        data[PAGE_SIZE + 3] ^= 0xFF
        blob.write_bytes(bytes(data))
        read_io = ReadIO(path="b2")
        pages = await plugin.read_with_checksum(read_io)
        try:
            verify_page_crcs(pages, len(data), entry, "b2")
            raise AssertionError("corruption not detected")
        except ChecksumError:
            pass

    asyncio.run(run())


@pytest.mark.parametrize("size", [0, 1, 4096, 4 * 1024 * 1024 + 7])
def test_checksum_entries_equal_across_packages(size) -> None:
    """One blob, one table entry: the two packages record the same entry
    (algorithm, digest, size and page digests) and each verifies the
    other's."""
    buf = np.random.default_rng(size).integers(0, 256, size, dtype="uint8").tobytes()
    entry = compute_checksum_entry(buf)
    assert entry == jintegrity.compute_checksum_entry(buf)
    verify_checksum(buf, jintegrity.compute_checksum_entry(buf), "p")
    jintegrity.verify_checksum(buf, entry, "p")
