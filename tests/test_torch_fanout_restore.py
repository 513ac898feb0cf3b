"""Single-reader fan-out restore in the port: each unique saved shard blob
is read from storage once across the ranks, and the kill switch restores
every-rank-reads.

Port of the fan-out cases of the JAX package's
``tests/test_fanout_restore.py``. The sharded snapshots are taken by the
JAX package in this process (one array row-sharded over 4 of its virtual
CPU devices, as that file takes them) and restored by the port's ranks,
spawned workers over the package's TCP store, through a plugin that
counts every read. The uneven case splits the world-1 snapshot into the
world-2 metadata a two-process take commits, as the JAX file does.
``sharded_blob_windows`` and ``assign_shard_owners`` are held against the
JAX functions on the same manifest.

The suite's conftest pins ``TORCHSNAPSHOT_TPU_FANOUT_RESTORE=0``; the
workers set the knob themselves. The module imports no jax at its top
(the workers import it).
"""

import asyncio
import collections
import os
import threading

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch.dist_store import InProcessStore
from torchsnapshot_tpu_torch.fanout import FanoutError, FanoutRestoreContext
from torchsnapshot_tpu_torch.io_types import ReadReq
from torchsnapshot_tpu_torch.manifest import sharded_blob_windows
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.resharding import assign_shard_owners
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.test_utils import (
    faulty_fs_plugin,
    init_torch_group,
    patch_storage_plugin,
    run_multiprocess,
)

torch.set_num_threads(1)

ROWS, COLS = 32, 8
DATA = torch.arange(ROWS * COLS, dtype=torch.float32).reshape(ROWS, COLS)


class CountingFS(FSStoragePlugin):
    """Records every read (path, byte range) this process issues."""

    reads: list = []

    async def read(self, read_io):
        CountingFS.reads.append((read_io.path, read_io.byte_range))
        await super().read(read_io)

    async def read_with_checksum(self, read_io):
        CountingFS.reads.append((read_io.path, read_io.byte_range))
        return await super().read_with_checksum(read_io)


def _sharded_reads() -> list:
    return [p for p, _ in CountingFS.reads if "sharded/" in p]


def _counted_restore(pg, path: str, fanout: bool, use_async: bool = False) -> dict:
    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "1" if fanout else "0"
    CountingFS.reads = []
    dest = {"m": TensorTreeState({"w": torch.zeros(ROWS, COLS)})}
    with patch_storage_plugin(CountingFS):
        if use_async:
            pending = Snapshot(path, pg=pg).async_restore(dest)
            pending.wait()
            telemetry = pending.restore_telemetry
        else:
            snapshot = Snapshot(path, pg=pg)
            snapshot.restore(dest)
            telemetry = snapshot.restore_telemetry
    reads = _sharded_reads()
    return {
        "equal": torch.equal(dest["m"].tree["w"], DATA),
        "sharded_reads": reads,
        "all_sharded_reads": [p for r in PGWrapper(pg).all_gather_object(reads) for p in r],
        **telemetry,
    }


def _uneven_restore(pg, path: str) -> bool:
    """6-row saved shards into 15-row destination boxes (Shard(0) over a
    gloo mesh of 2): the fan-out windows are partial row bands."""
    import torch.distributed as dist

    from test_torch_resharding import Meshes, local_equal

    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "1"
    init_torch_group(pg)
    try:
        dest = {"m": TensorTreeState({"w": Meshes(2).dtensor(torch.zeros(30, 3), "row2")})}
        Snapshot(path, pg=pg).restore(dest)
        return local_equal(dest["m"].tree["w"], torch.arange(90, dtype=torch.float32).reshape(30, 3))
    finally:
        dist.destroy_process_group()


def _owner_read_failure(pg, path: str) -> dict:
    """Every rank's sharded reads fail: whichever rank owns a shard fails
    its fetch, and the error reaches the peer within the round."""
    import time

    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "1"
    faulty = faulty_fs_plugin(lambda p: "sharded/" in p, ops=("read",), exc_msg="injected")
    dest = {"m": TensorTreeState({"w": torch.zeros(ROWS, COLS)})}
    t0 = time.monotonic()
    try:
        with patch_storage_plugin(faulty):
            Snapshot(path, pg=pg).restore(dest)
        raised = None
    except Exception as e:  # noqa: BLE001 - the case expects it
        raised = type(e).__name__
    return {"raised": raised, "s": time.monotonic() - t0, "untouched": not dest["m"].tree["w"].any()}


def fanout_worker(pg, paths: dict) -> dict:
    """Every leg in one spawn of two ranks: counted restores with fan-out
    on, off (the kill switch) and async, the uneven case, then the owner
    read failure."""
    return {
        "on": _counted_restore(pg, paths["four"], True),
        "off": _counted_restore(pg, paths["four"], False),
        "async": _counted_restore(pg, paths["four"], True, use_async=True),
        "uneven": _uneven_restore(pg, paths["uneven"]),
        "failure": _owner_read_failure(pg, paths["four"]),
    }


def _take_sharded(path: str, rows: int, cols: int, ways: int) -> None:
    """A JAX-package snapshot of one (rows, cols) f32 arange row-sharded
    over ``ways`` virtual CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts

    x = jnp.arange(rows * cols, dtype=jnp.float32).reshape(rows, cols)
    mesh = Mesh(np.array(jax.devices()[:ways]), ("x",))
    jts.Snapshot.take(path, {"m": jts.PyTreeState({"w": jax.device_put(x, NamedSharding(mesh, P("x")))})})


def _split_to_world2(path: str) -> None:
    """Rewrite a world-1 snapshot's metadata as the world-2 one: shards
    alternate between the two rank manifests, containers are kept per
    rank (the JAX file's helper; the blobs are untouched)."""
    from torchsnapshot_tpu.manifest import ShardedArrayEntry, SnapshotMetadata, is_container_entry

    import torchsnapshot_tpu as jts

    md = jts.Snapshot(path).metadata
    manifest = {}
    for key, entry in md.manifest.items():
        _, _, logical = key.partition("/")
        if isinstance(entry, ShardedArrayEntry) and len(entry.shards) > 1:
            manifest[key] = ShardedArrayEntry(dtype=entry.dtype, shape=entry.shape, shards=entry.shards[0::2])
            manifest[f"1/{logical}"] = ShardedArrayEntry(
                dtype=entry.dtype, shape=entry.shape, shards=entry.shards[1::2]
            )
        else:
            manifest[key] = entry
            if is_container_entry(entry):
                manifest[f"1/{logical}"] = entry
    with open(os.path.join(path, ".snapshot_metadata"), "w") as f:
        f.write(SnapshotMetadata(version=md.version, world_size=2, manifest=manifest).to_json())


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("fanout")
    paths = {"four": str(root / "four"), "uneven": str(root / "uneven")}
    _take_sharded(paths["four"], ROWS, COLS, 4)
    _take_sharded(paths["uneven"], 30, 3, 5)
    _split_to_world2(paths["uneven"])
    return paths


@pytest.fixture(scope="module")
def rows(snapshots) -> list:
    return run_multiprocess(fanout_worker, 2, args=(snapshots,))


def test_fanout_fetches_each_unique_shard_exactly_once(snapshots, rows) -> None:
    """With fan-out on, each unique saved shard is read from storage once
    across both ranks; each rank's own reads cover less than it needs, the
    rest arriving from its peer; the restore is bit-identical."""
    expected = sorted(sharded_blob_windows(Snapshot(snapshots["four"]).metadata.manifest))
    assert len(expected) == 4
    assert set(assign_shard_owners(expected, 2).values()) == {0, 1}, "both ranks should own shards"
    counts = collections.Counter(rows[0]["on"]["all_sharded_reads"])
    assert sorted(counts) == expected
    assert all(c == 1 for c in counts.values()), counts
    needed = DATA.numel() * DATA.element_size()
    for r in rows:
        on = r["on"]
        assert on["equal"]
        assert on["bytes_fetched"] < needed, on
        assert on["bytes_received"] > 0
        assert on["bytes_fetched"] + on["bytes_received"] >= needed
        assert on["bytes_published"] == rows[1 - rows.index(r)]["on"]["bytes_received"]


def test_fanout_kill_switch_restores_every_rank_reads(rows) -> None:
    """TORCHSNAPSHOT_TPU_FANOUT_RESTORE=0: every rank reads every shard
    itself (2 reads per unique shard at world 2), nothing is received from
    peers, and the restored bytes match."""
    counts = collections.Counter(rows[0]["off"]["all_sharded_reads"])
    assert len(counts) == 4
    assert all(c == 2 for c in counts.values()), counts
    for r in rows:
        assert r["off"]["equal"]
        assert not r["off"]["bytes_received"]
        assert r["off"]["bytes_fetched"] >= DATA.numel() * DATA.element_size()


def test_fanout_async_restore_single_read_per_shard(rows) -> None:
    """async_restore fans out too: the exchange runs on the calling
    thread, the background pipeline reads from the exchanged cache."""
    counts = collections.Counter(rows[0]["async"]["all_sharded_reads"])
    assert len(counts) == 4
    assert all(c == 1 for c in counts.values()), counts
    assert all(r["async"]["equal"] and r["async"]["bytes_received"] > 0 for r in rows)


def test_fanout_handles_uneven_shards(rows) -> None:
    """6-row saved shards, 15-row destination boxes, split manifests."""
    assert [r["uneven"] for r in rows] == [True, True]


def test_fanout_owner_read_failure_fails_fast(rows) -> None:
    """A failing owner read raises on every rank within the round, never
    degrading to every-rank-reads, and applies nothing."""
    for r in rows:
        f = r["failure"]
        assert f["raised"] is not None, f
        assert f["s"] < 60.0, "a peer blocked to the store timeout"
        assert f["untouched"]


def test_fanout_failed_round_leaves_no_store_keys() -> None:
    """When an owner's fetch fails, the surviving peer consumes the error
    marker and reaps the window it had published for the failed rank: a
    failed round leaves no key under its prefix."""
    store = InProcessStore()
    owners = {"sharded/a": 0, "sharded/b": 1}
    windows = {"sharded/a": (0, 8), "sharded/b": (0, 8)}

    class _Storage:
        def __init__(self, fail_path):
            self.fail_path = fail_path

        async def read(self, read_io):
            if read_io.path == self.fail_path:
                raise RuntimeError("injected owner read failure")
            read_io.buf = memoryview(b"x" * 8)

    errors = {}

    def _rank(rank, need, fail_path):
        ctx = FanoutRestoreContext(owners, windows, store, rank, 2)
        loop = asyncio.new_event_loop()
        try:
            ctx.exchange(
                [ReadReq(path=need, buffer_consumer=None)], _Storage(fail_path), loop, "nonce",
                timeout=30.0,
            )
        except BaseException as e:  # noqa: BLE001 - collected per rank
            errors[rank] = e
        finally:
            loop.close()

    # Rank 0 owns blob a (needed by rank 1) and its fetch fails; rank 1
    # owns blob b (needed by rank 0) and publishes it.
    threads = [
        threading.Thread(target=_rank, args=(0, "sharded/b", "sharded/a")),
        threading.Thread(target=_rank, args=(1, "sharded/a", "sharded/a")),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert isinstance(errors.get(0), RuntimeError)
    assert isinstance(errors.get(1), FanoutError)
    assert [k for k in store._kv if k.startswith("nonce")] == []


def test_fanout_exchange_across_staggered_ranks() -> None:
    """Three ranks on threads join one round at different times (rank 0
    sees its peers' needs land one by one): each blob is read once, by its
    owner, each rank's cache holds exactly its windows, and the round
    leaves no key behind."""
    import time

    store = InProcessStore()
    blobs = {f"sharded/b{i}": bytes(range(i, i + 64)) for i in range(5)}
    windows = {loc: (0, 64) for loc in blobs}
    owners = assign_shard_owners(windows, 3)
    reads = []

    class _Storage:
        async def read(self, read_io):
            reads.append(read_io.path)
            lo, hi = read_io.byte_range
            read_io.buf = memoryview(blobs[read_io.path][lo:hi])

    # Rank r needs the blobs i with i % 3 != r, the band [8 r, 8 r + 32).
    needs = {
        r: {loc: (8 * r, 8 * r + 32) for i, loc in enumerate(sorted(blobs)) if i % 3 != r}
        for r in range(3)
    }
    caches, errors = {}, {}

    def _rank(rank):
        time.sleep(0.05 * rank)
        ctx = FanoutRestoreContext(owners, windows, store, rank, 3)
        loop = asyncio.new_event_loop()
        try:
            reqs = [ReadReq(path=loc, buffer_consumer=None, byte_range=rng) for loc, rng in needs[rank].items()]
            ctx.exchange(reqs, _Storage(), loop, "round", timeout=30.0)
            caches[rank] = dict(ctx.cache)
        except BaseException as e:  # noqa: BLE001 - collected per rank
            errors[rank] = e
        finally:
            loop.close()

    threads = [threading.Thread(target=_rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert sorted(reads) == sorted({loc for n in needs.values() for loc in n})
    for r in range(3):
        assert set(caches[r]) == set(needs[r])
        for loc, (window, data) in caches[r].items():
            lo, hi = window
            assert lo <= needs[r][loc][0] and needs[r][loc][1] <= hi
            assert data == blobs[loc][lo:hi]
    assert [k for k in store._kv if k.startswith("round")] == []


def test_assign_shard_owners_is_deterministic_and_balanced() -> None:
    from torchsnapshot_tpu.resharding import assign_shard_owners as jax_owners

    locs = [f"sharded/m/w_{i * 8}_0" for i in range(8)]
    table = assign_shard_owners(locs, 4)
    assert table == assign_shard_owners(list(reversed(locs)), 4)
    assert all(c == 2 for c in collections.Counter(table.values()).values())
    assert assign_shard_owners([], 4) == {}
    assert set(assign_shard_owners(locs, 1).values()) == {0}
    for world in (1, 2, 3, 4, 7):
        assert assign_shard_owners(locs, world) == jax_owners(locs, world)


def test_sharded_blob_windows_shape(snapshots) -> None:
    """Four 8-row shard blobs, each window (0, 8 rows x 8 cols x 4 bytes);
    the port's function and the JAX one agree on the same manifest, the
    owner tables too."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.manifest import sharded_blob_windows as jax_windows
    from torchsnapshot_tpu.resharding import assign_shard_owners as jax_owners

    windows = sharded_blob_windows(Snapshot(snapshots["four"]).metadata.manifest)
    assert len(windows) == 4
    for loc, (lo, hi) in windows.items():
        assert "sharded/" in loc and lo == 0 and hi == 8 * 8 * 4
    jax_manifest = jts.Snapshot(snapshots["four"]).metadata.manifest
    assert windows == jax_windows(jax_manifest)
    assert assign_shard_owners(windows, 2) == jax_owners(jax_windows(jax_manifest), 2)


def test_fanout_report_fields_absent_without_fanout(snapshots) -> None:
    """A one-process restore reads every byte it needs from storage and
    receives nothing."""
    dest = {"m": TensorTreeState({"w": torch.zeros(ROWS, COLS)})}
    snapshot = Snapshot(snapshots["four"])
    snapshot.restore(dest)
    t = snapshot.restore_telemetry
    assert t["bytes_fetched"] >= DATA.numel() * DATA.element_size()
    assert not t["bytes_received"] and not t["bytes_published"]
    assert torch.equal(dest["m"].tree["w"], DATA)


def test_fanout_is_on_by_default(monkeypatch) -> None:
    """As in the JAX package: on unless the variable is "0"."""
    monkeypatch.delenv("TORCHSNAPSHOT_TPU_FANOUT_RESTORE", raising=False)
    assert knobs.is_fanout_restore_enabled()
    with knobs.disable_fanout_restore():
        assert not knobs.is_fanout_restore_enabled()
    with knobs.enable_fanout_restore():
        assert knobs.is_fanout_restore_enabled()
