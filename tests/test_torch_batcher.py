"""Slab batching in the port: write coalescing with manifest rewriting,
spanning reads, round trips with the knob on, slabs of sharded entries,
and batched snapshots that cross between the two packages.

Port of the JAX package's ``tests/test_batcher.py`` and of the slab cases
of ``tests/test_write_path.py`` that hold bytes (its vectorized zero-pack
write path is not ported: the port stages a slab into one buffer, with the
same bytes): a slab's bytes and checksum entry are the same staged with
the device pack or member by member, with or without the native runtime,
and in the JAX package. The module imports no jax at its top (its workers
are spawned); the cross-package tests import it inside.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch.batcher import batch_read_requests, batch_write_requests
from torchsnapshot_tpu_torch.io_preparer import DeviceCopier, prepare_read, prepare_write
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

torch.set_num_threads(1)


def _prepare(tensors):
    entries, reqs = [], []
    copier = DeviceCopier()
    for i, t in enumerate(tensors):
        entry, wr = prepare_write(t, f"t/{i}", rank=0, copier=copier)
        entries.append(entry)
        reqs.extend(wr)
    return entries, reqs


def test_write_batching_rewrites_entries() -> None:
    tensors = [torch.arange(16, dtype=torch.float32) * i for i in range(4)]  # 64 B each
    entries, reqs = _prepare(tensors)
    with knobs.override_slab_size_threshold_bytes(1024):
        entries, batched = batch_write_requests(entries, reqs)
    assert len(batched) == 1
    assert all(e.location == batched[0].path and e.location.startswith("batched/") for e in entries)
    assert [e.byte_range for e in entries] == [[0, 64], [64, 128], [128, 192], [192, 256]]


def test_write_batching_respects_threshold() -> None:
    tensors = [torch.zeros(16) for _ in range(4)]  # 64 B each, 2 per 128 B slab
    entries, reqs = _prepare(tensors)
    with knobs.override_slab_size_threshold_bytes(128):
        entries, batched = batch_write_requests(entries, reqs)
    assert len(batched) == 2
    assert len({r.path for r in batched}) == 2


def test_large_writes_left_alone() -> None:
    entries, reqs = _prepare([torch.zeros(1024), torch.zeros(4)])  # 4 KiB > threshold
    with knobs.override_slab_size_threshold_bytes(256):
        entries, batched = batch_write_requests(entries, reqs)
    assert {r.path for r in batched} == {"0/t/0", "0/t/1"}
    assert entries[0].location == "0/t/0"


def test_slab_roundtrip_through_storage(tmp_path) -> None:
    """Stage the slab, write it through the fs plugin, read the members
    back through one spanning read."""
    from torchsnapshot_tpu_torch.event_loop import run_in_fresh_event_loop
    from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    g = torch.Generator().manual_seed(0)
    tensors = [torch.randn(8, generator=g) for _ in range(3)]
    entries, reqs = _prepare(tensors)
    with knobs.override_slab_size_threshold_bytes(4096):
        entries, batched = batch_write_requests(entries, reqs)
    assert len(batched) == 1

    async def go():
        plugin = FSStoragePlugin(root=str(tmp_path))
        buf = await batched[0].buffer_stager.stage_buffer()
        await plugin.write(WriteIO(path=batched[0].path, buf=buf))
        outs = [torch.zeros(8) for _ in tensors]
        read_reqs = []
        for entry, out in zip(entries, outs):
            read_reqs.extend(prepare_read(entry, obj_out=out))
        merged = batch_read_requests(read_reqs)
        assert len(merged) == 1  # one spanning read for the slab
        io = ReadIO(path=merged[0].path, byte_range=merged[0].byte_range)
        await plugin.read(io)
        await merged[0].buffer_consumer.consume_buffer(io.buf)
        await plugin.close()
        return outs

    for a, b in zip(tensors, run_in_fresh_event_loop(go())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int8, torch.uint32, torch.bfloat16])
@pytest.mark.parametrize("pack", [False, True], ids=["per-member", "device-pack"])
def test_snapshot_roundtrip_with_batching(tmp_path, dtype, pack) -> None:
    tensors = {f"a{i}": (torch.arange(32) + i).to(dtype) for i in range(5)}
    pack_ctx = knobs.enable_device_pack() if pack else contextlib.nullcontext()
    with knobs.enable_batching(), knobs.override_slab_size_threshold_bytes(4096), pack_ctx:
        Snapshot.take(str(tmp_path), {"s": TensorTreeState(dict(tensors))})
        # Everything under the threshold: exactly one slab on disk.
        assert len(os.listdir(os.path.join(str(tmp_path), "batched"))) == 1
        dest = TensorTreeState({k: torch.zeros_like(v) for k, v in tensors.items()})
        Snapshot(str(tmp_path)).restore({"s": dest})
    for k, v in tensors.items():
        assert torch.equal(dest.tree[k], v)


def test_batching_roundtrip_without_knob_reads_back(tmp_path) -> None:
    """A batched snapshot restores with the knob off: the manifest's byte
    ranges carry everything."""
    tensors = {f"a{i}": torch.full((16,), float(i)) for i in range(3)}
    with knobs.enable_batching(), knobs.override_slab_size_threshold_bytes(4096):
        Snapshot.take(str(tmp_path), {"s": TensorTreeState(dict(tensors))})
    dest = TensorTreeState({k: torch.zeros_like(v) for k, v in tensors.items()})
    Snapshot(str(tmp_path)).restore({"s": dest})
    for k, v in tensors.items():
        assert torch.equal(dest.tree[k], v)


def _replicated_worker(pg, path: str) -> bool:
    """Replicated state with batching: the batch-rewritten entry of the
    rank that writes it wins consolidation, and the restore succeeds."""
    tensors = {f"w{i}": torch.full((64,), 1.0 + i) for i in range(6)}
    with knobs.enable_batching(), knobs.override_slab_size_threshold_bytes(512):
        snap = Snapshot.take(path, {"params": TensorTreeState(dict(tensors))}, pg=pg, replicated=["params/**"])
        dest = TensorTreeState({k: torch.zeros_like(v) for k, v in tensors.items()})
        snap.restore({"params": dest})
    return all(torch.equal(dest.tree[k], v) for k, v in tensors.items())


def test_replicated_with_batching(tmp_path) -> None:
    assert all(run_multiprocess(_replicated_worker, 2, args=(str(tmp_path / "s"),)))


def _sharded_worker(pg, path: str) -> bool:
    """Row-sharded DTensors below the slab threshold: their shard entries
    (nested in ShardedArray entries) point into each rank's slab, packed
    by the device pack; the column-sharded restore is bit-identical."""
    import torch.distributed as dist

    from test_torch_resharding import Meshes, local_equal, seeded

    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        full = {f"w{i}": seeded((10 + i, 4), i) for i in range(4)}
        state = {k: meshes.dtensor(v, "row2") for k, v in full.items()}
        with knobs.enable_batching(), knobs.enable_device_pack():
            Snapshot.take(path, {"s": TensorTreeState(state)}, pg=pg)
        fresh = {k: meshes.dtensor(torch.zeros_like(v), "col2") for k, v in full.items()}
        app = {"s": TensorTreeState(fresh)}
        with knobs.enable_batching():
            Snapshot(path, pg=pg).restore(app)
        return all(local_equal(app["s"].tree[k], v) for k, v in full.items())
    finally:
        dist.destroy_process_group()


def test_sharded_entries_batch_into_slabs(tmp_path) -> None:
    path = str(tmp_path / "s")
    assert all(run_multiprocess(_sharded_worker, 2, args=(path,)))
    manifest = Snapshot(path).get_manifest()
    shards = [s for k, e in manifest.items() if e.type == "ShardedArray" for s in e.shards]
    assert len(shards) == 8
    assert all(s.array.location.startswith("batched/") and s.array.byte_range for s in shards)
    assert len(os.listdir(os.path.join(path, "batched"))) == 2  # one slab per rank
    from test_torch_resharding import seeded

    assert torch.equal(Snapshot(path).read_object("0/s/w3"), seeded((13, 4), 3))


# ---------------------------------------------------------------------------
# slab bytes: the device pack, per-member staging, no native runtime, the
# JAX package
# ---------------------------------------------------------------------------


def _arrays(n: int, floats: int) -> dict:
    rng = np.random.default_rng(11)
    return {f"a{i}": rng.standard_normal(floats).astype(np.float32) for i in range(n)}


def _slab(path: str):
    [slab] = glob.glob(os.path.join(path, "batched", "*"))
    with open(os.path.join(path, "checksums", "0")) as f:
        table = json.load(f)
    [entry] = [v for k, v in table.items() if k.startswith("batched/")]
    with open(slab, "rb") as f:
        return f.read(), entry


def _take_batched(path: str, n: int, floats: int, pack: bool, native: bool = True):
    arrays = _arrays(n, floats)
    ctxs = [knobs.enable_batching(), knobs.override_slab_size_threshold_bytes(32 << 20)]
    if pack:
        ctxs.append(knobs.enable_device_pack())
    if not native:
        ctxs.append(knobs.disable_native())
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        Snapshot.take(path, {"s": TensorTreeState({k: torch.from_numpy(v) for k, v in arrays.items()})})
        dest = TensorTreeState({k: torch.zeros(floats) for k in arrays})
        Snapshot(path).restore({"s": dest})
    for k, v in arrays.items():
        assert np.array_equal(dest.tree[k].numpy(), v)
    return _slab(path)


SLAB_CASES = [(8, 1000), (3, (2 << 20) // 4)]  # many members; pages straddle members


@pytest.mark.parametrize("n,floats", SLAB_CASES)
def test_packed_and_per_member_slabs_bit_identical(tmp_path, n, floats) -> None:
    packed = _take_batched(str(tmp_path / "packed"), n, floats, pack=True)
    member = _take_batched(str(tmp_path / "member"), n, floats, pack=False)
    assert packed == member


def test_slab_without_native_runtime_same_bytes(tmp_path) -> None:
    nat_bytes, nat_entry = _take_batched(str(tmp_path / "nat"), 5, 800, pack=True)
    fb_bytes, fb_entry = _take_batched(str(tmp_path / "fb"), 5, 800, pack=True, native=False)
    assert fb_bytes == nat_bytes
    # The algorithm may differ (crc32 vs crc32c) without the runtime.
    assert fb_entry[2] == nat_entry[2]


@pytest.mark.parametrize("n,floats", SLAB_CASES)
def test_slab_bytes_and_checksums_equal_the_jax_package(tmp_path, n, floats) -> None:
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu import knobs as jknobs

    port = _take_batched(str(tmp_path / "port"), n, floats, pack=True)
    jpath = str(tmp_path / "jax")
    with jknobs.enable_batching(), jknobs.override_slab_size_threshold_bytes(32 << 20):
        jts.Snapshot.take(jpath, {"s": jts.PyTreeState(_arrays(n, floats))})
    assert _slab(jpath) == port


def _layout(manifest) -> dict:
    """Leaf -> byte range within its slab, and which leaves share a slab."""
    slabs = {}
    ranges = {}
    for k, e in sorted(manifest.items()):
        if e.type == "Array":
            ranges[k] = list(e.byte_range) if e.byte_range else None
            slabs.setdefault(e.location, []).append(k)
    return {"ranges": ranges, "groups": sorted(sorted(v) for v in slabs.values())}


@pytest.mark.parametrize("pack", [False, True], ids=["per-member", "device-pack"])
def test_batched_snapshots_cross_both_ways(tmp_path, pack) -> None:
    """Either package restores the other's batched snapshot, and both cut
    the same slabs at the same byte ranges (only the slab names, random,
    differ)."""
    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu import knobs as jknobs

    rng = np.random.default_rng(3)
    arrays = {f"a{i}": rng.standard_normal((7 + i, 5)).astype(np.float32) for i in range(9)}
    arrays["big"] = rng.standard_normal(2048).astype(np.float32)  # over the threshold
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    with jknobs.enable_batching(), jknobs.override_slab_size_threshold_bytes(600):
        jts.Snapshot.take(jpath, {"s": jts.PyTreeState(dict(arrays))})
    pack_ctx = knobs.enable_device_pack() if pack else contextlib.nullcontext()
    with knobs.enable_batching(), pack_ctx, knobs.override_slab_size_threshold_bytes(600):
        Snapshot.take(ppath, {"s": TensorTreeState({k: torch.from_numpy(v) for k, v in arrays.items()})})
    assert _layout(jts.Snapshot(jpath).get_manifest()) == _layout(Snapshot(ppath).get_manifest())
    assert len(os.listdir(os.path.join(ppath, "batched"))) > 1

    dest = TensorTreeState({k: torch.zeros(v.shape) for k, v in arrays.items()})
    with knobs.enable_batching():
        Snapshot(jpath).restore({"s": dest})
    for k, v in arrays.items():
        assert np.array_equal(dest.tree[k].numpy(), v), k
    jdest = jts.PyTreeState({k: np.zeros_like(v) for k, v in arrays.items()})
    with jknobs.enable_batching():
        jts.Snapshot(ppath).restore({"s": jdest})
    for k, v in arrays.items():
        assert np.array_equal(np.asarray(jdest.tree[k]), v), k
