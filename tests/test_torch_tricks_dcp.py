"""Interop with ``torch.distributed.checkpoint`` (``tricks/dcp.py``): the
interception pair and migration both ways.

Ports of the orbax cases of the JAX package's ``tests/test_tricks.py``:
migration in both directions (here through DCP's own ``FileSystemWriter``
/ ``FileSystemReader``), the interception point written and read by this
package (here ``SnapshotStorageWriter`` / ``SnapshotStorageReader``), a
save loop (DCP has no manager: ``dcp.async_save`` in a loop) and a key
that does not map. Added: chunked and batched snapshots through the
reader, a failed write that leaves no commit marker, and two gloo ranks
saving ``Shard(0)`` ``DTensor``s that restore at world 1 and load into
``Shard(1)``. The state mixes bf16, f32 and int tensors, a step and a
learning rate, nested dicts and lists, and keys that hold dots. This file
imports no jax (its workers are spawned); the JAX package is compared in
``tests/test_torch_dcp_crosspkg.py``.
"""

import asyncio
import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException

from torchsnapshot_tpu_torch import Snapshot, StateDict, TensorTreeState, knobs
from torchsnapshot_tpu_torch.fsck import verify_snapshot
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess
from torchsnapshot_tpu_torch.tricks import dcp as tdcp
from torchsnapshot_tpu_torch.tricks.dcp import (
    SnapshotStorageReader,
    SnapshotStorageWriter,
    load_dcp_state_dict,
    migrate_dcp_to_snapshot,
    migrate_snapshot_to_dcp,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:torch.distributed is disabled")


def make_state(seed: int = 0) -> dict:
    """bf16, f32 and int tensors, a step and a learning rate, nested dicts
    and lists, dotted keys."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "model": {
            "0.weight": f32(6, 4),
            "0.bias": f32(6),
            "emb.table": f32(16, 8).to(torch.bfloat16),
        },
        "optim": {
            "state": {"0.weight": {"exp_avg": f32(6, 4), "step": torch.tensor(3.0)}},
            "param_groups": [{"lr": 0.001, "betas": (0.9, 0.999), "params": ["0.weight", "0.bias"]}],
        },
        "extra": {
            "ids": torch.from_numpy(rng.integers(-5, 5, (3, 5)).astype(np.int64)),
            "layers": [{"w": f32(2, 3)}, {"w": f32(2, 3)}],
            "step": 7,
            "lr": 0.25,
        },
    }


class Value:
    """A stateful whose state is one value (a top-level leaf of a DCP
    state dict)."""

    def __init__(self, v=None):
        self.v = v

    def state_dict(self):
        return self.v

    def load_state_dict(self, v):
        self.v = v


def zeros_like_state(state):
    if isinstance(state, torch.Tensor):
        return torch.zeros_like(state)
    if isinstance(state, dict):
        return {k: zeros_like_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [zeros_like_state(v) for v in state]
    return copy.deepcopy(state) if not isinstance(state, (int, float)) else type(state)(0)


def assert_same(a, b, where="state") -> None:
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), where
    elif isinstance(a, dict):
        assert set(map(str, a)) == set(map(str, b)), (where, list(a), list(b))
        bs = {str(k): v for k, v in b.items()}
        for k, v in a.items():
            assert_same(v, bs[str(k)], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}.{i}")
    else:
        assert a == b, (where, a, b)


def as_app(state: dict) -> dict:
    return {k: TensorTreeState(v) for k, v in state.items()}


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------


def test_migration_both_directions(tmp_path) -> None:
    state = make_state()
    src = str(tmp_path / "dcp_src")
    dcp.save(state, storage_writer=dcp.FileSystemWriter(src))

    # DCP -> snapshot, raw (no template)
    snap = str(tmp_path / "snap")
    migrate_dcp_to_snapshot(src, snap)
    dest = TensorTreeState(zeros_like_state(state))
    Snapshot(snap).restore({"state": dest})
    assert_same(state, dest.tree)

    # snapshot -> DCP, into a template; then DCP's own reader, both ways
    out = str(tmp_path / "dcp_out")
    restored = migrate_snapshot_to_dcp(snap, out, template=zeros_like_state(state))
    assert_same(state, restored)
    assert_same(state, load_dcp_state_dict(out, template=zeros_like_state(state)))
    raw = load_dcp_state_dict(out)
    assert_same(state["model"], raw["model"])
    assert raw["extra"]["step"] == 7 and raw["extra"]["lr"] == 0.25

    # With a template the migrated snapshot is the template's structure.
    snap2 = str(tmp_path / "snap2")
    migrate_dcp_to_snapshot(src, snap2, template=zeros_like_state(state), key="train")
    dest = TensorTreeState(zeros_like_state(state))
    Snapshot(snap2).restore({"train": dest})
    assert_same(state, dest.tree)


def test_migrated_snapshot_restores_at_world_2_as_replicated(tmp_path) -> None:
    src = str(tmp_path / "dcp_src")
    state = make_state(1)
    dcp.save(state, storage_writer=dcp.FileSystemWriter(src))
    snap = str(tmp_path / "snap")
    migrate_dcp_to_snapshot(src, snap)
    manifest = Snapshot(snap).get_manifest()
    leaves = {k: e for k, e in manifest.items() if e.type in ("Array", "object", "int", "float", "str")}
    assert leaves and all(k.startswith("0/") and e.replicated for k, e in leaves.items())


# ---------------------------------------------------------------------------
# interception: the writer and the reader
# ---------------------------------------------------------------------------


def test_writer_restored_by_snapshot_restore(tmp_path) -> None:
    state = make_state(2)
    path = str(tmp_path / "snap")
    dcp.save(state, storage_writer=SnapshotStorageWriter(path))
    assert os.path.exists(os.path.join(path, SNAPSHOT_METADATA_FNAME))
    report = verify_snapshot(path, deep=True)
    assert report.ok, report.problems
    assert report.crcs_verified > 0

    app = as_app(zeros_like_state(state))
    Snapshot(path).restore(app)
    for k, v in state.items():
        assert_same(v, app[k].tree, k)

    # Template-free: every value comes back, in its structure.
    raw = {k: StateDict() for k in state}
    Snapshot(path).restore(raw)
    for k, v in state.items():
        assert_same(v, raw[k].data, k)
    # And the reader serves what the writer wrote.
    back = zeros_like_state(state)
    dcp.load(back, storage_reader=SnapshotStorageReader(path))
    assert_same(state, back)


def test_writer_dict_keys_that_read_as_integers_come_back_as_integers(tmp_path) -> None:
    """An optimizer's own state dict is keyed by parameter ids: restored
    natively from the writer's output it loads into the optimizer."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    path = str(tmp_path / "snap")
    dcp.save({"optim": opt.state_dict()}, storage_writer=SnapshotStorageWriter(path))
    raw = {"optim": StateDict()}
    Snapshot(path).restore(raw)
    assert sorted(raw["optim"].data["state"]) == [0, 1]
    fresh = torch.optim.AdamW(torch.nn.Linear(4, 3).parameters(), lr=0.5)
    fresh.load_state_dict(raw["optim"].data)
    assert fresh.param_groups[0]["lr"] == 0.1
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"], opt.state_dict()["state"][0]["exp_avg"])


@pytest.mark.parametrize("layout", ["plain", "chunked", "batched"])
def test_reader_over_snapshot_take(tmp_path, layout) -> None:
    state = make_state(3)
    path = str(tmp_path / "snap")
    if layout == "chunked":
        ctx = knobs.override_max_chunk_size_bytes(40)
    elif layout == "batched":
        ctx = knobs.enable_batching()
    else:
        ctx = knobs.disable_checksums()
    with ctx:
        Snapshot.take(path, as_app(state))
    manifest = Snapshot(path).get_manifest()
    types = {e.type for e in manifest.values()}
    if layout == "chunked":
        assert "ChunkedArray" in types
    if layout == "batched":
        assert any(getattr(e, "location", "").startswith("batched/") for e in manifest.values())
    dest = zeros_like_state(state)
    with (knobs.enable_batching() if layout == "batched" else knobs.override_max_chunk_size_bytes(1 << 30)):
        dcp.load(dest, storage_reader=SnapshotStorageReader(path))
    assert_same(state, dest)


def test_top_level_values(tmp_path) -> None:
    """A DCP state dict's top-level leaf is an app-state key whose
    stateful holds one value, both ways."""
    path = str(tmp_path / "snap")
    dcp.save({"step": 11, "w": torch.arange(4.0)}, storage_writer=SnapshotStorageWriter(path))
    app = {"step": Value(0), "w": Value(torch.zeros(4))}
    Snapshot(path).restore(app)
    assert app["step"].v == 11 and torch.equal(app["w"].v, torch.arange(4.0))
    path2 = str(tmp_path / "take")
    Snapshot.take(path2, {"step": Value(12), "w": Value(torch.ones(3))})
    dest = {"step": 0, "w": torch.zeros(3)}
    dcp.load(dest, storage_reader=SnapshotStorageReader(path2))
    assert dest["step"] == 12 and torch.equal(dest["w"], torch.ones(3))


def test_reader_reads_only_the_rows_it_needs(tmp_path, monkeypatch) -> None:
    """A destination that wants a row band of a saved tensor reads that
    band's bytes, not the blob (``plan_row_slab_reads``)."""
    from torch.distributed.checkpoint.planner import LoadItemType, ReadItem
    from torch.distributed.checkpoint.metadata import MetadataIndex

    full = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"m": TensorTreeState({"w": full})})
    reader = SnapshotStorageReader(path)
    reader.read_metadata()
    dst = torch.zeros(16, 8)

    class Planner:
        def resolve_tensor(self, item):
            return dst

        def commit_tensor(self, item, tensor):
            pass

    item = ReadItem(
        type=LoadItemType.TENSOR, dest_index=MetadataIndex("m.w"), dest_offsets=torch.Size([0, 0]),
        storage_index=MetadataIndex("m.w", torch.Size([0, 0])), storage_offsets=torch.Size([32, 0]),
        lengths=torch.Size([16, 8]),
    )
    seen = []
    real = tdcp.sync_execute_read_reqs

    def spy(read_reqs, **kw):
        seen.extend(r.byte_range for r in read_reqs)
        return real(read_reqs=read_reqs, **kw)

    monkeypatch.setattr(tdcp, "sync_execute_read_reqs", spy)
    reader.read_data(type("P", (), {"items": [item]})(), Planner()).wait()
    assert seen == [(32 * 32, 48 * 32)]
    assert torch.equal(dst, full[32:48])


def test_async_save_through_the_writer(tmp_path) -> None:
    """DCP has no manager: a loop of ``dcp.async_save`` calls, each to its
    own step directory, each committed and restorable."""
    futures = []
    states = [make_state(10 + step) for step in range(3)]
    for step, state in enumerate(states):
        futures.append(dcp.async_save(state, storage_writer=SnapshotStorageWriter(str(tmp_path / f"step_{step}"))))
    for fut in futures:
        fut.result()
    for step, state in enumerate(states):
        path = str(tmp_path / f"step_{step}")
        assert os.path.exists(os.path.join(path, SNAPSHOT_METADATA_FNAME))
        dest = {"model": TensorTreeState(zeros_like_state(state["model"]))}
        Snapshot(path).restore(dest)
        assert_same(state["model"], dest["model"].tree)


def test_save_and_load_inside_a_running_event_loop(tmp_path) -> None:
    state = make_state(4)
    path = str(tmp_path / "snap")

    async def main():
        dcp.save(state, storage_writer=SnapshotStorageWriter(path))
        back = zeros_like_state(state)
        dcp.load(back, storage_reader=SnapshotStorageReader(path))
        return back

    assert_same(state, asyncio.run(main()))


def test_unmapped_key_raises_and_names_it(tmp_path) -> None:
    path = str(tmp_path / "snap")
    dcp.save({"model": {"w": torch.ones(2)}}, storage_writer=SnapshotStorageWriter(path))
    with pytest.raises(CheckpointException) as info:
        dcp.load({"model": {"w": torch.zeros(2), "missing": torch.zeros(1)}}, storage_reader=SnapshotStorageReader(path))
    assert "model.missing" in str(info.value.failures)
    # Two manifest paths that flatten to one DCP name.
    clash = str(tmp_path / "clash")
    Snapshot.take(clash, {"m": TensorTreeState({"a.b": {"c": torch.ones(1)}, "a": {"b.c": torch.ones(1)}})})
    with pytest.raises(ValueError, match="m.a.b.c"):
        SnapshotStorageReader(clash).read_metadata()
    # A name the save planner cannot place.
    with pytest.raises(ValueError, match="'x.y'"):
        tdcp._obj_path("x.y", {"x.z": ("x", "z")})


def test_failed_write_leaves_no_commit_marker(tmp_path, monkeypatch) -> None:
    real = tdcp.prepare_write

    def failing(obj, logical_path, *args, **kwargs):
        if logical_path.endswith("emb.table"):
            raise RuntimeError("injected write failure")
        return real(obj, logical_path, *args, **kwargs)

    monkeypatch.setattr(tdcp, "prepare_write", failing)
    path = str(tmp_path / "snap")
    with pytest.raises(CheckpointException) as info:
        dcp.save(make_state(5), storage_writer=SnapshotStorageWriter(path))
    assert "injected write failure" in str(info.value.failures)
    assert not os.path.exists(os.path.join(path, SNAPSHOT_METADATA_FNAME))


def test_refused_dtypes_are_refused_by_name(tmp_path) -> None:
    from torchsnapshot_tpu_torch.manifest import ArrayEntry

    manifest = {"m": tdcp.DictEntry(keys=["w"]), "m/w": ArrayEntry("x", "buffer_protocol", "int4", [2], False)}
    with pytest.raises(ValueError, match="int4"):
        tdcp._dcp_view(manifest, tdcp._children(manifest))


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

SHAPES = {"w": (30, 6), "b": (18,), "e": (12, 4)}


def _full(name: str) -> torch.Tensor:
    from test_torch_resharding import seeded

    t = seeded(SHAPES[name], {"w": 1, "b": 2, "e": 3}[name])
    return t.to(torch.bfloat16) if name == "e" else t


_REAL_WRITE_BOX = tdcp.write_box


def _failing_write_box(*args, **kwargs):
    raise RuntimeError("injected write failure")


def _plain(i: int) -> torch.Tensor:
    return torch.arange(5, dtype=torch.float32) * (i + 1)


def world2_dcp_worker(pg, root: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from test_torch_resharding import Meshes, local_equal

    torch.set_num_threads(1)
    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        mesh = meshes._meshes[(pg.world_size,)]

        def dtensors(dim, zeros=False):
            out = {}
            for name in SHAPES:
                full = _full(name)
                d = dim if full.dim() > dim else 0
                out[name] = meshes.dtensor(torch.zeros_like(full) if zeros else full, ((2,), (("S", d),)))
            return out

        out = {}
        # (1) dcp.save through the writer, Shard(0)
        # with plain tensors, which DCP writes once, from either rank.
        state = {"m": dtensors(0), "rep": {f"t{i}": _plain(i) for i in range(4)}, "step": 3}
        dcp.save(state, storage_writer=SnapshotStorageWriter(os.path.join(root, "writer")))
        # (2) the writer's output through the reader into Shard(1)
        dest = {"m": dtensors(1, zeros=True), "rep": {f"t{i}": torch.zeros(5) for i in range(4)}, "step": 0}
        dcp.load(dest, storage_reader=SnapshotStorageReader(os.path.join(root, "writer")))
        out["reader_shard1"] = (
            all(local_equal(dest["m"][n], _full(n)) for n in SHAPES)
            and all(torch.equal(dest["rep"][f"t{i}"], _plain(i)) for i in range(4))
            and dest["step"] == 3
        )
        # Every rank restores the plain tensors natively, whoever wrote them.
        rep = {"rep": TensorTreeState({f"t{i}": torch.zeros(5) for i in range(4)})}
        Snapshot(os.path.join(root, "writer"), pg=pg).restore(rep)
        out["replicated_on_every_rank"] = all(torch.equal(rep["rep"].tree[f"t{i}"], _plain(i)) for i in range(4))
        # (3) Snapshot.take of Shard(0), loaded by the reader into Shard(1)
        Snapshot.take(os.path.join(root, "take"), {"m": TensorTreeState(dtensors(0))}, pg=pg)
        dest = {"m": dtensors(1, zeros=True)}
        dcp.load(dest, storage_reader=SnapshotStorageReader(os.path.join(root, "take"), pg=pg))
        out["take_reader_shard1"] = all(local_equal(dest["m"][n], _full(n)) for n in SHAPES)
        # (4) migration both ways with DTensor templates
        dcp.save({"m": dtensors(0)}, storage_writer=dcp.FileSystemWriter(os.path.join(root, "dcp_src")))
        migrate_dcp_to_snapshot(
            os.path.join(root, "dcp_src"), os.path.join(root, "migrated"), template={"m": dtensors(1, zeros=True)},
            pg=pg,
        )
        back = migrate_snapshot_to_dcp(
            os.path.join(root, "migrated"), os.path.join(root, "dcp_out"), template={"m": dtensors(0, zeros=True)},
            pg=pg,
        )
        out["migrated_back"] = all(local_equal(back["m"][n], _full(n)) for n in SHAPES)
        dest = {"m": dtensors(1, zeros=True)}
        dcp.load(dest, storage_reader=dcp.FileSystemReader(os.path.join(root, "dcp_out")))
        out["dcp_out_shard1"] = all(local_equal(dest["m"][n], _full(n)) for n in SHAPES)
        # (5) a write that fails on rank 1 alone: every rank raises, no marker.
        failed = os.path.join(root, "failed")
        if pg.rank == 1:
            tdcp.write_box = _failing_write_box
        try:
            dcp.save({"m": dtensors(0)}, storage_writer=SnapshotStorageWriter(failed))
            out["failure_raised"] = False
        except CheckpointException as e:
            out["failure_raised"] = "injected write failure" in str(e.failures)
        finally:
            tdcp.write_box = _REAL_WRITE_BOX
        dist.barrier()
        out["no_marker"] = not os.path.exists(os.path.join(failed, SNAPSHOT_METADATA_FNAME))
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dcp_world2"))
    return root, run_multiprocess(world2_dcp_worker, 2, args=(root,))


@pytest.mark.parametrize(
    "check",
    [
        "reader_shard1", "replicated_on_every_rank", "take_reader_shard1", "migrated_back", "dcp_out_shard1",
        "failure_raised", "no_marker",
    ],
)
def test_world2_routes_are_bit_identical(world2, check) -> None:
    _, results = world2
    assert all(r[check] for r in results), results


def _rank_bytes(path: str) -> dict:
    from torchsnapshot_tpu_torch.serialization import array_size_bytes

    out = {}
    for key, entry in Snapshot(path).get_manifest().items():
        if entry.type == "ShardedArray":
            rank = int(key.split("/", 1)[0])
            out[rank] = out.get(rank, 0) + sum(array_size_bytes(s.sizes, entry.dtype) for s in entry.shards)
    return out


@pytest.mark.parametrize("name", ["writer", "migrated"])
def test_world2_each_rank_writes_half(world2, name) -> None:
    root, _ = world2
    by_rank = _rank_bytes(os.path.join(root, name))
    total = sum(by_rank.values())
    assert set(by_rank) == {0, 1}
    for share in by_rank.values():
        assert abs(share / total - 0.5) <= 0.01, by_rank


def test_world2_writer_restores_at_world_1(world2) -> None:
    root, _ = world2
    path = os.path.join(root, "writer")
    dest = {"m": TensorTreeState({n: torch.zeros_like(_full(n)) for n in SHAPES}), "step": Value(0)}
    Snapshot(path).restore(dest)
    for n in SHAPES:
        assert_same(_full(n), dest["m"].tree[n], n)
    assert dest["step"].v == 3
    rep = {"rep": TensorTreeState({f"t{i}": torch.zeros(5) for i in range(4)})}
    Snapshot(path).restore(rep)
    assert all(torch.equal(rep["rep"].tree[f"t{i}"], _plain(i)) for i in range(4))
    manifest = Snapshot(path).get_manifest()
    assert all(manifest[f"0/rep/t{i}"].replicated for i in range(4))
    assert verify_snapshot(path, deep=True).problems == []
