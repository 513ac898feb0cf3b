"""Multi-process take and restore of the port: per-rank state, replicated
write-load partitioning, the manifest gather, fail-fast barriers, async
takes and restores across ranks, elastic world-size changes, and the
cross-package cases.

Port of the JAX package's ``tests/test_distributed_snapshot.py`` on the
port's TCP-store harness (spawned workers that import the port and never
``jax``). Its sharded cases (a ``jax.Array`` spanning processes) wait for
``DTensor`` (ROADMAP queue 1 step 6). Added here: a two-rank JAX snapshot
taken by the JAX harness restores through two port ranks bit for bit and
the reverse, and both packages' two-rank takes of one numpy state give the
same manifest and the same blobs per rank (each rank's checksum table
lists the blobs it wrote). Every comparison of state is bitwise.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import (
    RngState,
    Snapshot,
    StateDict,
    TensorTreeState,
    knobs,
)
from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.test_utils import (
    faulty_fs_plugin,
    patch_storage_plugin,
    run_multiprocess,
)


def _clean(pg, path: str) -> None:
    if pg.rank == 0:
        import shutil

        shutil.rmtree(path, ignore_errors=True)
    PGWrapper(pg).barrier()


# ---------------------------------------------------------------------------
# Ports of the JAX package's cases
# ---------------------------------------------------------------------------


def _restore_peer_failure_worker(pg, path: str):
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    _clean(pg, path)
    state = {"m": TensorTreeState({"w": torch.full((4096,), 1.0 + pg.rank)})}
    Snapshot.take(path, state, pg=pg)
    # Data blobs only: metadata and checksum-table reads precede any
    # cross-rank coordination.
    faulty = faulty_fs_plugin(lambda p: "/m/" in p, ops=("read",), exc_msg="injected read failure")
    dst = {"m": TensorTreeState({"w": torch.zeros(4096)})}
    t0 = time.monotonic()
    with patch_storage_plugin(faulty if pg.rank == 1 else FSStoragePlugin), pytest.raises(Exception):
        Snapshot(path, pg=pg).restore(dst)
    elapsed = time.monotonic() - t0
    dst2 = {"m": TensorTreeState({"w": torch.zeros(4096)})}
    Snapshot(path, pg=pg).restore(dst2)
    assert torch.equal(dst2["m"].tree["w"], torch.full((4096,), 1.0 + pg.rank))
    return elapsed


def test_restore_peer_failure_fails_fast(tmp_path) -> None:
    """Rank 1's data reads fail mid-restore: the error propagates through
    the inter-stateful barrier, so rank 0 raises within seconds instead of
    at the 300 s store timeout, and a clean retry restores per-rank
    values."""
    elapsed = run_multiprocess(_restore_peer_failure_worker, 2, args=(str(tmp_path / "s"),))
    assert max(elapsed) < 60.0, elapsed


def _take_and_manifest_worker(pg, path: str):
    _clean(pg, path)
    app_state = {
        "params": TensorTreeState({"w": torch.full((64, 8), 7.5), "b": torch.arange(8.0)}),
        "progress": StateDict(rank_steps=100 + pg.rank),
    }
    snap = Snapshot.take(path, app_state, pg=pg, replicated=["params/**"])
    md = snap.metadata
    assert md.world_size == 2
    # Replicated entries live under rank 0 only; per-rank entries per rank.
    assert md.manifest["0/params/w"].replicated
    assert "1/params/w" not in md.manifest
    assert "0/progress/rank_steps" in md.manifest
    assert "1/progress/rank_steps" in md.manifest
    # One copy of each replicated blob on disk.
    assert os.path.exists(os.path.join(path, "replicated", "params", "w"))
    assert os.path.exists(os.path.join(path, "replicated", "params", "b"))
    fresh = {
        "params": TensorTreeState({"w": torch.zeros(64, 8), "b": torch.zeros(8)}),
        "progress": StateDict(rank_steps=-1),
    }
    Snapshot(path, pg=pg).restore(fresh)
    assert torch.equal(fresh["params"].tree["w"], torch.full((64, 8), 7.5))
    assert torch.equal(fresh["params"].tree["b"], torch.arange(8.0))
    assert fresh["progress"]["rank_steps"] == 100 + pg.rank


def test_distributed_take_and_manifest(tmp_path) -> None:
    run_multiprocess(_take_and_manifest_worker, 2, args=(str(tmp_path / "s"),))


def _glob_worker(pg, path: str):
    _clean(pg, path)
    replicated = ["p/**"] if pg.rank == 0 else []
    snap = Snapshot.take(path, {"p": TensorTreeState({"w": torch.ones(4)})}, pg=pg, replicated=replicated)
    md = snap.metadata
    # Not replicated anywhere: per-rank entries on both ranks.
    assert not md.manifest["0/p/w"].replicated
    assert "1/p/w" in md.manifest


def test_replicated_glob_must_match_everywhere(tmp_path) -> None:
    """A glob only some ranks declare is not treated as replicated."""
    run_multiprocess(_glob_worker, 2, args=(str(tmp_path / "s"),))


def _elastic_take_worker(pg, path: str):
    _clean(pg, path)
    app_state = {
        "params": TensorTreeState({"w": torch.full((16,), 3.0)}),
        "progress": StateDict(steps=pg.rank),
        "own": TensorTreeState({"x": torch.full((8,), 10.0 + pg.rank)}),
    }
    Snapshot.take(path, app_state, pg=pg, replicated=["params/**"])


def test_elastic_restore_world2_to_world1_replicated(tmp_path) -> None:
    """A world-size-2 snapshot restored by one process: the replicated
    state and rank 0's per-rank state restore, and rank 1's per-rank
    entries are readable only through ``read_object("1/...")``."""
    path = str(tmp_path / "s")
    run_multiprocess(_elastic_take_worker, 2, args=(path,))
    fresh = {
        "params": TensorTreeState({"w": torch.zeros(16)}),
        "progress": StateDict(steps=-1),
        "own": TensorTreeState({"x": torch.zeros(8)}),
    }
    Snapshot(path).restore(fresh)
    assert torch.equal(fresh["params"].tree["w"], torch.full((16,), 3.0))
    assert fresh["progress"]["steps"] == 0  # rank 0's own value
    assert torch.equal(fresh["own"].tree["x"], torch.full((8,), 10.0))
    snap = Snapshot(path)
    assert torch.equal(snap.read_object("1/own/x"), torch.full((8,), 11.0))
    assert snap.read_object("1/progress/steps") == 1
    # Replicated entries are visible to every rank's path.
    assert torch.equal(snap.read_object("1/params/w"), torch.full((16,), 3.0))


def test_partitioner_balances_loads() -> None:
    """Unit level: greedy assignment spreads replicated bytes by argmin
    load, seen from rank 0 of a simulated two-rank world."""
    from torchsnapshot_tpu_torch.io_types import BufferStager, WriteReq
    from torchsnapshot_tpu_torch.partitioner import partition_write_reqs

    class FakeStager(BufferStager):
        def __init__(self, n):
            self.n = n

        async def stage_buffer(self, executor=None):
            return b"x" * self.n

        def get_staging_cost_bytes(self):
            return self.n

    class FakePG(PGWrapper):
        """Rank 0 of two ranks in one process: gathers are symmetric
        because replicated inputs are identical, and rank 0's broadcast is
        the identity."""

        def __init__(self, rank):
            self.store = None
            self.rank = rank
            self.world_size = 2

        def gather_object(self, obj, dst=0):
            return [obj, obj] if self.rank == dst else None

        def broadcast_object(self, obj, src=0):
            assert self.rank == src
            return obj

    reqs = [
        WriteReq("replicated/a", FakeStager(100)),
        WriteReq("replicated/b", FakeStager(90)),
        WriteReq("replicated/c", FakeStager(10)),
        WriteReq("0/own", FakeStager(5)),
    ]
    _, kept0 = partition_write_reqs({}, list(reqs), FakePG(0))
    kept0_paths = {r.path for r in kept0}
    assert "0/own" in kept0_paths
    # Loads start [5, 5]: a (100) goes to rank 0 on the tie, b (90) to
    # rank 1, c (10) to the lighter rank 1.
    assert "replicated/a" in kept0_paths
    assert "replicated/b" not in kept0_paths


def _four_rank_worker(pg, path: str):
    _clean(pg, path)
    app_state = {
        # 64x64 fp32 with 16-row chunks: 4 sub-partitionable chunks.
        "params": TensorTreeState(
            {"big": torch.arange(64.0 * 64).reshape(64, 64), "small": torch.full((32,), 1.5)}
        ),
        "progress": StateDict(steps=100 + pg.rank),
    }
    with knobs.override_max_chunk_size_bytes(64 * 4 * 16):
        snap = Snapshot.take(path, app_state, pg=pg, replicated=["params/**"])
    md = snap.metadata
    assert md.world_size == 4
    assert md.manifest["0/params/big"].replicated
    for r in (1, 2, 3):
        assert f"{r}/params/big" not in md.manifest
        assert f"{r}/progress/steps" in md.manifest
    # Consolidation gives the gathered entry its complete chunk list.
    assert len(md.manifest["0/params/big"].chunks) == 4
    fresh = {
        "params": TensorTreeState({"big": torch.zeros(64, 64), "small": torch.zeros(32)}),
        "progress": StateDict(steps=-1),
    }
    Snapshot(path, pg=pg).restore(fresh)
    assert torch.equal(fresh["params"].tree["big"], torch.arange(64.0 * 64).reshape(64, 64))
    assert torch.equal(fresh["params"].tree["small"], torch.full((32,), 1.5))
    assert fresh["progress"]["steps"] == 100 + pg.rank


def test_four_rank_protocol_roundtrip(tmp_path) -> None:
    """The whole protocol at 4 ranks: replicated verification,
    bin-packing, chunk sub-partitioning, manifest gather, commit barrier,
    then a 4-rank restore."""
    run_multiprocess(_four_rank_worker, 4, args=(str(tmp_path / "s"),))


def _rng_one_rank_worker(pg, path: str):
    _clean(pg, path)
    state = {"aa": StateDict(v=pg.rank), "zz": StateDict(w=10 + pg.rank)}
    if pg.rank == 0:
        state["mm_rng"] = RngState()
    snap = Snapshot.take(path, state, pg=pg)
    md = snap.metadata
    assert any(k.startswith("0/mm_rng/") for k in md.manifest)
    assert "1/aa/v" in md.manifest
    dest = {"aa": StateDict(v=-1), "zz": StateDict(w=-1)}
    if pg.rank == 0:
        dest["mm_rng"] = RngState()
    Snapshot(path, pg=pg).restore(dest)
    assert dest["aa"]["v"] == pg.rank
    assert dest["zz"]["w"] == 10 + pg.rank


def test_take_rng_on_one_rank_keeps_barrier_schedule(tmp_path) -> None:
    """An RngState on only one rank must not reorder the gathered key list
    (its capture happens out of band; its key keeps its sorted slot)."""
    run_multiprocess(_rng_one_rank_worker, 2, args=(str(tmp_path / "s"),))


def _setup_failure_worker(pg, path: str):
    import contextlib
    from unittest import mock

    _clean(pg, path)
    state = {"m": TensorTreeState({"w": torch.full((2048,), 2.0 + pg.rank, dtype=torch.float64)})}
    Snapshot.take(path, state, pg=pg)
    dest = {"m": TensorTreeState({"w": torch.zeros(2048, dtype=torch.float64)})}
    ctx = (
        mock.patch(
            "torchsnapshot_tpu_torch.snapshot.get_manifest_for_rank",
            side_effect=OSError("injected manifest read failure"),
        )
        if pg.rank == 1
        else contextlib.nullcontext()
    )
    t0 = time.monotonic()
    with ctx, pytest.raises(Exception):
        Snapshot(path, pg=pg).restore(dest)
    elapsed = time.monotonic() - t0
    dest2 = {"m": TensorTreeState({"w": torch.zeros(2048, dtype=torch.float64)})}
    Snapshot(path, pg=pg).restore(dest2)
    assert torch.equal(dest2["m"].tree["w"], torch.full((2048,), 2.0 + pg.rank, dtype=torch.float64))
    return elapsed


def test_restore_setup_failure_fails_fast(tmp_path) -> None:
    """Rank 1 fails in restore setup (the manifest read): the failure is
    reported into key barrier 0, so rank 0 abandons in seconds."""
    elapsed = run_multiprocess(_setup_failure_worker, 2, args=(str(tmp_path / "s"),))
    assert max(elapsed) < 60.0, elapsed


# ---------------------------------------------------------------------------
# Async take and restore across ranks; a failing writer
# ---------------------------------------------------------------------------


def _async_worker(pg, path: str):
    _clean(pg, path)
    w = torch.arange(4096.0).reshape(64, 64)
    state = {
        "m": TensorTreeState({"w": w.clone(), "mine": torch.full((256,), float(pg.rank))}),
        "p": StateDict(step=7 + pg.rank),
    }
    pending = Snapshot.async_take(path, state, pg=pg, replicated=["m/w"])
    # The live state may change at once; the snapshot holds the state at
    # the call.
    state["m"].tree["w"].add_(1.0)
    snap = pending.wait()
    assert snap.metadata.manifest["0/m/w"].replicated
    dest = {
        "m": TensorTreeState({"w": torch.zeros(64, 64), "mine": torch.zeros(256)}),
        "p": StateDict(step=-1),
    }
    restore = Snapshot(path, pg=pg).async_restore(dest)
    assert torch.equal(dest["m"].tree["w"], torch.zeros(64, 64))  # untouched until wait()
    restore.wait()
    assert torch.equal(dest["m"].tree["w"], w)
    assert torch.equal(dest["m"].tree["mine"], torch.full((256,), float(pg.rank)))
    assert dest["p"]["step"] == 7 + pg.rank
    with open(os.path.join(path, SNAPSHOT_METADATA_FNAME)) as f:
        return sorted(json.load(f)["manifest"])


def test_async_take_and_restore_across_ranks(tmp_path) -> None:
    """async_take with a process group commits once through the store
    barrier on the background threads; async_restore plans with barriers
    on the calling thread and applies in wait()."""
    keys = run_multiprocess(_async_worker, 2, args=(str(tmp_path / "s"),))
    assert keys[0] == keys[1]
    assert "0/m/w" in keys[0] and "1/m/w" not in keys[0] and "1/m/mine" in keys[0]


def _failing_writer_worker(pg, path: str, use_async: bool):
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    _clean(pg, path)
    faulty = faulty_fs_plugin(lambda p: p.startswith(f"{pg.rank}/"), exc_msg="injected write failure")
    state = {"m": TensorTreeState({"mine": torch.full((1024,), float(pg.rank))})}
    t0 = time.monotonic()
    with patch_storage_plugin(faulty if pg.rank == 1 else FSStoragePlugin), pytest.raises(Exception):
        if use_async:
            Snapshot.async_take(path, state, pg=pg).wait()
        else:
            Snapshot.take(path, state, pg=pg)
    return time.monotonic() - t0


@pytest.mark.parametrize("use_async", [False, True], ids=["take", "async-take"])
def test_failing_writer_leaves_no_commit(tmp_path, use_async: bool) -> None:
    """Rank 1's data writes fail: rank 0 raises within seconds through
    the commit barrier, and no commit marker is left."""
    path = str(tmp_path / "s")
    elapsed = run_multiprocess(_failing_writer_worker, 2, args=(path, use_async))
    assert max(elapsed) < 30.0, elapsed
    assert not os.path.exists(os.path.join(path, SNAPSHOT_METADATA_FNAME))


def _world1_replicated_restore_worker(pg, path: str):
    dest = {"m": TensorTreeState({"w": torch.zeros(32)}), "p": StateDict(step=-1)}
    Snapshot(path, pg=pg).restore(dest)
    assert torch.equal(dest["m"].tree["w"], torch.arange(32.0))
    return dest["p"]["step"]


def test_world1_replicated_snapshot_restores_on_two_ranks(tmp_path) -> None:
    """A world-1 snapshot taken with ``replicated=`` serves every rank of
    a later world: its replicated entries are visible to all of them."""
    path = str(tmp_path / "s")
    Snapshot.take(
        path,
        {"m": TensorTreeState({"w": torch.arange(32.0)}), "p": StateDict(step=5)},
        replicated=["**"],
    )
    assert run_multiprocess(_world1_replicated_restore_worker, 2, args=(path,)) == [5, 5]


def test_fanout_restore_is_refused(tmp_path) -> None:
    """Fan-out restore, once refused, now works: a multi-rank restore asked
    for it by rank 0's knob restores on every rank (the name is kept; the
    fan-out cases proper are in test_torch_fanout_restore.py). Only rank 0's
    knob counts: rank 1 turns it off and still takes part in the rounds."""
    path = str(tmp_path / "s")
    Snapshot.take(path, {"p": StateDict(step=5)}, replicated=["**"])
    with knobs.enable_fanout_restore():
        assert run_multiprocess(_fanout_worker, 2, args=(path,), timeout=60.0) == [5, 5]


def _fanout_worker(pg, path: str):
    if pg.rank == 1:
        os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "0"
    dest = {"p": StateDict(step=-1)}
    Snapshot(path, pg=pg).restore(dest)
    return dest["p"]["step"]


# ---------------------------------------------------------------------------
# Cross-package: the JAX package's two-rank snapshots and the port's
# ---------------------------------------------------------------------------

CHUNK_BYTES = 64 * 32 * 4  # "big" below splits into 4 chunks


def _np_state(rank: int) -> dict:
    rng = np.random.default_rng(1234)
    return {
        "big": rng.standard_normal((256, 32)).astype(np.float32),
        "w": rng.standard_normal((40, 24)).astype(np.float32),
        "h": rng.standard_normal((17,)).astype(np.float16),
        "i": np.arange(50, dtype=np.int64) * 3,
        "mine": np.full((100,), 1.5 + rank, np.float64),
    }


REPLICATED = ["m/big", "m/w", "m/h", "m/i"]


def _jax_take_worker(pg, path: str):
    os.environ["TORCHSNAPSHOT_TPU_MAX_CHUNK_SIZE_BYTES"] = str(CHUNK_BYTES)
    import torchsnapshot_tpu as jts

    state = {"m": jts.PyTreeState(_np_state(pg.rank)), "p": jts.StateDict(step=10 + pg.rank)}
    jts.Snapshot.take(path, state, pg=pg, replicated=REPLICATED)


def _jax_restore_worker(pg, path: str):
    import torchsnapshot_tpu as jts

    ref = _np_state(pg.rank)
    tree = {k: np.zeros_like(v) for k, v in ref.items()}
    dest = {"m": jts.PyTreeState(tree), "p": jts.StateDict(step=-1)}
    jts.Snapshot(path, pg=pg).restore(dest)
    for k, v in ref.items():
        got = np.asarray(dest["m"].tree[k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
    return dest["p"]["step"]


def _port_take_worker(pg, path: str):
    os.environ["TORCHSNAPSHOT_TPU_MAX_CHUNK_SIZE_BYTES"] = str(CHUNK_BYTES)
    tree = {k: torch.from_numpy(v) for k, v in _np_state(pg.rank).items()}
    Snapshot.take(path, {"m": TensorTreeState(tree), "p": StateDict(step=10 + pg.rank)}, pg=pg, replicated=REPLICATED)


def _port_restore_worker(pg, path: str):
    ref = _np_state(pg.rank)
    tree = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in ref.items()}
    dest = {"m": TensorTreeState(tree), "p": StateDict(step=-1)}
    Snapshot(path, pg=pg).restore(dest)
    for k, v in ref.items():
        got = dest["m"].tree[k].numpy()
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
    return dest["p"]["step"]


def _jax_run_multiprocess(fn, nproc: int, args):
    from torchsnapshot_tpu.test_utils import run_multiprocess as jax_run_multiprocess

    return jax_run_multiprocess(fn, nproc=nproc, args=args)


def test_jax_two_rank_snapshot_restores_through_port_ranks(tmp_path) -> None:
    path = str(tmp_path / "jax_snap")
    _jax_run_multiprocess(_jax_take_worker, 2, (path,))
    assert run_multiprocess(_port_restore_worker, 2, args=(path,)) == [10, 11]


def test_port_two_rank_snapshot_restores_through_jax_ranks(tmp_path) -> None:
    path = str(tmp_path / "port_snap")
    run_multiprocess(_port_take_worker, 2, args=(path,))
    assert _jax_run_multiprocess(_jax_restore_worker, 2, (path,)) == [10, 11]


def test_both_packages_take_the_same_layout(tmp_path) -> None:
    """Both packages' two-rank takes of one numpy state: the same manifest
    entries, and each rank writes the same blobs with the same CRCs (its
    checksum table lists what it wrote), so the partition of replicated
    state agrees."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    run_multiprocess(_port_take_worker, 2, args=(ours,))
    _jax_run_multiprocess(_jax_take_worker, 2, (theirs,))

    def manifest(path):
        with open(os.path.join(path, SNAPSHOT_METADATA_FNAME)) as f:
            return json.load(f)["manifest"]

    def tables(path):
        out = {}
        for rank in (0, 1):
            with open(os.path.join(path, "checksums", str(rank))) as f:
                out[rank] = json.load(f)
        return out

    assert manifest(ours) == manifest(theirs)
    ours_tables, theirs_tables = tables(ours), tables(theirs)
    assert ours_tables == theirs_tables
    # The replicated chunks were spread, not all written by one rank.
    assert all(any(p.startswith("replicated/") for p in t) for t in ours_tables.values())

    # What each rank of a later world sees: the same entries from both
    # packages' get_manifest_for_rank, at ranks 0 and 1 and at a rank the
    # snapshot never had (replicated entries and their containers only).
    from torchsnapshot_tpu.manifest import entry_to_yaml_obj as jax_entry_obj
    from torchsnapshot_tpu.manifest import get_manifest_for_rank as jax_manifest_for_rank
    from torchsnapshot_tpu.snapshot import Snapshot as JaxSnapshot
    from torchsnapshot_tpu_torch.manifest import entry_to_yaml_obj, get_manifest_for_rank

    port_md, jax_md = Snapshot(ours).metadata, JaxSnapshot(ours).metadata
    for rank in (0, 1, 2):
        mine = get_manifest_for_rank(port_md, rank)
        ref = jax_manifest_for_rank(jax_md, rank)
        assert {k: entry_to_yaml_obj(e) for k, e in mine.items()} == {
            k: jax_entry_obj(e) for k, e in ref.items()
        }, rank
    assert "m/mine" not in get_manifest_for_rank(port_md, 2)
    assert "m/big" in get_manifest_for_rank(port_md, 2)
