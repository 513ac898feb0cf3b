"""Placement of reference ShardedTensor entries into ``DTensor``s: a port,
case for case, of the JAX package's ``tests/test_reader_sharded_placement.py``.

The JAX cases place onto an 8-device CPU mesh in one process; here one
world of 4 gloo CPU ranks (spawned once for the module, meshes (4,) and
(2, 2), as ``test_torch_resharding.py`` builds them) runs every case,
each rank building only its own box. Where the JAX case expects one
process to raise for a hole, here exactly the ranks whose box meets the
hole raise, and the others get their rows. Added: the ``DTensor``
template form of ``sharding=``, the reader's read and host-byte
accounting, and the fixture writer of ``test_utils`` (the card's bridge
phase uses it) read back under ``Shard(0)``, ``Shard(1)`` and
``Replicate()``.

The module imports no jax: the spawned workers import it.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from torchsnapshot_tpu_torch.test_utils import (
    init_torch_group,
    run_multiprocess,
    write_sharded_reference_snapshot,
)
from torchsnapshot_tpu_torch.tricks.torchsnapshot_reader import ReferenceSnapshotReader

torch.set_num_threads(1)

FULL_8x4 = (np.arange(32, dtype=np.float32).reshape(8, 4) + np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32))
UNEVEN = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
PLAIN = np.random.default_rng(3).standard_normal((4, 4)).astype(np.float32)


def _sharded_snapshot(root: str, full: np.ndarray, row_splits) -> None:
    """A hand-built world_size=len(row_splits) snapshot whose one entry
    'sh/emb' is row-sharded at the given boundaries (YAML metadata, as the
    reference writes it)."""
    os.makedirs(os.path.join(root, "sharded"), exist_ok=True)
    manifest = {}
    start = 0
    for rnk, rows in enumerate(row_splits):
        with open(os.path.join(root, "sharded", f"emb_{rnk}"), "wb") as f:
            f.write(full[start : start + rows].tobytes())
        manifest[f"{rnk}/sh"] = {"type": "dict", "keys": ["emb"]}
        manifest[f"{rnk}/sh/emb"] = {"type": "ShardedTensor", "shards": [{
            "offsets": [start, 0],
            "sizes": [rows, full.shape[1]],
            "tensor": {
                "type": "Tensor", "location": f"sharded/emb_{rnk}", "serializer": "buffer_protocol",
                "dtype": "torch.float32", "shape": [rows, full.shape[1]], "replicated": False,
                "byte_range": None,
            },
        }]}
        start += rows
    _commit(root, manifest, len(row_splits))


def _commit(root: str, manifest: dict, world_size: int) -> None:
    with open(os.path.join(root, ".snapshot_metadata"), "w") as f:
        f.write(yaml.safe_dump({"version": "0.0.3", "world_size": world_size, "manifest": manifest}, sort_keys=False))


def _fixture_state() -> dict:
    rng = np.random.default_rng(4)
    return {"m": {
        "w": torch.from_numpy(rng.standard_normal((10, 6)).astype(np.float32)).to(torch.bfloat16),
        "u": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
        "big": torch.arange(300, dtype=torch.int64),
        "s": torch.tensor(2.5),
        "n": 3,
    }}


def _write_snapshots(root: str) -> None:
    _sharded_snapshot(os.path.join(root, "even"), FULL_8x4, [4, 4])
    _sharded_snapshot(os.path.join(root, "uneven"), UNEVEN, [3, 5])
    hole = os.path.join(root, "hole")
    _sharded_snapshot(hole, np.ones((8, 4), np.float32), [4, 4])
    meta = os.path.join(hole, ".snapshot_metadata")
    doc = yaml.safe_load(open(meta).read())
    del doc["manifest"]["1/sh/emb"], doc["manifest"]["1/sh"]
    _commit(hole, doc["manifest"], 2)
    dup = os.path.join(root, "dup")
    os.makedirs(os.path.join(dup, "sharded"))
    with open(os.path.join(dup, "sharded", "emb_dup"), "wb") as f:
        f.write(np.ones((4, 4), np.float32).tobytes())
    box = {"offsets": [0, 0], "sizes": [4, 4], "tensor": {
        "type": "Tensor", "location": "sharded/emb_dup", "serializer": "buffer_protocol",
        "dtype": "torch.float32", "shape": [4, 4], "replicated": False, "byte_range": None,
    }}
    _commit(dup, {k: v for r in (0, 1) for k, v in (
        (f"{r}/sh", {"type": "dict", "keys": ["emb"]}),
        (f"{r}/sh/emb", {"type": "ShardedTensor", "shards": [box]}),
    )}, 2)
    plain = os.path.join(root, "plain")
    os.makedirs(os.path.join(plain, "0", "s"))
    with open(os.path.join(plain, "0", "s", "w"), "wb") as f:
        f.write(PLAIN.tobytes())
    _commit(plain, {
        "0/s": {"type": "dict", "keys": ["w"]},
        "0/s/w": {
            "type": "Tensor", "location": "0/s/w", "serializer": "buffer_protocol", "dtype": "torch.float32",
            "shape": [4, 4], "replicated": False, "byte_range": None,
        },
    }, 1)
    write_sharded_reference_snapshot(os.path.join(root, "fixture"), _fixture_state(), world_size=4, slab_max_bytes=64)


# ---------------------------------------------------------------------------
# the world-4 worker
# ---------------------------------------------------------------------------


def _local(dt) -> np.ndarray:
    t = dt.to_local()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _expected(full: torch.Tensor, mesh, placements) -> np.ndarray:
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, placements)
    t = full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _spied(reader: ReferenceSnapshotReader) -> list:
    reads = []
    orig = reader._read_blobs

    def spy(requests, dests=None):
        reads.extend((loc, br) for loc, br in requests if loc != ".snapshot_metadata")
        return orig(requests, dests)

    reader._read_blobs = spy
    return reads


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def world4_worker(pg, root: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    init_torch_group(pg)
    try:
        line = init_device_mesh("cpu", (4,))
        grid = init_device_mesh("cpu", (2, 2))
        out = {}

        def read(name, sharding, **kw):
            return ReferenceSnapshotReader(os.path.join(root, name), device="cpu").read_sharded(
                "0/sh/emb" if name != "plain" else "0/s/w", sharding, **kw
            )

        full = torch.from_numpy(FULL_8x4)
        dt = read("even", (line, [Shard(0)]))
        out["even_line"] = (tuple(dt.shape), dt.placements == (Shard(0),), _local(dt), _expected(full, line, [Shard(0)]))
        out["grid"] = [
            (_local(d), _expected(full, grid, p))
            for p, d in (
                ((Shard(0), Shard(1)), read("even", (grid, [Shard(0), Shard(1)]))),
                ((Replicate(), Replicate()), read("even", (grid, [Replicate(), Replicate()]))),
            )
        ]
        out["uneven"] = (_local(read("uneven", (line, [Shard(0)]))), _expected(torch.from_numpy(UNEVEN), line, [Shard(0)]))
        out["hole"] = _outcome(lambda: _local(read("hole", (line, [Shard(0)]), global_shape=(8, 4))))
        out["dup"] = _outcome(lambda: _local(read("dup", (grid, [Replicate(), Replicate()]), global_shape=(8, 4))))
        out["plain"] = (_local(read("plain", (line, [Shard(0)]))), _expected(torch.from_numpy(PLAIN), line, [Shard(0)]))

        # Ranged row windows for dim-0 resharding; whole pieces for columns.
        reader = ReferenceSnapshotReader(os.path.join(root, "even"), device="cpu")
        reads = _spied(reader)
        rows = reader.read_sharded("0/sh/emb", (line, [Shard(0)]))
        row_reads = list(reads)
        reads.clear()
        cols = reader.read_sharded("0/sh/emb", (line, [Shard(1)]))
        out["ranged"] = {
            "rows": (_local(rows), _expected(full, line, [Shard(0)])),
            "cols": (_local(cols), _expected(full, line, [Shard(1)])),
            "row_reads": row_reads,
            "col_reads": list(reads),
            "stats": reader.stats,
        }
        # A DTensor template gives the same placement as its (mesh, placements).
        out["template"] = (_local(read("even", rows)), _expected(full, line, [Shard(0)]))

        # The fixture writer's 4-rank snapshot, every leaf under every layout
        # that its rank admits.
        state = _fixture_state()["m"]
        reader = ReferenceSnapshotReader(os.path.join(root, "fixture"), device="cpu")
        fixture = {}
        for name, t in state.items():
            if not isinstance(t, torch.Tensor):
                continue
            layouts = [[Replicate()]] + [[Shard(d)] for d in range(t.ndim)]
            for placements in layouts:
                dt = reader.read_sharded(f"0/m/{name}", (line, placements))
                fixture[(name, str(placements[0]))] = (
                    _local(dt), _expected(t, line, placements), str(dt.dtype)
                )
        out["fixture"] = fixture
        out["fixture_stats"] = reader.stats
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_sharded"))
    _write_snapshots(root)
    return run_multiprocess(world4_worker, 4, args=(root,))


def test_resharding_on_read_4_way(runs):
    for r in runs:
        shape, placed, got, want = r["even_line"]
        assert shape == (8, 4) and placed
        np.testing.assert_array_equal(got, want)


def test_resharding_to_2d_mesh_and_replicated(runs):
    for r in runs:
        for got, want in r["grid"]:
            np.testing.assert_array_equal(got, want)
    # Fully replicated: every rank holds the whole array.
    for r in runs:
        np.testing.assert_array_equal(r["grid"][1][0], FULL_8x4)


def test_uneven_saved_splits_reshard(runs):
    for r in runs:
        np.testing.assert_array_equal(*r["uneven"])


def test_holes_are_detected(runs):
    """Rows 4-8 lost: ranks 2 and 3, whose boxes they are, raise; ranks 0
    and 1 get their rows (each rank builds only its own box)."""
    for rank, r in enumerate(runs):
        kind, value = r["hole"]
        if rank >= 2:
            assert kind == "ValueError" and "holes" in value
        else:
            assert kind == "ok"
            np.testing.assert_array_equal(value, np.ones((2, 4), np.float32))


def test_row_contiguous_overlaps_use_ranged_reads(runs):
    """Dim-0 resharding (the FSDP case): each rank's rows arrive through a
    ranged read of just those rows, never a whole-shard read; column
    sharding falls back to whole source pieces, still correct."""
    row_bytes = 4 * 4
    for r in runs:
        ranged = r["ranged"]
        np.testing.assert_array_equal(*ranged["rows"])
        np.testing.assert_array_equal(*ranged["cols"])
        assert ranged["row_reads"], "no blob reads recorded"
        for location, byte_range in ranged["row_reads"]:
            assert byte_range is not None, f"whole-blob read of {location}"
            assert byte_range[1] - byte_range[0] == 2 * row_bytes, (location, byte_range)
        assert ranged["col_reads"] and all(br is None for _, br in ranged["col_reads"])
        stats = ranged["stats"]
        assert stats.ranged_reads == len(ranged["row_reads"])
        assert stats.whole_reads == len(ranged["col_reads"])


def test_duplicate_saved_shards_cannot_mask_holes(runs):
    """Two ranks recording the SAME shard box must not double-count
    coverage: a replicated destination with rows 4-8 missing raises on
    every rank."""
    for r in runs:
        kind, value = r["dup"]
        assert kind == "ValueError" and "holes" in value


def test_plain_tensor_entry_shardable(runs):
    for r in runs:
        np.testing.assert_array_equal(*r["plain"])


def test_dtensor_template_sharding(runs):
    for r in runs:
        np.testing.assert_array_equal(*r["template"])


def test_fixture_writer_snapshot_under_every_layout(runs):
    """The fixture writer's 4-rank snapshot (2-D leaves sharded on dim 0,
    small ones in a slab, a large one in its own blob) placed under
    Replicate, Shard(0) and Shard(1): every local is its slice, bit for
    bit, and no rank held more host bytes than the largest leaf's box
    plus its sources."""
    state = _fixture_state()["m"]
    for r in runs:
        assert len(r["fixture"]) == 2 * 3 + 2 * 2 + 1
        for (name, _), (got, want, dtype) in r["fixture"].items():
            assert dtype == str(state[name].dtype)
            np.testing.assert_array_equal(got, want)
        stats = r["fixture_stats"]
        assert stats.ranged_reads > 0
        assert 0 < stats.peak_host_bytes <= 3 * state["big"].nbytes
    # Column boxes read whole row shards; rank 3's column boxes are empty.
    assert [r["fixture_stats"].whole_reads > 0 for r in runs] == [True, True, True, False]
