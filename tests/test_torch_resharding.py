"""Sharded (``DTensor``) checkpointing in the port: write dedup, shard
subdivision, and elastic resharding across layouts and world sizes.

Port of the JAX package's ``tests/test_sharded_resharding.py`` on gloo CPU
meshes: a world-4 run (meshes (4,) and (2, 2)) takes every case's snapshot
and restores it under another layout, a world-2 run restores the same
snapshots on a mesh of 2 and takes its own, and this process (world 1)
restores them into plain tensors. The JAX package's ``NamedSharding``s
become ``DTensor`` placements (``Shard``, ``Replicate``, nested shards of
one dimension), with torch's uneven chunking; each rank's expected local
shard comes from torch's own ``compute_local_shape_and_global_offset``.
Added here: the port's box function held against torch's for even,
uneven, empty, nested and 2-D layouts, and the copied geometry against the
JAX package's on seeded random boxes. Comparisons are bitwise.

The module imports no jax at its top: the spawned workers import it.
Other port test files reuse its workers.
"""

import asyncio
import itertools
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs
from torchsnapshot_tpu_torch.parallel.overlap import placements_box
from torchsnapshot_tpu_torch.resharding import (
    Box,
    box_overlap,
    placement_spec,
    plan_row_slab_reads,
    row_slab_byte_window,
    subdivide_box,
    target_boxes_for_placements,
)
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

torch.set_num_threads(1)

S0, S1, R = ("S", 0), ("S", 1), ("R",)

# name -> (mesh shape, placements); the torch analogs of the JAX test's
# shardings on 4 ranks.
LAYOUTS = {
    "row4": ((4,), (S0,)),
    "col4": ((4,), (S1,)),
    "grid22": ((2, 2), (S0, S1)),
    "rowrep": ((2, 2), (S0, R)),
    "colrep": ((2, 2), (R, S1)),
    "nested": ((2, 2), (S0, S0)),
    "full_replicated": ((2, 2), (R, R)),
    "row2": ((2,), (S0,)),
    "col2": ((2,), (S1,)),
    "rep2": ((2,), (R,)),
}

MATRIX = list(itertools.permutations(["row4", "grid22", "colrep"], 2)) + [
    ("row4", "row4"),
    ("grid22", "nested"),
    ("col4", "rowrep"),
    ("rowrep", "col4"),
    ("grid22", "full_replicated"),
]
# 30 x 22 cuts unevenly over 4 (8, 8, 8, 6 rows; 6, 6, 6, 4 columns).
MATRIX_SHAPE = (30, 22)
FUZZ_SEEDS = range(16)


def placements_of(spec):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(p[1]) if p[0] == "S" else Replicate() for p in spec]


def seeded(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=torch.float32).reshape(shape) + seed).to(dtype)


def expected_local(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` by torch's own layout function."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, placements)
    return full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]


def make_dtensor(full: torch.Tensor, mesh, placements):
    """A DTensor of ``full`` built from this rank's local shard alone (no
    collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        expected_local(full, mesh, placements).clone(), mesh, placements,
        run_check=False, shape=full.shape, stride=full.stride(),
    )


def local_equal(dt, full: torch.Tensor) -> bool:
    local = dt.to_local()
    want = expected_local(full, dt.device_mesh, dt.placements)
    return local.shape == want.shape and torch.equal(
        local.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    )


class Meshes:
    """The meshes of one world, built once per worker."""

    def __init__(self, world: int) -> None:
        from torch.distributed.device_mesh import init_device_mesh

        self._meshes = {(world,): init_device_mesh("cpu", (world,))}
        if world == 4:
            self._meshes[(2, 2)] = init_device_mesh("cpu", (2, 2))

    def dtensor(self, full: torch.Tensor, layout):
        mesh_shape, spec = LAYOUTS[layout] if isinstance(layout, str) else layout
        return make_dtensor(full, self._meshes[tuple(mesh_shape)], placements_of(spec))


def _tree(**leaves):
    return {"m": TensorTreeState(dict(leaves))}


def fuzz_case(seed: int):
    """Random shape, a random world-4 source layout and world-4 and world-2
    destination layouts (placements that shard any dimension, repeated
    dimensions and uneven cuts included)."""
    rng = np.random.default_rng(9000 + seed)
    ndim = int(rng.integers(1, 4))
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 16, 24, 40])) for _ in range(ndim))

    def layout(mesh_shape):
        spec = tuple(
            ("S", int(rng.integers(0, ndim))) if rng.random() < 0.6 else R for _ in mesh_shape
        )
        return (mesh_shape, spec)

    meshes4 = [(4,), (2, 2)]
    src = layout(meshes4[int(rng.integers(0, 2))])
    dst4 = layout(meshes4[int(rng.integers(0, 2))])
    return shape, src, dst4, layout((2,))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def world4_worker(pg, root: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    init_torch_group(pg)
    try:
        meshes = Meshes(4)
        out = {"matrix": {}, "fuzz": {}, "box_mismatch": []}
        full = seeded(MATRIX_SHAPE, 0)
        for i, (src, dst) in enumerate(MATRIX):
            path = os.path.join(root, f"matrix_{i}")
            Snapshot.take(path, _tree(w=meshes.dtensor(full, src)), pg=pg)
            fresh = _tree(w=meshes.dtensor(torch.zeros(MATRIX_SHAPE), dst))
            Snapshot(path, pg=pg).restore(fresh)
            out["matrix"][i] = local_equal(fresh["m"].tree["w"], full)
        for seed in FUZZ_SEEDS:
            shape, src, dst4, _ = fuzz_case(seed)
            full = seeded(shape, seed)
            x = meshes.dtensor(full, src)
            want = compute_local_shape_and_global_offset(full.shape, x.device_mesh, x.placements)
            if Box.from_dtensor(x) != Box(tuple(want[1]), tuple(want[0])):
                out["box_mismatch"].append((seed, Box.from_dtensor(x), want))
            path = os.path.join(root, f"fuzz_{seed}")
            Snapshot.take(path, _tree(w=x), pg=pg)
            fresh = _tree(w=meshes.dtensor(torch.zeros(shape), dst4))
            Snapshot(path, pg=pg).restore(fresh)
            out["fuzz"][seed] = local_equal(fresh["m"].tree["w"], full)
        # Replica dedup: 2-way column sharding replicated twice.
        Snapshot.take(os.path.join(root, "dedup"), _tree(w=meshes.dtensor(torch.ones(16, 8), "colrep")), pg=pg)
        # The subdivision knob: each 32 x 16 f32 box is 2 KiB, cut into 16-row pieces.
        full = seeded((64, 16), 3)
        with knobs.override_max_shard_size_bytes(1024):
            Snapshot.take(os.path.join(root, "subdiv"), _tree(w=meshes.dtensor(full, "rowrep")), pg=pg)
        fresh = _tree(w=meshes.dtensor(torch.zeros(64, 16), "rowrep"))
        Snapshot(os.path.join(root, "subdiv"), pg=pg).restore(fresh)
        out["subdiv"] = local_equal(fresh["m"].tree["w"], full)
        # Saved 4-way (8-row boxes), restored 2-way (15-row boxes) below.
        Snapshot.take(os.path.join(root, "misaligned"), _tree(w=meshes.dtensor(seeded((30, 3), 5), "row4")), pg=pg)
        return out
    finally:
        dist.destroy_process_group()


def world2_worker(pg, root: str) -> dict:
    import torch.distributed as dist

    init_torch_group(pg)
    try:
        meshes = Meshes(2)
        out = {"fuzz": {}}
        for seed in FUZZ_SEEDS:
            shape, _, _, dst2 = fuzz_case(seed)
            fresh = _tree(w=meshes.dtensor(torch.zeros(shape), dst2))
            Snapshot(os.path.join(root, f"fuzz_{seed}"), pg=pg).restore(fresh)
            out["fuzz"][seed] = local_equal(fresh["m"].tree["w"], seeded(shape, seed))
        fresh = _tree(w=meshes.dtensor(torch.zeros(30, 3), "row2"))
        Snapshot(os.path.join(root, "misaligned"), pg=pg).restore(fresh)
        out["misaligned"] = local_equal(fresh["m"].tree["w"], seeded((30, 3), 5))
        bad = _tree(w=meshes.dtensor(torch.zeros(8, 22), "row2"))
        try:
            Snapshot(os.path.join(root, "matrix_0"), pg=pg).restore(bad)
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
        Snapshot.take(os.path.join(root, "cols"), _tree(w=meshes.dtensor(seeded((32, 24), 0), "col2")), pg=pg)
        Snapshot.take(
            os.path.join(root, "bf16"),
            _tree(w=meshes.dtensor(seeded((16, 6), 0, torch.bfloat16), "row2")), pg=pg,
        )
        Snapshot.take(os.path.join(root, "rows64"), _tree(w=meshes.dtensor(seeded((64, 16), 0), "row2")), pg=pg)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resharding"))
    w4 = run_multiprocess(world4_worker, 4, args=(root,))
    w2 = run_multiprocess(world2_worker, 2, args=(root,))
    return root, w4, w2


# ---------------------------------------------------------------------------
# the resharding matrix and fuzz (worlds 4 -> 4, 2 and 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(MATRIX)), ids=[f"{a}->{b}" for a, b in MATRIX])
def test_resharding_matrix(runs, case) -> None:
    root, w4, _ = runs
    assert all(r["matrix"][case] for r in w4), [r["matrix"][case] for r in w4]
    # And at world 1, into a plain tensor.
    out = _tree(w=torch.zeros(MATRIX_SHAPE))
    Snapshot(os.path.join(root, f"matrix_{case}")).restore(out)
    assert torch.equal(out["m"].tree["w"], seeded(MATRIX_SHAPE, 0))


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_resharding_fuzz(runs, seed) -> None:
    """Random shape and source layout, restored under independent random
    layouts at worlds 4 and 2 (elastic down) and read whole at world 1."""
    root, w4, w2 = runs
    shape, src, dst4, dst2 = fuzz_case(seed)
    msg = f"{shape} {src} -> {dst4} / {dst2}"
    assert all(r["fuzz"][seed] for r in w4), msg
    assert all(r["fuzz"][seed] for r in w2), msg
    whole = Snapshot(os.path.join(root, f"fuzz_{seed}")).read_object(f"0/m/w")
    assert torch.equal(whole, seeded(shape, seed)), msg


def test_box_from_dtensor_matches_torch_in_the_fuzz(runs) -> None:
    _, w4, _ = runs
    assert all(not r["box_mismatch"] for r in w4), [r["box_mismatch"] for r in w4]


def test_misaligned_shard_boundaries(runs) -> None:
    """Saved 4-way (8-row boxes, the last 6), restored 2-way (15-row
    boxes): each destination draws from two saved shards whose boundaries
    do not align with its own."""
    _, _, w2 = runs
    assert all(r["misaligned"] for r in w2)


def test_replica_dedup_writes_each_box_once(runs) -> None:
    root, _, _ = runs
    entry = Snapshot(os.path.join(root, "dedup")).get_manifest()
    shards = [s for k, e in entry.items() if k.endswith("/m/w") for s in e.shards]
    # 2-way column sharding replicated twice: exactly 2 boxes on disk.
    assert sorted(tuple(s.offsets) for s in shards) == [(0, 0), (0, 4)]


def test_shard_subdivision_knob(runs) -> None:
    root, w4, _ = runs
    manifest = Snapshot(os.path.join(root, "subdiv")).get_manifest()
    shards = [s for k, e in manifest.items() if k.endswith("/m/w") for s in e.shards]
    assert len(shards) == 4
    assert all(s.sizes[0] <= 16 for s in shards)
    assert all(r["subdiv"] for r in w4)


def test_sharded_read_object_full_assembly(runs) -> None:
    root, _, _ = runs
    out = Snapshot(os.path.join(root, "bf16")).read_object("0/m/w")
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    assert torch.equal(out, seeded((16, 6), 0, torch.bfloat16))


def test_sharded_restore_shape_mismatch_raises(runs) -> None:
    _, _, w2 = runs
    for r in w2:
        assert r["mismatch"] is not None and "reshard" in r["mismatch"]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_box_overlap_math() -> None:
    a = Box((0, 0), (4, 4))
    b = Box((2, 2), (4, 4))
    ov = box_overlap(a, b)
    assert ov.src_slices == (slice(2, 4), slice(2, 4))
    assert ov.dst_slices == (slice(0, 2), slice(0, 2))
    assert box_overlap(Box((0,), (4,)), Box((4,), (4,))) is None
    with pytest.raises(ValueError, match="Rank mismatch"):
        box_overlap(Box((0,), (4,)), Box((0, 0), (4, 4)))


def test_subdivide_box() -> None:
    box = Box((8, 0), (10, 4))
    pieces = subdivide_box(box, max_bytes=4 * 4 * 4, itemsize=4)  # 4 rows a piece
    assert [p.offsets[0] for p in pieces] == [8, 12, 16]
    assert sum(p.sizes[0] for p in pieces) == 10
    assert subdivide_box(Box((), ()), 10, 4) == [Box((), ())]


def test_plan_row_slab_reads_geometry() -> None:
    shard = (32, 24)
    row_nbytes = 24 * 4
    ov = box_overlap(Box((0, 0), shard), Box((8, 12), (8, 12)))
    plan = plan_row_slab_reads(shard, [ov], row_nbytes)
    assert plan is not None and len(plan) == 1
    (read,) = plan
    assert read.rows == (8, 16)
    assert read.byte_range == (8 * row_nbytes, 16 * row_nbytes)
    assert read.buf_shape == (8, 24)
    (copy,) = read.copies
    assert copy.dst_rows == slice(0, 8)
    assert copy.src_slices == (slice(0, 8), slice(12, 24))
    assert row_slab_byte_window(shard, ov, row_nbytes) is None
    full = box_overlap(Box((0, 0), shard), Box((8, 0), (8, 24)))
    assert row_slab_byte_window(shard, full, row_nbytes, base=100) == (
        100 + 8 * row_nbytes, 100 + 16 * row_nbytes,
    )
    whole = box_overlap(Box((0, 0), shard), Box((0, 0), shard))
    assert plan_row_slab_reads(shard, [whole], row_nbytes) is None
    split = plan_row_slab_reads(shard, [whole], row_nbytes, buffer_limit_bytes=8 * row_nbytes)
    assert [r.rows for r in split] == [(0, 8), (8, 16), (16, 24), (24, 32)]
    assert plan_row_slab_reads((), [whole], 4) is None


def test_plan_row_slab_reads_roundtrip_matches_direct_copy() -> None:
    rng = np.random.default_rng(7)
    for _ in range(24):
        ndim = int(rng.integers(1, 4))
        shard = tuple(int(rng.integers(1, 9)) for _ in range(ndim))
        src = rng.standard_normal(shard).astype(np.float32)
        overlaps, views = [], []
        for _ in range(int(rng.integers(1, 4))):
            offs = tuple(int(rng.integers(0, s)) for s in shard)
            sizes = tuple(int(rng.integers(1, s - o + 1)) for s, o in zip(shard, offs))
            overlaps.append(box_overlap(Box((0,) * ndim, shard), Box(offs, sizes)))
            views.append(np.zeros(sizes, np.float32))
        row_nbytes = int(np.prod(shard[1:], dtype=np.int64)) * 4
        plan = plan_row_slab_reads(
            shard, overlaps, row_nbytes, buffer_limit_bytes=int(rng.integers(1, 5)) * row_nbytes
        )
        if plan is None:
            for view, ov in zip(views, overlaps):
                view[...] = src[ov.src_slices]
        else:
            blob = src.tobytes()
            for read in plan:
                a, b = read.byte_range
                buf = np.frombuffer(blob[a:b], np.float32).reshape(read.buf_shape)
                for copy in read.copies:
                    views[copy.overlap_index][copy.dst_rows] = buf[copy.src_slices]
        for view, ov in zip(views, overlaps):
            np.testing.assert_array_equal(view, src[ov.src_slices])


def _execute(reqs, root: str) -> None:
    from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    loop = asyncio.new_event_loop()
    try:
        sync_execute_read_reqs(reqs, url_to_storage_plugin(root), 10**7, 0, loop)
    finally:
        loop.close()


def test_column_partial_destinations_use_ranged_reads(runs) -> None:
    """A destination that slices a saved shard's rows and columns pays a
    row-banded ranged read, not the whole shard."""
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry, get_manifest_for_rank
    from torchsnapshot_tpu_torch.serialization import array_size_bytes
    from torchsnapshot_tpu_torch.sharded_io_preparer import _reqs_for_saved_shard

    root, _, _ = runs
    path = os.path.join(root, "cols")
    entry = get_manifest_for_rank(Snapshot(path).metadata, 0)["m/w"]
    assert isinstance(entry, ShardedArrayEntry)
    saved = entry.shards[0]
    saved_box = Box(tuple(saved.offsets), tuple(saved.sizes))
    ov = box_overlap(saved_box, Box((8, 0), (8, 6)))
    view = torch.zeros(8, 6)
    reqs = _reqs_for_saved_shard(saved, saved_box, [(view, ov)])
    assert reqs and all(r.byte_range is not None for r in reqs)
    fetched = sum(r.byte_range[1] - r.byte_range[0] for r in reqs)
    assert fetched == array_size_bytes(saved.sizes, saved.array.dtype) // 4
    _execute(reqs, path)
    assert torch.equal(view, seeded((32, 24), 0)[8:16, 0:6])


class _StubMesh:
    def __init__(self, shape, coordinate) -> None:
        self.shape = shape
        self._coordinate = coordinate

    def get_coordinate(self):
        return self._coordinate


def test_target_boxes_for_placements_groups_replicas() -> None:
    """One box per rank; replicas of a box at coordinates that differ on
    the replicated mesh dimension get the same box."""
    placements = placements_of((R, S1))
    boxes = [
        target_boxes_for_placements(_StubMesh((2, 2), list(c)), placements, (16, 8))
        for c in itertools.product(range(2), range(2))
    ]
    assert all(len(b) == 1 for b in boxes)
    distinct = {next(iter(b)) for b in boxes}
    assert distinct == {Box((0, 0), (16, 4)), Box((0, 4), (16, 4))}
    assert target_boxes_for_placements(_StubMesh((2,), None), placements_of((S0,)), (4,)) == {}


def test_sharded_read_respects_buffer_limit(runs) -> None:
    """A memory budget splits sharded reads into ranged row reads."""
    from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank
    from torchsnapshot_tpu_torch.sharded_io_preparer import ShardedArrayIOPreparer

    root, _, _ = runs
    path = os.path.join(root, "rows64")
    entry = get_manifest_for_rank(Snapshot(path).metadata, 0)["m/w"]
    out = torch.zeros(64, 16)
    # Each saved shard is 32 x 16 x 4 B = 2 KiB; a 512 B limit splits it.
    reqs = ShardedArrayIOPreparer.prepare_read(entry, out, buffer_size_limit_bytes=512)
    assert len(reqs) > len(entry.shards)
    assert all(r.byte_range[1] - r.byte_range[0] <= 512 for r in reqs)
    _execute(reqs, path)
    assert torch.equal(out, seeded((64, 16), 0))


def test_sharded_prepare_read_requires_cpu_tensor_destination(runs) -> None:
    from torchsnapshot_tpu_torch.io_preparer import prepare_read
    from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank

    root, _, _ = runs
    entry = get_manifest_for_rank(Snapshot(os.path.join(root, "rows64")).metadata, 0)["m/w"]
    with pytest.raises(ValueError, match="CPU tensor destination"):
        prepare_read(entry, obj_out=None)


# ---------------------------------------------------------------------------
# the box function against torch's, and the copied geometry against JAX's
# ---------------------------------------------------------------------------

BOX_CASES = [
    ((8, 4), (2,), (S0,)),  # even
    ((7, 4), (4,), (S0,)),  # uneven: 2, 2, 2, 1
    ((1, 4096), (2,), (S0,)),  # rank 1 empty
    ((3, 5), (4,), (S1,)),  # uneven columns, two empty
    ((30, 22), (2, 2), (S0, S1)),  # 2-D
    ((30, 22), (2, 2), (S0, S0)),  # nested on one dimension
    ((5, 3), (2, 2), (S0, S0)),  # nested and uneven: 2, 1, 1, 1
    ((2, 3), (2, 2), (S0, S0)),  # nested, trailing empties
    ((9, 9), (2, 2), (R, S0)),
    ((6,), (4,), (R,)),
]


@pytest.mark.parametrize("shape,mesh_shape,spec", BOX_CASES)
def test_placements_box_matches_torch(shape, mesh_shape, spec) -> None:
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    placements = placements_of(spec)
    boxes = []
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        local, offset = _compute_local_shape_and_global_offset(shape, mesh_shape, list(coord), placements)
        box = placements_box(shape, mesh_shape, coord, placement_spec(placements, len(shape)))
        assert box == Box(tuple(offset), tuple(local)), (coord, box, local, offset)
        boxes.append(box)
    # The boxes that hold data tile the array exactly once per replica.
    covered = torch.zeros(shape, dtype=torch.int64)
    for box in boxes:
        covered[box.to_index()] += 1
    replicas = int(np.prod([n for n, p in zip(mesh_shape, spec) if p[0] == "R"]))
    assert bool((covered == replicas).all())


def test_placement_spec_refuses_partial_and_strided() -> None:
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.placement_types import _StridedShard

    with pytest.raises(ValueError, match="Partial"):
        placement_spec([Partial()], 2)
    with pytest.raises(NotImplementedError, match="_StridedShard"):
        placement_spec([_StridedShard(0, split_factor=2)], 2)


def test_copied_geometry_matches_the_jax_package() -> None:
    """box_overlap, subdivide_box, plan_row_slab_reads, row_slab_byte_window
    and assign_shard_owners give the JAX package's answers on seeded random
    boxes."""
    from torchsnapshot_tpu import resharding as jr

    rng = np.random.default_rng(11)
    for _ in range(200):
        ndim = int(rng.integers(1, 4))
        shard = tuple(int(rng.integers(1, 12)) for _ in range(ndim))
        a_off = tuple(int(rng.integers(0, 10)) for _ in range(ndim))
        b_off = tuple(int(rng.integers(0, 10)) for _ in range(ndim))
        b_sizes = tuple(int(rng.integers(1, 12)) for _ in range(ndim))
        mine = box_overlap(Box(a_off, shard), Box(b_off, b_sizes))
        theirs = jr.box_overlap(jr.Box(a_off, shard), jr.Box(b_off, b_sizes))
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert (mine.src_slices, mine.dst_slices) == (theirs.src_slices, theirs.dst_slices)
            row_nbytes = int(np.prod(shard[1:], dtype=np.int64)) * 2
            limit = int(rng.integers(1, 6)) * row_nbytes
            p1 = plan_row_slab_reads(shard, [mine], row_nbytes, 64, limit)
            p2 = jr.plan_row_slab_reads(shard, [theirs], row_nbytes, 64, limit)
            assert (p1 is None) == (p2 is None)
            if p1 is not None:
                assert [(r.rows, r.byte_range, r.buf_shape) for r in p1] == [
                    (r.rows, r.byte_range, r.buf_shape) for r in p2
                ]
                assert [
                    [(c.overlap_index, c.dst_rows, c.src_slices) for c in r.copies] for r in p1
                ] == [[(c.overlap_index, c.dst_rows, c.src_slices) for c in r.copies] for r in p2]
            assert row_slab_byte_window(shard, mine, row_nbytes, 8) == jr.row_slab_byte_window(
                shard, theirs, row_nbytes, 8
            )
        budget = int(rng.integers(1, 400))
        mine_pieces = subdivide_box(Box(a_off, shard), budget, 4)
        theirs_pieces = jr.subdivide_box(jr.Box(a_off, shard), budget, 4)
        assert [(p.offsets, p.sizes) for p in mine_pieces] == [(p.offsets, p.sizes) for p in theirs_pieces]
    locs = [f"sharded/m/w_{i}" for i in range(13)]
    for world in (1, 2, 3, 8):
        from torchsnapshot_tpu_torch.resharding import assign_shard_owners

        assert assign_shard_owners(locs, world) == jr.assign_shard_owners(locs, world)


# ---------------------------------------------------------------------------
# workers that other port test files run
# ---------------------------------------------------------------------------

INCR_CHUNK = 1024  # 16 rows of (64, 16) f32: two pieces per rank's box


def _entry_fields(path: str, logical: str) -> list:
    from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank

    entry = get_manifest_for_rank(Snapshot(path).metadata, 0)[logical]
    return sorted(
        (tuple(s.offsets), tuple(s.sizes), s.array.location, s.array.digest) for s in entry.shards
    )


def sharded_incremental_worker(pg, root: str) -> dict:
    """Base take with digests of a row-sharded (64, 16) f32 and an uneven
    (1001, 16) bf16; rank 1 changes one row; an incremental take; then the
    same state re-laid out column-wise (another mesh layout) and taken
    incrementally against the same base; both restored bit for bit."""
    import torch.distributed as dist

    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        w = seeded((64, 16), 1)
        u = seeded((1001, 16), 2, torch.bfloat16)
        out = {}
        with knobs.override_incremental_chunk_size_bytes(INCR_CHUNK):
            base = os.path.join(root, "base")
            Snapshot.take(base, _tree(w=meshes.dtensor(w, "row2"), u=meshes.dtensor(u, "row2")),
                          pg=pg, record_digests=True)
            w2 = w.clone()
            w2[40] += 1.0  # rank 1's box, its first piece
            incr = os.path.join(root, "incr")
            Snapshot.take(incr, _tree(w=meshes.dtensor(w2, "row2"), u=meshes.dtensor(u, "row2")),
                          pg=pg, incremental_base=base)
            moved = os.path.join(root, "moved")
            Snapshot.take(moved, _tree(w=meshes.dtensor(w2, "col2"), u=meshes.dtensor(u, "col2")),
                          pg=pg, incremental_base=base)
        for name, path, want_w in (("incr", incr, w2), ("moved", moved, w2)):
            fresh = _tree(w=meshes.dtensor(torch.zeros(64, 16), "row2"),
                          u=meshes.dtensor(torch.zeros(1001, 16, dtype=torch.bfloat16), "col2"))
            Snapshot(path, pg=pg).restore(fresh)
            out[name] = local_equal(fresh["m"].tree["w"], want_w) and local_equal(fresh["m"].tree["u"], u)
        return out
    finally:
        dist.destroy_process_group()


def row_sharded_take_worker(pg, path: str, rows: int, cols: int, page_size=None) -> None:
    """Take ``s/emb``, a (rows, cols) f32 sharded by rows over the ranks
    (checksum pages of ``page_size`` bytes, when given)."""
    import torch.distributed as dist

    if page_size is not None:
        import torchsnapshot_tpu_torch.integrity as integrity

        integrity.PAGE_SIZE = page_size
    init_torch_group(pg)
    try:
        emb = Meshes(pg.world_size).dtensor(seeded((rows, cols), 0), "row2")
        Snapshot.take(path, {"s": TensorTreeState({"emb": emb})}, pg=pg)
    finally:
        dist.destroy_process_group()


def async_and_in_place_worker(pg, root: str) -> dict:
    """async_take of DTensors with the live shards mutated before wait();
    an async_restore whose reads fail on rank 1 raises on both ranks and
    leaves rank 1's live DTensor untouched, one that succeeds applies at
    wait(); restore lands in place in a DTensor parameter's local tensor."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.test_utils import faulty_fs_plugin, patch_storage_plugin

    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        full = seeded((10, 6), 4)
        x = meshes.dtensor(full, "row2")
        path = os.path.join(root, "async")
        pending = Snapshot.async_take(path, _tree(w=x), pg=pg)
        x.to_local().add_(100.0)  # after the capture: not in the snapshot
        pending.wait()
        out = {}
        live = meshes.dtensor(torch.full((10, 6), -1.0), "col2")
        before = live.to_local().clone()
        faulty = faulty_fs_plugin(lambda p: p.startswith("sharded/"), ops=("read",), exc_msg="injected read failure")
        with patch_storage_plugin(faulty if pg.rank == 1 else FSStoragePlugin):
            failing = Snapshot(path, pg=pg).async_restore(_tree(w=live))
            try:
                failing.wait()
                out["failed_raised"] = False
            except Exception:  # noqa: BLE001 - the case expects it
                out["failed_raised"] = True
        out["untouched"] = torch.equal(live.to_local(), before)
        live.to_local().fill_(-1.0)
        app = _tree(w=live)
        pending = Snapshot(path, pg=pg).async_restore(app)
        out["untouched_before_wait"] = torch.equal(live.to_local(), before)
        pending.wait()
        out["applied"] = local_equal(app["m"].tree["w"], full)
        # In place into a module's DTensor parameter.
        module = torch.nn.Module()
        module.w = torch.nn.Parameter(meshes.dtensor(torch.zeros(10, 6), "row2"))
        storage = module.w.to_local().data_ptr()
        Snapshot(path, pg=pg).restore({"m": module})
        out["in_place"] = (
            isinstance(module.w, DTensor)
            and module.w.to_local().data_ptr() == storage
            and local_equal(module.w, full)
        )
        return out
    finally:
        dist.destroy_process_group()


def test_async_take_and_restore_of_dtensors(tmp_path) -> None:
    results = run_multiprocess(async_and_in_place_worker, 2, args=(str(tmp_path),))
    for r in results:
        assert r["failed_raised"], r
        assert r["untouched_before_wait"] and r["applied"], r
        assert r["in_place"], r
    # The rank whose reads failed applied nothing (its peer, whose reads
    # landed, applies its own keys before it meets the failure).
    assert results[1]["untouched"]
