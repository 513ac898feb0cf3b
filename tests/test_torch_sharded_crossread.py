"""Sharded snapshots cross between the two packages, bit for bit.

- A JAX snapshot of arrays sharded ``P('x')``, ``P(None, 'x')``, 2-D and
  replicated x sharded over the 8 virtual CPU devices restores in the port
  into ``DTensor``s at worlds 1, 2 and 4 (other layouts than it was saved
  under) and into plain tensors.
- A port snapshot of ``DTensor``s (``Shard(0)``, ``Shard(1)``,
  ``[Shard(0), Replicate]``, 2-D, uneven, an empty box) at worlds 2 and 4
  restores in the JAX package under ``NamedSharding``s and through
  ``read_object(..., sharding=)``.
- Where both packages cut the same boxes (the JAX mesh over the first 2 or
  4 devices, the port's mesh of 2 or 4 ranks), the two snapshots' merged
  manifests agree field for field (locations, offsets, sizes, dtype,
  digests) and so do their checksum tables.
- A fully-replicated ``DTensor`` is inferred replicated, as a
  fully-replicated ``jax.Array`` is: the same dense replicated entry.

The port's ranks are spawned workers on gloo CPU meshes; the module
imports no jax at its top (the workers import it), the tests import the
JAX package inside.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

from test_torch_resharding import Meshes, local_equal

torch.set_num_threads(1)

# The JAX snapshot's leaves: name -> (shape, dtype, mesh shape, spec).
JAX_LEAVES = {
    "row": ((64, 8), "float32", (8,), ("x",)),
    "col": ((16, 32), "bfloat16", (8,), (None, "x")),
    "grid": ((32, 24), "float32", (4, 2), ("a", "b")),
    "repsh": ((32, 16), "int32", (4, 2), (None, "b")),
}
# The layouts each port world restores the JAX leaves into (another
# layout than the one saved; world 1 is a mesh of one rank).
RESTORE_LAYOUTS = {
    1: {name: ((1,), (("S", 0),)) for name in JAX_LEAVES},
    2: {"row": "col2", "col": "row2", "grid": "rep2", "repsh": "row2"},
    4: {"row": "grid22", "col": "nested", "grid": "colrep", "repsh": "col4"},
}
# The port snapshots' leaves: name -> (shape, dtype, layout per world).
# "a" and "b" cut the same boxes as the JAX snapshot of the same world.
PORT_LEAVES = {
    "a": ((32, 8), "float32", {2: "row2", 4: "grid22"}),
    "b": ((16, 12), "bfloat16", {2: "col2", 4: "rowrep"}),
    "c": ((4, 4), "float32", {2: "rep2", 4: "full_replicated"}),
    "u": ((1001, 16), "bfloat16", {2: "row2", 4: "col4"}),  # uneven
    "e": ((1, 16), "float32", {2: "row2", 4: "row4"}),  # empty boxes
}
# The JAX package's layouts that cut the same boxes as PORT_LEAVES "a"-"c".
SAME_BOXES = {
    2: {"mesh": ((2,), ("x",)), "a": ("x",), "b": (None, "x"), "c": ()},
    4: {"mesh": ((2, 2), ("a", "b")), "a": ("a", "b"), "b": ("a",), "c": ()},
}


def values(shape, dtype: str, seed: int = 0) -> np.ndarray:
    """Seeded values as float32 (int32 kept integral), cast by each
    package to its dtype: both round to nearest even."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.float32).reshape(shape) * 0.5 + seed).astype(
        np.int32 if dtype == "int32" else np.float32
    )


def torch_values(shape, dtype: str, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(values(shape, dtype, seed)).to(getattr(torch, dtype))


def port_world_worker(pg, root: str) -> dict:
    """Restore the JAX snapshot into this world's layouts; at worlds 2 and
    4 also take the port snapshot of PORT_LEAVES."""
    import torch.distributed as dist

    world = pg.world_size
    init_torch_group(pg)
    try:
        if world == 1:
            from torch.distributed.device_mesh import init_device_mesh

            mesh1 = init_device_mesh("cpu", (1,))

            class _One:
                def dtensor(self, full, layout):
                    from test_torch_resharding import make_dtensor, placements_of

                    return make_dtensor(full, mesh1, placements_of(layout[1]))

            meshes = _One()
        else:
            meshes = Meshes(world)
        out = {}
        fresh = {
            name: meshes.dtensor(torch.zeros(shape, dtype=getattr(torch, dt)), RESTORE_LAYOUTS[world][name])
            for name, (shape, dt, _, _) in JAX_LEAVES.items()
        }
        app = {"s": TensorTreeState(dict(fresh))}
        Snapshot(os.path.join(root, "jax"), pg=pg).restore(app)
        out["from_jax"] = {
            name: local_equal(app["s"].tree[name], torch_values(shape, dt))
            for name, (shape, dt, _, _) in JAX_LEAVES.items()
        }
        if world > 1:
            state = {
                name: meshes.dtensor(torch_values(shape, dt), layouts[world])
                for name, (shape, dt, layouts) in PORT_LEAVES.items()
            }
            Snapshot.take(os.path.join(root, f"port_w{world}"), {"s": TensorTreeState(state)},
                          pg=pg, record_digests=True)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    root = str(tmp_path_factory.mktemp("crossread"))

    def named(mesh_shape, names, spec):
        n = int(np.prod(mesh_shape))
        mesh = Mesh(np.array(devs[:n]).reshape(mesh_shape), names)
        return NamedSharding(mesh, P(*spec))

    def jax_array(shape, dtype, sharding):
        return jax.device_put(jnp.asarray(values(shape, dtype)).astype(getattr(jnp, dtype)), sharding)

    tree = {}
    for name, (shape, dt, mesh_shape, spec) in JAX_LEAVES.items():
        names = ("x",) if len(mesh_shape) == 1 else ("a", "b")
        tree[name] = jax_array(shape, dt, named(mesh_shape, names, spec))
    jts.Snapshot.take(os.path.join(root, "jax"), {"s": jts.PyTreeState(tree)})
    for world, same in SAME_BOXES.items():
        mesh_shape, names = same["mesh"]
        tree = {
            name: jax_array(PORT_LEAVES[name][0], PORT_LEAVES[name][1], named(mesh_shape, names, same[name]))
            for name in ("a", "b", "c")
        }
        jts.Snapshot.take(os.path.join(root, f"jax_w{world}"), {"s": jts.PyTreeState(tree)},
                          record_digests=True)
    results = {world: run_multiprocess(port_world_worker, world, args=(root,)) for world in (1, 2, 4)}
    return root, results


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(JAX_LEAVES))
def test_jax_sharded_snapshot_restores_into_dtensors(snaps, world, name) -> None:
    _, results = snaps
    assert all(r["from_jax"][name] for r in results[world]), [r["from_jax"] for r in results[world]]


@pytest.mark.parametrize("name", sorted(JAX_LEAVES))
def test_jax_sharded_snapshot_restores_into_plain_tensors(snaps, name) -> None:
    root, _ = snaps
    shape, dt, _, _ = JAX_LEAVES[name]
    app = {"s": TensorTreeState({name: torch.zeros(shape, dtype=getattr(torch, dt))})}
    Snapshot(os.path.join(root, "jax")).restore(app)
    assert torch.equal(app["s"].tree[name], torch_values(shape, dt))
    assert torch.equal(Snapshot(os.path.join(root, "jax")).read_object(f"0/s/{name}"), torch_values(shape, dt))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PORT_LEAVES))
def test_port_sharded_snapshot_restores_in_jax(snaps, world, name) -> None:
    """Each leaf into a NamedSharding over 8 devices (rows where they
    divide evenly, else replicated), and through read_object(sharding=)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts

    root, _ = snaps
    path = os.path.join(root, f"port_w{world}")
    shape, dt, _ = PORT_LEAVES[name]
    want = np.asarray(jnp.asarray(values(shape, dt)).astype(getattr(jnp, dt)))
    mesh = Mesh(np.array(jax.devices()), ("x",))
    sharding = NamedSharding(mesh, P("x") if shape[0] % 8 == 0 else P())
    app = {"s": jts.PyTreeState({name: jax.device_put(jnp.zeros(shape, getattr(jnp, dt)), sharding)})}
    jts.Snapshot(path).restore(app)
    got = app["s"].tree[name]
    assert got.sharding.is_equivalent_to(sharding, len(shape))
    assert np.asarray(got).tobytes() == want.tobytes()
    other = NamedSharding(Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b")),
                          P(None, "b") if shape[1] % 2 == 0 else P())
    read = jts.Snapshot(path).read_object(f"0/s/{name}", sharding=other)
    assert np.asarray(read).tobytes() == want.tobytes()


def _merged_entry(path: str, logical: str, jax_pkg: bool):
    if jax_pkg:
        import torchsnapshot_tpu as jts
        from torchsnapshot_tpu.manifest import get_manifest_for_rank
    else:
        from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank
        jts = None
    snap = (jts.Snapshot if jax_pkg else Snapshot)(path)
    return get_manifest_for_rank(snap.metadata, 0)[logical]


def _fields(entry) -> list:
    def arr(a):
        return (a.location, a.serializer, a.dtype, list(a.shape), a.replicated, a.byte_range, a.digest)

    if entry.type == "ShardedArray":
        shards = sorted(entry.shards, key=lambda s: s.offsets)
        return [entry.dtype, list(entry.shape)] + [(s.offsets, s.sizes, arr(s.array)) for s in shards]
    return [entry.type, arr(entry)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_same_boxes_give_the_same_entry_and_checksums(snaps, world, name) -> None:
    """The JAX package's snapshot on the first ``world`` devices and the
    port's on ``world`` ranks, of the same values cut into the same boxes:
    equal entries (digests included) and equal checksum-table entries."""
    import asyncio

    from torchsnapshot_tpu.integrity import load_checksum_tables as jload
    from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JFS

    from torchsnapshot_tpu_torch.integrity import load_checksum_tables
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    root, _ = snaps
    jpath, ppath = os.path.join(root, f"jax_w{world}"), os.path.join(root, f"port_w{world}")
    jentry = _merged_entry(jpath, f"s/{name}", True)
    pentry = _merged_entry(ppath, f"s/{name}", False)
    assert _fields(jentry) == _fields(pentry)
    if pentry.type == "ShardedArray":
        assert all(s.array.digest.startswith("mlh64:") for s in pentry.shards)
    locations = [loc for loc in (
        [s.array.location for s in pentry.shards] if pentry.type == "ShardedArray" else [pentry.location]
    )]
    assert all(loc.startswith(("sharded/", "replicated/")) for loc in locations)
    if name == "c":
        assert pentry.type == "Array" and pentry.replicated  # inferred replicated
    loop = asyncio.new_event_loop()
    try:
        jt = jload(1, JFS(jpath), loop)
        pt = load_checksum_tables(world, FSStoragePlugin(ppath), loop)
    finally:
        loop.close()
    for loc in locations:
        assert tuple(jt[loc]) == tuple(pt[loc]), loc


def _worker_replicated_inference(pg, path: str) -> list:
    import torch.distributed as dist

    init_torch_group(pg)
    try:
        meshes = Meshes(pg.world_size)
        rep = meshes.dtensor(torch.ones(8, 4), "rep2")
        Snapshot.take(path, {"s": TensorTreeState({"rep": rep})}, pg=pg)
        return sorted(Snapshot(path).get_manifest())
    finally:
        dist.destroy_process_group()


def test_fully_replicated_dtensor_is_inferred_replicated(tmp_path) -> None:
    """Inferred at world 2 with no glob: one replicated entry under rank 0,
    written once (by one rank), as the JAX package does for a
    fully-replicated jax.Array spanning processes."""
    path = str(tmp_path / "s")
    keys = run_multiprocess(_worker_replicated_inference, 2, args=(path,))[0]
    manifest = Snapshot(path).get_manifest()
    entry = manifest["0/s/rep"]
    assert entry.type == "Array" and entry.replicated and entry.location == "replicated/s/rep"
    assert "1/s/rep" not in keys
    assert os.path.exists(os.path.join(path, "replicated", "s", "rep"))
    out = {"s": TensorTreeState({"rep": torch.zeros(8, 4)})}
    Snapshot(path).restore(out)
    assert torch.equal(out["s"].tree["rep"], torch.ones(8, 4))
