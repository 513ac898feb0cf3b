"""MoE and pipeline-stacked train states cross between the two packages,
bit for bit.

- The JAX package takes an MoE train state sharded over its 8 virtual CPU
  devices (the expert-stacked leaves over ``sp``, its ep layout); the port
  restores it entry by entry at world 1 (into a live model and AdamW) and
  at world 2 into the expert-parallel layout (the expert-stacked leaves
  and their moments ``Shard(0)`` ``DTensor``s, the rest plain tensors).
- The port's takes of MoE states, at world 1 and in the expert-parallel
  layout at world 2, restore in the JAX package on 8- and 4-device meshes
  (as ``tests/test_model.py``'s elastic case does).
- The JAX package's stage stacks of an all-MoE model (4 stages of one MoE
  block: 4-D expert stacks, ``stack_stage_params`` over pp = 4) restore in
  the port into pp = 2 (``Shard(0)`` over a gloo mesh of 2) and pp = 1
  (full stacks); the port's pp = 2 take restores in the JAX package at
  pp = 4 and pp = 2.
- World-1 takes of the same MoE values, and pp = 2 takes of the same
  stacks, give the same manifest entries in both packages: paths,
  locations, dtype strings, shapes and boxes.

The port mirrors the JAX ``TrainState.as_pytree()`` with
:func:`jax_tree`: its parameters under their JAX names, the AdamW moments
as optax's ``mu`` / ``nu``, the counts as int32 scalars. The module
imports no jax at its top (the spawned workers re-import it).
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.serialization import tensor_from_numpy
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, n_experts=4, moe_every=2, learning_rate=1e-2)
# The stacked state's model: every block MoE, so that 4 stages of one block
# stack (a stage's blocks must match the other stages').
PP_CFG = dict(CFG, moe_every=1)
STAGES = 4
EXPERT_LEAVES = ("w_in", "w_out")


def port_cfg(cfg: dict = CFG) -> tt.TransformerConfig:
    return tt.TransformerConfig(**cfg)


def _map(tree, fn, path=()):
    if hasattr(tree, "_asdict"):  # optax's states: their fields by name, as the JAX flatten keys them
        tree = dict(tree._asdict())
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves(tree) -> dict:
    out = {}
    _map(tree, lambda path, leaf: out.__setitem__("/".join(path), leaf))
    return out


def jax_tree(state: tt.TrainState, seed: int = 0) -> dict:
    """The port's train state as the JAX ``TrainState.as_pytree()``: live
    parameters and moments, the step as int32 scalars, and ``rng`` the
    uint32 key ``jax.random.PRNGKey(seed)`` would be."""
    params = tt.params_tree(state.model)
    moments = state.optimizer.state
    step = torch.tensor(state.step, dtype=torch.int32)
    return {
        "params": params,
        "opt_state": [
            {
                "count": step.clone(),
                "mu": _map(params, lambda _, p: moments[p]["exp_avg"]),
                "nu": _map(params, lambda _, p: moments[p]["exp_avg_sq"]),
            },
            {},
            {},
        ],
        "step": step,
        "rng": torch.tensor([0, seed], dtype=torch.uint32),
    }


def stage_tree(params: dict) -> list:
    """The model's blocks as STAGES per-stage trees of equal blocks."""
    per = len(params["layers"]) // STAGES
    return [{"blocks": params["layers"][i * per:(i + 1) * per]} for i in range(STAGES)]


def _is_expert(path: tuple, leaf) -> bool:
    return path[-1] in EXPERT_LEAVES and leaf.dim() == 3


def _local(dt):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh, dt.placements)
    return dt.to_local().float().numpy(), tuple(offset)


def world2_worker(pg, root: str) -> dict:
    """Expert parallel: the JAX MoE snapshot into the ep layout, then the
    port's take of it. Pipeline: the JAX pp = 4 stacks into pp = 2, then
    the port's pp = 2 take of them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    init_torch_group(pg)
    try:
        out = {}
        mesh = init_device_mesh("cpu", (2,))
        state = tt.init_train_state(port_cfg(), seed=1, device="cpu")

        def ep(path, leaf):
            if not _is_expert(path, leaf):
                return torch.zeros_like(leaf)
            n = leaf.shape[0] // 2
            return DTensor.from_local(
                torch.zeros_like(leaf[:n]), mesh, [Shard(0)], run_check=False, shape=leaf.shape, stride=leaf.stride()
            )

        tree = _map(jax_tree(state), ep)
        app = {"train": TensorTreeState(tree)}
        Snapshot(os.path.join(root, "jax_moe"), pg=pg).restore(app)
        out["ep"] = {
            k: (_local(v) if hasattr(v, "device_mesh") else (v.float().numpy(), None))
            for k, v in _leaves(app["train"].tree).items()
        }
        Snapshot.take(os.path.join(root, "port_ep2"), {"train": TensorTreeState(app["train"].tree)}, pg=pg,
                      replicated=["train/**"])

        pp_mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pp",))
        from torchsnapshot_tpu_torch.parallel import stack_stage_params

        model = tt.Transformer(port_cfg(PP_CFG), device="cpu")
        stacked = stack_stage_params(
            _map(stage_tree(tt.params_tree(model)), lambda _, p: torch.zeros_like(p.detach())), mesh=pp_mesh
        )
        app = {"pp": TensorTreeState(stacked)}
        Snapshot(os.path.join(root, "jax_pp4"), pg=pg).restore(app)
        out["pp"] = {k: _local(v) for k, v in _leaves(app["pp"].tree).items()}
        Snapshot.take(os.path.join(root, "port_pp2"), {"pp": TensorTreeState(app["pp"].tree)}, pg=pg)
        return out
    finally:
        dist.destroy_process_group()


def _jax_cfg(cfg: dict = CFG):
    from torchsnapshot_tpu.models import transformer as jt

    return jt.TransformerConfig(**cfg)


def _jax_stacked(params, n_devices: int):
    import jax
    from jax.sharding import Mesh

    from torchsnapshot_tpu.parallel import stack_stage_params

    mesh = Mesh(np.asarray(jax.devices()[:n_devices]).reshape(n_devices), ("pp",))
    return stack_stage_params(stage_tree(params), mesh=mesh), mesh


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.models import transformer as jt

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    root = str(tmp_path_factory.mktemp("moe_cross"))
    cfg = _jax_cfg()
    mesh = jt.make_mesh(8)
    state = jt.init_train_state(cfg, seed=3, mesh=mesh)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    state, _ = jt.make_train_step(cfg, mesh=mesh)(state, jax.device_put(tokens, NamedSharding(mesh, P("dp", None))))
    jts.Snapshot.take(os.path.join(root, "jax_moe"), {"train": jts.PyTreeState(state.as_pytree())})
    jax_np = jax.tree_util.tree_map(np.asarray, state.as_pytree())
    jts.Snapshot.take(os.path.join(root, "jax_moe1"), {"train": jts.PyTreeState(jax_np)})
    pp_params = jt.init_params(_jax_cfg(PP_CFG), jax.random.PRNGKey(5))
    for n in (4, 2):
        stacked, _ = _jax_stacked(pp_params, n)
        jts.Snapshot.take(os.path.join(root, f"jax_pp{n}"), {"pp": jts.PyTreeState(stacked)})
    pp_np = jax.tree_util.tree_map(np.asarray, pp_params)
    stacked_np = jax.tree_util.tree_map(lambda *a: np.stack(a), *stage_tree(pp_np))
    return {"root": root, "jax": jax_np, "stacked": stacked_np, "ranks": run_multiprocess(world2_worker, 2, args=(root,))}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.contiguous().view(torch.uint8).numpy().tobytes() if x.dim() else x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def test_jax_moe_state_restores_in_port_at_world_1(snaps) -> None:
    """Into a live model and AdamW, in place: every parameter, both
    moments of every leaf and the counts, bit for bit."""
    state = tt.init_train_state(port_cfg(), seed=1, device="cpu")
    tree = jax_tree(state)
    Snapshot(os.path.join(snaps["root"], "jax_moe")).restore({"train": TensorTreeState(tree)})
    want = _leaves(snaps["jax"])
    got = _leaves(tree)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert _bits(t) == _bits(want[k]), k
    assert _bits(state.model.layers[1].w_in) == _bits(want["params/layers/1/w_in"])
    assert _bits(state.optimizer.state[state.model.layers[3].router]["exp_avg_sq"]) == _bits(
        want["opt_state/0/nu/layers/3/router"]
    )


def test_jax_moe_state_restores_into_the_port_expert_parallel_layout(snaps) -> None:
    """World 2: each rank's expert-stacked leaves (parameters and moments)
    hold its two experts; every other leaf is whole."""
    want = _leaves(snaps["jax"])
    experts = 0
    for rank in snaps["ranks"]:
        for k, (local, offset) in rank["ep"].items():
            full = want[k].astype(np.float32)
            if offset is None:
                assert local.tobytes() == full.tobytes(), k
                continue
            experts += 1
            assert offset[0] == 2 * (offset[0] // 2) and local.shape[0] == 2, k
            assert local.tobytes() == full[offset[0]:offset[0] + 2].tobytes(), k
    assert experts == 2 * 3 * 2 * 2  # ranks x (param, mu, nu) x MoE blocks x (w_in, w_out)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_port_moe_state_restores_in_jax(snaps, tmp_path, n_devices) -> None:
    """A port-trained MoE state taken at world 1 restores in the JAX
    package under its sharded layouts (the ep leaves over ``sp``)."""
    import jax

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.models import transformer as jt

    state = tt.init_train_state(port_cfg(), seed=4, device="cpu")
    tokens = torch.from_numpy(tt.random_tokens(state.model.cfg, 4, 16, 0))
    tt.make_train_step(state.model.cfg)(state, tokens)
    tree = jax_tree(state, seed=4)
    path = str(tmp_path / "port_moe")
    Snapshot.take(path, {"train": TensorTreeState(tree)})
    dest = jts.PyTreeState(jt.init_train_state(_jax_cfg(), seed=9, mesh=jt.make_mesh(n_devices)).as_pytree())
    jts.Snapshot(path).restore({"train": dest})
    got = _leaves(jax.tree_util.tree_map(np.asarray, dest.tree))
    want = _leaves(tree)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert _bits(t) == _bits(got[k]), k


def test_port_expert_parallel_take_restores_in_jax(snaps) -> None:
    import jax

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.models import transformer as jt

    dest = jts.PyTreeState(jt.init_train_state(_jax_cfg(), seed=9, mesh=jt.make_mesh(4)).as_pytree())
    jts.Snapshot(os.path.join(snaps["root"], "port_ep2")).restore({"train": dest})
    got = _leaves(jax.tree_util.tree_map(np.asarray, dest.tree))
    for k, a in _leaves(snaps["jax"]).items():
        assert _bits(got[k]) == _bits(a), k


def test_jax_stacked_state_restores_in_port_at_pp_2_and_pp_1(snaps) -> None:
    """The JAX pp = 4 stacks: into pp = 2 (two stages a rank) and, in one
    process, into full stacks."""
    want = _leaves(snaps["stacked"])
    for rank in snaps["ranks"]:
        assert sorted(rank["pp"]) == sorted(want)
        for k, (local, offset) in rank["pp"].items():
            assert local.tobytes() == want[k][offset[0]:offset[0] + 2].astype(np.float32).tobytes(), k
    assert want["blocks/0/w_in"].shape == (STAGES, 4, 32, 64)
    dest = _map(snaps["stacked"], lambda _, v: torch.zeros(v.shape, dtype=torch.bfloat16))
    Snapshot(os.path.join(snaps["root"], "jax_pp4")).restore({"pp": TensorTreeState(dest)})
    got = _leaves(dest)
    for k, v in want.items():
        assert _bits(got[k]) == _bits(v), k


@pytest.mark.parametrize("n_devices", [4, 2])
def test_port_stacked_take_restores_in_jax(snaps, n_devices) -> None:
    import jax
    import jax.numpy as jnp

    import torchsnapshot_tpu as jts
    from torchsnapshot_tpu.models import transformer as jt
    from torchsnapshot_tpu.parallel import pipeline_stage_shardings

    params = jt.init_params(_jax_cfg(PP_CFG), jax.random.PRNGKey(9))
    stacked, mesh = _jax_stacked(params, n_devices)
    zeros = jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(jnp.zeros_like(leaf), s), stacked, pipeline_stage_shardings(stacked, mesh)
    )
    dest = jts.PyTreeState(zeros)
    jts.Snapshot(os.path.join(snaps["root"], "port_pp2")).restore({"pp": dest})
    got = _leaves(jax.tree_util.tree_map(np.asarray, dest.tree))
    for k, v in _leaves(snaps["stacked"]).items():
        assert _bits(got[k]) == _bits(v), k


def _entries(path: str, jax_pkg: bool) -> tuple:
    """(leaf entries by logical path, container paths) of rank 0's merged
    manifest."""
    if jax_pkg:
        import torchsnapshot_tpu as jts
        from torchsnapshot_tpu.manifest import get_manifest_for_rank, is_container_entry

        meta = jts.Snapshot(path).metadata
    else:
        from torchsnapshot_tpu_torch.manifest import get_manifest_for_rank, is_container_entry

        meta = Snapshot(path).metadata
    manifest = get_manifest_for_rank(meta, 0)
    return (
        {k: e for k, e in manifest.items() if not is_container_entry(e)},
        sorted(k for k, e in manifest.items() if is_container_entry(e)),
    )


def _fields(entry) -> tuple:
    def arr(a):
        return (a.location, a.serializer, a.dtype, list(a.shape), a.replicated, a.byte_range)

    if entry.type == "ShardedArray":
        shards = sorted(entry.shards, key=lambda s: s.offsets)
        return (entry.type, entry.dtype, list(entry.shape), [(s.offsets, s.sizes, arr(s.array)) for s in shards])
    if entry.type in ("Array", "ChunkedArray"):
        return (entry.type, entry.dtype, list(entry.shape), entry.replicated)
    return (entry.type,)


def test_same_values_give_the_same_manifest_entries(snaps, tmp_path) -> None:
    """World 1: the port's take of the JAX MoE state's values (through
    :func:`jax_tree`'s layout) against the JAX package's take of them.
    pp = 2: the port's take of the stacks against the JAX package's take
    on the first two devices (the same boxes)."""
    state = tt.init_train_state(port_cfg(), seed=1, device="cpu")
    tree = _map(jax_tree(state), lambda path, t: tensor_from_numpy(np.array(
        _leaves(snaps["jax"])["/".join(path)])))
    path = str(tmp_path / "port_moe1")
    Snapshot.take(path, {"train": TensorTreeState(tree)})
    for jname, pname, prefix in (("jax_moe1", path, "train"), ("jax_pp2", os.path.join(snaps["root"], "port_pp2"), "pp")):
        jentries, jcontainers = _entries(os.path.join(snaps["root"], jname), True)
        pentries, pcontainers = _entries(pname, False)
        assert jentries and all(k.startswith(f"{prefix}/") for k in jentries)
        assert sorted(jentries) == sorted(pentries) and jcontainers == pcontainers
        for k, e in jentries.items():
            assert _fields(e) == _fields(pentries[k]), k
