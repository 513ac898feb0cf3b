"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's, on the same numpy inputs.

The five cases of ``tests/test_pipeline.py``: the pipelined output against
the sequential one, the bubble-only schedule (one microbatch), the
gradient through the schedule, the stacked state's checkpoint round trip
with an elastic restore from pp = 4 into pp = 2, and the refusal of a
stack that does not match the pp size. The port's ranks are four spawned
processes on gloo CPU meshes (spawned once for the module): a pp = 4 mesh,
and a (pp = 2, dp = 2) mesh of two pipelines;
the JAX side runs ``pipelined_apply`` on the 8 virtual CPU devices.
Tolerances are the JAX file's: outputs within 1e-5, gradients within 1e-4
(f32 on both sides; the programs differ only in summation order).

The module imports no jax at its top (the workers re-import it), so its
``cuda_only`` case, the NCCL hop on two cards, runs on a card's machine:
``python -m pytest --noconftest -m cuda_only tests/test_torch_pipeline.py``.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, telemetry
from torchsnapshot_tpu_torch.parallel import pipeline_stage_shardings, pipelined_apply, stack_stage_params
from torchsnapshot_tpu_torch.parallel.pipeline import transport
from torchsnapshot_tpu_torch.telemetry import names as metric_names
from torchsnapshot_tpu_torch.telemetry.registry import series_key
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

torch.set_num_threads(1)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"]) + x  # residual keeps the hopping shape


def make_stages(n_stages: int, d: int, seed: int = 0) -> list:
    """``tests/test_pipeline.py``'s stages as numpy f32 arrays (the same
    draws in the same order)."""
    rng = np.random.default_rng(seed)
    return [
        {
            "w": np.asarray(rng.standard_normal((d, d)) * 0.1, np.float32),
            "b": np.asarray(rng.standard_normal((d,)) * 0.1, np.float32),
        }
        for _ in range(n_stages)
    ]


def torch_stages(stages: list, device: str = "cpu") -> list:
    return [{k: torch.from_numpy(v).to(device) for k, v in s.items()} for s in stages]


def stacked_numpy(stages: list) -> dict:
    return {k: np.stack([s[k] for s in stages]) for k in stages[0]}


def _inputs(case: str) -> tuple:
    """(n_stages, d, stage seed, x, n_microbatches) of each case."""
    if case == "sequential":
        return 4, 16, 0, np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32), 4
    if case == "bubble":
        return 2, 8, 3, np.ones((2, 8), np.float32), 1
    assert case == "grad"
    return 2, 8, 5, np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32), 2


def _pp_mesh(world: int, device: str = "cpu"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, (world,), mesh_dim_names=("pp",))


def _run_case(case: str, mesh, device: str = "cpu") -> dict:
    n, d, seed, x, n_micro = _inputs(case)
    stacked = stack_stage_params(torch_stages(make_stages(n, d, seed), device), mesh=mesh)
    x = torch.from_numpy(x).to(device)
    if case != "grad":
        with torch.no_grad():
            out = pipelined_apply(stage_fn, stacked, x, mesh=mesh, n_microbatches=n_micro)
        return {"out": out.cpu().numpy()}
    for leaf in stacked.values():
        leaf.requires_grad_(True)
    x.requires_grad_(True)
    before = telemetry.metrics().counters_snapshot()
    out = pipelined_apply(stage_fn, stacked, x, mesh=mesh, n_microbatches=n_micro)
    (out**2).sum().backward()
    return {
        "out": out.detach().cpu().numpy(),
        "grad": {k: v.grad.to_local().cpu().numpy() for k, v in stacked.items()},
        "x_grad": x.grad.cpu().numpy(),
        "counters": telemetry.metrics().counters_delta_since(before),
    }


def _local_equal(dt, full: np.ndarray) -> bool:
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, dt.device_mesh, dt.placements)
    want = full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    return dt.to_local().numpy().tobytes() == want.tobytes() and tuple(dt.to_local().shape) == want.shape


def world_worker(pg, root: str) -> dict:
    """A world of 4: the sequential case at pp = 4; the take of a stacked
    state and its restore at the same degree; then on a (pp = 2, dp = 2)
    mesh (two pipelines, each over its own pp group) the bubble-only and
    gradient cases, the elastic restore of the pp = 4 snapshot, and the
    refusals."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    init_torch_group(pg)
    try:
        mesh = _pp_mesh(pg.world_size)
        out = {"sequential": _run_case("sequential", mesh)}
        stages = make_stages(4, 16, seed=7)
        full = stacked_numpy(stages)
        stacked = stack_stage_params(torch_stages(stages), mesh=mesh)
        out["local_stages"] = {k: tuple(v.to_local().shape) for k, v in stacked.items()}
        Snapshot.take(os.path.join(root, "pp4"), {"pp": TensorTreeState(stacked)}, pg=pg)
        dest = {k: torch.zeros_like(v) for k, v in stacked.items()}
        app = {"pp": TensorTreeState(dest)}
        Snapshot(os.path.join(root, "pp4"), pg=pg).restore(app)
        out["same_degree"] = {k: _local_equal(v, full[k]) for k, v in app["pp"].tree.items()}

        mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pp", "dp"))
        out["pp_rank"], out["dp_rank"] = mesh2.get_local_rank(0), mesh2.get_local_rank(1)
        out.update({case: _run_case(case, mesh2) for case in ("bubble", "grad")})
        shardings = pipeline_stage_shardings({k: torch.from_numpy(v) for k, v in full.items()}, mesh2)
        dest = {}
        for k, v in full.items():
            m, placements = shardings[k]
            dest[k] = DTensor.from_local(
                torch.zeros((v.shape[0] // 2, *v.shape[1:])), m, placements,
                run_check=False, shape=torch.Size(v.shape), stride=torch.from_numpy(v).stride(),
            )
        app = {"pp": TensorTreeState(dest)}
        Snapshot(os.path.join(root, "pp4"), pg=pg).restore(app)
        out["elastic"] = {k: _local_equal(v, full[k]) for k, v in app["pp"].tree.items()}
        errors = []
        for stages, batch, n_micro in ((make_stages(4, 8), 4, 2), (make_stages(2, 8), 3, 2)):
            try:
                pipelined_apply(
                    stage_fn, stack_stage_params(torch_stages(stages), mesh=None), torch.ones((batch, 8)),
                    mesh=mesh2, n_microbatches=n_micro,
                )
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out["refusals"] = errors
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    return {"root": root, "ranks": run_multiprocess(world_worker, 4, args=(root,))}


def _jax_case(case: str) -> dict:
    """JAX's pipelined_apply on the same inputs (and its gradient)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from torchsnapshot_tpu.parallel import pipelined_apply as jax_pipelined_apply
    from torchsnapshot_tpu.parallel import stack_stage_params as jax_stack

    n, d, seed, x, n_micro = _inputs(case)
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("pp",))
    stages = [{k: jnp.asarray(v) for k, v in s.items()} for s in make_stages(n, d, seed)]
    stacked = jax_stack(stages, mesh=mesh)

    def jfn(params, a):
        return jnp.tanh(a @ params["w"] + params["b"]) + a

    def apply(params, a):
        return jax_pipelined_apply(jfn, params, a, mesh=mesh, n_microbatches=n_micro)

    out = {"out": np.asarray(apply(stacked, jnp.asarray(x)))}
    if case == "grad":
        grads, x_grad = jax.grad(lambda p, a: jnp.sum(apply(p, a) ** 2), argnums=(0, 1))(stacked, jnp.asarray(x))
        out["grad"] = {k: np.asarray(v) for k, v in grads.items()}
        out["x_grad"] = np.asarray(x_grad)
    seq = x
    for s in make_stages(n, d, seed):
        seq = np.tanh(seq @ s["w"] + s["b"]) + seq
    out["sequential"] = seq
    return out


@pytest.mark.parametrize("case", ["sequential", "bubble"])
def test_pipeline_matches_jax_and_sequential(worlds, case) -> None:
    """Every rank returns the last stage's output (replicated), equal to
    JAX's pipelined output and to the sequential application."""
    want = _jax_case(case)
    for rank_out in worlds["ranks"]:
        got = rank_out[case]["out"]
        np.testing.assert_allclose(got, want["out"], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got, want["sequential"], rtol=OUT_TOL, atol=OUT_TOL)


def test_pipeline_grad(worlds) -> None:
    """Reverse mode through the schedule (hops backward, the output's
    broadcast, the input's sum): each rank's stage gradient is its row of
    JAX's stacked gradient, and every rank's input gradient is JAX's,
    neither scaled by the number of stages."""
    want = _jax_case("grad")
    ranks = worlds["ranks"]
    for rank_out in ranks:
        np.testing.assert_allclose(rank_out["grad"]["out"], want["out"], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(rank_out["grad"]["x_grad"], want["x_grad"], rtol=GRAD_TOL, atol=GRAD_TOL)
        # 2 stages, 2 microbatches: 3 ticks, 2 hops forward and 2 back;
        # one broadcast of the (4, 8) f32 output, one sum of its cotangent.
        # CPU tensors make no host round trip.
        moved = rank_out["grad"]["counters"]
        for kind, calls, nbytes in (("hop", 4, 4 * 2 * 8 * 4), ("broadcast", 1, 4 * 8 * 4), ("sum", 1, 4 * 8 * 4)):
            assert moved[series_key(metric_names.PIPELINE_TRANSFERS_TOTAL, {"kind": kind})] == calls
            assert moved[series_key(metric_names.PIPELINE_TRANSFER_BYTES_TOTAL, {"kind": kind})] == nbytes
            assert moved[series_key(metric_names.PIPELINE_TRANSFER_SECONDS_TOTAL, {"kind": kind})] > 0
        assert metric_names.DEVICE_TO_HOST_BYTES_TOTAL not in moved
    for dp in (0, 1):  # each pipeline on its own pp group
        pipeline = sorted((r for r in ranks if r["dp_rank"] == dp), key=lambda r: r["pp_rank"])
        for name, g in want["grad"].items():
            got = np.concatenate([r["grad"]["grad"][name] for r in pipeline])
            np.testing.assert_allclose(got, g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_pipeline_state_checkpoint_roundtrip(worlds) -> None:
    """Stacked pp-sharded state saves and restores byte-identically at the
    same degree (pp = 4, one stage a rank) and into pp = 2 (two stages a
    rank: the stage dim resharded), and at pp = 1 into full stacks."""
    ranks = worlds["ranks"]
    assert all(r["local_stages"] == {"w": (1, 16, 16), "b": (1, 16)} for r in ranks)
    assert all(all(r["same_degree"].values()) for r in ranks)
    assert all(all(r["elastic"].values()) for r in ranks)
    full = stacked_numpy(make_stages(4, 16, seed=7))
    dest = {k: torch.zeros(v.shape) for k, v in full.items()}
    Snapshot(os.path.join(worlds["root"], "pp4")).restore({"pp": TensorTreeState(dest)})
    assert all(dest[k].numpy().tobytes() == full[k].tobytes() for k in full)


def test_pipeline_rejects_stage_mesh_mismatch(worlds) -> None:
    stages_msg, batch_msg = worlds["ranks"][0]["refusals"]
    assert stages_msg is not None and "stacked for 4 stages" in stages_msg and "2 devices" in stages_msg
    assert batch_msg is not None and "must divide by n_microbatches=2" in batch_msg


def nccl_worker(pg) -> dict:
    import torch.distributed as dist

    torch.cuda.set_device(pg.rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_torch_group(pg, backend="nccl")
    try:
        mesh = _pp_mesh(pg.world_size, "cuda")
        got = _run_case("grad", mesh, "cuda")
        got["transport"] = transport(mesh.get_group(0), torch.device("cuda"))
        return got
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda_only
def test_nccl_hop_on_two_cards() -> None:
    """On an NCCL group the hops send the CUDA activations as they are;
    outputs and gradients equal the gloo route's reference (the
    sequential application, and its gradient by autograd on the CPU)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one device)")
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, seed, x, _ = _inputs("grad")
    stages = [{k: v.requires_grad_(True) for k, v in s.items()} for s in torch_stages(make_stages(n, d, seed))]
    x = torch.from_numpy(x).requires_grad_(True)
    y = x
    for s in stages:
        y = stage_fn(s, y)
    (y**2).sum().backward()
    ranks = run_multiprocess(nccl_worker, 2)
    for r, got in enumerate(ranks):
        assert got["transport"] == "nccl"
        np.testing.assert_allclose(got["out"], y.detach().numpy(), rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got["x_grad"], x.grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
        for name in ("w", "b"):
            np.testing.assert_allclose(got["grad"][name][0], stages[r][name].grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
