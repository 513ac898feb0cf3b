"""The port's ring attention (``ops/ring_attention.py``) and the
sequence-parallel transformer against the JAX package's, on the same numpy
inputs.

The cases of ``tests/test_ring_attention.py``: the ring's output and
gradients, the sp = 1 and meshless fallbacks, the transformer's logits
under ``ring`` / ``ring_flash`` / ``flash`` against the dense (``ulysses``)
model, the train step, and the refusal of a sequence the kernels cannot
tile. The port's ranks are two spawned processes on a gloo CPU mesh with
an ``sp`` dimension of 2 (spawned once for the module); the JAX side runs
its ring on an ``sp`` = 2 mesh of the virtual CPU devices, ``ring_flash``
through the Pallas kernel in interpret mode. The JAX parameters reach the
port's ranks through ``params_from_jax``. Tolerances are the JAX file's:
outputs 1e-5, gradients 1e-4, the fallbacks 1e-5 / 1e-6, the model's logits
2e-4 (f32 on both sides; the programs differ only in summation order). The
train step is held as ``tests/test_torch_model.py`` holds it: the loss to
1e-5 and both AdamW moments to 1e-4, which sees a gradient that was not
summed over the ranks, or summed twice.

Added: the sp = 2 job's take restores at world 1 bit for bit. The module
imports no jax at its top (the workers re-import it), so its ``cuda_only``
case, the ring over NCCL on two cards, runs on a card's machine:
``python -m pytest --noconftest -m cuda_only tests/test_torch_ring_attention.py``.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.ops import causal_attention
from torchsnapshot_tpu_torch.ops.ring_attention import ring_attention_block_specs, ring_causal_attention
from torchsnapshot_tpu_torch.telemetry import names as metric_names
from torchsnapshot_tpu_torch.telemetry.registry import series_key
from torchsnapshot_tpu_torch.test_utils import init_torch_group, run_multiprocess

# One intra-op thread: with more, the CPU backward is not bitwise
# reproducible across processes and the replicas' states drift.
torch.set_num_threads(1)

SP = 2
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 2e-4
MOMENT_RTOL = 1e-4

# (batch, seq, heads, dim) and seed of each attention case; ring_flash needs
# seq / sp to divide by 64.
QKV_CASES = {
    "fwd": ((2, 32, 4, 8), 0),
    "grad": ((2, 32, 4, 8), 1),
    "sp1": ((2, 16, 4, 8), 2),
    "flash_fwd": ((2, 128, 4, 8), 3),
    "flash_grad": ((2, 128, 4, 8), 4),
}
MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def qkv(case: str) -> tuple:
    shape, seed = QKV_CASES[case]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def model_tokens(case: str) -> np.ndarray:
    """(4, 32) tokens for the ring / ulysses comparison, (2, 128) for the
    flash impls and the step (the JAX file's shapes), (2, 96) for the
    refusal."""
    shape = {"ring": (4, 32), "flash": (2, 128), "step": (2, 128), "bad": (2, 96)}[case]
    return np.random.default_rng(1 if case == "step" else 0).integers(0, 64, shape).astype(np.int64)


def tcfg(attn_impl: str, n_experts: int = 0) -> tt.TransformerConfig:
    return tt.TransformerConfig(**MODEL, n_experts=n_experts, dtype=torch.float32, attn_impl=attn_impl)


def port_model(cfg: tt.TransformerConfig, params: dict) -> tt.Transformer:
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(cfg, params))
    return model


def block(x: torch.Tensor, r: int, n: int) -> torch.Tensor:
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def _state_numpy(state: tt.TrainState) -> dict:
    """Every tensor of a port train state by name, as numpy."""
    out = {f"param/{n}": p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k}/{n}"] = state.optimizer.state[p][k].numpy().copy()
    return out


def world_worker(pg, root: str, jax_params: dict) -> dict:
    """Rank r of the sp = 2 world: every case's output block."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torchsnapshot_tpu_torch import telemetry

    torch.set_num_threads(1)
    init_torch_group(pg)
    try:
        mesh = init_device_mesh("cpu", (SP,), mesh_dim_names=("sp",))
        r = mesh.get_local_rank(0)
        out = {"rank": r}
        for case, flash in (("fwd", False), ("flash_fwd", True)):
            blocks = [block(torch.from_numpy(t), r, SP) for t in qkv(case)]
            out[case] = ring_causal_attention(*blocks, mesh=mesh, use_flash=flash).numpy()
        for case, flash in (("grad", False), ("flash_grad", True)):
            blocks = [block(torch.from_numpy(t), r, SP).clone().requires_grad_() for t in qkv(case)]
            before = telemetry.metrics().counters_snapshot()
            ring_causal_attention(*blocks, mesh=mesh, use_flash=flash).square().sum().backward()
            out[case] = [t.grad.numpy() for t in blocks]
            out[f"{case}_counters"] = telemetry.metrics().counters_delta_since(before)
        dp_mesh = init_device_mesh("cpu", (SP, 1), mesh_dim_names=("dp", "sp"))
        q, k, v = (torch.from_numpy(t) for t in qkv("sp1"))
        out["sp1"] = ring_causal_attention(q, k, v, mesh=dp_mesh).numpy()
        out["no_mesh"] = ring_causal_attention(q, k, v, mesh=None).numpy()
        out["specs"] = [[repr(p) for p in ring_attention_block_specs(m)[1]] for m in (mesh, dp_mesh)]

        with torch.no_grad():
            for n_experts in (0, 4):
                cfg = tcfg("ring", n_experts)
                tokens = torch.from_numpy(model_tokens("ring"))
                model = port_model(cfg, jax_params[f"ring{n_experts}"])
                out[f"logits_ring{n_experts}"] = model(tt.sequence_block(tokens, mesh), mesh).numpy()
            cfg = tcfg("ring_flash")
            model = port_model(cfg, jax_params["flash"])
            tokens = torch.from_numpy(model_tokens("flash"))
            out["logits_ring_flash"] = model(tt.sequence_block(tokens, mesh), mesh).numpy()
            try:
                model(tt.sequence_block(torch.from_numpy(model_tokens("bad")), mesh), mesh)
                out["bad_seq"] = None
            except ValueError as e:
                out["bad_seq"] = str(e)

        cfg = tcfg("ring_flash")
        state = tt.init_train_state(cfg, seed=1, device="cpu")
        state.model.load_state_dict(tt.params_from_jax(cfg, jax_params["step"]))
        state, loss = tt.make_train_step(cfg, mesh)(state, torch.from_numpy(model_tokens("step")))
        out["step_loss"] = float(loss)
        out["step"] = state.step
        out["state"] = _state_numpy(state)
        Snapshot.take(os.path.join(root, "sp2"), {"train": state}, pg=pg, replicated=["train/**"])
        return out
    finally:
        dist.destroy_process_group()


def _jax_params() -> dict:
    """The JAX models' parameters as numpy trees, by case."""
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import TransformerConfig, init_params, init_train_state

    def cfg(attn_impl, n_experts=0):
        return TransformerConfig(**MODEL, n_experts=n_experts, dtype=jnp.float32, attn_impl=attn_impl)

    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {
        "ring0": as_np(init_params(cfg("ulysses"), jax.random.PRNGKey(0))),
        "ring4": as_np(init_params(cfg("ulysses", 4), jax.random.PRNGKey(0))),
        "flash": as_np(init_params(cfg("ulysses"), jax.random.PRNGKey(1))),
        "step": as_np(init_train_state(cfg("ring_flash"), seed=0).params),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ring"))
    params = _jax_params()
    ranks = sorted(run_multiprocess(world_worker, SP, args=(root, params)), key=lambda o: o["rank"])
    return {"root": root, "params": params, "ranks": ranks}


def _jax_mesh(sp: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:sp]).reshape(1, sp, 1), ("dp", "sp", "tp"))


def _jax_ring(case: str, use_flash: bool = False, sp: int = SP):
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import ring_causal_attention as jax_ring

    q, k, v = (jnp.asarray(t) for t in qkv(case))
    return np.asarray(jax_ring(q, k, v, mesh=_jax_mesh(sp), use_flash=use_flash, interpret=use_flash))


def _jax_ring_grads(case: str):
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import ring_causal_attention as jax_ring

    mesh = _jax_mesh(SP)
    q, k, v = (jnp.asarray(t) for t in qkv(case))
    loss = lambda q, k, v: jnp.sum(jnp.square(jax_ring(q, k, v, mesh=mesh)))  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _jax_logits(params: dict, tokens: np.ndarray, n_experts: int = 0) -> np.ndarray:
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import TransformerConfig, forward

    cfg = TransformerConfig(**MODEL, n_experts=n_experts, dtype=jnp.float32, attn_impl="ulysses")
    return np.asarray(forward(cfg, params, jnp.asarray(tokens, jnp.int32)))


def _gathered(ranks: list, key: str) -> np.ndarray:
    """The ranks' sequence blocks of ``key`` joined along the sequence."""
    return np.concatenate([o[key] for o in ranks], axis=1)


def test_ring_matches_dense_forward(worlds) -> None:
    want = _jax_ring("fwd")
    np.testing.assert_allclose(_gathered(worlds["ranks"], "fwd"), want, rtol=OUT_TOL, atol=OUT_TOL)
    dense = causal_attention(*(torch.from_numpy(t) for t in qkv("fwd"))).numpy()
    np.testing.assert_allclose(want, dense, rtol=OUT_TOL, atol=OUT_TOL)


def test_ring_matches_dense_grad(worlds) -> None:
    """Each rank's gradients are its blocks of JAX's: the hops' backward
    returns every key/value block's cotangent to its owner, once. The
    ring_flash backward (the einsum ring recomputed) gives the same."""
    for case in ("grad", "flash_grad"):
        want = _jax_ring_grads(case)
        for i, name in enumerate("qkv"):
            got = np.concatenate([o[case][i] for o in worlds["ranks"]], axis=1)
            np.testing.assert_allclose(got, want[i], rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{case} d{name}")
    # sp = 2: one hop of the stacked (k, v) forward and one back; the
    # ring_flash backward recomputes the forward (one more forward hop).
    for case, hops in (("grad", 2), ("flash_grad", 3)):
        (b, s, h, d), _ = QKV_CASES[case]
        for o in worlds["ranks"]:
            moved = o[f"{case}_counters"]
            assert moved[series_key(metric_names.PIPELINE_TRANSFERS_TOTAL, {"kind": "ring"})] == hops
            assert moved[series_key(metric_names.PIPELINE_TRANSFER_BYTES_TOTAL, {"kind": "ring"})] == (
                hops * 2 * b * (s // SP) * h * d * 4
            )


def test_ring_sp1_mesh_and_no_mesh(worlds) -> None:
    """A mesh whose sp is 1 and no mesh both run the dense op. The block
    placements shard the sequence over sp and the batch over dp."""
    import jax.numpy as jnp

    from torchsnapshot_tpu.ops import causal_attention as jax_dense

    q, k, v = (jnp.asarray(t) for t in qkv("sp1"))
    sp1 = _jax_ring("sp1", sp=1)
    dense = np.asarray(jax_dense(q, k, v))
    for o in worlds["ranks"]:
        np.testing.assert_allclose(o["sp1"], sp1, rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(o["no_mesh"], dense, rtol=1e-6, atol=1e-6)
        assert o["specs"] == [["Shard(dim=1)"], ["Shard(dim=0)", "Shard(dim=1)"]]


@pytest.mark.parametrize("n_experts", [0, 4])
def test_transformer_ring_vs_ulysses(worlds, n_experts) -> None:
    """The sp = 2 model's logits equal the dense model's: two schedules of
    the same math."""
    want = _jax_logits(worlds["params"][f"ring{n_experts}"], model_tokens("ring"), n_experts)
    got = _gathered(worlds["ranks"], f"logits_ring{n_experts}")
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_ring_flash_matches_dense_forward(worlds) -> None:
    """Every ring step in the chunk kernel's plain version (the JAX side:
    the Pallas kernel, interpreted), merged by the same recurrence."""
    want = _jax_ring("flash_fwd", use_flash=True)
    np.testing.assert_allclose(_gathered(worlds["ranks"], "flash_fwd"), want, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("attn_impl", ["flash", "ring_flash"])
def test_transformer_flash_impls_match_ulysses(worlds, attn_impl) -> None:
    want = _jax_logits(worlds["params"]["flash"], model_tokens("flash"))
    if attn_impl == "ring_flash":
        got = _gathered(worlds["ranks"], "logits_ring_flash")
    else:
        with torch.no_grad():
            got = port_model(tcfg("flash"), worlds["params"]["flash"])(torch.from_numpy(model_tokens("flash"))).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _jax_step(attn_impl: str):
    """The JAX step (on the sp = 2 mesh) from init_train_state(seed=0)."""
    import jax
    import jax.numpy as jnp

    from torchsnapshot_tpu.models import TransformerConfig, init_train_state, make_train_step

    cfg = TransformerConfig(**MODEL, n_experts=0, dtype=jnp.float32, attn_impl=attn_impl)
    mesh = _jax_mesh(SP)
    state = init_train_state(cfg, seed=0, mesh=mesh)
    state, loss = make_train_step(cfg, mesh=mesh)(state, jnp.asarray(model_tokens("step"), jnp.int32))
    adam = state.opt_state[0]
    as_sd = lambda tree: tt.params_from_jax(tcfg(attn_impl), jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return float(loss), int(state.step), as_sd(adam.mu), as_sd(adam.nu)


@pytest.mark.parametrize("attn_impl", ["flash", "ring_flash"])
def test_train_step_with_flash_impls(worlds, attn_impl) -> None:
    """One step of the port (flash at world 1; ring_flash on both sp
    ranks, the loss and gradients summed over sp) against JAX's step on its
    mesh: the loss and both AdamW moments of every parameter."""
    jloss, jstep, want_mu, want_nu = _jax_step(attn_impl)
    if attn_impl == "ring_flash":
        ranks = worlds["ranks"]
        got = [(o["step_loss"], o["step"], o["state"]) for o in ranks]
        # The replicas stayed bit-identical.
        for name, value in ranks[0]["state"].items():
            assert value.tobytes() == ranks[1]["state"][name].tobytes(), name
    else:
        cfg = tcfg("flash")
        state = tt.init_train_state(cfg, seed=1, device="cpu")
        state.model.load_state_dict(tt.params_from_jax(cfg, worlds["params"]["step"]))
        state, loss = tt.make_train_step(cfg)(state, torch.from_numpy(model_tokens("step")))
        got = [(float(loss), state.step, _state_numpy(state))]
    for loss, step, tensors in got:
        assert np.isfinite(loss) and step == jstep == 1
        np.testing.assert_allclose(loss, jloss, rtol=OUT_TOL, atol=OUT_TOL)
        for name in want_mu:
            for key, want in (("exp_avg", want_mu[name]), ("exp_avg_sq", want_nu[name])):
                want = want.numpy()
                np.testing.assert_allclose(
                    tensors[f"{key}/{name}"], want, rtol=MOMENT_RTOL,
                    atol=MOMENT_RTOL * float(np.abs(want).max()), err_msg=f"{key}/{name}",
                )


def test_flash_rejects_bad_seq_loudly(worlds) -> None:
    """flash needs seq % 128 == 0 and ring_flash s_local % 64 == 0; neither
    falls back to the dense path the caller chose flash to avoid."""
    model = tt.Transformer(tcfg("flash"), device="cpu")
    with pytest.raises(ValueError, match="seq % 128"):
        model(torch.from_numpy(model_tokens("bad")))
    for o in worlds["ranks"]:
        assert o["bad_seq"] is not None and "s_local=48" in o["bad_seq"]


def test_sp_take_restores_at_world_1(worlds) -> None:
    """The sp = 2 job's take (its leaves declared replicated, so each
    rank writes a share) restores in one process bit for bit."""
    ranks = worlds["ranks"]
    cfg = tcfg("ring_flash")
    fresh = tt.init_train_state(cfg, seed=5, device="cpu")
    Snapshot(os.path.join(worlds["root"], "sp2")).restore({"train": fresh})
    got = _state_numpy(fresh)
    assert fresh.step == ranks[0]["step"] == 1
    assert sorted(got) == sorted(ranks[0]["state"])
    for name, value in ranks[0]["state"].items():
        assert got[name].tobytes() == value.tobytes(), name
    written = [os.path.join(worlds["root"], "sp2", "checksums", str(r)) for r in range(SP)]
    assert all(os.path.getsize(p) > 2 for p in written)  # both ranks wrote blobs


def nccl_worker(pg) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(pg.rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_torch_group(pg, backend="nccl")
    try:
        mesh = init_device_mesh("cuda", (SP,), mesh_dim_names=("sp",))
        r = mesh.get_local_rank(0)
        out = {"rank": r}
        for flash in (False, True):
            blocks = [block(torch.from_numpy(t).cuda(), r, SP).clone().requires_grad_() for t in _nccl_qkv()]
            y = ring_causal_attention(*blocks, mesh=mesh, use_flash=flash)
            y.square().sum().backward()
            out[flash] = (y.detach().cpu().numpy(), [t.grad.cpu().numpy() for t in blocks])
        return out
    finally:
        dist.destroy_process_group()


def _nccl_qkv() -> tuple:
    rng = np.random.default_rng(7)
    return tuple(rng.standard_normal((2, 256, 4, 64)).astype(np.float32) for _ in range(3))


@pytest.mark.cuda_only
def test_ring_over_nccl_on_two_cards() -> None:
    """On an NCCL group the hops send the CUDA blocks as they are; ring and
    ring_flash (the f32 chunk kernel on the card) equal the dense op on
    the CPU, outputs and gradients."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one device)")
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in _nccl_qkv())
    y = causal_attention(q, k, v)
    y.square().sum().backward()
    ranks = sorted(run_multiprocess(nccl_worker, SP), key=lambda o: o["rank"])
    for flash in (False, True):
        got = np.concatenate([o[flash][0] for o in ranks], axis=1)
        np.testing.assert_allclose(got, y.detach().numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
        for i, t in enumerate((q, k, v)):
            g = np.concatenate([o[flash][1][i] for o in ranks], axis=1)
            np.testing.assert_allclose(g, t.grad.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)
