"""Snapshot take/restore of the port, and the shared on-disk format.

Round trips over the dtype table, the refusals of the three dtypes without
a torch counterpart, the commit-marker invariant under a failing storage
plugin, and cross-reads in both directions between torchsnapshot_tpu_torch
and torchsnapshot_tpu: the snapshot format is one format. Everything is
compared bit for bit (no tolerance): a checkpoint returns the bytes it was
given.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.tricks.torch import TorchStateful
from torchsnapshot_tpu_torch import (
    RngState,
    Snapshot,
    StateDict,
    TensorTreeState,
    knobs,
)
from torchsnapshot_tpu_torch import snapshot as snapshot_mod
from torchsnapshot_tpu_torch.manifest import ArrayEntry, ChunkedArrayEntry
from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

# One intra-op thread: the suite runs this file beside others in parallel
# workers, and torch's default of a thread per core would starve them (and
# their timing-sensitive tests).
torch.set_num_threads(1)

DTYPES = [
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "complex64",
    "complex128", "float8_e4m3fn", "float8_e5m2",
]


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensor(dtype: str, shape=(16, 4), seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if dtype.startswith("complex"):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(dtype))
    if dtype.startswith(("int", "uint")):
        return torch.from_numpy(rng.integers(0, 100, shape).astype(dtype))
    f32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return f32.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_dtypes(tmp_path, dtype) -> None:
    src = _tensor(dtype)
    Snapshot.take(str(tmp_path), {"s": StateDict(x=src, n=3, name="w")})
    dst = torch.zeros_like(src)
    live = StateDict(x=dst, n=0, name="")
    snap = Snapshot(str(tmp_path))
    snap.restore({"s": live})
    assert live["x"] is dst  # restored in place
    assert _bytes(dst) == _bytes(src)
    assert (live["n"], live["name"]) == (3, "w")
    assert _bytes(snap.read_object("0/s/x")) == _bytes(src)
    assert snap.get_manifest()["0/s/x"].dtype == dtype


def test_chunked_roundtrip_and_ranged_read_object(tmp_path) -> None:
    src = _tensor("float32", shape=(64, 32))
    with knobs.override_max_chunk_size_bytes(2048):
        Snapshot.take(str(tmp_path), {"s": TensorTreeState({"w": src, "list": [src[:2]]})})
    snap = Snapshot(str(tmp_path))
    assert isinstance(snap.get_manifest()["0/s/w"], ChunkedArrayEntry)
    tree = {"w": torch.zeros_like(src), "list": [torch.zeros(2, 32)]}
    snap.restore({"s": TensorTreeState(tree)})
    assert _bytes(tree["w"]) == _bytes(src)
    assert _bytes(tree["list"][0]) == _bytes(src[:2])
    out = torch.empty_like(src)
    assert snap.read_object("0/s/w", obj_out=out, memory_budget_bytes=1000) is out
    assert _bytes(out) == _bytes(src)


def test_module_optimizer_and_rng_roundtrip(tmp_path) -> None:
    cfg = tt.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, dtype=torch.float32
    )
    state = tt.init_train_state(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(tt.random_tokens(cfg, 2, 16, 0))
    tt.make_train_step(cfg)(state, tokens)
    torch.manual_seed(11)
    rng_at_take = torch.get_rng_state()
    Snapshot.take(
        str(tmp_path), {"model": state.model, "optim": state.optimizer, "rng": RngState()}
    )
    fresh = tt.init_train_state(cfg, seed=1, device="cpu")
    torch.rand(4)
    live_moment = fresh.optimizer.state[fresh.model.embed]["exp_avg"]
    Snapshot(str(tmp_path)).restore(
        {"model": fresh.model, "optim": fresh.optimizer, "rng": RngState()}
    )
    assert _bytes(torch.get_rng_state()) == _bytes(rng_at_take)
    for (n, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        assert _bytes(a) == _bytes(b), n
    # The moments were restored into the optimizer's live tensors.
    assert fresh.optimizer.state[fresh.model.embed]["exp_avg"] is live_moment
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for key, value in sa["state"][i].items():
            assert _bytes(sb["state"][i][key]) == _bytes(value), (i, key)


def test_two_rng_states_are_refused(tmp_path) -> None:
    with pytest.raises(RuntimeError, match="At most one RngState"):
        Snapshot.take(str(tmp_path), {"a": RngState(), "b": RngState()})


@pytest.mark.parametrize("dtype", ["float8_e4m3b11fnuz", "int4", "uint4"])
def test_dtypes_without_torch_counterpart_are_refused(tmp_path, dtype) -> None:
    arr = np.arange(8).astype(getattr(ml_dtypes, dtype))
    with pytest.raises(ValueError, match="no torch counterpart"):
        Snapshot.take(str(tmp_path / "port"), {"s": StateDict(x=arr)})
    assert not os.path.exists(tmp_path / "port" / ".snapshot_metadata")
    # Written by the JAX package, which has them: refused on read too.
    jts.Snapshot.take(str(tmp_path / "jax"), {"s": jts.StateDict(x=arr)})
    with pytest.raises(ValueError, match="no torch counterpart"):
        Snapshot(str(tmp_path / "jax")).read_object("0/s/x")


def test_failing_storage_leaves_no_commit_marker(tmp_path, monkeypatch) -> None:
    class FailingPlugin(FSStoragePlugin):
        async def write(self, write_io):
            if write_io.path.startswith("0/"):
                raise OSError("injected blob write failure")
            await super().write(write_io)

        async def write_with_checksum(self, write_io):
            await self.write(write_io)

    monkeypatch.setattr(snapshot_mod, "url_to_storage_plugin", lambda p: FailingPlugin(root=p))
    with pytest.raises(OSError, match="injected"):
        Snapshot.take(str(tmp_path), {"s": StateDict(x=torch.ones(1024))})
    assert not (tmp_path / ".snapshot_metadata").exists()


def _tiny_bf16_state(seed: int) -> tt.TrainState:
    cfg = tt.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256, attn_impl="flash"
    )
    return tt.init_train_state(cfg, seed=seed, device="cpu")


def test_jax_package_reads_what_the_port_writes(tmp_path) -> None:
    state = _tiny_bf16_state(0)
    Snapshot.take(str(tmp_path), {"train": state})
    snap = jts.Snapshot(str(tmp_path))
    for i, block in enumerate(tt.params_tree(state.model)["layers"]):
        for name, t in block.items():
            got = snap.read_object(f"0/train/params/layers/{i}/{name}")
            assert got.dtype == ml_dtypes.bfloat16 and got.shape == tuple(t.shape)
            assert got.tobytes() == _bytes(t), (i, name)
    assert snap.read_object("0/train/step") == 0
    embed = snap.read_object("0/train/params/embed")
    assert embed.tobytes() == _bytes(state.model.embed)


def test_port_restores_what_the_jax_package_writes(tmp_path) -> None:
    src = _tiny_bf16_state(0)
    tokens = torch.from_numpy(tt.random_tokens(src.model.cfg, 2, 128, 0))
    tt.make_train_step(src.model.cfg)(src, tokens)
    jts.Snapshot.take(
        str(tmp_path),
        {"model": TorchStateful(src.model), "optim": TorchStateful(src.optimizer)},
    )
    dst = _tiny_bf16_state(1)
    storage_before = {n: p.data_ptr() for n, p in dst.model.named_parameters()}
    Snapshot(str(tmp_path)).restore({"model": dst.model, "optim": dst.optimizer})
    live = dict(dst.model.named_parameters())
    for name, p in src.model.named_parameters():
        assert live[name].data_ptr() == storage_before[name]  # in place
        assert _bytes(live[name]) == _bytes(p), name
    sa, sb = src.optimizer.state_dict(), dst.optimizer.state_dict()
    for i in sa["state"]:
        for key, value in sa["state"][i].items():
            assert _bytes(sb["state"][i][key]) == _bytes(value), (i, key)


def test_manifest_leaf_entries_equal_across_packages(tmp_path) -> None:
    state = _tiny_bf16_state(0)
    with knobs.override_max_chunk_size_bytes(16 * 1024):
        Snapshot.take(str(tmp_path / "port"), {"model": state.model})
    from torchsnapshot_tpu import knobs as jknobs

    with jknobs.override_max_chunk_size_bytes(16 * 1024):
        jts.Snapshot.take(str(tmp_path / "jax"), {"model": TorchStateful(state.model)})
    port = Snapshot(str(tmp_path / "port")).get_manifest()
    ref = jts.Snapshot(str(tmp_path / "jax")).get_manifest()

    def leaves(manifest):
        out = {}
        for path, e in manifest.items():
            if isinstance(e, ArrayEntry) or type(e).__name__ == "ArrayEntry":
                out[path] = ("array", e.dtype, list(e.shape), e.serializer)
            elif isinstance(e, ChunkedArrayEntry) or type(e).__name__ == "ChunkedArrayEntry":
                out[path] = ("chunked", e.dtype, list(e.shape), [
                    (c.offsets, c.sizes, c.array.location) for c in e.chunks
                ])
        return out

    assert leaves(port) and leaves(port) == leaves(ref)
    assert any(v[0] == "chunked" for v in leaves(port).values())
