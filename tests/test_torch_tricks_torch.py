"""``TorchStateful`` in the port (``torchsnapshot_tpu_torch/tricks/torch.py``):
a port, case for case, of the JAX package's ``tests/test_tricks_torch.py``
on the CPU. The JAX case that restores into jax arrays restores here into
a ``TensorTreeState``; the snapshots crossing packages are held in
``test_torch_bridge_crosspkg.py``."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.tricks.torch import TorchStateful


def _model() -> torch.nn.Module:
    torch.manual_seed(7)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))


def _stepped(model: torch.nn.Module) -> torch.optim.Optimizer:
    optim = torch.optim.Adam(model.parameters(), lr=1e-3)
    # One step so the optimizer has real state tensors.
    model(torch.randn(4, 8)).sum().backward()
    optim.step()
    return optim


def test_module_and_optimizer_roundtrip(tmp_path) -> None:
    model = _model()
    optim = _stepped(model)
    Snapshot.take(str(tmp_path), {"model": TorchStateful(model), "optim": TorchStateful(optim)})

    fresh_model = _model()
    with torch.no_grad():
        for p in fresh_model.parameters():
            p.zero_()
    fresh_optim = _stepped(fresh_model)
    Snapshot(str(tmp_path)).restore(
        {"model": TorchStateful(fresh_model), "optim": TorchStateful(fresh_optim)}
    )

    for (k1, v1), (k2, v2) in zip(model.state_dict().items(), fresh_model.state_dict().items()):
        assert k1 == k2
        assert torch.equal(v1, v2), k1
    s1, s2 = optim.state_dict(), fresh_optim.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for pid in s1["state"]:
        for field, val in s1["state"][pid].items():
            got = s2["state"][pid][field]
            if isinstance(val, torch.Tensor):
                assert torch.equal(val, got), (pid, field)
            else:
                assert val == got, (pid, field)


def test_bf16_tensor_roundtrip(tmp_path) -> None:
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8).to(torch.bfloat16)
    Snapshot.take(str(tmp_path), {"s": TorchStateful({"t": t.clone()})})

    stateful = TorchStateful({"t": torch.zeros(8, 8, dtype=torch.bfloat16)})
    Snapshot(str(tmp_path)).restore({"s": stateful})
    assert torch.equal(stateful.obj["t"], t)


def test_noncontiguous_and_scalar(tmp_path) -> None:
    state = {
        "strided": torch.arange(24, dtype=torch.float32).reshape(4, 6).t(),
        "scalar": torch.tensor(3.5),
        "step": 12,
    }
    Snapshot.take(str(tmp_path), {"s": TorchStateful(dict(state))})
    stateful = TorchStateful({"strided": torch.zeros(6, 4), "scalar": torch.tensor(0.0), "step": 0})
    Snapshot(str(tmp_path)).restore({"s": stateful})
    assert torch.equal(stateful.obj["strided"], state["strided"])
    assert float(stateful.obj["scalar"]) == 3.5
    assert stateful.obj["step"] == 12


def test_save_through_bridge_restore_into_tensor_tree(tmp_path) -> None:
    """The migration path: a trainer writes through the bridge class, and
    a process without it restores the same logical paths as plain
    tensors."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    Snapshot.take(str(tmp_path), {"params": TorchStateful({"w": w})})

    fresh = {"params": TensorTreeState({"w": torch.zeros(3, 4)})}
    Snapshot(str(tmp_path)).restore(fresh)
    np.testing.assert_array_equal(fresh["params"].tree["w"].numpy(), w.numpy())


def test_plain_dict_restore_mutates_original_in_place(tmp_path) -> None:
    """A caller holding the original plain dict must observe restored
    non-tensor leaves (step counters, lr floats) after restore, not just
    the in-place-copied tensors; destination-only keys survive."""
    src = {
        "w": torch.arange(6, dtype=torch.float32),
        "step": 41,
        "lr": 0.25,
        "sched": [1, 2, {"gamma": 0.9}],
    }
    Snapshot.take(str(tmp_path), {"s": TorchStateful(src)})

    w_live = torch.zeros(6, dtype=torch.float32)
    dst = {"w": w_live, "step": 0, "lr": 0.0, "sched": [0, 0, {"gamma": 0.0}], "new_field": "kept"}
    held = dst  # what a training loop would keep a reference to
    held_sched = dst["sched"]
    Snapshot(str(tmp_path)).restore({"s": TorchStateful(dst)})
    assert held["step"] == 41
    assert held["lr"] == 0.25
    assert held_sched[0] == 1 and held_sched[2]["gamma"] == pytest.approx(0.9)
    assert held["w"] is w_live
    np.testing.assert_array_equal(held["w"].numpy(), np.arange(6, dtype=np.float32))
    assert held["new_field"] == "kept"
