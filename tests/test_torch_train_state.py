"""``TrainStateStateful`` (``tricks/train_state.py``): a model and its
optimizers as one Stateful, in ``get_state_dict``'s names.

Ports of the flax cases of the JAX package's ``tests/test_tricks.py``: a
train state taken after one step restores into a fresh one (here a fresh
model and AdamW) and training continues bit for bit; an object without
the protocol raises ``TypeError`` naming what it lacks. Added: the same
through ``dcp.save`` with the snapshot writer, and the JAX package
restoring the snapshot raw, equal to the torch state.
"""

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from torchsnapshot_tpu_torch import Snapshot
from torchsnapshot_tpu_torch.tricks.dcp import SnapshotStorageWriter
from torchsnapshot_tpu_torch.tricks.train_state import TrainStateStateful

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:torch.distributed is disabled")


def _model(seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 3))


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))


def _step(model, opt, seed: int) -> torch.Tensor:
    opt.zero_grad()
    loss = model(_batch(seed)).pow(2).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def _trained(seed: int = 0):
    model = _model(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    _step(model, opt, 100)
    return model, opt


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("route", ["take", "dcp-writer"])
def test_train_state_roundtrip_continues_bit_for_bit(tmp_path, route) -> None:
    model, opt = _trained()
    path = str(tmp_path / "snap")
    tss = TrainStateStateful(model, opt, step=1)
    if route == "take":
        Snapshot.take(path, {"train": tss})
    else:
        dcp.save({"train": tss}, storage_writer=SnapshotStorageWriter(path))

    fresh_model = _model(1)
    fresh_opt = torch.optim.AdamW(fresh_model.parameters(), lr=1e-2)
    dest = TrainStateStateful(fresh_model, fresh_opt)
    Snapshot(path).restore({"train": dest})
    assert dest.step == 1
    for (name, a), b in zip(model.state_dict().items(), fresh_model.state_dict().values()):
        assert _same_bits(a, b), name
    for pa, pb in zip(model.parameters(), fresh_model.parameters()):
        sa, sb = opt.state[pa], fresh_opt.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert _same_bits(sa[k], sb[k]), k
    assert fresh_opt.param_groups[0]["lr"] == opt.param_groups[0]["lr"]

    # The next step is the live run's, bit for bit.
    live = _step(model, opt, 101)
    resumed = _step(fresh_model, fresh_opt, 101)
    assert _same_bits(live, resumed)
    for pa, pb in zip(model.parameters(), fresh_model.parameters()):
        assert _same_bits(pa.detach(), pb.detach())


def test_state_dict_is_fqn_keyed_with_the_step() -> None:
    model, opt = _trained()
    sd = TrainStateStateful(model, opt, step=4).state_dict()
    assert set(sd) == {"model", "optim", "step"} and sd["step"] == 4
    assert set(sd["model"]) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    assert set(sd["optim"]["state"]) == {"0.weight", "0.bias", "2.weight", "2.bias"}


@pytest.mark.parametrize(
    "build,match",
    [
        (lambda m, o: TrainStateStateful({"just": "a dict"}, o), "state_dict"),
        (lambda m, o: TrainStateStateful(m, object()), "state_dict"),
        (lambda m, o: TrainStateStateful(m, [o, {"lr": 1}]), "state_dict"),
    ],
    ids=["model", "optimizer", "one-of-the-optimizers"],
)
def test_train_state_rejects_objects_without_the_protocol(build, match) -> None:
    model, opt = _trained()
    with pytest.raises(TypeError, match=match):
        build(model, opt)


def test_jax_package_restores_the_train_state_raw(tmp_path) -> None:
    """The JAX package reads the snapshot as a raw tree: the same names
    and the same values as the torch state."""
    import torchsnapshot_tpu as jts

    model, opt = _trained()
    path = str(tmp_path / "snap")
    Snapshot.take(path, {"train": TrainStateStateful(model, opt, step=3)})

    class Raw:
        value = None

        def state_dict(self):
            return {}

        def load_state_dict(self, sd):
            self.value = sd

    raw = Raw()
    jts.Snapshot(path).restore({"train": raw})
    assert raw.value["step"] == 3
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(np.asarray(raw.value["model"][name]), t.numpy())
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(
            np.asarray(raw.value["optim"]["state"][name]["exp_avg"]), opt.state[p]["exp_avg"].numpy()
        )
