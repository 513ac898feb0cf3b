"""Randomized crash consistency in the port: storage fails at an
arbitrary write index, and the take leaves no commit marker while a clean
retake over the partial directory commits and restores byte-exact; reads
failing at an arbitrary index raise, and a clean retry restores.

Port of the JAX package's ``tests/test_crash_consistency.py``, its two
cases with their seeds. Each case is driven by a declarative
:class:`~torchsnapshot_tpu_torch.chaos.FaultPlan` over the fs plugin, and
asserts that its plan survives the one-line JSON form a red run prints.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState
from torchsnapshot_tpu_torch.chaos import ChaosEngine, FaultPlan, chaotic_plugin_type
from torchsnapshot_tpu_torch.chaos.plan import seeded_failure_plan
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.test_utils import patch_storage_plugin

torch.set_num_threads(1)


def _chaotic_fs(plan: FaultPlan):
    engine = ChaosEngine(plan)
    return chaotic_plugin_type(FSStoragePlugin, engine), engine


def _tree(rng, n_leaves: int, max_len: int) -> dict:
    return {
        f"l{i}": torch.from_numpy(rng.standard_normal(int(rng.integers(1, max_len))).astype(np.float32))
        for i in range(n_leaves)
    }


def _zeros(state: dict) -> dict:
    return {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in state.items()})}


def _assert_restored(dst: dict, state: dict) -> None:
    for k, v in state.items():
        assert torch.equal(dst["m"].tree[k], v), k


@pytest.mark.parametrize("seed", range(4))
def test_read_failure_raises_then_clean_retry_succeeds(tmp_path, seed) -> None:
    """Reads failing at an arbitrary index surface as an exception, never
    a silent partial success, and a clean retry restores byte-exact."""
    rng = np.random.default_rng(7000 + seed)
    n_leaves = int(rng.integers(2, 16))
    state = _tree(rng, n_leaves, 4000)
    path = str(tmp_path / "s")
    Snapshot.take(path, {"m": TensorTreeState(dict(state))})
    fail_at = int(rng.integers(0, n_leaves))
    plan = seeded_failure_plan(seed, "storage-read", fail_at, exc_msg="injected read failure")
    assert FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    cls, engine = _chaotic_fs(plan)
    with patch_storage_plugin(cls), pytest.raises(OSError, match="injected read failure"):
        Snapshot(path).restore(_zeros(state))
    assert engine.fired and all(point == "storage-read" for point, _, _ in engine.fired)
    dst = _zeros(state)
    Snapshot(path).restore(dst)
    _assert_restored(dst, state)


@pytest.mark.parametrize("seed", range(8))
def test_crash_at_random_write_index(tmp_path, seed) -> None:
    rng = np.random.default_rng(4000 + seed)
    n_leaves = int(rng.integers(2, 20))
    state = _tree(rng, n_leaves, 5000)
    fail_at = int(rng.integers(0, n_leaves + 2))
    plan = seeded_failure_plan(seed, "storage-write", fail_at, exc_msg="injected failure")
    cls, engine = _chaotic_fs(plan)
    path = str(tmp_path / "s")
    crashed = False
    try:
        with patch_storage_plugin(cls):
            Snapshot.take(path, {"m": TensorTreeState(dict(state))})
    except OSError:
        crashed = True
    if crashed:
        assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
        # A fresh engine over the same plan line fires at the same op.
        replay_cls, replay_engine = _chaotic_fs(FaultPlan.from_json(plan.to_json()))
        with patch_storage_plugin(replay_cls), pytest.raises(OSError):
            Snapshot.take(str(tmp_path / "replay"), {"m": TensorTreeState(dict(state))})
        assert replay_engine.fired[0][2] == engine.fired[0][2] == "fail"
    Snapshot.take(path, {"m": TensorTreeState(dict(state))})
    dst = _zeros(state)
    Snapshot(path).restore(dst)
    _assert_restored(dst, state)
