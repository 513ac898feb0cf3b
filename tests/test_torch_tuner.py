"""The port's write-path autotuner (``tuner/``): tunable bounds and steps,
env-always-wins precedence, the verdict -> direction policy, the decision
log, revert-on-regression, the manager's closed loop, the kill switch,
and one applied vector on every rank.

Ports of the JAX package's ``tests/test_tuner.py``, under the same names,
on torch state. Added: the port's ``write_vectorized`` tunable has the
JAX package's bounds, and only ``storage-tier-slow`` moves it. This file
imports no ``jax`` (its spawned worker re-imports it): the JAX tuner and
the port's deciding alike, and each loading the other's state file, are
in ``tests/test_torch_diagnosis_crosspkg.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, StateDict, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.test_utils import run_multiprocess
from torchsnapshot_tpu_torch.tuner import TUNABLES, Autotuner, TunerState, policy, tunables
from torchsnapshot_tpu_torch.tuner import state as tuner_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_overrides():
    telemetry.reset_metrics()
    knobs.clear_tuner_overrides()
    yield
    knobs.clear_tuner_overrides()
    telemetry.reset_metrics()


def _state(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    return {"s": StateDict(w=torch.from_numpy(rng.standard_normal(n).astype(np.float32)))}


def test_tunable_move_is_bounded_and_clamped():
    t = TUNABLES["staging_threads"]
    assert t.move(4, +1) == 8
    assert t.move(4, -1) == 2
    assert t.move(32, +1) == 32
    assert t.saturated(32, +1)
    assert t.move(1, -1) == 1
    assert t.saturated(1, -1)
    assert TUNABLES["staging_pool_slabs"].move(3, +1) >= 4
    frac = TUNABLES["memory_budget_fraction"]
    assert frac.move(0.6, +1) == pytest.approx(0.75)
    assert frac.move(0.9, +1) == pytest.approx(0.9)


def test_apply_vector_respects_env_and_budget_clamp():
    with knobs.override_staging_threads(3):
        applied = tunables.apply_vector({"staging_threads": 16, "io_concurrency": 32})
        assert applied["staging_threads"] == 3
        assert applied["io_concurrency"] == 32
        assert knobs.get_per_rank_io_concurrency() == 32
    applied = tunables.apply_vector(
        {"staging_pool_slabs": 4, "staging_pool_slab_bytes": 512 * tunables.MIB},
        memory_budget_bytes=256 * tunables.MIB,
    )
    assert applied["staging_pool_slabs"] * applied["staging_pool_slab_bytes"] <= 256 * tunables.MIB
    clamped = tunables.clamp_vector(
        {"staging_pool_slabs": 4, "staging_pool_slab_bytes": 512 * tunables.MIB},
        memory_budget_bytes=40 * tunables.MIB,
    )
    assert clamped["staging_pool_slab_bytes"] == 16 * tunables.MIB
    assert clamped["staging_pool_slabs"] == 2


def test_policy_maps_verdicts_to_directions():
    vec = tunables.current_vector()
    d, _ = policy.decide([names.RULE_BUDGET_STARVED], vec, {}, 0, 0)
    assert (d.tunable, d.direction) == ("memory_budget_fraction", +1)
    d, _ = policy.decide([names.RULE_WRITE_TAIL_STALL], vec, {}, 0, 0)
    assert (d.tunable, d.direction) == ("io_concurrency", +1)
    d, _ = policy.decide([names.RULE_RETRY_STORM], vec, {}, 0, 0)
    assert (d.tunable, d.direction) == ("io_concurrency", -1)
    d, _ = policy.decide([names.RULE_D2H_BOUND], vec, {}, 0, 0)
    assert d.action == "hold"
    d, _ = policy.decide([names.RULE_D2H_BOUND, names.RULE_BUDGET_STARVED], vec, {}, 0, 0)
    assert d.tunable == "memory_budget_fraction"


def test_policy_falls_through_saturated_and_cooling_candidates():
    vec = dict(tunables.current_vector())
    vec["memory_budget_fraction"] = 0.9
    d, _ = policy.decide([names.RULE_BUDGET_STARVED], vec, {}, 0, 0)
    assert d.tunable == "staging_pool_slab_bytes"
    cooldowns = {policy.move_key("io_concurrency", +1): 0}
    d, _ = policy.decide([names.RULE_WRITE_TAIL_STALL], vec, cooldowns, 1, 0)
    assert (d.tunable, d.direction) == ("max_chunk_size_bytes", -1)
    d, _ = policy.decide([names.RULE_WRITE_TAIL_STALL], vec, cooldowns, policy.COOLDOWN_DECISIONS + 1, 0)
    assert (d.tunable, d.direction) == ("io_concurrency", +1)


def test_policy_exploration_round_robin_and_convergence():
    vec = dict(tunables.current_vector())
    d, idx = policy.decide([], vec, {}, 0, 0)
    assert (d.reason, d.tunable) == ("explore", "staging_threads")
    d, idx = policy.decide([], vec, {}, 1, idx)
    assert d.tunable == "io_concurrency"
    d, idx = policy.decide([], vec, {}, 2, idx)
    assert d.tunable == "staging_pool_slab_bytes"
    maxed = dict(vec)
    for name in tunables.explore_order():
        maxed[name] = TUNABLES[name].hi
    d, _ = policy.decide([], maxed, {}, 3, 0)
    assert d.action == "hold" and "converged" in d.reason


def test_state_round_trips_and_bounds(tmp_path):
    root = str(tmp_path)
    st = TunerState(vector={"staging_threads": 8}, known_good={})
    for i in range(tuner_state.MAX_DECISIONS + 5):
        st.record_decision({"step": i, "decision": {"action": "hold"}})
    path = tuner_state.save_state(root, st)
    assert path is not None and os.path.basename(path) == ".tuner-state.json"
    loaded = tuner_state.load_state(root)
    assert loaded.vector == {"staging_threads": 8}
    assert len(loaded.decisions) == tuner_state.MAX_DECISIONS
    assert loaded.decision_count == tuner_state.MAX_DECISIONS + 5
    with open(path, "w") as f:
        f.write("{torn")
    assert tuner_state.load_state(root) is None
    assert tuner_state.state_path_for("s3://bucket/ckpt") is None


def _fake_report(take_s, mb=128):
    return {
        "kind": "take", "rank": 0, "phases": {"staging": round(take_s * 0.4, 3), "writing": take_s},
        "bytes_moved": mb * 1024 * 1024, "budget_wait_s": 0.0, "retries": {}, "mirror": {},
        "tunables": knobs.tunable_snapshot(),
    }


def test_autotuner_reverts_on_regression_and_cools_down(tmp_path):
    root = str(tmp_path)
    at = Autotuner(root)
    for step in range(3):
        at._decide(step, _fake_report(take_s=1.0))
    st = tuner_state.load_state(root)
    last = st.decisions[-1]["decision"]
    assert last["action"] == "adjust"
    known_good = dict(st.known_good)
    assert dict(st.vector) != known_good
    vec = at._decide(3, _fake_report(take_s=3.0))
    st = tuner_state.load_state(root)
    reverted = st.decisions[-1]["decision"]
    assert reverted["action"] == "revert"
    assert reverted["tunable"] == last["tunable"]
    assert "regression" in reverted["reason"]
    assert vec == known_good == st.vector
    assert policy.move_key(last["tunable"], last["direction"]) in st.cooldowns


def test_autotuner_survives_restart_from_state_file(tmp_path):
    root = str(tmp_path)
    Autotuner(root)._decide(0, _fake_report(take_s=1.0))
    saved = tuner_state.load_state(root)
    vec = Autotuner(root)._decide(1, _fake_report(take_s=1.0))
    st = tuner_state.load_state(root)
    assert [d["step"] for d in st.decisions] == [0, 1]
    first = saved.decisions[-1]["decision"]
    assert vec[first["tunable"]] == first["to_value"]
    second = st.decisions[-1]["decision"]
    assert (second.get("tunable"), second.get("action")) != (first["tunable"], "adjust") or (
        second["from_value"] == first["to_value"]
    )


def test_manager_closed_loop_records_decisions_and_knob_trajectory(tmp_path):
    root = str(tmp_path / "ckpt")
    with knobs.enable_autotune(), knobs.override_history_max_records(16):
        mgr = CheckpointManager(root, keep_last_n=2)
        for step in range(3):
            mgr.save(step, _state(seed=step))
        with open(os.path.join(root, ".tuner-state.json")) as f:
            doc = json.load(f)
        assert [d["step"] for d in doc["decisions"]] == [0, 1, 2]
        for d in doc["decisions"]:
            assert d["decision"]["action"] in ("adjust", "hold", "revert")
            assert d["vector"]
        assert telemetry.last_report("take").tunables["staging_threads"] >= 1
        from torchsnapshot_tpu_torch.telemetry import history

        rows = history.load_history(history.history_path_for(root))
        assert len(rows) == 3 and all(r.get("tunables") for r in rows)


def test_kill_switch_means_no_tuner_reads_or_writes(tmp_path):
    assert not knobs.is_autotune_enabled()
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_n=2)
    for step in range(2):
        mgr.save(step, _state(seed=step))
    assert not os.path.exists(os.path.join(root, ".tuner-state.json"))
    assert knobs.get_tuner_overrides() == {}
    assert mgr._autotuner is None
    assert telemetry.last_report("take").tunables is not None


def test_autotuner_holds_without_a_report(tmp_path):
    assert Autotuner(str(tmp_path))._decide(0, None) == tunables.current_vector()
    assert tuner_state.load_state(str(tmp_path)) is None


def test_write_vectorized_is_carried_untouched(tmp_path):
    """``write_vectorized`` is in the port's set as in the JAX package's:
    bounded 0..1, on by default, and moved up only by
    ``storage-tier-slow`` (past a saturated ``io_concurrency``); a
    decided vector carries it, and applying a 0 turns the zero-pack
    write off through the override layer."""
    t = TUNABLES["write_vectorized"]
    assert (t.lo, t.hi, t.env) == (0, 1, "TORCHSNAPSHOT_TPU_WRITE_VECTORIZED")
    assert t.move(1, +1) == 1 and t.move(0, +1) == 1 and t.move(1, -1) == 0
    assert tunables.clamp_vector({"write_vectorized": 7})["write_vectorized"] == 1
    assert tunables.clamp_vector({"write_vectorized": -3})["write_vectorized"] == 0
    assert knobs.tunable_snapshot()["write_vectorized"] == 1
    movers = {
        verdict for verdict, moves in policy.VERDICT_ACTIONS.items()
        if any(name == "write_vectorized" for name, _ in moves)
    }
    assert movers == {names.RULE_STORAGE_TIER_SLOW}
    assert ("write_vectorized", +1) in policy.VERDICT_ACTIONS[names.RULE_STORAGE_TIER_SLOW]
    assert "write_vectorized" not in tunables.explore_order()
    vec = dict(tunables.current_vector(), write_vectorized=0)
    vec["io_concurrency"] = TUNABLES["io_concurrency"].hi
    d, _ = policy.decide([names.RULE_STORAGE_TIER_SLOW], vec, {}, 0, 0)
    assert (d.tunable, d.direction) == ("write_vectorized", +1)
    for verdict in (names.RULE_BUDGET_STARVED, names.RULE_WRITE_TAIL_STALL, names.RULE_RETRY_STORM):
        d, _ = policy.decide([verdict], vec, {}, 0, 0)
        assert d.tunable != "write_vectorized"
    root = str(tmp_path)
    at = Autotuner(root)
    for step in range(3):
        decided = at._decide(step, _fake_report(take_s=1.0))
        assert decided["write_vectorized"] == 1
    st = tuner_state.load_state(root)
    assert st.vector["write_vectorized"] == 1
    applied = tunables.apply_vector(dict(decided, write_vectorized=0))
    assert applied["write_vectorized"] == 0
    assert not knobs.is_write_vectorized_enabled()
    knobs.clear_tuner_overrides()
    assert knobs.is_write_vectorized_enabled()


def _rank_consistency_worker(pg, root: str):
    with knobs.enable_autotune():
        mgr = CheckpointManager(root, pg=pg)
        rng = np.random.default_rng(pg.rank)
        state = {"s": StateDict(w=torch.from_numpy(rng.standard_normal(2048).astype(np.float32)))}
        applied = []
        for step in range(3):
            mgr.save(step, state)
            applied.append(dict(tunables.current_vector()))
        st = tuner_state.load_state(root) if pg.rank == 0 else None
        return applied, [d["step"] for d in st.decisions] if st else None


def test_all_ranks_apply_the_same_decided_vector(tmp_path):
    results = run_multiprocess(_rank_consistency_worker, nproc=2, args=(str(tmp_path / "ckpt"),))
    vectors = [r[0] for r in results]
    for step_idx in range(3):
        assert vectors[0][step_idx] == vectors[1][step_idx], f"rank vectors diverged at step {step_idx}"
    assert results[0][1] == [0, 1, 2]
