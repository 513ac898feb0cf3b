"""The port's goodput engine: run-level wall-time attribution, lost-work
accounting, storage-cost curves, the CLI, the ``goodput_*`` gauges, and the
manager's restore rows in the step history.

Ports of the JAX package's ``tests/test_goodput.py``, each docstring naming
the case it ports, on torch state, except ``test_doctor_trend_appends_run_
level_verdicts`` and ``test_fsck_stats_summarizes_ledger`` (the doctor and
``fsck --stats`` are ROADMAP step 10d). The JAX cases that judge a ledger
through the doctor's ``recovery-cost-high`` / ``goodput-degraded`` rules
hold here the attribution those rules read, against the rules' JAX
thresholds (60 s of recovery, 15% overhead). This file imports no ``jax``.
"""

import json
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, PreemptionSaver, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import goodput, history, ledger, names
from torchsnapshot_tpu_torch.telemetry.sink import atomic_write_text

torch.set_num_threads(1)

# The JAX doctor's thresholds (torchsnapshot_tpu/telemetry/doctor.py).
_RECOVERY_COST_S = 60.0
_GOODPUT_DEGRADED_FRAC = 0.15


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_metrics()
    ledger.reset_owned_roots()
    yield
    telemetry.reset_metrics()
    ledger.reset_owned_roots()


def _state(n=2, size=1024, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)}


def _interrupted_run(root: str):
    """A manager run with one injected interruption and restore: saves at
    steps 0 and 2, a preemption notice at step 3 whose save never lands,
    then a fresh manager restores and saves step 3. Returns the test's
    own (wall, lost window) clocks."""
    t0 = time.time()
    mgr = CheckpointManager(root, keep_last_n=4)
    saver = PreemptionSaver(signals=(), ledger_root=root)
    try:
        for step in range(4):
            if step % 2 == 0:
                mgr.save(step, {"s": TensorTreeState(_state(seed=step))})
                lost_t0 = time.time()
            time.sleep(0.15)  # "training"
            if step == 3:
                saver.request_save()
                assert saver.should_save(step)
    finally:
        saver.uninstall()
    lost_window = time.time() - lost_t0
    seg1_wall = time.time() - t0

    t1 = time.time()
    mgr2 = CheckpointManager(root, keep_last_n=4)
    dest = {"s": TensorTreeState(_state(seed=2))}
    assert mgr2.restore_latest(dest) == 2
    time.sleep(0.15)
    mgr2.save(3, {"s": TensorTreeState(_state(seed=3))})
    return seg1_wall + time.time() - t1, lost_window


def test_attribution_sums_to_measured_wall_within_tolerance(tmp_path):
    """Ports ``test_attribution_sums_to_measured_wall_within_tolerance``:
    the buckets sum to the ledger wall, which tracks the test's wall
    within 5%, and the interrupted segment reports its lost work."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        measured_wall, lost_window = _interrupted_run(root)
        analysis = goodput.analyze_root(root)
    run = goodput.latest_run(analysis)
    assert run is not None and len(run["segments"]) == 2
    buckets = run["train_s"] + run["visible_stall_s"] + run["restore_s"] + run["lost_work_s"]
    assert buckets == pytest.approx(run["wall_s"], rel=1e-6, abs=1e-3)
    assert run["wall_s"] == pytest.approx(measured_wall, rel=0.05)
    seg1 = run["segments"][0]
    assert seg1["interrupted"]
    assert seg1["lost_work_s"] == pytest.approx(lost_window, rel=0.25)
    assert seg1["lost_steps"] == 1
    assert seg1["preemption_step"] == 3
    assert run["interruptions"][0]["recovery_cost_s"] > 0
    assert run["restore_s"] > 0


def test_goodput_cli_table_and_json(tmp_path, capsys):
    """Ports ``test_goodput_cli_table_and_json``, through
    ``python -m torchsnapshot_tpu_torch.telemetry.goodput``'s ``main``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _interrupted_run(root)
        assert goodput.main([root]) == 0
        out = capsys.readouterr().out
        assert "lost work" in out and "visible stall" in out
        assert "preempted at step 3" in out
        assert "storage:" in out
        assert goodput.main([root, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["runs"][-1]["segments"][0]["interrupted"]
        assert doc["storage"]["retained_steps"] > 0


def test_goodput_cli_without_ledger(tmp_path, capsys):
    """Ports ``test_goodput_cli_without_ledger``."""
    assert goodput.main([str(tmp_path)]) == 1
    assert "no run ledger" in capsys.readouterr().out


def test_manager_commits_refresh_goodput_gauges(tmp_path):
    """Ports ``test_manager_commits_refresh_goodput_gauges``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        mgr = CheckpointManager(root)
        for step in range(2):
            mgr.save(step, {"s": TensorTreeState(_state(seed=step))})
    gauges = telemetry.metrics().collect()["gauges"]
    assert names.GOODPUT_OVERHEAD_FRACTION in gauges
    assert gauges[names.GOODPUT_STORAGE_BYTES_PER_STEP] > 0
    assert 0.0 <= gauges[names.GOODPUT_OVERHEAD_FRACTION] <= 1.0


def test_storage_curve_tracks_retention(tmp_path):
    """Ports ``test_storage_curve_tracks_retention``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        mgr = CheckpointManager(root, keep_last_n=2)
        for step in range(4):
            mgr.save(step, {"s": TensorTreeState(_state(seed=step))})
        storage = goodput.analyze_root(root)["storage"]
    assert storage["retained_steps"] == 2
    assert [row["step"] for row in storage["per_step"]] == [2, 3]
    assert storage["bytes_per_retained_step"] > 0
    assert storage["reclaimed_steps"] == 2
    assert storage["reclaimed_bytes"] > 0


def _synthetic_interrupted_ledger(root: str, lost_s: float, restore_s: float):
    """A ledger written through the real API with injected timestamps: a
    segment committing through t+300 and dying at t+300+lost_s, then a
    resumed segment whose recovery restore took restore_s."""
    t0 = 1_700_000_000.0
    rid = ledger.open_run(root)
    assert rid is not None
    atomic_write_text(ledger.ledger_path_for(root), "")
    ledger.post_event(
        root, names.EVENT_RUN_START, create=True, run_id=rid, segment=1, world_size=1, unix_ts=t0
    )
    for i, off in enumerate((60.0, 180.0, 300.0)):
        ledger.post_event(
            root, names.EVENT_VISIBLE_STALL, step=i, kind="take", visible_s=2.0, wall_s=2.0,
            nbytes=1 << 20, unix_ts=t0 + off,
        )
        ledger.post_event(
            root, names.EVENT_STEP_COMMITTED, step=i, bytes_new=1 << 20, bytes_reused=0,
            bytes_total=1 << 20, blobs=2, unix_ts=t0 + off + 0.5,
        )
    ledger.post_event(
        root, names.EVENT_PREEMPTION, step=5, target_step=6, unix_ts=t0 + 300.0 + lost_s
    )
    t1 = t0 + 300.0 + lost_s + 30.0
    ledger.post_event(root, names.EVENT_RUN_START, run_id=rid, segment=2, world_size=1, unix_ts=t1)
    ledger.post_event(
        root, names.EVENT_RESTORE_SERVED, step=2, kind="restore", restore_s=restore_s,
        nbytes=1 << 20, unix_ts=t1 + restore_s,
    )
    ledger.post_event(
        root, names.EVENT_STEP_COMMITTED, step=3, bytes_new=1 << 20, bytes_reused=0,
        bytes_total=1 << 20, blobs=2, unix_ts=t1 + restore_s + 60.0,
    )


def test_recovery_cost_high_fires_with_ledger_evidence(tmp_path):
    """Ports ``test_recovery_cost_high_fires_with_ledger_evidence``: the
    interruption's attribution (the evidence the JAX rule cites) crosses
    the 60 s recovery budget, with its lost work, lost steps, preemption
    step and recovery restore."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _synthetic_interrupted_ledger(root, lost_s=90.0, restore_s=45.0)
        itr = goodput.latest_run(goodput.analyze_root(root))["interruptions"][0]
    assert itr["recovery_cost_s"] == pytest.approx(135.0, abs=2.0)
    assert itr["recovery_cost_s"] > _RECOVERY_COST_S
    assert itr["lost_work_s"] == pytest.approx(89.5, abs=2.0)
    assert itr["lost_steps"] == 3
    assert itr["preemption_step"] == 5
    assert itr["last_committed_step"] == 2
    assert itr["restore_s"] == pytest.approx(45.0, abs=1.0)


def test_recovery_cost_excludes_deliberate_restores(tmp_path):
    """Ports ``test_recovery_cost_excludes_deliberate_restores``: a restore
    after the resumed segment's first commit stays in the restore bucket
    but never prices the interruption."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _synthetic_interrupted_ledger(root, lost_s=10.0, restore_s=5.0)
        ledger.post_event(
            root, names.EVENT_RESTORE_SERVED, step=1, kind="restore", restore_s=300.0, nbytes=1,
            unix_ts=1_700_000_900.0,
        )
        run = goodput.latest_run(goodput.analyze_root(root))
    itr = run["interruptions"][0]
    assert itr["restore_s"] == pytest.approx(5.0)
    assert itr["recovery_cost_s"] == pytest.approx(15.0, abs=1.0)
    assert run["restore_s"] == pytest.approx(305.0)
    assert itr["recovery_cost_s"] < _RECOVERY_COST_S


def test_by_tier_durable_tracks_retention(tmp_path):
    """Ports ``test_by_tier_durable_tracks_retention``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        assert ledger.open_run(root) is not None
        for step in range(3):
            ledger.post_event(
                root, names.EVENT_STEP_COMMITTED, step=step, bytes_new=100, bytes_reused=0,
                bytes_total=100, blobs=1,
            )
            ledger.post_event(
                root, names.EVENT_MIRROR_SETTLED, step=step, lag_s=1.0, nbytes=100, blobs=1, error=None
            )
        ledger.post_event(root, names.EVENT_GC_RECLAIMED, step=0, bytes_reclaimed=100, blobs=1)
        ledger.prune_steps(root, {0})
        storage = goodput.analyze_root(root)["storage"]
    assert storage["retained_steps"] == 2
    assert storage["by_tier"] == {"primary": 200, "durable": 200}


def test_recovery_cost_quiet_below_threshold(tmp_path):
    """Ports ``test_recovery_cost_quiet_below_threshold``."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _synthetic_interrupted_ledger(root, lost_s=10.0, restore_s=5.0)
        itr = goodput.latest_run(goodput.analyze_root(root))["interruptions"][0]
    assert itr["recovery_cost_s"] < _RECOVERY_COST_S


def test_goodput_degraded_fires_on_overhead_heavy_run(tmp_path):
    """Ports ``test_goodput_degraded_fires_on_overhead_heavy_run``: stalls
    and recovery eat more than the rule's 15% of the wall."""
    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _synthetic_interrupted_ledger(root, lost_s=90.0, restore_s=45.0)
        run = goodput.latest_run(goodput.analyze_root(root))
    assert run["overhead_fraction"] >= _GOODPUT_DEGRADED_FRAC
    assert run["lost_work_s"] > 0 and run["visible_stall_s"] > 0


def test_goodput_quiet_on_healthy_run(tmp_path):
    """Ports ``test_goodput_quiet_on_healthy_run``: a clean run stays under
    both thresholds, and a step dir resolves the root's ledger."""
    root = str(tmp_path / "ckpts")
    t0 = 1_700_000_000.0
    with knobs.enable_ledger():
        rid = ledger.open_run(root)
        atomic_write_text(ledger.ledger_path_for(root), "")
        ledger.post_event(
            root, names.EVENT_RUN_START, create=True, run_id=rid, segment=1, world_size=1, unix_ts=t0
        )
        for i in range(3):
            ledger.post_event(
                root, names.EVENT_VISIBLE_STALL, step=i, kind="take", visible_s=1.0, wall_s=1.0,
                nbytes=1, unix_ts=t0 + 100.0 * (i + 1),
            )
            ledger.post_event(
                root, names.EVENT_STEP_COMMITTED, step=i, bytes_new=1, bytes_reused=0,
                bytes_total=1, blobs=1, unix_ts=t0 + 100.0 * (i + 1) + 0.5,
            )
        run = goodput.latest_run(goodput.analyze_root(root))
        assert run["overhead_fraction"] < _GOODPUT_DEGRADED_FRAC
        assert run["interruptions"] == []
        found = ledger.find_ledger_for(f"{root}/step_0000000001")
        assert found is not None and found.endswith(ledger.LEDGER_BASENAME)
        assert len(ledger.load_ledger(found)) == 7


def test_restore_rows_land_in_history_with_kind_isolation(tmp_path):
    """Ports ``test_restore_rows_land_in_history_with_kind_isolation``:
    manager restores append history rows, and trend detection baselines
    per kind."""
    root = str(tmp_path / "ckpts")
    with knobs.override_history_max_records(32):
        mgr = CheckpointManager(root)
        for step in range(3):
            mgr.save(step, {"s": TensorTreeState(_state(seed=step))})
        dest = {"s": TensorTreeState(_state(seed=0))}
        mgr.restore(2, dest)
        mgr.async_restore(2, dest).wait()
        records = history.load_history(history.history_path_for(root))
    assert [r["kind"] for r in records] == ["take", "take", "take", "restore", "async_restore"]
    mixed = []
    for i in range(6):
        mixed.append(
            {"step": i, "kind": "take", "take_s": 1.0, "mb_s": 100.0, "budget_wait_s": 0.0,
             "phases": {"writing": 1.0}}
        )
        mixed.append(
            {"step": i, "kind": "restore", "take_s": 40.0, "mb_s": 10.0, "budget_wait_s": 0.0,
             "phases": {"loading": 40.0}}
        )
    assert history.detect_trend_regressions(mixed) == []
    mixed.append(
        {"step": 6, "kind": "take", "take_s": 5.0, "mb_s": 100.0, "budget_wait_s": 0.0,
         "phases": {"writing": 5.0}}
    )
    rows = history.detect_trend_regressions(mixed)
    assert rows and all(r["kind"] == "take" for r in rows)
    assert {r["step"] for r in rows} == {6}
