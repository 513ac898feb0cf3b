"""The port's checkpoint doctor: the rule registry, the report and
evidence rules over synthetic inputs and over real recorded artifacts of
the port's takes, the bench-trial epistemics, the step history and trend
regression detection, and ``fsck --stats``.

Ports of the JAX package's ``tests/test_doctor.py`` (under the same
names, on torch state), of the dedup rule case of ``tests/test_cas.py``,
of the five staleness-rule cases of ``tests/test_cdn_storm.py`` and of
the two doctor cases of ``tests/test_goodput.py``. Where a case feeds the
doctor a synthetic input, the JAX doctor is fed the same input and must
give the same verdicts (``_both``). The JAX case that reads ``bench.py``'s
trial diagnostics holds here the port's trial diagnosis against the JAX
one instead: the port has no bench.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu.telemetry import doctor as jdoctor
from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, knobs, telemetry
from torchsnapshot_tpu_torch.dist_store import TCPStore
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import doctor, history, ledger, names, wire
from torchsnapshot_tpu_torch.telemetry.stats import main as stats_main

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset_metrics()
    ledger.reset_owned_roots()
    yield
    telemetry.reset_metrics()
    ledger.reset_owned_roots()


def _state(n=4, size=2048, seed=0):
    rng = np.random.default_rng(seed)
    return {"s": StateDict({f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)})}


def _both(fn: str, *args):
    """The port's verdicts of ``doctor.<fn>(*args)``, after checking the
    JAX doctor gives the same list for the same input."""
    ours = getattr(doctor, fn)(*args)
    theirs = getattr(jdoctor, fn)(*args)
    assert [v.to_dict() for v in ours] == [v.to_dict() for v in theirs]
    return ours


def _evidence(**fields):
    """An Evidence of each package, for ``_both_evidence``."""
    return doctor.Evidence(**fields), jdoctor.Evidence(**fields)


def _both_evidence(**fields):
    ours, theirs = _evidence(**fields)
    out = doctor.diagnose_evidence(ours)
    assert [v.to_dict() for v in out] == [v.to_dict() for v in jdoctor.diagnose_evidence(theirs)]
    return out


def _rule(verdicts, rule):
    return [v for v in verdicts if v.rule == rule]


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------


def test_every_registered_rule_id_is_declared_in_names():
    declared = {v for k, v in vars(names).items() if k.startswith("RULE_") and isinstance(v, str)}
    registered = set(doctor.registered_rule_ids())
    assert registered <= declared
    # The same catalogue as the JAX doctor's, fleet rules included.
    assert doctor.registered_rule_ids() == jdoctor.registered_rule_ids()
    for rule_id in (
        names.RULE_D2H_BOUND,
        names.RULE_BUDGET_STARVED,
        names.RULE_STRAGGLER_RANK,
        names.RULE_STORAGE_TIER_SLOW,
        names.RULE_MIRROR_LAGGING,
        names.RULE_WRITE_TAIL_STALL,
        names.RULE_INTERRUPTED_TAKE,
    ):
        assert rule_id in registered


# ---------------------------------------------------------------------------
# Report-scope rules over synthetic reports
# ---------------------------------------------------------------------------


def _report(**over):
    base = {
        "kind": "take",
        "rank": 0,
        "phases": {"staging": 1.0, "writing": 2.0},
        "bytes_moved": 100 * 1024**2,
        "budget_wait_s": 0.0,
        "retries": {},
        "mirror": {},
    }
    base.update(over)
    return base


def _rules_for(reports):
    return {v.rule for v in _both("diagnose_reports", reports)}


def test_storage_tier_slow_vs_d2h_bound():
    assert _rules_for([_report(phases={"staging": 0.2, "writing": 3.0})]) == {names.RULE_STORAGE_TIER_SLOW}
    assert _rules_for([_report(phases={"staging": 2.8, "writing": 3.0})]) == {names.RULE_D2H_BOUND}
    assert _rules_for([_report(phases={"staging": 1.5, "writing": 3.0})]) == set()


def test_budget_starved_cites_wait_fraction():
    starved = _report(budget_wait_s=1.5, phases={"staging": 1.5, "writing": 3.0})
    budget = _rule(_both("diagnose_reports", [starved]), names.RULE_BUDGET_STARVED)
    assert len(budget) == 1
    assert budget[0].evidence["wait_frac"] == 0.5
    assert budget[0].evidence["budget_wait_s"] == 1.5


def test_straggler_rank_names_the_rank():
    report = _report(
        aggregated={
            "phase_writing_s": {"min": 1.0, "median": 1.1, "max": 9.0, "straggler": 3},
            "bytes_moved": {"min": 1.0, "median": 1.0, "max": 1.0, "straggler": 0},
        },
        phases={"staging": 1.5, "writing": 3.0},
    )
    verdicts = _rule(_both("diagnose_reports", [report]), names.RULE_STRAGGLER_RANK)
    assert len(verdicts) == 1
    assert verdicts[0].evidence["straggler_rank"] == 3
    assert verdicts[0].evidence["metric"] == "phase_writing_s"


def test_async_visible_stall_rule():
    regressed = _report(kind="async_take", visible_s=99.7, staged_s=99.8, phases={"staging": 99.6, "writing": 101.1})
    healthy = _report(kind="async_take", visible_s=0.02, staged_s=1.4, phases={"staging": 1.4, "writing": 2.0})
    assert names.RULE_ASYNC_VISIBLE_STALL in _rules_for([regressed])
    assert names.RULE_ASYNC_VISIBLE_STALL not in _rules_for([healthy])
    assert names.RULE_ASYNC_VISIBLE_STALL not in _rules_for([_report(kind="take", visible_s=None)])
    assert names.RULE_ASYNC_VISIBLE_STALL not in _rules_for([_report(kind="async_take")])
    verdict = _rule(_both("diagnose_reports", [regressed]), names.RULE_ASYNC_VISIBLE_STALL)[0]
    assert verdict.evidence["visible_s"] == 99.7
    assert verdict.evidence["staging_s"] == 99.6
    assert verdict.evidence["budget_s"] == 5.0
    with knobs.override_async_visible_budget_seconds(0.0):
        assert names.RULE_ASYNC_VISIBLE_STALL not in _rules_for([regressed])
    with knobs.override_async_visible_budget_seconds(0.01):
        assert names.RULE_ASYNC_VISIBLE_STALL in _rules_for([healthy])


def test_async_visible_stall_end_to_end(tmp_path):
    """Over real recorded async takes of the port: the device-snapshot
    default stays under the budget; with staging back in the visible
    span and a budget below any real visible time the rule fires."""
    state = {"p": StateDict(w=torch.ones(256, 64))}
    with knobs.enable_telemetry():
        Snapshot.async_take(str(tmp_path / "ok"), state).wait()
    assert names.RULE_ASYNC_VISIBLE_STALL not in {v.rule for v in doctor.diagnose_snapshot(str(tmp_path / "ok"))}
    with knobs.enable_telemetry(), knobs.disable_async_device_snapshot(), (
        knobs.override_async_visible_budget_seconds(1e-9)
    ):
        Snapshot.async_take(str(tmp_path / "bad"), state).wait()
        fired = _rule(doctor.diagnose_snapshot(str(tmp_path / "bad")), names.RULE_ASYNC_VISIBLE_STALL)
    assert fired and fired[0].evidence["visible_s"] > 0


def test_mirror_lagging_and_retry_storm_thresholds():
    lagging = _report(mirror={"upload_lag_s": 120.0, "snapshots_pending": 1}, phases={"staging": 1.5, "writing": 3.0})
    assert names.RULE_MIRROR_LAGGING in _rules_for([lagging])
    storm = _report(retries={"attempts": 5.0, "backoff_s": 2.0, "exhausted": 0.0}, phases={"staging": 1.5, "writing": 3.0})
    assert names.RULE_RETRY_STORM in _rules_for([storm])
    quiet = _report(
        mirror={"upload_lag_s": 0.5, "snapshots_pending": 1}, retries={"attempts": 1.0},
        phases={"staging": 1.5, "writing": 3.0},
    )
    assert _rules_for([quiet]) == set()


def test_restore_read_amplified_rule():
    amplified = _report(kind="restore", phases={"loading": 1.0}, bytes_needed=100 * 1024**2, bytes_fetched=200 * 1024**2)
    verdicts = _rule(_both("diagnose_reports", [amplified]), names.RULE_RESTORE_READ_AMPLIFIED)
    assert verdicts
    ev = verdicts[0].evidence
    assert ev["amplification"] == 2.0
    assert ev["bytes_fetched"] == 200 * 1024**2
    assert ev["bytes_needed"] == 100 * 1024**2
    assert ev["threshold_factor"] == doctor.READ_AMPLIFIED_FACTOR
    healthy = _report(kind="restore", phases={"loading": 1.0}, bytes_needed=100 * 1024**2, bytes_fetched=110 * 1024**2)
    assert names.RULE_RESTORE_READ_AMPLIFIED not in _rules_for([healthy])
    assert names.RULE_RESTORE_READ_AMPLIFIED not in _rules_for([dict(amplified, kind="take")])
    assert names.RULE_RESTORE_READ_AMPLIFIED not in _rules_for([dict(amplified, bytes_received=1024)])
    assert names.RULE_RESTORE_READ_AMPLIFIED not in _rules_for([_report(kind="restore", phases={"loading": 1.0})])


def test_restore_read_amplified_falls_back_to_plugin_counters():
    report = _report(
        kind="async_restore", phases={"loading": 1.0}, bytes_needed=10 * 1024**2,
        plugins={"fs": {"read_bytes": 40 * 1024**2, "read_ops": 12}},
    )
    verdicts = _rule(_both("diagnose_reports", [report]), names.RULE_RESTORE_READ_AMPLIFIED)
    assert verdicts
    assert verdicts[0].evidence["fetched_from"] == "plugin-counters"
    assert verdicts[0].evidence["amplification"] == 4.0


def test_restore_read_amplified_cli_end_to_end(tmp_path, capsys):
    snap = str(tmp_path / "snap")
    with knobs.enable_telemetry():
        Snapshot.take(snap, _state(n=2, size=256))
        Snapshot(snap).restore(_state(n=2, size=256, seed=1))
    stats_main(["doctor", snap, "--json"])
    assert names.RULE_RESTORE_READ_AMPLIFIED not in capsys.readouterr().out
    with open(os.path.join(snap, ".telemetry.jsonl"), "a", encoding="utf-8") as f:
        f.write(json.dumps(_report(
            kind="restore", path=snap, phases={"loading": 2.0}, bytes_needed=1024**2, bytes_fetched=4 * 1024**2,
        )) + "\n")
    rc = stats_main(["doctor", snap])
    out = capsys.readouterr().out
    assert rc == 2
    assert names.RULE_RESTORE_READ_AMPLIFIED in out
    assert "amplification=4.0" in out


def test_restore_cold_start_slow_rule():
    cold = _report(
        kind="restore", phases={"loading": 2.0}, cold_start_s=8.0,
        cold_start={"event_loop_s": 1.0, "plugin_open_s": 2.5, "native_load_s": 4.5},
    )
    verdicts = _rule(_both("diagnose_reports", [cold]), names.RULE_RESTORE_COLD_START_SLOW)
    assert verdicts
    ev = verdicts[0].evidence
    assert ev["wall_s"] == 10.0
    assert ev["cold_fraction"] == 0.8
    assert ev["budget_fraction"] == 0.5
    assert ev["plugin_open_s"] == 2.5
    assert ev["native_load_s"] == 4.5
    assert names.RULE_RESTORE_COLD_START_SLOW not in _rules_for(
        [_report(kind="restore", phases={"loading": 0.1}, cold_start_s=0.4)]
    )
    assert names.RULE_RESTORE_COLD_START_SLOW not in _rules_for(
        [_report(kind="restore", phases={"loading": 9.0}, cold_start_s=2.0)]
    )
    assert names.RULE_RESTORE_COLD_START_SLOW not in _rules_for([dict(cold, kind="take")])
    with knobs.override_cold_start_budget_fraction(0):
        assert names.RULE_RESTORE_COLD_START_SLOW not in _rules_for([cold])


# ---------------------------------------------------------------------------
# Real recorded artifacts
# ---------------------------------------------------------------------------


def test_doctor_cli_on_synthetic_slow_storage_take(tmp_path, monkeypatch, capsys):
    """Storage latency injected into the port's fs plugin: the CLI names
    storage-tier-slow with the phase evidence that triggered it."""
    orig = FSStoragePlugin.write

    async def slow_write(self, write_io):
        await asyncio.sleep(0.3)
        await orig(self, write_io)

    async def decline_fused(self, write_io):
        return None

    monkeypatch.setattr(FSStoragePlugin, "write", slow_write)
    monkeypatch.setattr(FSStoragePlugin, "write_with_checksum", decline_fused)
    snap = str(tmp_path / "snap")
    with knobs.enable_telemetry():
        Snapshot.take(snap, _state(n=3, size=256))
    rc = stats_main(["doctor", snap])
    out = capsys.readouterr().out
    assert rc == 2
    assert names.RULE_STORAGE_TIER_SLOW in out
    assert "write_drain_s=" in out
    slow = _rule(doctor.diagnose_snapshot(snap), names.RULE_STORAGE_TIER_SLOW)
    assert slow
    ev = slow[0].evidence
    assert ev["write_drain_s"] > ev["staging_s"]
    assert ev["wall_s"] >= ev["write_drain_s"]


def _heartbeat(**over):
    doc = {
        "kind": "take", "rank": 0, "phase": "writing", "written_bytes": 1024, "planned_bytes": 4096,
        "items_done": 1, "planned_items": 4, "terminal": None,
    }
    doc.update(over)
    return doc


def test_doctor_flags_interrupted_take_from_leftover_heartbeat(tmp_path):
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / ".progress-rank0.json").write_text(json.dumps(_heartbeat()))
    verdicts = doctor.diagnose_snapshot(str(snap))
    interrupted = _rule(verdicts, names.RULE_INTERRUPTED_TAKE)
    assert len(interrupted) == 1
    assert interrupted[0].severity == "critical"
    assert interrupted[0].evidence["written_bytes"] == 1024
    assert interrupted[0].evidence["planned_bytes"] == 4096
    assert verdicts[0].rule == names.RULE_INTERRUPTED_TAKE
    assert [v.to_dict() for v in verdicts] == [v.to_dict() for v in jdoctor.diagnose_snapshot(str(snap))]


def test_doctor_spares_fresh_heartbeat_of_live_op(tmp_path):
    snap = tmp_path / "snap"
    snap.mkdir()
    doc = _heartbeat(interval_s=1.0, updated_unix_ts=time.time())
    (snap / ".progress-rank0.json").write_text(json.dumps(doc))
    assert _rule(doctor.diagnose_snapshot(str(snap)), names.RULE_INTERRUPTED_TAKE) == []
    doc["updated_unix_ts"] = time.time() - 3600
    (snap / ".progress-rank0.json").write_text(json.dumps(doc))
    assert _rule(doctor.diagnose_snapshot(str(snap)), names.RULE_INTERRUPTED_TAKE)


def test_fsck_stats_lists_progress_leftovers(tmp_path, capsys):
    from torchsnapshot_tpu_torch.fsck import main as fsck_main

    snap = str(tmp_path / "snap")
    Snapshot.take(snap, _state(n=2, size=128))
    with open(os.path.join(snap, ".progress-rank0.json"), "w", encoding="utf-8") as f:
        json.dump(_heartbeat(written_bytes=10, planned_bytes=100, items_done=0, planned_items=2), f)
    rc = fsck_main([snap, "--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "progress heartbeats" in out
    assert "NOT TERMINAL" in out
    assert names.RULE_INTERRUPTED_TAKE in out


# ---------------------------------------------------------------------------
# tuner-thrashing
# ---------------------------------------------------------------------------


def _tuner_decisions(values, tunable="io_concurrency", action="adjust"):
    return [
        {"step": i, "decision": {"action": action, "tunable": tunable}, "vector": {tunable: v, "staging_threads": 4}}
        for i, v in enumerate(values)
    ]


def _thrash(decisions, **fields):
    return _rule(_both_evidence(path="x", tuner_state={"decisions": decisions}, **fields), names.RULE_TUNER_THRASHING)


def test_tuner_thrashing_rule_flags_a_b_a_cycles():
    verdicts = _thrash(_tuner_decisions([16, 32, 16, 32]), tuner_state_file="/r/.tuner-state.json")
    assert len(verdicts) == 1
    ev = verdicts[0].evidence
    assert ev["tunable"] == "io_concurrency"
    assert ev["values"] == [16, 32, 16]
    assert ev["steps"] == [0, 1, 2]
    assert verdicts[0].source == ".tuner-state.json"
    assert _thrash(_tuner_decisions([16, 32, 64, 64])) == []
    one_revert = _tuner_decisions([16, 32]) + [
        {"step": 2, "decision": {"action": "revert", "tunable": "io_concurrency"},
         "vector": {"io_concurrency": 16, "staging_threads": 4}},
    ]
    assert _thrash(list(one_revert)) == []
    repeated = list(one_revert) + [
        {"step": 3, "decision": {"action": "adjust", "tunable": "io_concurrency"},
         "vector": {"io_concurrency": 32, "staging_threads": 4}},
        {"step": 4, "decision": {"action": "revert", "tunable": "io_concurrency"},
         "vector": {"io_concurrency": 16, "staging_threads": 4}},
    ]
    rep = _thrash(repeated)
    assert rep and rep[0].evidence["cycles_in_window"] >= 2
    assert _thrash(_tuner_decisions([16, 32])) == []
    assert _thrash(_tuner_decisions([16, 32, 16] + [64] * doctor.TUNER_THRASH_WINDOW)) == []


def test_tuner_thrashing_end_to_end_injection(tmp_path, capsys):
    root = tmp_path / "ckpt"
    CheckpointManager(str(root)).save(0, _state(n=2, size=128))
    snap = os.path.join(str(root), "step_0000000000")
    (root / ".tuner-state.json").write_text(json.dumps({"decisions": _tuner_decisions([16, 32, 64, 64])}))
    assert names.RULE_TUNER_THRASHING not in {v.rule for v in doctor.diagnose_snapshot(snap)}
    (root / ".tuner-state.json").write_text(json.dumps({"decisions": _tuner_decisions([16, 32, 16, 32, 16])}))
    rc = stats_main(["doctor", snap])
    out = capsys.readouterr().out
    assert rc == 2
    assert names.RULE_TUNER_THRASHING in out
    assert "io_concurrency" in out
    verdicts = _rule(doctor.diagnose_snapshot(snap), names.RULE_TUNER_THRASHING)
    assert verdicts and verdicts[0].evidence["values"][:2] == [16, 32]


# ---------------------------------------------------------------------------
# Bench-trial epistemics
# ---------------------------------------------------------------------------


def test_diagnose_take_trial_matches_bench_semantics():
    verdicts = _both("diagnose_take_trial", 10.0, 1.0, 1.0, 1.1, {"staging": 9.5, "writing": 10.0})
    assert [v.rule for v in verdicts] == [names.RULE_IN_TAKE_STALL]
    ev = verdicts[0].evidence
    assert ev["ratio"] < doctor.STALL_EFFICIENCY_RATIO
    assert ev["staging_done_s"] == 9.5
    assert [v.rule for v in _both("diagnose_take_trial", 1.0, 1.0, 0.4, 1.0)] == [names.RULE_LINK_UNSTABLE]
    assert _both("diagnose_take_trial", 1.0, 1.0, 1.0, 1.05) == []


def test_probes_unstable_series():
    for probes, unstable in (([1.0, 1.2, 1.1], False), ([1.0, 2.0, 1.9], True), ([], False)):
        assert doctor.probes_unstable(probes) is unstable is jdoctor.probes_unstable(probes)


@pytest.mark.parametrize("take_s, probes", [(10.0, (1.0, 1.1)), (2.0, (1.0, 1.05)), (3.0, (0.5, 1.2))])
def test_bench_diagnostics_embed_doctor_verdicts(take_s, probes):
    """The JAX case holds bench.py's trial ratios against the doctor's;
    the port has no bench, so the port's trial diagnosis is held against
    the JAX doctor's on the same brackets, ratios and verdict ids."""
    ours = _both("diagnose_take_trial", take_s, 1.0, *probes)
    bracket = max(probes)
    for v in ours:
        if v.rule == names.RULE_IN_TAKE_STALL:
            assert v.evidence["ratio"] == pytest.approx((1.0 / take_s) / bracket, rel=1e-2)


# ---------------------------------------------------------------------------
# History + trend
# ---------------------------------------------------------------------------


def _summary(step, take_s, mb_s=100.0, wait=0.01):
    return {
        "step": step, "kind": "take", "path": f"/snaps/step_{step:010d}", "unix_ts": 0.0, "take_s": take_s,
        "phases": {"staging": take_s * 0.4, "writing": take_s}, "bytes_moved": 1024, "blobs": 4, "mb_s": mb_s,
        "budget_wait_s": wait,
    }


def test_trend_flags_exactly_the_injected_regression():
    records = [_summary(0, 1.0), _summary(1, 1.05), _summary(2, 0.95), _summary(3, 3.2), _summary(4, 1.0)]
    verdicts = _both("diagnose_trend", records)
    assert {v.evidence["step"] for v in verdicts} == {3}
    assert all(v.rule == names.RULE_TREND_REGRESSION for v in verdicts)
    take_rows = [v for v in verdicts if v.evidence["metric"] == "take_s"]
    assert take_rows and take_rows[0].evidence["value"] == 3.2


def test_trend_quiet_on_flat_history():
    assert _both("diagnose_trend", [_summary(i, 1.0 + 0.01 * (i % 3)) for i in range(10)]) == []


def test_manager_saves_append_bounded_history(tmp_path):
    root = str(tmp_path / "ckpts")
    state = _state(n=2, size=256)
    with knobs.override_history_max_records(3), knobs.enable_telemetry():
        mgr = CheckpointManager(root)
        for step in range(5):
            mgr.save(step, state)
    records = history.load_history(history.history_path_for(root))
    assert [r["step"] for r in records] == [2, 3, 4]
    assert all(r["kind"] == "take" for r in records)
    assert all(r["take_s"] >= 0 for r in records)
    # Every row carries its take's critical path.
    assert all(r["critpath"]["coverage"] >= 0.95 for r in records)


def test_async_save_records_history_too(tmp_path):
    root = str(tmp_path / "ckpts")
    with knobs.override_history_max_records(10), knobs.enable_telemetry():
        CheckpointManager(root).async_save(0, _state(n=2, size=256)).wait()
    records = history.load_history(history.history_path_for(root))
    assert [r["step"] for r in records] == [0]
    assert records[0]["kind"] == "async_take"


def test_history_disabled_by_default_in_suite(tmp_path):
    root = str(tmp_path / "ckpts")
    CheckpointManager(root).save(0, _state(n=1, size=64))
    assert not os.path.exists(os.path.join(root, ".telemetry-history.jsonl"))


def test_doctor_trend_cli_over_manager_history(tmp_path, capsys):
    root = tmp_path / "ckpts"
    root.mkdir()
    records = [_summary(i, 1.0) for i in range(4)] + [_summary(4, 5.0)]
    with open(root / ".telemetry-history.jsonl", "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    rc = stats_main(["doctor", "--trend", str(root)])
    out = capsys.readouterr().out
    assert rc == 2
    assert "step 4" in out
    assert names.RULE_TREND_REGRESSION in out
    rc = stats_main(["trend", str(root), "--json"])
    rows = json.loads(capsys.readouterr().out)
    assert rc == 2
    assert {r["evidence"]["step"] for r in rows} == {4}


def test_trend_end_to_end_over_real_manager_steps(tmp_path, monkeypatch, capsys):
    orig = FSStoragePlugin.write
    current = {"step": None}

    async def maybe_slow(self, write_io):
        if current["step"] == 2:
            await asyncio.sleep(0.25)
        await orig(self, write_io)

    async def decline_fused(self, write_io):
        return None

    monkeypatch.setattr(FSStoragePlugin, "write", maybe_slow)
    monkeypatch.setattr(FSStoragePlugin, "write_with_checksum", decline_fused)
    root = str(tmp_path / "ckpts")
    state = _state(n=2, size=256)
    with knobs.override_history_max_records(10), knobs.enable_telemetry():
        mgr = CheckpointManager(root)
        for step in range(4):
            current["step"] = step
            mgr.save(step, state)
    rc = stats_main(["doctor", "--trend", root])
    out = capsys.readouterr().out
    assert rc == 2, out
    records = history.load_history(history.history_path_for(root))
    assert {v.evidence["step"] for v in _both("diagnose_trend", records)} == {2}


def test_doctor_trend_cli_without_history(tmp_path, capsys):
    rc = stats_main(["doctor", "--trend", str(tmp_path)])
    assert rc == 1
    assert "no step history" in capsys.readouterr().out


def test_history_append_is_bounded_and_atomic(tmp_path):
    with knobs.override_history_max_records(2):
        for i in range(4):
            history.append_summary(str(tmp_path), _summary(i, 1.0))
    path = history.history_path_for(str(tmp_path))
    assert [r["step"] for r in history.load_history(path)] == [2, 3]
    with open(path, "a", encoding="utf-8") as f:
        f.write("{torn\n")
    assert len(history.load_history(path)) == 2


# ---------------------------------------------------------------------------
# Ledger rules: dedup-ineffective, cdn-staleness-high, run-level cost
# ---------------------------------------------------------------------------


def _step_record(step, total, reused, unchanged, covered, cas=True):
    return {
        "event": names.EVENT_STEP_COMMITTED, "step": step, "cas": cas, "bytes_total": total,
        "bytes_new": total - reused, "bytes_reused": reused, "bytes_digest_unchanged": unchanged,
        "bytes_digest_covered": covered,
    }


def test_dedup_ineffective_rule_fires_and_stays_quiet():
    """Ports ``tests/test_cas.py::test_dedup_ineffective_rule_fires_and_
    stays_quiet``."""

    def verdicts(records):
        return _rule(
            _both_evidence(path="/r", ledger_records=records, ledger_file="/r/.ledger.jsonl"),
            names.RULE_DEDUP_INEFFECTIVE,
        )

    out = verdicts([_step_record(i, 1000, 0, 900, 1000) for i in range(4)])
    assert len(out) == 1
    assert out[0].evidence["reuse_fraction"] == 0.0
    assert out[0].evidence["digest_unchanged_fraction"] == 0.9
    assert verdicts([_step_record(i, 1000, 900, 900, 1000) for i in range(4)]) == []
    assert verdicts([_step_record(i, 1000, 0, 50, 1000) for i in range(4)]) == []
    assert verdicts([_step_record(i, 1000, 0, 0, 0) for i in range(4)]) == []
    assert verdicts([_step_record(0, 1000, 0, 900, 1000)]) == []
    assert verdicts([_step_record(i, 1000, 0, 900, 1000, cas=False) for i in range(4)]) == []


def _swap_record(staleness, seq=1, sub=0):
    return {
        "event": names.EVENT_CDN_SWAPPED, "topic": "t", "seq": seq, "step": seq, "subscriber": sub,
        "staleness_s": staleness,
    }


@pytest.mark.parametrize(
    "budget, records, fires",
    [
        ("1.0", [{"event": names.EVENT_CDN_PUBLISHED, "seq": 1}] + [_swap_record(5.0, sub=i) for i in range(6)], True),
        ("1.0", [_swap_record(0.2, sub=i) for i in range(6)], False),
        ("1.0", [_swap_record(9.0, sub=i) for i in range(4)], False),
        ("0", [_swap_record(9.0, sub=i) for i in range(8)], False),
    ],
    ids=["fires_over_budget", "quiet_within_budget", "needs_min_samples", "disabled_by_zero_budget"],
)
def test_staleness_rule(monkeypatch, budget, records, fires):
    """Ports the four synthetic staleness-rule cases of
    ``tests/test_cdn_storm.py``: over the budget with enough swaps the
    rule fires and cites the median; within it, under five samples, or
    with the budget at 0 it stays quiet."""
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS", budget)
    verdicts = _rule(
        _both_evidence(path="x", ledger_records=records, ledger_file="/run/.ledger.jsonl"),
        names.RULE_CDN_STALENESS_HIGH,
    )
    assert len(verdicts) == int(fires)
    if fires:
        ev = verdicts[0].evidence
        assert ev["median_staleness_s"] == 5.0
        assert ev["budget_s"] == 1.0
        assert ev["swaps_observed"] == 6
        assert ev["publishes_observed"] == 1
        assert verdicts[0].source == ".ledger.jsonl"


def test_staleness_rule_end_to_end_through_a_real_ledger(tmp_path, monkeypatch):
    root = str(tmp_path)
    with knobs.enable_ledger():
        ledger.open_run(root)
        for i in range(6):
            ledger.post_event(
                root, names.EVENT_CDN_SWAPPED, topic="t", seq=1, step=1, subscriber=i, staleness_s=9.5
            )
        monkeypatch.setenv("TORCHSNAPSHOT_TPU_CDN_STALENESS_BUDGET_SECONDS", "1.0")
        verdicts = _rule(doctor.diagnose_evidence(doctor.gather_evidence(root)), names.RULE_CDN_STALENESS_HIGH)
    assert len(verdicts) == 1
    assert verdicts[0].evidence["median_staleness_s"] == 9.5


def test_doctor_trend_appends_run_level_verdicts(tmp_path, capsys):
    """Ports ``tests/test_goodput.py::test_doctor_trend_appends_run_level_
    verdicts``: ``doctor --trend`` on a root with an expensive
    interruption speaks run-level cost alongside the per-step rows."""
    root = str(tmp_path / "ckpts")
    t0 = 1_600_000_000.0
    with knobs.enable_ledger(), knobs.override_history_max_records(16):
        mgr = CheckpointManager(root)
        for step in range(3):
            mgr.save(step, _state(n=2, size=256, seed=step))
        for event, fields in (
            (names.EVENT_RUN_START, dict(run_id="history00run", segment=1, world_size=1, unix_ts=t0)),
            (names.EVENT_STEP_COMMITTED, dict(step=0, bytes_new=1, bytes_reused=0, bytes_total=1, blobs=1,
                                              unix_ts=t0 + 10.0)),
            (names.EVENT_PREEMPTION, dict(step=4, target_step=5, unix_ts=t0 + 200.0)),
            (names.EVENT_RUN_START, dict(run_id="history00run", segment=2, world_size=1, unix_ts=t0 + 230.0)),
            (names.EVENT_RESTORE_SERVED, dict(step=0, kind="restore", restore_s=40.0, nbytes=1,
                                              unix_ts=t0 + 270.0)),
        ):
            ledger.post_event(root, event, **fields)
        rc = doctor.main(["--trend", root])
    assert rc == 2
    assert names.RULE_RECOVERY_COST_HIGH in capsys.readouterr().out


def test_fsck_stats_summarizes_ledger(tmp_path, capsys):
    """Ports ``tests/test_goodput.py::test_fsck_stats_summarizes_ledger``
    on the port's interrupted run."""
    from test_torch_goodput import _interrupted_run
    from torchsnapshot_tpu_torch.fsck import main as fsck_main

    root = str(tmp_path / "ckpts")
    with knobs.enable_ledger():
        _interrupted_run(root)
        rc = fsck_main([f"{root}/step_0000000002", "--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "run ledger" in out
    assert "run-start=2" in out
    assert "preempted at step 3" in out
    assert "interrupted" in out


# ---------------------------------------------------------------------------
# The fleet rules over a live coordination store
# ---------------------------------------------------------------------------


def _fleet_diagnose(store, capsys):
    entries = wire.collect_fleet(store)
    assert [e["id"] for e in entries] == ["7"]
    assert doctor.diagnose_fleet(entries) == []
    assert doctor.diagnose_fleet([]) == []
    return 0


def _fleet_doctor_cli(store, capsys):
    rc = doctor.main(["--fleet", f"127.0.0.1:{store.port}"])
    assert "doctor fleet" in capsys.readouterr().out
    return rc


def _fleet_table_cli(store, capsys):
    rc = stats_main(["fleet", f"127.0.0.1:{store.port}", "--once"])
    out = capsys.readouterr().out
    assert "ROLE" in out and "trainer" in out
    return rc


@pytest.mark.parametrize(
    "call",
    [_fleet_diagnose, _fleet_doctor_cli, _fleet_table_cli],
    ids=["diagnose_fleet", "doctor-fleet", "telemetry-fleet"],
)
def test_fleet_diagnosis_is_refused(call, capsys):
    """Once refused by name, now run: ``diagnose_fleet``, ``doctor
    --fleet`` and ``telemetry fleet`` read one live publisher's snapshot
    off a coordination store served in this process, and a healthy
    fleet gives no verdict."""
    telemetry.reset_metrics()
    wire.reset_recent_dials()
    store = TCPStore("127.0.0.1", 0, is_server=True)
    reporter = wire.FleetReporter(store, "trainer", 7, interval_s=0)
    try:
        assert reporter.publish(phase="write", force=True)
        assert call(store, capsys) == 0
    finally:
        reporter.close()
        store.close()
        telemetry.reset_metrics()
        wire.reset_recent_dials()
