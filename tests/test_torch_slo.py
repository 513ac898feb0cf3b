"""The port's SLO engine (``telemetry/slo.py``): burn-window arithmetic,
the sample extractors, edge-triggered breach events with their gauges and
counter, and the CLI's judgment.

Ports of the JAX package's ``tests/test_slo.py``, under the same names,
with the packaged geometry (fast 8 @ 2.0, slow 64 @ 1.0, error budget
0.1). Every judgment of synthetic records is also asked of the JAX
engine, which must give the same objectives list (``_evaluate``).
"""

import pytest

import torchsnapshot_tpu_torch.telemetry as telemetry
from torchsnapshot_tpu.telemetry import slo as jslo
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.telemetry import ledger, names, slo

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _fresh_state():
    telemetry.reset_metrics()
    ledger.reset_owned_roots()
    slo.reset_slo_state()
    yield
    telemetry.reset_metrics()
    ledger.reset_owned_roots()
    slo.reset_slo_state()


def _stall_records(values):
    return [
        {"event": names.EVENT_VISIBLE_STALL, "unix_ts": T0 + i, "step": i, "visible_s": v}
        for i, v in enumerate(values)
    ]


def _evaluate(records, history=()):
    ours = slo.evaluate(records, list(history))
    assert ours == jslo.evaluate(records, list(history))
    return ours


def _entry(results, slo_id):
    return next(o for o in results if o["objective"] == slo_id)


def test_objectives_match_the_jax_catalogue():
    assert [o["objective"] for o in _evaluate([])] == [o["objective"] for o in jslo.evaluate([])]


def test_cliff_fires_the_fast_window():
    entry = _entry(_evaluate(_stall_records([0.1] * 60 + [10.0] * 8)), names.SLO_TAKE_VISIBLE_STALL)
    assert not entry["disabled"]
    assert entry["samples"] == 68
    assert entry["last_value"] == 10.0
    assert entry["fast"]["bad"] == 8
    assert entry["fast"]["burn"] == 10.0
    assert entry["breaching"]
    assert entry["burn_rate"] == 10.0


def test_drift_fires_the_slow_window_only():
    values = [10.0 if i % 7 == 6 else 0.1 for i in range(64)]
    entry = _entry(_evaluate(_stall_records(values)), names.SLO_TAKE_VISIBLE_STALL)
    assert entry["slow"]["bad"] == 9
    assert entry["slow"]["burn"] == pytest.approx(1.4062, abs=1e-3)
    assert entry["fast"]["bad"] == 1
    assert entry["fast"]["burn"] == 1.25
    assert entry["breaching"]
    assert entry["fast"]["burn"] < entry["fast"]["threshold"]
    assert entry["slow"]["burn"] >= entry["slow"]["threshold"]


def test_healthy_run_reports_zero_burn():
    entry = _entry(_evaluate(_stall_records([0.1] * 100)), names.SLO_TAKE_VISIBLE_STALL)
    assert entry["burn_rate"] == 0.0 and not entry["breaching"]
    empty = _entry(_evaluate([]), names.SLO_TAKE_VISIBLE_STALL)
    assert empty["samples"] == 0 and not empty["breaching"]


def test_nonpositive_target_disables_one_objective():
    records = _stall_records([10.0] * 8) + [
        {"event": names.EVENT_RESTORE_SERVED, "unix_ts": T0 + 100, "restore_s": 1e6}
    ]
    with knobs.override_slo_restore_seconds(0):
        results = _evaluate(records)
    restore = _entry(results, names.SLO_RESTORE_WALL)
    assert restore["disabled"] and not restore["breaching"]
    assert restore["fast"] is None and restore["slow"] is None
    assert _entry(results, names.SLO_TAKE_VISIBLE_STALL)["breaching"]


def test_window_knobs_reshape_the_judgment():
    with knobs.override_slo_windows(2, 0):
        entry = _entry(_evaluate(_stall_records([10.0] * 2 + [0.1] * 6)), names.SLO_TAKE_VISIBLE_STALL)
    assert entry["slow"] is None
    assert entry["fast"]["samples"] == 2
    assert entry["fast"]["bad"] == 0
    assert not entry["breaching"]


def test_overhead_samples_reset_at_run_start():
    records = [
        {"event": names.EVENT_RUN_START, "unix_ts": T0},
        {"event": names.EVENT_VISIBLE_STALL, "unix_ts": T0 + 4, "visible_s": 5.0},
        {"event": names.EVENT_STEP_COMMITTED, "unix_ts": T0 + 10, "step": 1},
        {"event": names.EVENT_RUN_START, "unix_ts": T0 + 1000},
        {"event": names.EVENT_STEP_COMMITTED, "unix_ts": T0 + 1010, "step": 2},
    ]
    samples = slo._overhead_samples(records, [])
    assert samples == [(T0 + 10, 0.5), (T0 + 1010, 0.0)] == jslo._overhead_samples(records, [])


def test_coordination_samples_come_from_history():
    history = [
        {"kind": "take", "unix_ts": T0, "take_s": 10.0, "coordination_s": 4.0},
        {"kind": "restore", "unix_ts": T0 + 1, "take_s": 9.0},
        {"kind": "async_take", "unix_ts": T0 + 2, "take_s": 2.0, "coordination_s": 1.0},
    ]
    samples = slo._coordination_samples([], history)
    assert samples == [(T0, 0.4), (T0 + 2, 0.5)] == jslo._coordination_samples([], history)


def _breach_ready_root(tmp_path):
    root = str(tmp_path)
    assert ledger.open_run(root) is not None
    for i in range(8):
        ledger.post_event(
            root, names.EVENT_VISIBLE_STALL, step=i, kind="async_take", visible_s=50.0, unix_ts=T0 + i
        )
    return root


def test_evaluate_step_posts_one_breach_event_per_episode(tmp_path):
    with knobs.enable_ledger(), knobs.enable_slo():
        root = _breach_ready_root(tmp_path)
        assert names.SLO_TAKE_VISIBLE_STALL in slo.evaluate_step(root, step=8)["breaching"]
        ledger.post_event(
            root, names.EVENT_VISIBLE_STALL, step=8, kind="async_take", visible_s=50.0, unix_ts=T0 + 8
        )
        assert names.SLO_TAKE_VISIBLE_STALL in slo.evaluate_step(root, step=9)["breaching"]
        breaches = [
            r for r in ledger.load_ledger(ledger.ledger_path_for(root)) if r.get("event") == names.EVENT_SLO_BREACH
        ]
    assert len(breaches) == 1
    assert breaches[0]["objective"] == names.SLO_TAKE_VISIBLE_STALL
    assert breaches[0]["step"] == 8
    assert breaches[0]["fast_burn"] == 10.0
    assert breaches[0]["last_value"] == 50.0


def test_evaluate_step_exports_burn_gauges_and_counter(tmp_path):
    with knobs.enable_ledger(), knobs.enable_slo():
        slo.evaluate_step(_breach_ready_root(tmp_path), step=8)
    collected = telemetry.metrics().collect()
    labels = {"objective": names.SLO_TAKE_VISIBLE_STALL}
    assert collected["gauges"][telemetry.series_key(names.OBJECTIVE_BURN_RATE, labels)] == 10.0
    assert collected["counters"][telemetry.series_key(names.OBJECTIVE_BREACHES_TOTAL, labels)] == 1.0


def test_slo_cli_exit_codes(tmp_path, capsys):
    with knobs.enable_ledger(), knobs.enable_slo():
        root = _breach_ready_root(tmp_path)
        assert slo.main([root]) == 2
        out = capsys.readouterr().out
        assert "BURNING" in out and names.SLO_TAKE_VISIBLE_STALL in out
    assert slo.main([str(tmp_path / "nowhere")]) == 1
