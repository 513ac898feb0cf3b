"""The port's per-operation reports and their sinks: the JSONL event log
beside the snapshot or in a telemetry dir, the restore's byte fields and
cold start, the async take's phases, the budget-wait instrumentation, the
tiered mirror's report, Prometheus exposition, the cross-rank aggregation
(in one function and across two spawned ranks), and GC of the event log.

Ports of the report, sink and Prometheus cases of the JAX package's
``tests/test_telemetry.py`` (each docstring names the case it ports), on
torch state; the stats-CLI and RSS-profiler cases are in
``tests/test_torch_doctor.py`` and ``tests/test_torch_rss_profiler.py``.
This file imports no ``jax``: the cross-package reads are in
``tests/test_torch_telemetry_crosspkg.py``.
"""

import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import CheckpointManager, Snapshot, StateDict, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.scheduler import last_phase_timings, reset_phase_timings
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry.sink import events_path_for, local_fs_root

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_registry():
    telemetry.reset_metrics()
    yield
    telemetry.reset_metrics()


def _state(n=3, size=512, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)}


def _events(path):
    return telemetry.load_events(os.path.join(path, ".telemetry.jsonl"))


def test_phase_timings_and_reports_do_not_leak_across_takes(tmp_path):
    """Ports ``test_phase_timings_shim_and_reports_do_not_leak_across_
    takes``: a phase recorded between takes shows on the global channel
    but never in the next take's report."""
    state = {"m": TensorTreeState(_state())}
    with knobs.enable_telemetry():
        Snapshot.take(str(tmp_path / "take1"), state)
        assert set(last_phase_timings()) == {"staging", "writing"}
        telemetry.record_phase("mirroring", 1.23)
        Snapshot.take(str(tmp_path / "take2"), state)
        assert "mirroring" in last_phase_timings()
        events = _events(str(tmp_path / "take2"))
        assert len(events) == 1
        assert set(events[0]["phases"]) == {"staging", "writing"}
        reset_phase_timings()
        assert last_phase_timings() == {}
        Snapshot.take(str(tmp_path / "take3"), state)
        assert set(last_phase_timings()) == {"staging", "writing"}


def test_take_report_via_jsonl_sink(tmp_path):
    """Ports the report half of ``test_take_report_via_jsonl_sink_and_
    stats_cli``: phases, per-plugin bytes, the zero-filled retry counter,
    bytes moved and peak staged bytes, and the take's critical path,
    whose segments partition its wall."""
    path = str(tmp_path / "step_0000000001")
    with knobs.enable_telemetry():
        Snapshot.take(path, {"m": TensorTreeState(_state(size=4096))})
    events = _events(path)
    assert len(events) == 1
    report = events[0]
    assert report["kind"] == "take"
    assert report["phases"]["staging"] >= 0.0
    assert report["phases"]["writing"] >= report["phases"]["staging"]
    assert report["plugins"]["fs"]["write_bytes"] > 0
    assert report["plugins"]["fs"]["write_ops"] >= 3
    assert report["retries"]["attempts"] == 0
    assert report["bytes_moved"] == 3 * 4096 * 4
    assert report["peak_staged_bytes"] > 0
    assert report["tunables"] == knobs.tunable_snapshot()
    cp = report["critical_path"]
    assert cp["coverage"] >= 0.95 and cp["dominant"] in cp["segments"]
    assert sum(cp["segments"].values()) == pytest.approx(cp["wall_s"], abs=1e-5)
    assert report["wire"] is None


def test_restore_report_emitted(tmp_path):
    """Ports ``test_restore_report_emitted``, with the port's restore byte
    fields: needed = fetched = moved on a plain one-process restore."""
    path = str(tmp_path / "snap")
    state = _state()
    with knobs.enable_telemetry():
        Snapshot.take(path, {"m": TensorTreeState(dict(state))})
        dst = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in state.items()})}
        Snapshot(path).restore(dst)
    events = _events(path)
    assert [e["kind"] for e in events] == ["take", "restore"]
    restore = events[1]
    assert "loading" in restore["phases"]
    assert restore["plugins"]["fs"]["read_bytes"] > 0
    assert restore["bytes_moved"] > 0
    assert restore["bytes_needed"] == restore["bytes_fetched"] == restore["bytes_moved"]
    assert restore["bytes_received"] == 0
    assert restore["cold_start_s"] >= 0.0
    assert set(restore["cold_start"]) == {"event_loop_s", "plugin_open_s", "native_load_s"}
    assert restore["cold_start_s"] == round(sum(restore["cold_start"].values()), 6)
    assert events[0].get("cold_start_s") is None


def test_async_take_report_emitted(tmp_path):
    """Ports ``test_async_take_report_emitted``, with the visible / staged
    split an async take's report carries."""
    path = str(tmp_path / "snap")
    with knobs.enable_telemetry():
        Snapshot.async_take(path, {"m": TensorTreeState(_state())}).wait()
    events = _events(path)
    assert [e["kind"] for e in events] == ["async_take"]
    assert set(events[0]["phases"]) == {"staging", "writing"}
    assert 0.0 <= events[0]["visible_s"] <= events[0]["staged_s"]
    assert events[0]["staging_pool"]["slabs"] == knobs.get_staging_pool_slabs()


def test_async_restore_report_emitted(tmp_path):
    """The async restore's report lands at ``wait()``, rank-local, with the
    byte fields of the sync one."""
    path = str(tmp_path / "snap")
    state = _state()
    Snapshot.take(path, {"m": TensorTreeState(dict(state))})
    dst = {"m": TensorTreeState({k: torch.zeros_like(v) for k, v in state.items()})}
    with knobs.enable_telemetry():
        Snapshot(path).async_restore(dst).wait()
    (report,) = _events(path)
    assert report["kind"] == "async_restore"
    assert report["bytes_needed"] == report["bytes_fetched"] == report["bytes_moved"] > 0


def test_telemetry_dir_knob_takes_precedence(tmp_path):
    """Ports ``test_telemetry_dir_knob_takes_precedence``."""
    snap = str(tmp_path / "snap")
    tdir = str(tmp_path / "telemetry")
    with knobs.override_telemetry_dir(tdir):
        Snapshot.take(snap, {"m": TensorTreeState(_state())})
    assert not os.path.exists(os.path.join(snap, ".telemetry.jsonl"))
    events = telemetry.load_events(os.path.join(tdir, "events.jsonl"))
    assert len(events) == 1 and events[0]["path"] == snap


def test_sink_disabled_writes_nothing(tmp_path):
    """Ports ``test_sink_disabled_writes_nothing``: the registry records
    whether or not a sink writes."""
    snap = str(tmp_path / "snap")
    Snapshot.take(snap, {"m": TensorTreeState(_state())})
    assert not os.path.exists(os.path.join(snap, ".telemetry.jsonl"))
    counters = telemetry.metrics().counters_snapshot()
    assert counters['storage_write_bytes_total{plugin="fs"}'] > 0
    assert counters['snapshot_reports_total{kind="take"}'] == 1


def test_events_path_resolution():
    """Ports ``test_events_path_resolution``."""
    assert local_fs_root("/plain/dir") == "/plain/dir"
    assert local_fs_root("fs:///plain/dir") == "/plain/dir"
    assert local_fs_root("tiered:///fast|gs://bucket/x") == "/fast"
    assert local_fs_root("gs://bucket/x") is None
    assert local_fs_root("memory://name") is None
    assert events_path_for("/plain/dir") is None
    with knobs.enable_telemetry():
        assert events_path_for("/plain/dir") == "/plain/dir/.telemetry.jsonl"
        assert events_path_for("gs://bucket/x") is None
    with knobs.override_telemetry_dir("/tmp/t"):
        assert events_path_for("gs://bucket/x") == "/tmp/t/events.jsonl"


def test_report_records_budget_wait_under_tight_budget(tmp_path):
    """Ports ``test_report_records_budget_wait_under_tight_budget``."""
    path = str(tmp_path / "snap")
    with knobs.enable_telemetry(), knobs.override_per_rank_memory_budget_bytes(2600):
        Snapshot.take(path, {"m": TensorTreeState(_state(n=6, size=512))})
    report = _events(path)[0]
    assert report["budget_wait_s"] > 0.0
    assert 0 < report["peak_staged_bytes"] <= 2600 + 512 * 4


def test_mirror_job_emits_report_and_gauges(tmp_path):
    """Ports ``test_mirror_job_emits_report_and_gauges``: the take's report
    records the backlog it created, and the settled job its own report."""
    from torchsnapshot_tpu_torch.tiered import reset_mirror, wait_durable

    reset_mirror()
    try:
        fast = str(tmp_path / "fast")
        url = f"tiered://{fast}|{tmp_path / 'durable'}"
        with knobs.enable_telemetry():
            Snapshot.take(url, {"m": TensorTreeState(_state())})
            wait_durable(url, timeout=60)
        events = _events(fast)
        kinds = [e["kind"] for e in events]
        assert "take" in kinds and "mirror" in kinds
        take = next(e for e in events if e["kind"] == "take")
        assert take["mirror"] != {}
        mirror = next(e for e in events if e["kind"] == "mirror")
        assert mirror["blobs"] == mirror["mirror"]["blobs_total"]
        assert mirror["bytes_moved"] > 0
        assert mirror["mirror"]["lag_s"] >= 0.0
        assert mirror["error"] is None
        data = telemetry.metrics().collect()
        assert data["counters"][names.MIRROR_JOBS_DONE_TOTAL] == 1
        assert data["counters"][names.MIRROR_BYTES_TOTAL] > 0
        assert data["gauges"][names.MIRROR_SNAPSHOTS_PENDING] == 0
    finally:
        reset_mirror()


def test_prometheus_textfile_written(tmp_path):
    """Ports ``test_prometheus_textfile_written``."""
    prom = str(tmp_path / "metrics.prom")
    with knobs.override_prometheus_textfile(prom):
        Snapshot.take(str(tmp_path / "snap"), {"m": TensorTreeState(_state())})
    text = open(prom).read()
    assert 'storage_write_bytes_total{plugin="fs"}' in text
    assert 'snapshot_reports_total{kind="take"} 1' in text
    assert 'snapshot_phase_seconds_bucket{phase="writing",le="+Inf"}' in text
    assert "snapshot_phase_seconds_count" in text
    assert not [f for f in os.listdir(tmp_path) if f.startswith("metrics.prom.tmp")]


def test_aggregate_across_ranks_finds_straggler():
    """Ports ``test_aggregate_across_ranks_finds_straggler``."""
    ranks = [
        {"phases": {"writing": 1.0}, "bytes_moved": 100, "budget_wait_s": 0.0},
        {"phases": {"writing": 9.0}, "bytes_moved": 100, "budget_wait_s": 0.5},
        {"phases": {"writing": 2.0}, "bytes_moved": 300, "budget_wait_s": 0.1},
    ]
    agg = telemetry.aggregate_across_ranks(ranks)
    assert agg["phase_writing_s"] == {"min": 1.0, "median": 2.0, "max": 9.0, "straggler": 1}
    assert agg["bytes_moved"]["straggler"] == 2
    assert agg["budget_wait_s"]["max"] == 0.5


def _gathered_report_worker(pg, path: str):
    os.environ["TORCHSNAPSHOT_TPU_TELEMETRY"] = "1"
    state = {"s": TensorTreeState(_state(seed=pg.rank)), "r": StateDict(rank=pg.rank)}
    Snapshot.take(path, state, pg=pg)
    Snapshot.async_take(path + "_async", state, pg=pg).wait()
    return True


def test_two_rank_take_reports_are_gathered_on_rank0(tmp_path):
    """Each rank of a two-rank take appends its report, and rank 0's
    carries the gathered spread (a straggler per metric) and the clock
    offsets; the async take's commit thread gathers the same way."""
    from torchsnapshot_tpu_torch.test_utils import run_multiprocess

    path = str(tmp_path / "snap")
    assert all(run_multiprocess(_gathered_report_worker, nproc=2, args=(path,), timeout=120.0))
    for snap, kind in ((path, "take"), (path + "_async", "async_take")):
        by_rank = {e["rank"]: e for e in _events(snap)}
        assert sorted(by_rank) == [0, 1] and by_rank[0]["kind"] == kind
        agg = by_rank[0]["aggregated"]
        assert agg and all(set(v) == {"min", "median", "max", "straggler"} for v in agg.values())
        assert agg["bytes_moved"]["straggler"] in (0, 1)
        assert len(by_rank[0]["clock_offsets_s"]) == 2
        assert by_rank[1]["aggregated"] is None


def test_manager_gc_removes_snapshot_event_log(tmp_path):
    """Ports ``test_manager_gc_removes_snapshot_event_log``."""
    root = str(tmp_path / "ckpts")
    mgr = CheckpointManager(root, keep_last_n=1)
    state = {"m": TensorTreeState(_state())}
    with knobs.enable_telemetry():
        mgr.save(0, state)
        step0 = os.path.join(root, "step_0000000000", ".telemetry.jsonl")
        assert os.path.exists(step0)
        mgr.save(1, state)
    assert not os.path.exists(step0)
    assert os.path.exists(os.path.join(root, "step_0000000001", ".telemetry.jsonl"))


def test_load_events_skips_corrupt_lines(tmp_path):
    """Ports the event-log half of ``test_stats_renderer_handles_empty_
    and_corrupt_lines``: a torn line is skipped, not raised."""
    import json

    log = tmp_path / "events.jsonl"
    log.write_text(json.dumps({"kind": "take", "path": "/x", "phases": {"writing": 1.0}}) + "\n{torn-line\n")
    events = telemetry.load_events(str(log))
    assert len(events) == 1 and events[0]["path"] == "/x"
