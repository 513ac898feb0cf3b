"""The port's critical-path engine and differential analysis
(``telemetry/critpath.py``): sweep-line attribution over synthetic
recorder windows, the coverage bar on the port's real takes and restores
(one process, two spawned ranks with the cross-rank fold, and the
peer-served restore), the stitched-wire descent over a merged Chrome doc,
the diff CLI, the bench-record differential, and the trend integrations.

Ports of the JAX package's ``tests/test_critpath.py``, under the same
names, on torch state. The JAX two-process case is marked slow there; its
port here runs in the suite. This file imports no ``jax`` (its spawned
worker re-imports it): the cases that feed one recorder window to both
packages are in ``tests/test_torch_diagnosis_crosspkg.py``.
"""

import asyncio
import json
import os
import re
from pathlib import Path

import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import critpath, names
from torchsnapshot_tpu_torch.telemetry.doctor import diagnose_trend, registered_rule_ids
from torchsnapshot_tpu_torch.telemetry.history import detect_trend_regressions
from torchsnapshot_tpu_torch.telemetry.stats import main as stats_main
from torchsnapshot_tpu_torch.test_utils import run_multiprocess

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _ev(name, ts_us, dur_us, bseq, args=None):
    return {"ph": "X", "name": name, "ts": ts_us, "dur": dur_us, "bseq": bseq, "args": args or {}}


def _arange_state(n):
    return {"m": StateDict(w=torch.arange(n, dtype=torch.float32))}


def _zeros_state(n):
    return {"m": StateDict(w=torch.zeros(n, dtype=torch.float32))}


# ---------------------------------------------------------------------------
# Sweep-line attribution
# ---------------------------------------------------------------------------


def test_sweep_charges_innermost_frame_and_partitions_exactly():
    events = [
        _ev(names.SPAN_TAKE, 0, 1_000_000, 0),
        _ev(names.SPAN_PIPELINE_STAGE, 0, 400_000, 1),
        _ev(names.SPAN_STORAGE_WRITE, 100_000, 200_000, 2, {"blob": "0/w"}),
    ]
    cp = critpath.critical_path_from_events(events, "take")
    assert cp["wall_s"] == pytest.approx(1.0)
    assert cp["coverage"] == pytest.approx(1.0)
    assert cp["segments"]["staging"] == pytest.approx(0.2, abs=1e-6)
    assert cp["segments"]["write_drain"] == pytest.approx(0.2, abs=1e-6)
    assert cp["segments"]["other"] == pytest.approx(0.6, abs=1e-6)
    assert sum(cp["segments"].values()) == pytest.approx(cp["wall_s"])
    assert cp["dominant"] == "other"
    write = [c for c in cp["chain"] if c["span"] == names.SPAN_STORAGE_WRITE]
    assert write and write[0]["blob"] == "0/w"
    assert write[0]["gated_s"] == pytest.approx(0.2, abs=1e-6)


def test_async_take_attributes_over_envelope_union():
    events = [
        _ev(names.SPAN_ASYNC_TAKE_STAGE, 0, 100_000, 0),
        _ev(names.SPAN_ASYNC_TAKE_COMMIT, 200_000, 300_000, 1),
        _ev(names.SPAN_PIPELINE_STAGE, 0, 100_000, 2),
        _ev(names.SPAN_STORAGE_WRITE, 150_000, 100_000, 3),
    ]
    cp = critpath.critical_path_from_events(events, "async_take")
    assert cp["wall_s"] == pytest.approx(0.4)
    assert cp["segments"]["staging"] == pytest.approx(0.1, abs=1e-6)
    assert cp["segments"]["write_drain"] == pytest.approx(0.05, abs=1e-6)
    assert sum(cp["segments"].values()) == pytest.approx(0.4)


def test_no_envelope_yields_none():
    assert critpath.critical_path_from_events([], "take") is None
    assert critpath.critical_path_from_events([_ev(names.SPAN_STORAGE_WRITE, 0, 10, 0)], "take") is None
    assert critpath.critical_path_from_events([_ev(names.SPAN_TAKE, 0, 100, 0)], "no_such_kind") is None


def test_foreign_envelope_bounds_but_never_gates():
    events = [_ev(names.SPAN_TAKE, 0, 100_000, 0), _ev(names.SPAN_ASYNC_TAKE_COMMIT, 0, 100_000, 1)]
    assert critpath.critical_path_from_events(events, "take")["segments"] == {"other": pytest.approx(0.1)}


# ---------------------------------------------------------------------------
# The port's reports carry critical paths that meet the coverage bar
# ---------------------------------------------------------------------------


def _assert_coverage(ev):
    cp = ev.get("critical_path")
    assert cp, f"{ev.get('kind')} report carries no critical_path"
    assert cp["coverage"] >= critpath.MIN_COVERAGE
    assert sum(cp["segments"].values()) >= 0.95 * cp["wall_s"]
    assert cp["dominant"] in cp["segments"]
    return cp


def test_single_process_take_and_restore_meet_coverage_bar(tmp_path):
    path = str(tmp_path / "snap")
    with knobs.enable_telemetry():
        Snapshot.take(path, _arange_state(1 << 20))
        dest = _zeros_state(1 << 20)
        Snapshot(path).restore(dest)
    assert torch.equal(dest["m"]["w"], torch.arange(1 << 20, dtype=torch.float32))
    by_kind = {e["kind"]: e for e in telemetry.load_events(os.path.join(path, ".telemetry.jsonl"))}
    take_cp = _assert_coverage(by_kind["take"])
    restore_cp = _assert_coverage(by_kind["restore"])
    assert any(c["segment"] == "write_drain" for c in take_cp["chain"])
    assert any(c["segment"] == "read_drain" for c in restore_cp["chain"])


def _worker_take_restore_critpath(pg, path):
    os.environ["TORCHSNAPSHOT_TPU_FANOUT_RESTORE"] = "1"
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    n = 200_000
    with knobs.enable_telemetry():
        Snapshot.take(path, _arange_state(n), pg=pg, replicated=["**"])
        PGWrapper(pg).barrier()
        dest = _zeros_state(n)
        Snapshot(path, pg=pg).restore(dest)
        assert torch.equal(dest["m"]["w"], torch.arange(n, dtype=torch.float32))
    if pg.rank != 0:
        return None
    events = telemetry.load_events(os.path.join(path, ".telemetry.jsonl"))
    takes = [e for e in events if e.get("kind") == "take"]
    restores = [e for e in events if e.get("kind") == "restore"]
    assert takes and restores
    for ev in takes + restores:
        _assert_coverage(ev)
    agg = [e for e in takes if e.get("aggregated")]
    assert agg, "rank 0's take report carries no cross-rank aggregate"
    folded = agg[-1]["aggregated"]
    critpath_keys = [k for k in folded if k.startswith("critpath_")]
    assert critpath_keys, f"no critpath fold in {sorted(folded)}"
    assert {"min", "median", "max", "straggler"} <= set(folded[critpath_keys[0]])
    return sorted(critpath_keys)


def test_two_process_take_and_fanout_restore_meet_coverage_bar(tmp_path):
    results = run_multiprocess(_worker_take_restore_critpath, nproc=2, args=(str(tmp_path / "s"),))
    assert results[0] and results[1] is None


def test_peer_served_restore_attributes_peer_segment(tmp_path):
    """The peer -> fast -> durable ladder, peer-served: blob reads gated
    by ``peer:pull`` attribute to the ``peer`` segment, and the pull's
    round trip, a ``wire:rpc`` span inside ``peer:pull`` (the innermost
    frame gates), to ``wire``; the chain cites the pull through one of
    the two."""
    import glob

    from test_torch_peer_tier import _FakeWorld
    from torchsnapshot_tpu_torch.tiered import peer

    path = str(tmp_path / "snap")
    n = 50_000
    peer.reset_peer_tier()
    with knobs.enable_peer_tier(), knobs.enable_telemetry():
        world = _FakeWorld()
        try:
            Snapshot.take(path, _arange_state(n))
            assert world.rep.drain(timeout=60)
            for blob in glob.glob(os.path.join(path, "m", "*")):
                os.remove(blob)
            dest = _zeros_state(n)
            Snapshot(path).restore(dest)
            assert torch.equal(dest["m"]["w"], torch.arange(n, dtype=torch.float32))
        finally:
            world.close()
    restore = [e for e in telemetry.load_events(os.path.join(path, ".telemetry.jsonl")) if e["kind"] == "restore"][-1]
    cp = _assert_coverage(restore)
    assert cp["segments"].get("peer", 0.0) > 0.0
    assert cp["segments"].get("wire", 0.0) > 0.0
    assert any(c["span"] in (names.SPAN_PEER_PULL, names.SPAN_WIRE_RPC) for c in cp["chain"])


# ---------------------------------------------------------------------------
# Merged-doc attribution
# ---------------------------------------------------------------------------


def _B(pid, tid, name, ts_us, args=None):
    return {"ph": "B", "pid": pid, "tid": tid, "name": name, "ts": ts_us, "args": args or {}}


def _E(pid, tid, ts_us):
    return {"ph": "E", "pid": pid, "tid": tid, "ts": ts_us}


def test_doc_attribution_descends_stitched_wire_to_peer_frames():
    doc = {
        "traceEvents": [
            _B(0, 1, names.SPAN_TAKE, 0),
            _B(0, 1, names.SPAN_WIRE_RPC, 1_000, {"span_id": "s1", "trace_id": "t1", "op": "fetch"}),
            _B(1, 7, names.SPAN_WIRE_HANDLER, 1_500, {"parent_span_id": "s1", "trace_id": "t1"}),
            _B(1, 7, names.SPAN_STORAGE_READ, 2_000, {"blob": "0/w"}),
            _E(1, 7, 8_000),
            _E(1, 7, 8_500),
            _E(0, 1, 9_000),
            _E(0, 1, 10_000),
        ]
    }
    cp = critpath.critical_path_from_doc(doc, "take")
    assert cp["dominant"] == "read_drain"
    assert cp["segments"]["read_drain"] > 0.0
    assert cp["segments"].get("wire", 0.0) < cp["segments"]["read_drain"]
    cited = [c for c in cp["chain"] if c["span"] == names.SPAN_STORAGE_READ]
    assert cited and cited[0]["blob"] == "0/w"


def test_doc_attribution_without_stitch_keeps_wire_segment():
    doc = {
        "traceEvents": [
            _B(0, 1, names.SPAN_TAKE, 0),
            _B(0, 1, names.SPAN_WIRE_RPC, 100, {"span_id": "sX", "trace_id": "tX"}),
            _E(0, 1, 900),
            _E(0, 1, 1_000),
        ]
    }
    assert critpath.critical_path_from_doc(doc, "take")["segments"]["wire"] == pytest.approx(0.0008)


def test_spans_from_chrome_reports_self_time():
    from torchsnapshot_tpu_torch.telemetry.trace import longest_spans_from_doc, spans_from_chrome, summarize_merged

    doc = {"traceEvents": [_B(0, 1, "parent", 0), _B(0, 1, "child", 10_000), _E(0, 1, 90_000), _E(0, 1, 100_000)]}
    by = {s["name"]: s for s in spans_from_chrome(doc)}
    assert by["parent"]["dur_us"] == 100_000
    assert by["parent"]["self_us"] == 20_000
    assert by["child"]["self_us"] == 80_000
    tops = longest_spans_from_doc(doc, 2)
    assert tops[0]["name"] == "parent"
    assert tops[0]["dur_ms"] == 100.0
    assert tops[0]["self_ms"] == 20.0
    summary = summarize_merged(doc)
    assert "self" in summary and "top self-time spans" in summary


# ---------------------------------------------------------------------------
# Diff CLI
# ---------------------------------------------------------------------------


def test_diff_cli_attributes_injected_storage_slowdown(tmp_path, monkeypatch, capsys):
    """A sleep inside the port's instrumented fs write (below the
    ``storage:write`` span) is pinned on ``write_drain`` with span
    citations."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    async def none_coro():
        return None

    before, after = str(tmp_path / "before"), str(tmp_path / "after")
    state = _arange_state(100_000)
    with knobs.enable_telemetry():
        Snapshot.take(before, state)
        orig_write = FSStoragePlugin._write_impl

        async def slow_write(self, write_io):
            await asyncio.sleep(0.1)
            await orig_write(self, write_io)

        monkeypatch.setattr(FSStoragePlugin, "_write_impl", slow_write)
        monkeypatch.setattr(FSStoragePlugin, "write_with_checksum", lambda self, write_io: none_coro())
        Snapshot.take(after, state)
    rc = stats_main(["diff", before, after, "--kind", "take"])
    out = capsys.readouterr().out
    assert rc == 2
    assert "write_drain" in out and "REGRESSED" in out
    assert "gating spans" in out and "storage:" in out
    rc = stats_main(["diff", before, after, "--kind", "take", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 2
    assert doc["regressed"][0]["segment"] == "write_drain"
    assert doc["evidence"]


def test_diff_cli_unusable_operand_exits_1(tmp_path, capsys):
    assert stats_main(["diff", str(tmp_path), str(tmp_path)]) == 1
    assert "no report found" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Bench differential (pure JSON: the repo's BENCH_r*.json records)
# ---------------------------------------------------------------------------


def _bench_parsed(name):
    return json.loads((REPO_ROOT / name).read_text())["parsed"]


def test_bench_regressions_quiet_on_real_r06_vs_r07():
    assert critpath.bench_regressions([("r06", _bench_parsed("BENCH_r06.json")), ("r07", _bench_parsed("BENCH_r07.json"))]) == []


def test_bench_regression_fires_on_doctored_pair(tmp_path, capsys):
    r06, r07 = _bench_parsed("BENCH_r06.json"), _bench_parsed("BENCH_r07.json")
    doctored = dict(r07, value=round(r07["value"] * 0.2, 4))
    rows = critpath.bench_regressions([("r06", r06), ("doctored", doctored)])
    assert [r["leg"] for r in rows] == ["value"]
    assert rows[0]["baseline_records"] == ["r06"]
    assert critpath.bench_verdicts(rows)[0].rule == names.RULE_BENCH_REGRESSION
    a, b, ok = tmp_path / "BENCH_r90.json", tmp_path / "BENCH_r91.json", tmp_path / "BENCH_r92.json"
    a.write_text(json.dumps({"parsed": r06}))
    b.write_text(json.dumps({"parsed": doctored}))
    ok.write_text(json.dumps({"parsed": r07}))
    assert stats_main(["diff", str(a), str(b)]) == 2
    out = capsys.readouterr().out
    assert "REGRESSED" in out and names.RULE_BENCH_REGRESSION in out
    assert stats_main(["diff", str(a), str(ok)]) == 0


def test_bench_skipped_leg_zero_is_not_a_regression():
    base = {"value": 0.2, "pipeline_efficiency": 0.6}
    assert critpath.bench_regressions([("a", base), ("b", {"value": 0.2, "pipeline_efficiency": 0.0})]) == []
    assert critpath.bench_regressions([("a", {"value": 0.0}), ("b", {"value": 0.2}), ("c", {"value": 0.21})]) == []


# ---------------------------------------------------------------------------
# Trend integration
# ---------------------------------------------------------------------------


def _hist_row(kind, dominant, step, seconds=1.0):
    return {
        "kind": kind, "step": step, "path": f"/ckpt/step_{step}",
        "critpath": {"dominant": dominant, "coverage": 1.0, "segments": {dominant: seconds}},
    }


def test_detect_critical_path_shifts_flags_moved_dominant():
    records = [_hist_row("take", "write_drain", i) for i in range(4)]
    records.append(_hist_row("take", "coordination", 4, seconds=2.5))
    rows = critpath.detect_critical_path_shifts(records)
    assert len(rows) == 1
    assert rows[0]["dominant"] == "coordination"
    assert rows[0]["previous_dominant"] == "write_drain"
    assert rows[0]["baseline_share"] == 1.0
    assert rows[0]["dominant_s"] == 2.5
    assert critpath.detect_critical_path_shifts([_hist_row("take", "write_drain", i) for i in range(6)]) == []
    mixed = [_hist_row("take", "write_drain", i) for i in range(4)] + [_hist_row("restore", "read_drain", 4)]
    assert critpath.detect_critical_path_shifts(mixed) == []


def test_doctor_trend_emits_critical_path_shifted_verdict():
    records = [_hist_row("take", "write_drain", i) for i in range(4)] + [_hist_row("take", "coordination", 4)]
    shifted = [v for v in diagnose_trend(records) if v.rule == names.RULE_CRITICAL_PATH_SHIFTED]
    assert len(shifted) == 1
    assert "coordination" in shifted[0].summary
    assert shifted[0].evidence["previous_dominant"] == "write_drain"


def test_trend_series_cover_critpath_segments():
    def row(step, write_drain):
        return {
            "kind": "take", "step": step, "take_s": 2.0,
            "critpath": {"dominant": "write_drain", "segments": {"write_drain": write_drain, "staging": 0.5}},
        }

    metrics = {r["metric"] for r in detect_trend_regressions([row(i, 1.0) for i in range(4)] + [row(4, 1.9)])}
    assert "critpath_write_drain_s" in metrics
    assert "critpath_staging_s" not in metrics


def test_new_rule_ids_are_registered_and_kebab_case():
    ids = registered_rule_ids()
    for rid in (names.RULE_CRITICAL_PATH_SHIFTED, names.RULE_BENCH_REGRESSION):
        assert rid in ids
        assert re.fullmatch(r"[a-z0-9]+(-[a-z0-9]+)*", rid)


def test_history_rows_carry_critpath_summary(tmp_path):
    from torchsnapshot_tpu_torch.telemetry.history import summarize_report
    from torchsnapshot_tpu_torch.telemetry.report import SnapshotReport

    report = SnapshotReport(kind="take", path=str(tmp_path), rank=0)
    report.critical_path = {
        "wall_s": 1.0, "coverage": 1.0, "segments": {"write_drain": 0.75, "other": 0.25},
        "dominant": "write_drain", "chain": [],
    }
    row = summarize_report(report, step=7)
    assert row["critpath"]["dominant"] == "write_drain"
    assert row["critpath"]["segments"]["write_drain"] == 0.75
    assert summarize_report(SnapshotReport(kind="take", path=str(tmp_path), rank=0), step=8)["critpath"] is None
