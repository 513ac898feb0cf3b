"""The port's flight recorder: span ring semantics, Chrome-trace export
determinism, the per-operation export through take, async take and
restore, the cross-rank merge with its clock-offset alignment, and the
merge CLI.

Ports of the JAX package's ``tests/test_trace.py`` recorder, export, merge
and clock-offset cases, under the same names, on torch state; the
watchdog, RSS-profiler and ``fsck --stats`` cases are ROADMAP step 10d and
stay out. The merge CLI is ``python -m
torchsnapshot_tpu_torch.telemetry.trace`` (its ``main``). This file
imports no ``jax``: merging a port trace with a JAX one is in
``tests/test_torch_telemetry_crosspkg.py``.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, TensorTreeState, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import names
from torchsnapshot_tpu_torch.telemetry.trace import (
    SpanRecorder,
    chrome_trace,
    longest_spans,
    merge_traces,
    spans_from_chrome,
    summarize_merged,
    write_trace_file,
)
from torchsnapshot_tpu_torch.telemetry.trace import main as trace_main

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Trace tests read the process-global recorder and registry."""
    telemetry.reset_metrics()
    telemetry.reset_trace()
    yield
    telemetry.reset_metrics()
    telemetry.reset_trace()


def _state(n=3, size=512, seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)}


def validate_chrome(doc):
    """The acceptance validator: JSON-shaped trace events, ts sorted
    non-decreasing, and per-(pid, tid) B/E pairs balanced with proper
    stack discipline."""
    events = doc["traceEvents"]
    last_ts = None
    stacks = {}
    for ev in events:
        assert ev["ph"] in ("M", "B", "E", "i"), ev
        if ev["ph"] == "M":
            continue
        assert isinstance(ev["ts"], int)
        if last_ts is not None:
            assert ev["ts"] >= last_ts, "timestamps not sorted"
        last_ts = ev["ts"]
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            assert "name" in ev
            stacks.setdefault(key, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks.get(key), f"E without matching B on {key}"
            stacks[key].pop()
    dangling = {k: v for k, v in stacks.items() if v}
    assert not dangling, f"unbalanced B/E: {dangling}"


# ---------------------------------------------------------------------------
# Recorder semantics
# ---------------------------------------------------------------------------


def test_span_nesting_and_args_recorded():
    rec = SpanRecorder(capacity=64)
    with rec.span(names.SPAN_TAKE, path="/x"):
        with rec.span(names.SPAN_STORAGE_WRITE, plugin="fs", blob="0/a"):
            pass
        rec.instant(names.INSTANT_STORAGE_RETRY, scope="s3")
    events = rec.events_since(0)
    assert [e["name"] for e in events] == [
        names.SPAN_STORAGE_WRITE,
        names.INSTANT_STORAGE_RETRY,
        names.SPAN_TAKE,
    ]  # completion order: inner span first, envelope last
    by_name = {e["name"]: e for e in events}
    assert by_name[names.SPAN_STORAGE_WRITE]["args"]["blob"] == "0/a"
    assert by_name[names.SPAN_TAKE]["args"]["path"] == "/x"
    assert by_name[names.INSTANT_STORAGE_RETRY]["ph"] == "i"
    # The envelope's span contains the inner span on the timeline.
    outer, inner = by_name[names.SPAN_TAKE], by_name[names.SPAN_STORAGE_WRITE]
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]


def test_ring_eviction_keeps_newest_spans():
    rec = SpanRecorder(capacity=8)
    for i in range(30):
        with rec.span(names.SPAN_PIPELINE_STAGE, blob=f"b{i}"):
            pass
    events = rec.events_since(0)
    assert len(events) == 8
    assert rec.dropped == 22
    # Newest survive, oldest evicted.
    blobs = [e["args"]["blob"] for e in events]
    assert blobs == [f"b{i}" for i in range(22, 30)]


def test_mark_windows_the_export():
    rec = SpanRecorder(capacity=64)
    with rec.span(names.SPAN_TAKE, path="old"):
        pass
    mark = rec.mark()
    with rec.span(names.SPAN_TAKE, path="new"):
        pass
    events = rec.events_since(mark)
    assert [e["args"]["path"] for e in events] == ["new"]


def test_mark_carries_dropped_baseline_for_window_local_drops():
    rec = SpanRecorder(capacity=4)
    for _ in range(10):
        with rec.span(names.SPAN_PIPELINE_STAGE):
            pass
    mark = rec.mark()
    assert mark.dropped == rec.dropped == 6
    for _ in range(6):
        with rec.span(names.SPAN_PIPELINE_STAGE):
            pass
    # What export_op_trace stamps into the file: this window's
    # evictions, not the recorder's lifetime total.
    assert rec.dropped - mark.dropped == 6


def test_open_spans_and_stall_flag():
    rec = SpanRecorder(capacity=64)
    token = rec.begin(names.SPAN_STORAGE_WRITE, plugin="fs", blob="0/a")
    spans = rec.open_spans()
    assert len(spans) == 1 and spans[0]["name"] == names.SPAN_STORAGE_WRITE
    assert rec.flag_stalled(spans[0]["token"])
    assert not rec.flag_stalled(spans[0]["token"])  # fire-once latch
    rec.end(token)
    assert rec.open_spans() == []
    assert not rec.flag_stalled(token)  # closed span: gone


def test_end_is_noop_for_unknown_token():
    rec = SpanRecorder(capacity=8)
    rec.end(12345)  # never raises; double-close is a silent no-op
    assert rec.events_since(0) == []


# ---------------------------------------------------------------------------
# Chrome export: determinism + validity under concurrent writers
# ---------------------------------------------------------------------------


def test_concurrent_writers_export_valid_and_deterministic():
    rec = SpanRecorder(capacity=4096)

    def worker(i):
        for j in range(40):
            with rec.span(names.SPAN_PIPELINE_STAGE, blob=f"t{i}/{j}"):
                with rec.span(
                    names.SPAN_STORAGE_WRITE, plugin="fs", blob=f"t{i}/{j}"
                ):
                    pass

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = rec.events_since(0)
    assert len(events) == 8 * 40 * 2
    doc = chrome_trace(events, rec.tid_names(), rank=0)
    validate_chrome(doc)
    # Deterministic: exporting the same recorder twice yields the same
    # document (stable event ordering), and it round-trips JSON.
    doc2 = chrome_trace(rec.events_since(0), rec.tid_names(), rank=0)
    assert doc["traceEvents"] == doc2["traceEvents"]
    assert json.loads(json.dumps(doc))["traceEvents"] == doc["traceEvents"]


def test_asyncio_tasks_get_distinct_tracks():
    """Interleaved coroutine spans on ONE thread must not cross B/E
    stacks: each task is its own track."""
    rec = SpanRecorder(capacity=256)

    async def op(i):
        with rec.span(names.SPAN_STORAGE_WRITE, plugin="s3", blob=f"b{i}"):
            await asyncio.sleep(0.001 * (i % 3))

    async def main():
        await asyncio.gather(*(op(i) for i in range(16)))

    asyncio.new_event_loop().run_until_complete(main())
    events = rec.events_since(0)
    assert len(events) == 16
    validate_chrome(chrome_trace(events, rec.tid_names(), rank=0))


# ---------------------------------------------------------------------------
# Take / restore wiring: per-op export
# ---------------------------------------------------------------------------


def test_take_and_restore_export_traces(tmp_path):
    snap = str(tmp_path / "snap")
    app_state = {"s": TensorTreeState(_state())}
    with knobs.enable_trace():
        Snapshot.take(snap, app_state)
        Snapshot(snap).restore(app_state)
    take_trace = os.path.join(snap, ".trace-take-rank0.json")
    restore_trace = os.path.join(snap, ".trace-restore-rank0.json")
    assert os.path.exists(take_trace) and os.path.exists(restore_trace)
    with open(take_trace) as f:
        doc = json.load(f)
    validate_chrome(doc)
    span_names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "B"}
    # The take envelope, the pipeline stages, and the fs writes all
    # landed on one timeline.
    assert names.SPAN_TAKE in span_names
    assert names.SPAN_PIPELINE_STAGE in span_names
    assert names.SPAN_STORAGE_WRITE in span_names
    with open(restore_trace) as f:
        rdoc = json.load(f)
    validate_chrome(rdoc)
    rnames = {e["name"] for e in rdoc["traceEvents"] if e["ph"] == "B"}
    assert names.SPAN_RESTORE in rnames
    assert names.SPAN_STORAGE_READ in rnames


def test_trace_dir_knob_takes_precedence(tmp_path):
    snap = str(tmp_path / "snap")
    trace_dir = str(tmp_path / "traces")
    with knobs.override_trace_dir(trace_dir):
        Snapshot.take(snap, {"s": TensorTreeState(_state())})
    assert os.path.exists(
        os.path.join(trace_dir, "trace-take-rank0.json")
    )
    assert not os.path.exists(os.path.join(snap, ".trace-take-rank0.json"))


def test_trace_sink_disabled_writes_nothing(tmp_path):
    snap = str(tmp_path / "snap")
    Snapshot.take(snap, {"s": TensorTreeState(_state())})
    assert not [
        f for f in os.listdir(snap) if f.startswith(".trace-")
    ]


def test_async_take_exports_trace(tmp_path):
    snap = str(tmp_path / "snap")
    with knobs.enable_trace():
        pending = Snapshot.async_take(snap, {"s": TensorTreeState(_state())})
        pending.wait()
    with open(os.path.join(snap, ".trace-async_take-rank0.json")) as f:
        doc = json.load(f)
    validate_chrome(doc)
    span_names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "B"}
    assert names.SPAN_ASYNC_TAKE_STAGE in span_names
    assert names.SPAN_ASYNC_TAKE_COMMIT in span_names


# ---------------------------------------------------------------------------
# Cross-rank merge
# ---------------------------------------------------------------------------


def _fake_rank_trace(tmp_path, rank, t0_us, span_dur_us):
    rec = SpanRecorder(capacity=64)
    with rec.span(names.SPAN_TAKE, path="/snap", rank=rank):
        with rec.span(names.SPAN_STORAGE_WRITE, plugin="fs", blob=f"{rank}/a"):
            pass
    events = rec.events_since(0)
    # Rebase onto a synthetic clock so offsets are exact.
    base = min(e["ts"] for e in events)
    for e in events:
        e["ts"] = t0_us + (e["ts"] - base)
        if e["ph"] == "X":
            e["dur"] = span_dur_us
    doc = chrome_trace(events, rec.tid_names(), rank=rank)
    path = str(tmp_path / f".trace-take-rank{rank}.json")
    write_trace_file(path, doc)
    return path


def test_merge_sorts_and_keeps_balance(tmp_path):
    p0 = _fake_rank_trace(tmp_path, 0, 1_000_000, 500)
    p1 = _fake_rank_trace(tmp_path, 1, 1_000_200, 900)
    merged = merge_traces([p0, p1])
    validate_chrome(merged)
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
    assert pids == {0, 1}


def test_merge_separates_files_claiming_the_same_rank(tmp_path):
    """Two co-hosted processes' mirror exports both claim rank 0; the
    merge must give each file its own pid — overlaying them on one pid
    would interleave their tracks and tear the B/E stacks."""
    p0 = _fake_rank_trace(tmp_path, 0, 1_000_000, 500)
    sub = tmp_path / "other"
    sub.mkdir()
    p1 = _fake_rank_trace(sub, 0, 1_000_100, 900)
    merged = merge_traces([p0, p1])
    validate_chrome(merged)
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
    assert len(pids) == 2


def test_merge_applies_clock_offsets(tmp_path):
    # Rank 1's clock runs 0.5 s ahead; with the offset applied its
    # events shift back into rank 0's frame.
    p0 = _fake_rank_trace(tmp_path, 0, 1_000_000, 500)
    p1 = _fake_rank_trace(tmp_path, 1, 1_500_000, 500)
    plain = merge_traces([p0, p1])
    aligned = merge_traces([p0, p1], {0: 0.0, 1: 0.5})
    validate_chrome(aligned)

    def rank_min_ts(doc, pid):
        return min(
            e["ts"]
            for e in doc["traceEvents"]
            if e["ph"] == "B" and e["pid"] == pid
        )

    assert rank_min_ts(plain, 1) - rank_min_ts(plain, 0) == 500_000
    assert rank_min_ts(aligned, 1) == rank_min_ts(aligned, 0)


def test_merge_degrades_when_a_rank_has_no_clock_offset(tmp_path, caplog):
    """A rank missing from the offsets map (older schema, or it never
    reached the gather) merges UNCORRECTED with a warning and an
    ``unaligned_ranks`` flag — never a failed merge or a dropped pid."""
    p0 = _fake_rank_trace(tmp_path, 0, 1_000_000, 500)
    p1 = _fake_rank_trace(tmp_path, 1, 1_500_000, 500)
    with caplog.at_level("WARNING", logger="torchsnapshot_tpu_torch.telemetry.trace"):
        merged = merge_traces([p0, p1], {0: 0.0})
    validate_chrome(merged)
    assert merged["otherData"]["unaligned_ranks"] == [1]
    assert any("no clock offset" in r.message for r in caplog.records)

    def rank_min_ts(doc, pid):
        return min(
            e["ts"]
            for e in doc["traceEvents"]
            if e["ph"] == "B" and e["pid"] == pid
        )

    # Rank 1's events are present and verbatim (unshifted), not dropped.
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] != "M"}
    assert pids == {0, 1}
    assert rank_min_ts(merged, 1) - rank_min_ts(merged, 0) == 500_000


def test_merge_cli_end_to_end(tmp_path, capsys):
    """The merge CLI (``python -m torchsnapshot_tpu_torch.telemetry.trace
    <dir>``) merges per-rank files, writes well-formed JSON, and renders a
    straggler summary."""
    _fake_rank_trace(tmp_path, 0, 1_000_000, 500)
    _fake_rank_trace(tmp_path, 1, 1_000_100, 2_000)
    rc = trace_main([str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "longest spans" in out
    assert "straggler" in out
    merged_path = tmp_path / ".trace.merged.json"
    assert merged_path.exists()
    with open(merged_path) as f:
        validate_chrome(json.load(f))
    # Rank 1's write span is 4x rank 0's: straggler attribution names it.
    assert "rank 1" in out


def test_merge_cli_no_traces(tmp_path, capsys):
    assert trace_main([str(tmp_path)]) == 1
    assert "no trace files" in capsys.readouterr().out


def test_clock_offsets_from_gather():
    gathered = [
        {"gather_unix_ts": 100.0},
        {"gather_unix_ts": 100.25},
        {"gather_unix_ts": 99.9},
        {},  # older-schema peer: degrades to 0
    ]
    assert telemetry.clock_offsets_from_gather(gathered) == [
        0.0,
        0.25,
        -0.1,
        0.0,
    ]
    assert telemetry.clock_offsets_from_gather([{}]) is None
    assert telemetry.clock_offsets_from_gather([]) is None


def test_longest_spans_reads_exported_file(tmp_path):
    rec = SpanRecorder(capacity=64)
    with rec.span(names.SPAN_TAKE, path="/snap"):
        with rec.span(names.SPAN_STORAGE_WRITE, plugin="fs", blob="0/big"):
            time.sleep(0.02)
    path = str(tmp_path / ".trace-take-rank0.json")
    write_trace_file(
        path, chrome_trace(rec.events_since(0), rec.tid_names(), rank=0)
    )
    tops = longest_spans(path, 2)
    assert [t["name"] for t in tops] == [
        names.SPAN_TAKE,
        names.SPAN_STORAGE_WRITE,
    ]
    assert tops[1]["blob"] == "0/big"
    assert tops[0]["dur_ms"] >= 20


def test_report_carries_clock_offsets_field():
    report = telemetry.SnapshotReport(kind="take", path="/x")
    assert report.clock_offsets_s is None
    d = report.to_dict()
    assert "clock_offsets_s" in d
    # Round-trips (and tolerates the gather-side stamp key).
    d["clock_offsets_s"] = [0.0, 0.1]
    d["gather_unix_ts"] = 123.0
    restored = telemetry.SnapshotReport.from_dict(d)
    assert restored.clock_offsets_s == [0.0, 0.1]


def test_spans_from_chrome_tolerates_torn_window():
    """An E whose B fell outside the export window (ring eviction /
    op-boundary overlap) is skipped, not a crash."""
    doc = {
        "traceEvents": [
            {"ph": "E", "name": "x", "pid": 0, "tid": 0, "ts": 10},
            {"ph": "B", "name": "y", "pid": 0, "tid": 0, "ts": 20},
            {"ph": "E", "name": "y", "pid": 0, "tid": 0, "ts": 30},
        ]
    }
    spans = spans_from_chrome(doc)
    assert [s["name"] for s in spans] == ["y"]
    assert summarize_merged(doc)  # renders without the torn E
