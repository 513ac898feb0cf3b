"""The port's benchmark reading the program's own spans and counters: the
device's idle gaps labelled by the flight recorder's spans
(``portbench/harness/program_spans.py``), the per-layer readers that
work from the new registry series, and the existing readers, which read
the same values from a record that also holds the new series and
labelled gaps.

On the CPU: a tiny copy of the benchmark (``portbench/tests/tinybench.py``)
runs each one-rank cell once, one process a cell, with its registry as
the benchmark records it. This file imports no ``jax``.
"""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
for p in (BENCH, os.path.join(BENCH, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.program_spans import (  # noqa: E402
    LabelledProfile,
    program_intervals,
    summarize_labelled,
    thread_base,
)
from harness.trace import ANCHOR, Profile, summarize  # noqa: E402

# The per-layer metrics the benchmark had before the program's spans were
# read; each reads the same value from the records below with or without
# the new series.
EXISTING = (
    "save_call_ms", "commit_s", "save_s", "restore_s", "staging_s", "loading_s", "d2h_GBps",
    "h2d_GBps", "write_GBps", "read_GBps", "coord_s", "write_share_max_pct", "step_ms_clean",
    "step_ms_clean.restart", "drain_step_ms", "train_mfu_pct", "train_mfu_pct.restart",
    "flash_chunk_roofline", "flash_chunk_roofline.restart", "device_idle_pct",
    "device_idle_pct.restart",
)
NEW = (
    "manager_save_s", "manager_async_call_ms", "manager_restore_s", "manager_commit_s",
    "manager_bookkeeping_s", "restore_place_s", "read_service_GBps", "write_service_GBps",
    "drain_cpu_s", "capture_GB_s",
)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "spans_m_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------
# labelling the idle gaps
# ----------------------------------------------------------------------

DEV = [(0, 100, "k"), (200, 300, "k"), (400, 500, "k"), (600, 700, "k"), (800, 900, "k")]
HARNESS = [("step", 0, 150), ("save", 150, 750), ("step", 750, 1000)]


def test_no_program_spans_gives_the_benchmarks_own_summary():
    assert summarize_labelled(DEV, 0, 1000, HARNESS) == summarize(DEV, 0, 1000, HARNESS)
    assert summarize_labelled(DEV, 0, 1000, HARNESS, [], []) == summarize(DEV, 0, 1000, HARNESS)


def test_gaps_take_the_main_threads_span_then_another_threads():
    # Gaps: [100,200) mid 150 (save), [300,400) mid 350, [500,600) mid 550,
    # [700,800) mid 750 (step), [900,1000) mid 950 (step).
    main = [(140, 520, 1, "manager:save"), (300, 420, 2, "take:plan")]
    others = [(500, 800, 3, "snapshot-commit:storage:write"), (540, 560, 4, "asyncio:storage:fs_native_write")]
    out = summarize_labelled(DEV, 0, 1000, HARNESS, main, others)
    base = summarize(DEV, 0, 1000, HARNESS)
    assert {k: v for k, v in out.items() if k not in ("idle_gaps", "idle_by_span", "labelled_s")} == {
        k: v for k, v in base.items() if k != "idle_gaps"
    }
    labels = [g[0] for g in out["idle_gaps"]]
    # The longest gaps in the benchmark's order, each prefix its label.
    assert [lbl.split("/")[0] for lbl in labels] == [g[0] for g in base["idle_gaps"]]
    assert labels == [
        "save/manager:save",
        "save/take:plan",
        "save/asyncio:storage:fs_native_write",
        "step/snapshot-commit:storage:write",
        "step",
    ]
    # Idle seconds by label: each gap cut where a span starts or ends.
    assert dict(out["idle_by_span"]) == {
        "save/snapshot-commit:storage:write": pytest.approx(110e-9),
        "save/take:plan": pytest.approx(100e-9),
        "save/manager:save": pytest.approx(70e-9),
        "save/asyncio:storage:fs_native_write": pytest.approx(20e-9),
        "step/snapshot-commit:storage:write": pytest.approx(50e-9),
        "step/manager:save": pytest.approx(10e-9),
        "step": pytest.approx(140e-9),
    }
    assert out["labelled_s"] == {"save": [pytest.approx(300e-9), pytest.approx(300e-9)],
                                 "step": [pytest.approx(60e-9), pytest.approx(200e-9)]}


def test_idle_by_span_sums_every_gap_not_only_the_longest():
    dev = [(i * 20, i * 20 + 10, "k") for i in range(30)]
    out = summarize_labelled(dev, 0, 600, [("save", 0, 600)], [(0, 600, 1, "manager:save")], [])
    assert len(out["idle_gaps"]) == 10
    assert out["idle_by_span"] == [["save/manager:save", pytest.approx(300e-9)]]


def test_one_long_gap_counts_each_span_that_ran_in_it():
    """A blocking save with the card idle throughout: the writes, the
    commit and the bookkeeping each get their own seconds; the gap itself
    takes the label of its midpoint."""
    main = [(0, 1000, 1, "manager:save"), (0, 600, 2, "storage:write"), (600, 900, 3, "manager:commit"),
            (900, 1000, 4, "manager:bookkeeping")]
    out = summarize_labelled([(1000, 1100, "k")], 0, 1100, [("save", 0, 1000), ("step", 1000, 1100)], main, [])
    assert out["idle_gaps"] == [["save/storage:write", pytest.approx(1000e-9)]]
    assert dict(out["idle_by_span"]) == {"save/storage:write": pytest.approx(600e-9),
                                         "save/manager:commit": pytest.approx(300e-9),
                                         "save/manager:bookkeeping": pytest.approx(100e-9)}


def test_recorder_events_move_onto_the_profilers_time_base():
    events = [
        {"ph": "X", "name": "manager:save", "ts": 10, "dur": 5, "tid": 0, "bseq": 1},
        {"ph": "X", "name": "storage:read", "ts": 11, "dur": 2, "tid": 1, "bseq": 2},
        {"ph": "X", "name": "storage:fs_native_read", "ts": 12, "dur": 1, "tid": 2, "bseq": 3},
        {"ph": "i", "name": "storage:retry", "ts": 12, "tid": 2, "bseq": 4},
    ]
    names = {0: "MainThread", 1: "MainThread:task-4", 2: "asyncio_3"}
    main, others = program_intervals(events, names, "MainThread", shift_ns=-7)
    assert main == [(9993, 14993, 1, "manager:save"), (10993, 12993, 2, "storage:read")]
    assert others == [(11993, 12993, 3, "asyncio:storage:fs_native_read")]
    assert thread_base("snapshot-commit:task-12") == "snapshot-commit"
    assert thread_base("ts-consume_0") == "ts-consume" and thread_base("MainThread") == "MainThread"


class _Event:
    """A profiler event as ``Profile.reduce`` reads it."""

    def __init__(self, name, start, dur, cuda=True, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._cuda, self._annotation = cuda, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation


_WINDOW = _Event(ANCHOR, 10_000, 9_000, cuda=False, annotation=True)
_DEVICE = [
    _Event("ampere_sgemm", 9_000, 2_000),  # begins before the window
    _Event("flash_wgmma_kernel<Cfg, true, false>(Params)", 12_000, 500),
    _Event("Memcpy HtoD (Pageable -> Device)", 13_000, 700),
    _Event("portbench.step", 12_000, 3_000, annotation=True),  # the device's copy of a host span
    _Event("aten::mm", 14_000, 200, cuda=False),
    _Event("Memcpy DtoH (Device -> Pinned)", 15_500, 1_000),
    _Event("elementwise_kernel", 18_800, 900),  # ends after the window
]


@pytest.mark.parametrize("events", [
    [_WINDOW, *_DEVICE],
    [_WINDOW, _DEVICE[3], _DEVICE[4]],  # no device time
    _DEVICE,  # no anchor
], ids=["window", "no_device_time", "no_anchor"])
def test_labelled_reduce_is_the_benchmarks_reduce_without_program_spans(events):
    """``LabelledProfile.reduce`` repeats ``Profile.reduce`` before it adds
    the labels: on the same profiler events, with no program span in the
    window, both give the same summary."""
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    plain, labelled = Profile(True), LabelledProfile(True)
    for p in (plain, labelled):
        p._prof, p.anchor_host_ns = prof, 4_000
    labelled._program = ([], {}, 3)
    spans = [("step", 4_000, 9_000), ("save", 9_000, 11_000), ("step", 11_000, 13_000)]
    want, got = plain.reduce(spans), labelled.reduce(spans)
    if want is None:
        assert got is None
        return
    assert want["idle_gaps"] and want["busy_s"] > 0
    assert got.pop("program_spans") == 0 and got.pop("program_spans_dropped") == 3
    assert got == want
    # With program spans in the window, only the gap labels differ.
    labelled._program = ([{"ph": "X", "name": "manager:save", "ts": 5, "dur": 2, "tid": 0, "bseq": 1}],
                         {0: labelled._main_thread}, 0)
    got = labelled.reduce(spans)
    assert got["program_spans"] == 1 and got["idle_by_span"]
    assert {k: v for k, v in got.items() if k in want and k != "idle_gaps"} == {
        k: v for k, v in want.items() if k != "idle_gaps"
    }
    assert [g[0].split("/")[0] for g in got["idle_gaps"]] == [g[0] for g in want["idle_gaps"]]


# ----------------------------------------------------------------------
# the readers on records with and without the new series
# ----------------------------------------------------------------------


def _records():
    trace = {"busy_s": 7.5, "window_s": 10.0, "flash_chunk_calls": 100, "flash_chunk_s": 0.02,
             "d2h_s": 0.5, "h2d_s": 0.25, "device_ops": [["k", 7.5]], "idle_gaps": [["save", 1.5]]}
    base = {"ranks": 2, "chips": 2, "window_s": 10.0,
            "steps": [(0.2, "step"), (0.4, "step"), (0.3, "step"), (1.0, "drain")],
            "step_counts": [4, 4], "flops_per_step": 1e12, "peak_flops": 1e15, "flash_chunk_bound_s": 5e-5,
            "traces": [trace, trace]}
    counters = [
        {'storage_write_bytes_total{plugin="fs"}': 3e9, 'storage_read_bytes_total{plugin="fs"}': 2e9,
         "device_to_host_bytes_total": 1e9, "host_to_device_bytes_total": 1e9,
         'coordination_store_seconds_total{op="get"}': 0.2,
         'coordination_barrier_wait_seconds_total{impl="tree"}': 0.1},
        {'storage_write_bytes_total{plugin="fs"}': 1e9, "device_to_host_bytes_total": 1e9,
         'coordination_store_seconds_total{op="get"}': 0.5},
    ]
    hist = [
        {"sum": {'storage_write_seconds{plugin="fs"}': 2.0, 'storage_read_seconds{plugin="fs"}': 4.0,
                 'snapshot_phase_seconds{phase="staging"}': 0.6, 'snapshot_phase_seconds{phase="loading"}': 1.5},
         "count": {'storage_write_seconds{plugin="fs"}': 10, 'storage_read_seconds{plugin="fs"}': 10,
                   'snapshot_phase_seconds{phase="staging"}': 2, 'snapshot_phase_seconds{phase="loading"}': 3}},
        {"sum": {'storage_write_seconds{plugin="fs"}': 2.0, 'snapshot_phase_seconds{phase="staging"}': 1.0},
         "count": {'storage_write_seconds{plugin="fs"}': 10, 'snapshot_phase_seconds{phase="staging"}': 2}},
    ]
    saves = [{"call_s": 1.0, "committed_s": 1.5}, {"call_s": 2.0, "committed_s": 2.5}]
    old = {
        "sync": dict(base, mode="sync", saves=saves, restores=[], counters=counters, histograms=hist),
        "async": dict(base, mode="async", saves=saves, restores=[], counters=counters, histograms=hist),
        "restart": dict(base, mode="sync", ranks=1, saves=[], restores=[{"s": 1.0}, {"s": 1.2}, {"s": 0.8}],
                        counters=counters[:1], histograms=hist[:1], traces=[trace]),
    }
    more_counters = {'checkpoint_thread_cpu_seconds_total{role="storage"}': 0.4,
                     "async_capture_device_byte_seconds_total": 2e8,
                     "async_capture_device_bytes_total": 1e9}
    more_sums = {'manager_call_seconds{op="save"}': 3.0, 'manager_call_seconds{op="restore"}': 3.0,
                 'manager_call_seconds{op="async_save"}': 0.1, 'manager_phase_seconds{phase="commit"}': 0.2,
                 'manager_phase_seconds{phase="bookkeeping"}': 0.1, 'restore_phase_seconds{phase="place"}': 0.3,
                 'storage_write_service_seconds{plugin="fs"}': 1.0, 'storage_read_service_seconds{plugin="fs"}': 1.0}
    more_counts = {k: 2 for k in more_sums}
    labelled = dict(trace, idle_gaps=[["save/manager:save", 1.5]], idle_by_span=[["save/manager:save", 1.5]],
                    labelled_s={"save": [1.5, 1.5]}, program_spans=120, program_spans_dropped=0)
    new = {}
    for kind, rec in old.items():
        rec = json.loads(json.dumps(rec))
        rec["counters"] = [dict(c, **more_counters) for c in rec["counters"]]
        rec["histograms"] = [{"sum": dict(h["sum"], **more_sums), "count": dict(h["count"], **more_counts)}
                             for h in rec["histograms"]]
        rec["traces"] = [labelled for _ in rec["traces"]]
        new[kind] = rec
    return old, new


# Each existing reader's value on the records above, as the benchmark read
# them before the program's spans: (sync, async, restart).
PINNED = {
    "save_call_ms": (None, 1500.0, None), "commit_s": (None, 2.0, None), "save_s": (1.5, None, None),
    "restore_s": (None, None, 1.0), "staging_s": (0.5, 0.5, None), "loading_s": (None, None, 0.5),
    "d2h_GBps": (2.0, 2.0, None), "h2d_GBps": (None, None, 4.0), "write_GBps": (1.0, 1.0, None),
    "read_GBps": (None, None, 0.5), "coord_s": (0.25, 0.25, None), "write_share_max_pct": (75.0, 75.0, None),
    "step_ms_clean": (300.0, 300.0, 300.0), "step_ms_clean.restart": (300.0, 300.0, 300.0),
    "drain_step_ms": (1000.0, 1000.0, 1000.0),
    "train_mfu_pct": (0.04, 0.04, 0.04), "train_mfu_pct.restart": (0.04, 0.04, 0.04),
    "flash_chunk_roofline": (25.0, 25.0, 25.0), "flash_chunk_roofline.restart": (25.0, 25.0, 25.0),
    "device_idle_pct": (25.0, 25.0, 25.0), "device_idle_pct.restart": (25.0, 25.0, 25.0),
}


@pytest.mark.parametrize("name", EXISTING)
def test_existing_readers_read_the_same_values(name):
    old, new = _records()
    read = _reader(name)
    for i, kind in enumerate(("sync", "async", "restart")):
        want = PINNED[name][i]
        before, after = read(old[kind]), read(new[kind])
        assert before == after
        assert before == (pytest.approx(want) if want is not None else None), (kind, before)


def test_new_readers_on_the_records():
    old, new = _records()
    r = {n: _reader(n) for n in NEW}
    assert r["manager_save_s"](new["sync"]) == pytest.approx(1.5)
    assert r["manager_async_call_ms"](new["async"]) == pytest.approx(50.0)
    assert r["manager_restore_s"](new["restart"]) == pytest.approx(1.5)
    assert r["manager_commit_s"](new["async"]) == pytest.approx(0.1)
    assert r["manager_bookkeeping_s"](new["sync"]) == pytest.approx(0.05)
    assert r["restore_place_s"](new["restart"]) == pytest.approx(0.1)
    assert r["read_service_GBps"](new["restart"]) == pytest.approx(2.0)
    assert r["write_service_GBps"](new["sync"]) == pytest.approx(2.0)
    assert r["drain_cpu_s"](new["async"]) == pytest.approx(0.2)
    assert r["capture_GB_s"](new["async"]) == pytest.approx(0.1)
    # A program without the spans (the parent) leaves nothing to read.
    for n in NEW:
        for kind in old:
            assert r[n](old[kind]) is None, (n, kind)


# ----------------------------------------------------------------------
# a tiny run of each cell
# ----------------------------------------------------------------------

# The four-rank cell's tiny run is in portbench/tests/test_portbench_program_spans.py,
# out of this parallel suite: its ranks meet on a port picked before it is bound.
CELLS = ("pythia-160m.async_save", "pythia-160m.sync_save", "pythia-410m.restart", "lfm2-8b-a1b.async_save")
# Read from device copies the CPU never makes.
DEVICE_ONLY = {"capture_GB_s"}

_RUN = """
import json, sys
sys.path[:0] = [{repo!r}, {bench!r}, {tests!r}]
from tinybench import make_tiny_root
from harness.cell import run_cell
from harness.spec import load_cell
root = make_tiny_root({root!r})
cell = load_cell(root, {cell!r})
rec = run_cell(root, cell, 2**31 + 41, 1.0, False)[0]
print(json.dumps({{m.name: m.reader(rec) for m in cell.per_layer}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_gives_each_new_reader_a_number_in_its_cells(tmp_path, cell):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        listed = {m["name"]: m.get("workloads") for m in json.load(f)["per_layer"]}
    code = _RUN.format(repo=REPO, bench=BENCH, tests=os.path.join(BENCH, "tests"), root=str(tmp_path / "b"), cell=cell)
    done = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=400, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert done.returncode == 0, done.stderr[-3000:]
    values = json.loads(done.stdout.strip().splitlines()[-1])
    for name in NEW:
        if cell not in listed[name]:
            assert name not in values
        elif name not in DEVICE_ONLY:
            assert isinstance(values[name], float) and values[name] > 0, (name, values)
