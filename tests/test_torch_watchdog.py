"""The port's stall watchdog (``telemetry/watchdog.py``): one firing per
stall episode with the open-span tree, the op's progress and its critical
path prefix in the ``watchdog:stall`` instant; silence while work
progresses; re-arming for a new episode; no thread at all with the
deadline off; and a stack dump that keeps no frame alive.

Ports of the watchdog cases of the JAX package's ``tests/test_trace.py``,
under the same names, and of its ``fsck --stats`` trace listing, on torch
state. This file imports no ``jax``: both packages' watchdogs over one
span pattern are in ``tests/test_torch_diagnosis_crosspkg.py``.
"""

import asyncio
import gc
import json
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs, telemetry
from torchsnapshot_tpu_torch.telemetry import critpath, names, trace, watchdog
from torchsnapshot_tpu_torch.telemetry.watchdog import reset_watchdog

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset_metrics()
    telemetry.reset_trace()
    reset_watchdog()
    yield
    reset_watchdog()
    telemetry.reset_metrics()
    telemetry.reset_trace()


def _state(n=3, size=512, seed=0):
    rng = np.random.default_rng(seed)
    return {"s": StateDict({f"l{i}": torch.from_numpy(rng.standard_normal(size).astype(np.float32)) for i in range(n)})}


def test_watchdog_fires_exactly_once_on_injected_slow_plugin(tmp_path, monkeypatch, caplog):
    """One storage write of the port's take held past the deadline: the
    watchdog fires once for the episode, and the stall instant carries
    the open-span tree, the take's progress and the gating segment."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    orig_write = FSStoragePlugin.write
    injected = []

    async def slow_write(self, write_io):
        if not injected:
            injected.append(write_io.path)
            await asyncio.sleep(0.7)
        await orig_write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", slow_write)
    registry = telemetry.metrics()
    baseline = registry.counters_snapshot()
    snap = str(tmp_path / "snap")
    with knobs.override_watchdog_deadline_seconds(0.15), knobs.enable_trace():
        with caplog.at_level("ERROR"):
            Snapshot.take(snap, _state(n=1, size=64))
    time.sleep(0.3)  # further scans of an edge-triggered watchdog stay quiet
    assert registry.counters_delta_since(baseline).get(names.WATCHDOG_STALLS_TOTAL) == 1.0
    with open(os.path.join(snap, ".trace-take-rank0.json")) as f:
        doc = json.load(f)
    stalls = [e for e in doc["traceEvents"] if e["ph"] == "i" and e["name"] == names.INSTANT_WATCHDOG_STALL]
    assert len(stalls) == 1
    args = stalls[0]["args"]
    assert args["age_s"] >= 0.15
    assert any(names.SPAN_TAKE in s for s in args["open_spans"])
    assert any("take rank0" in row and "items" in row for row in args["progress"])
    assert args["critical_path"] and any(args["span"] in entry for entry in args["critical_path"])
    assert args["gating_segment"] == critpath.segment_for(args["span"])
    assert "open-span tree" in caplog.text and "thread stacks" in caplog.text and "Thread" in caplog.text


def test_watchdog_ignores_long_spans_with_ongoing_progress():
    rec = trace.get_recorder()
    registry = telemetry.metrics()
    baseline = registry.counters_snapshot()
    with knobs.override_watchdog_deadline_seconds(0.1):
        with rec.span(names.SPAN_TAKE, path="/healthy-but-long"):
            deadline = time.monotonic() + 0.5
            while time.monotonic() < deadline:
                with rec.span(names.SPAN_STORAGE_WRITE, plugin="fs", blob="b"):
                    pass
                time.sleep(0.02)
    assert names.WATCHDOG_STALLS_TOTAL not in registry.counters_delta_since(baseline)


def test_watchdog_rearms_for_a_new_stall_episode():
    rec = trace.get_recorder()
    registry = telemetry.metrics()
    baseline = registry.counters_snapshot()
    with knobs.override_watchdog_deadline_seconds(0.1):
        with rec.span(names.SPAN_MIRROR_BLOB, blob="a"):
            time.sleep(0.3)
        time.sleep(0.2)
        with rec.span(names.SPAN_MIRROR_BLOB, blob="b"):
            time.sleep(0.3)
        time.sleep(0.1)
    assert registry.counters_delta_since(baseline).get(names.WATCHDOG_STALLS_TOTAL) == 2.0


def test_watchdog_silent_on_fast_work(tmp_path):
    """With the suite's deadline of 0 a take starts no watchdog thread."""
    assert knobs.get_watchdog_deadline_seconds() == 0.0
    registry = telemetry.metrics()
    baseline = registry.counters_snapshot()
    Snapshot.take(str(tmp_path / "snap"), _state())
    assert names.WATCHDOG_STALLS_TOTAL not in registry.counters_delta_since(baseline)
    assert watchdog._WATCHDOG is None


def test_stack_dump_holds_no_frame_alive():
    """The stall report's stack dump reads every thread's frames and
    lets them go: a tensor that a parked thread holds is freed once the
    thread lets go of it, after a dump was taken."""
    ready, release = threading.Event(), threading.Event()
    ref = []

    def parked():
        tensor = torch.ones(1024)
        ref.append(weakref.ref(tensor))
        ready.set()
        release.wait(10)

    t = threading.Thread(target=parked, name="parked")
    t.start()
    assert ready.wait(10)
    dump = watchdog._thread_stacks()
    assert "Thread parked" in dump and "release.wait" in dump
    release.set()
    t.join(10)
    gc.collect()
    assert ref[0]() is None


def test_fsck_stats_lists_trace_files(tmp_path, capsys):
    from torchsnapshot_tpu_torch.fsck import main as fsck_main

    snap = str(tmp_path / "snap")
    with knobs.enable_trace(), knobs.enable_telemetry():
        Snapshot.take(snap, _state())
    rc = fsck_main([snap, "--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "flight-recorder traces" in out
    assert ".trace-take-rank0.json" in out
    assert names.SPAN_TAKE in out
